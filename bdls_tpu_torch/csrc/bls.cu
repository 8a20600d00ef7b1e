// Batched BLS12-381 certificate check for Hopper (sm_90a): K9 and K11.
//
// Replaces the TPU programs of bdls_tpu/ops/bls_kernel.py: the jitted
// Miller loop (_jitted_miller, :498), the final exponentiation
// (_jitted_fe_product :508, the x-chain stages _jitted_stage :519) and
// the compare (_jitted_compare, :552), composed by verify_pipeline(_fast)
// (:609, :642): the (B,) verdict of e(g1, sig) == e(pk, H(m)), computed
// as FE(n1·d2) == FE(n2·d1) and FE(n1·d2) != 0. The TPU shaped those
// programs for its vector unit (radix-12 limbs, every FQ12 product one
// 144-wide batched multiply plus a constant contraction, lax.scan over
// the loop bits); here a warp carries one Miller loop, or one side's
// final exponentiation, with 12 x 32-bit Montgomery limbs
// (csrc/fp381.cuh, csrc/bls12.cuh).
//
// Three kernels:
// - bls_miller_kernel: 2B independent (Q, P) pairs -> (n, d), a warp a
//   pair (a block of 32 threads). Pair t < B is (sig, g1) of lane t,
//   pair B + t is (H(m), pk) of lane t. A pair of the twisted form (every
//   honest certificate's) runs the Miller loop in the Fp2 tower with the
//   known zeros left out; any other pair runs the dense formulas with
//   tower products; both give the reference's (n, d)
//   (bls12.cuh:miller_pair).
// - bls_final_kernel (K9's x-chain, the "kernel-fast" backend with the
//   Miller launch) and bls_final_full_kernel (K11, the full exponent
//   (p^12 - 1)/r, the value of the reference's final_exp (:456-474)
//   inside _jitted_fe_product (:508), composed by verify_pipeline (:609),
//   the "kernel" backend): a block a lane, warp 0 takes lhs = n1·d2,
//   warp 1 rhs = n2·d1, each through the exact chain with cyclotomic
//   squares (bls12.cuh:final_exp_exact; K11's values are the cube roots
//   of K9's), writes it to fe, and after the block's barrier thread 0
//   compares.
//
// What bounds it: 32-bit multiply throughput in principle (the least
// work is some 17,700 381-bit products a certificate); in practice the
// latency of a dependent chain, since a call carries 1-128 certificates:
// a few hundred warps on 132 SMs. So each (Q, P) pair and each side is a
// warp, its values in shared memory, each step's independent Fp products
// spread over the 32 lanes (bls12.cuh's warp code): the twisted Miller
// loop is some 400 steps of one to three Fp products a lane, some 11,300
// Fp products a pair (a dense pair some 124,000); a side's chain some 314
// cyclotomic squares of one Fp product deep across the warp, some 60
// products of four, and the norm's Fermat inverse (some 570 products on
// one lane). The Miller launch keeps one warp a block (17,856 bytes of
// shared memory: the dense path's 22 FQ12 values beside the product
// scratch), so that 128 certificates' 256 pairs spread over the SMs.
//
// Interface: plain C, bound with ctypes (bdls_tpu_torch/ops/_build.py).
// Every FQ12 array is (12 words, 12 coefficients, N) int32, canonical
// little-endian words; the final launches' Frobenius table holds the
// sparse entries of k = 1, 2 (bls12.cuh, FROB_ENTRY words each). A
// launch goes on the caller's stream, does not synchronise, and returns
// cudaGetLastError().
#include <cuda_runtime.h>

#include "bls12.cuh"

namespace bdls {

__global__ void __launch_bounds__(WARP)
bls_miller_kernel(const int32_t* __restrict__ qx,
                  const int32_t* __restrict__ qy,
                  const int32_t* __restrict__ px,
                  const int32_t* __restrict__ py, int32_t* __restrict__ n_out,
                  int32_t* __restrict__ d_out, int N) {
  __shared__ miller_warp ws;
  miller_pair(ws, threadIdx.x, qx, qy, px, py, blockIdx.x, N, n_out, d_out);
}

// a block of two warps a lane: warp 0 computes FE(n1·d2), warp 1
// FE(n2·d1), into fe (columns 2b and 2b + 1) and shared memory
template <bool CUBE>
__device__ __forceinline__ void final_block(const int32_t* n,
                                            const int32_t* d,
                                            const uint32_t* frob,
                                            int32_t* fe, uint8_t* out,
                                            int B) {
  __shared__ fe_warp ws[2];
  const int b = blockIdx.x, side = threadIdx.x / WARP;
  const int N = 2 * B;
  final_side<CUBE>(ws[side], threadIdx.x % WARP, n, side ? B + b : b, d,
                   side ? b : B + b, N, frob, fe, 2 * b + side);
  __syncthreads();
  if (threadIdx.x == 0)
    out[b] = compare_tail(ws[0].v[FW_OUT], ws[1].v[FW_OUT]) ? 1 : 0;
}

// K9: the x-chain, FE = f^(3(p^12 - 1)/r)
__global__ void __launch_bounds__(2 * WARP)
bls_final_kernel(const int32_t* __restrict__ n,
                 const int32_t* __restrict__ d,
                 const uint32_t* __restrict__ frob, int32_t* __restrict__ fe,
                 uint8_t* __restrict__ out, int B) {
  final_block<true>(n, d, frob, fe, out, B);
}

// K11: the full exponent, FE = f^((p^12 - 1)/r)
__global__ void __launch_bounds__(2 * WARP)
bls_final_full_kernel(const int32_t* __restrict__ n,
                      const int32_t* __restrict__ d,
                      const uint32_t* __restrict__ frob,
                      int32_t* __restrict__ fe, uint8_t* __restrict__ out,
                      int B) {
  final_block<false>(n, d, frob, fe, out, B);
}

}  // namespace bdls

// The Miller loops of N (Q, P) pairs: qx, qy, px, py in, n, d out; a
// block of 32 threads a pair.
extern "C" int bdls_bls_miller(const void* qx, const void* qy,
                               const void* px, const void* py, void* n,
                               void* d, int N, void* stream) {
  if (N <= 0) return 0;
  bdls::bls_miller_kernel<<<N, bdls::WARP, 0, (cudaStream_t)stream>>>(
      (const int32_t*)qx, (const int32_t*)qy, (const int32_t*)px,
      (const int32_t*)py, (int32_t*)n, (int32_t*)d, N);
  return (int)cudaGetLastError();
}

// Final exponentiations (the x-chain) and compares of B lanes from the
// 2B Miller outputs: fe (12, 12, 2B) receives FE(n1·d2) and FE(n2·d1)
// interleaved (column 2b and 2b + 1), out B bytes, 1 = valid; frob holds
// the sparse Frobenius entries of k = 1, 2 (FROB1_NNZ + FROB2_NNZ entries
// of FROB_ENTRY words); a block of 64 threads a lane.
extern "C" int bdls_bls_final(const void* n, const void* d, const void* frob,
                              void* fe, void* out, int B, void* stream) {
  if (B <= 0) return 0;
  bdls::bls_final_kernel<<<B, 2 * bdls::WARP, 0, (cudaStream_t)stream>>>(
      (const int32_t*)n, (const int32_t*)d, (const uint32_t*)frob,
      (int32_t*)fe, (uint8_t*)out, B);
  return (int)cudaGetLastError();
}

// bdls_bls_final with the full exponent (K11).
extern "C" int bdls_bls_final_full(const void* n, const void* d,
                                   const void* frob, void* fe, void* out,
                                   int B, void* stream) {
  if (B <= 0) return 0;
  bdls::bls_final_full_kernel<<<B, 2 * bdls::WARP, 0,
                                (cudaStream_t)stream>>>(
      (const int32_t*)n, (const int32_t*)d, (const uint32_t*)frob,
      (int32_t*)fe, (uint8_t*)out, B);
  return (int)cudaGetLastError();
}
