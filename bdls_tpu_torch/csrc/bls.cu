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
// the loop bits); here one thread carries one Miller loop, or one side's
// final exponentiation, with 12 x 32-bit Montgomery limbs
// (csrc/fp381.cuh, csrc/bls12.cuh).
//
// Three kernels:
// - bls_miller_kernel: 2B independent (Q, P) pairs -> (n, d). Pair t < B
//   is (sig, g1) of lane t, pair B + t is (H(m), pk) of lane t.
// - bls_final_kernel: thread 2b takes lhs = n1·d2 of lane b, thread
//   2b + 1 rhs = n2·d1; each runs the x-chain final exponentiation,
//   writes it to the fe scratch, and after the block's barrier thread 2b
//   compares. With the Miller launch it is the "kernel-fast" backend.
// - bls_final_full_kernel (K11): the full exponent (p^12 - 1)/r, the
//   value of the reference's final_exp (:456-474) inside
//   _jitted_fe_product (:508), composed by verify_pipeline (:609), the
//   "kernel" backend. A block a lane: warp 0 takes lhs, warp 1 rhs, each
//   through the exact x-chain with cyclotomic squares
//   (bls12.cuh:final_exp_exact), its values in shared memory and each
//   step's independent Fp products spread over its 32 threads; after the
//   block's barrier thread 0 compares. Its values are the cube roots of
//   bls_final_kernel's.
//
// What bounds it: 32-bit multiply throughput in principle, some 0.4 M
// 381-bit Montgomery products a certificate (two Miller loops of some
// 170 k, two final exponentiations of some 30 k); in practice the
// latency of a dependent chain, since a call carries 1-128
// certificates. K9 runs one thread a chain, its FQ12 values (576 bytes
// each, some 20 live) in local memory; a block a lane with the
// coefficient products spread over its threads, and the twisted
// (Fp2-tower) Miller loop with sparse lines, are its redesigns
// (ROADMAP.md Queue R). K11's chain is some 314 cyclotomic squares of
// one Fp product deep across the warp, some 60 products of four, and
// the norm's Fermat inverse (some 570 products on one thread).
//
// Interface: plain C, bound with ctypes (bdls_tpu_torch/ops/_build.py).
// Every FQ12 array is (12 words, 12 coefficients, N) int32, canonical
// little-endian words; K9's Frobenius tables are (3, 12, 12, 12) words in
// Montgomery form (k = 1, 2, 6), K11's the sparse entries of k = 1, 2
// (bls12.cuh, FROB_ENTRY words each). A launch goes on the caller's stream,
// does not synchronise, and returns cudaGetLastError().
#include <cuda_runtime.h>

#include "bls12.cuh"

namespace bdls {

__global__ void bls_miller_kernel(const int32_t* __restrict__ qx,
                                  const int32_t* __restrict__ qy,
                                  const int32_t* __restrict__ px,
                                  const int32_t* __restrict__ py,
                                  int32_t* __restrict__ n_out,
                                  int32_t* __restrict__ d_out, int N) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= N) return;
  fq12 Qx, Qy, Px, Py, n, d;
  f12_load(Qx, qx, t, N);
  f12_load(Qy, qy, t, N);
  f12_load(Px, px, t, N);
  f12_load(Py, py, t, N);
  miller_nd(n, d, Qx, Qy, Px, Py);
  f12_store(n_out, n, t, N);
  f12_store(d_out, d, t, N);
}

__global__ void bls_final_kernel(const int32_t* __restrict__ n,
                                 const int32_t* __restrict__ d,
                                 const uint32_t* __restrict__ frob,
                                 int32_t* __restrict__ fe,
                                 uint8_t* __restrict__ out, int B) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int b = t >> 1, side = t & 1;
  const int N = 2 * B;
  if (b < B) {
    // side 0: n1·d2 (lane b of n, lane B + b of d); side 1: n2·d1
    fq12 x, y;
    f12_load(x, n, side ? B + b : b, N);
    f12_load(y, d, side ? b : B + b, N);
    f12_mul(x, x, y);
    final_exp(y, x, frob_at(frob));
    f12_store(fe, y, t, N);
  }
  // the two sides of a lane are in one block (blockDim is even)
  __syncthreads();
  if (b < B && side == 0) {
    fq12 lhs, rhs;
    f12_load(lhs, fe, t, N);
    f12_load(rhs, fe, t + 1, N);
    out[b] = compare_tail(lhs, rhs) ? 1 : 0;
  }
}

// K11: a block of two warps a lane; warp 0 computes FE(n1·d2), warp 1
// FE(n2·d1), into fe (columns 2b and 2b + 1) and shared memory
__global__ void __launch_bounds__(2 * WARP)
bls_final_full_kernel(const int32_t* __restrict__ n,
                      const int32_t* __restrict__ d,
                      const uint32_t* __restrict__ frob,
                      int32_t* __restrict__ fe, uint8_t* __restrict__ out,
                      int B) {
  __shared__ fe_warp ws[2];
  const int b = blockIdx.x, side = threadIdx.x / WARP;
  const int N = 2 * B;
  final_full_side(ws[side], threadIdx.x % WARP, n, side ? B + b : b, d,
                  side ? b : B + b, N, frob, fe, 2 * b + side);
  __syncthreads();
  if (threadIdx.x == 0)
    out[b] = compare_tail(ws[0].v[FW_OUT], ws[1].v[FW_OUT]) ? 1 : 0;
}

}  // namespace bdls

// The Miller loops of N (Q, P) pairs: qx, qy, px, py in, n, d out.
extern "C" int bdls_bls_miller(const void* qx, const void* qy,
                               const void* px, const void* py, void* n,
                               void* d, int N, int threads, void* stream) {
  if (N <= 0) return 0;
  if (threads <= 0 || threads > 1024) return (int)cudaErrorInvalidValue;
  const dim3 grid((N + threads - 1) / threads);
  bdls::bls_miller_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)qx, (const int32_t*)qy, (const int32_t*)px,
      (const int32_t*)py, (int32_t*)n, (int32_t*)d, N);
  return (int)cudaGetLastError();
}

// Final exponentiations and compares of B lanes from the 2B Miller
// outputs: fe (12, 12, 2B) receives FE(n1·d2) and FE(n2·d1) interleaved
// (column 2b and 2b + 1), out B bytes, 1 = valid. threads must be even.
extern "C" int bdls_bls_final(const void* n, const void* d, const void* frob,
                              void* fe, void* out, int B, int threads,
                              void* stream) {
  if (B <= 0) return 0;
  if (threads <= 0 || threads > 1024 || (threads & 1))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((2 * B + threads - 1) / threads);
  bdls::bls_final_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)n, (const int32_t*)d, (const uint32_t*)frob,
      (int32_t*)fe, (uint8_t*)out, B);
  return (int)cudaGetLastError();
}

// bdls_bls_final with the full exponent (K11): frob holds the sparse
// Frobenius entries of k = 1, 2 (FROB1_NNZ + FROB2_NNZ entries of
// FROB_ENTRY words); a block of 64 threads a lane.
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
