// Batched Ed25519 verify (RFC 8032, cofactorless) for Hopper (sm_90a): K8.
//
// Replaces the TPU program bdls_tpu/ops/ed25519.py:_jitted_verify_cached
// -> verify_ed25519: the (B,) verdict of [S]B + [k](-A) == R for six
// (16, B) arrays of 16-bit limbs (ax, ay, rx, ry, s, k). The TPU shaped
// that program for its vector unit (radix-12 fold limbs, one-hot table
// lookups, a lax.scan over the 33 ladder steps); here 8 x 32-bit limbs
// mod 2^255 - 19 and the extended-coordinate formulas carry a lane from
// its inputs to its verdict.
//
// The vpu build runs a thread group a lane (csrc/edwards_group.cuh, on
// the step rule of K1's csrc/verify_group.cuh): GROUP threads share the
// lane's state in shared memory (the inputs, the [0..8]·(-A) table, both
// accumulators, the next B entry) and split each step's independent
// products (plain form, each product reduced through 2^256 = 38 mod p);
// [k](-A) takes 640 steps of at most four products, [S]B rides in the
// spare shares, each B entry read from global memory by three shares in
// a step of its own. A block is one warp, 32 / GROUP lanes.
// What bounds it: the latency of a step (a task's operand sums, its
// product, a __syncwarp) times some 660 steps; a lane reads 384 bytes and
// 32 B entries of 96 bytes (the 786 KB table stays in L2) and writes one
// byte.
//
// The mxu build (-DBDLS_MUL_MXU) runs the same group body over
// grp::ed_field_mxu: each round's products through K5's warp-collective
// call (csrc/mxu.cuh), then the same fold through 2^256 = 38, so the B
// table and the forms are the vpu build's.
//
// Interface: plain C, bound with ctypes (bdls_tpu_torch/ops/_build.py).
// The launch goes on the caller's stream, does not synchronise, and
// returns cudaGetLastError().
#include <cuda_runtime.h>

#include "edwards_group.cuh"

namespace bdls {

#ifdef BDLS_MUL_MXU
// a block is BDLS_MXU_WARPS warps at most (K5's static buffers)
#define BDLS_ED_BOUNDS __launch_bounds__(32 * BDLS_MXU_WARPS)
#else
// a block is one warp; at 16 an SM (128 registers a thread) the 132 SMs
// hold the 2048 blocks of 8192 lanes in one wave
#define BDLS_ED_BOUNDS __launch_bounds__(32, 16)
#endif

// A group past B runs lane B - 1 as filler and stores nothing (in the mxu
// build it also makes every K5 call of the warp).
__global__ void BDLS_ED_BOUNDS
    ed25519_kernel(const int32_t* __restrict__ ax,
                   const int32_t* __restrict__ ay,
                   const int32_t* __restrict__ rx,
                   const int32_t* __restrict__ ry,
                   const int32_t* __restrict__ s,
                   const int32_t* __restrict__ k,
                   const uint32_t* __restrict__ btab,
                   uint8_t* __restrict__ out, int B) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int group = threadIdx.x / grp::GROUP;
  const int b = blockIdx.x * (blockDim.x / grp::GROUP) + group;
  const bool live = b < B;
  grp::ed_state& st = reinterpret_cast<grp::ed_state*>(smem)[group];
  const grp::gctx g{(int)(threadIdx.x % grp::GROUP), grp::warp_mask()};
  const bool ok = grp::verify_ed25519_group<grp::ed_engine>(
      g, st, ax, ay, rx, ry, s, k, btab, live ? b : B - 1, B);
  if (grp::votes(g.share, live)) out[b] = ok ? 1 : 0;
}

constexpr int LANE_THREADS = grp::GROUP;
constexpr size_t LANE_SMEM = sizeof(grp::ed_state);

}  // namespace bdls

// Threads a lane in this build: grp::GROUP in both engines. A block of
// `threads` threads carries threads / bdls_ed25519_lane_threads() lanes.
extern "C" int bdls_ed25519_lane_threads() { return bdls::LANE_THREADS; }

// Bytes of dynamic shared memory a lane in this build (its ed_state).
extern "C" int bdls_ed25519_lane_smem() { return (int)bdls::LANE_SMEM; }

// btab: the (32, 256, 3, 8) positioned B tables, (y - x, y + x, 2d·xy)
// mod p in plain form (ops/ed25519.py:device_b_table). threads: a block's
// threads, a multiple of bdls_ed25519_lane_threads(), at most 32 (in the
// mxu build 32). out: B bytes, 1 = valid.
extern "C" int bdls_verify_ed25519(const void* ax, const void* ay,
                                   const void* rx, const void* ry,
                                   const void* s, const void* k,
                                   const void* btab, void* out, int B,
                                   int threads, void* stream) {
  if (B <= 0) return 0;
  if (threads <= 0 || threads > 1024 || threads % bdls::LANE_THREADS != 0)
    return (int)cudaErrorInvalidValue;
  // the kernel's launch bounds: one warp a block at most (vpu), whole
  // warps in the mxu build
  if (threads > 32 || !bdls::grp::block_fits(threads))
    return (int)cudaErrorInvalidValue;
  const int lanes = threads / bdls::LANE_THREADS;
  const size_t smem = (size_t)lanes * bdls::LANE_SMEM;
  if (smem + bdls::grp::STATIC_SMEM > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((B + lanes - 1) / lanes);
  bdls::ed25519_kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
      (const int32_t*)ax, (const int32_t*)ay, (const int32_t*)rx,
      (const int32_t*)ry, (const int32_t*)s, (const int32_t*)k,
      (const uint32_t*)btab, (uint8_t*)out, B);
  return (int)cudaGetLastError();
}

namespace bdls {

// n dependent products a thread, x = x·y, on one warp: the latency of
// the group bodies' product (grp::field_prod / grp::ed_engine), one K5
// call a product in the mxu build, mont_mul_cs or mul_25519 on each
// thread in the vpu build
template <class P>
__global__ void __launch_bounds__(32)
    field_chain_kernel(const uint32_t* __restrict__ a,
                       const uint32_t* __restrict__ b,
                       uint32_t* __restrict__ out, int n) {
  const int i = threadIdx.x;
  fe x, y;
  load_fe(x, a + 8 * i);
  load_fe(y, b + 8 * i);
  const P p{};
#pragma unroll 1
  for (int k = 0; k < n; ++k) {
    if constexpr (P::collective) x = p.warp(x, y, 0xFFFFFFFFu, 0);
    else p.run(x, x, y, 0);
  }
  BDLS_UNROLL
  for (int j = 0; j < 8; ++j) out[8 * i + j] = x.v[j];
}

}  // namespace bdls

// mod: 0 = P-256 p, 1 = P-256 n, 2 = secp256k1 p, 3 = secp256k1 n (the
// Montgomery product a·b·2^-256), 4 = 2^255 - 19 (the plain product). a,
// b, out: (32, 8) words, b < m a row; one warp, thread i computes
// out_i = a_i·b_i^n (each step's product as the group bodies make it).
extern "C" int bdls_field_chain(int mod, const void* a, const void* b,
                                void* out, int n, void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const uint32_t* x = (const uint32_t*)a;
  const uint32_t* y = (const uint32_t*)b;
  uint32_t* z = (uint32_t*)out;
  using namespace bdls;
  switch (mod) {
    case 0: field_chain_kernel<grp::field_prod<P256P>>
                <<<1, 32, 0, st>>>(x, y, z, n); break;
    case 1: field_chain_kernel<grp::field_prod<P256N>>
                <<<1, 32, 0, st>>>(x, y, z, n); break;
    case 2: field_chain_kernel<grp::field_prod<K256P>>
                <<<1, 32, 0, st>>>(x, y, z, n); break;
    case 3: field_chain_kernel<grp::field_prod<K256N>>
                <<<1, 32, 0, st>>>(x, y, z, n); break;
    case 4: field_chain_kernel<grp::ed_engine>
                <<<1, 32, 0, st>>>(x, y, z, n); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
