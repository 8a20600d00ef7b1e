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
// The mxu build (-DBDLS_MUL_MXU: mont_mul is K5's warp-collective
// mma.sync) keeps one thread a lane (csrc/edwards.cuh:verify_lane_ed25519,
// Montgomery form, blocks of 64 threads).
//
// Interface: plain C, bound with ctypes (bdls_tpu_torch/ops/_build.py).
// The launch goes on the caller's stream, does not synchronise, and
// returns cudaGetLastError().
#include <cuda_runtime.h>

#include "edwards_group.cuh"

namespace bdls {

#ifdef BDLS_MUL_MXU
__global__ void ed25519_kernel(const int32_t* __restrict__ ax,
                               const int32_t* __restrict__ ay,
                               const int32_t* __restrict__ rx,
                               const int32_t* __restrict__ ry,
                               const int32_t* __restrict__ s,
                               const int32_t* __restrict__ k,
                               const uint32_t* __restrict__ btab,
                               uint8_t* __restrict__ out, int B) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  // mma.sync needs the whole warp: a thread past B runs lane 0 as
  // filler and stores nothing
  const bool live = b < B;
  const int lane = live ? b : 0;
  fe vax, vay, vrx, vry, vs, vk;
  load_limbs16(vax, ax, lane, B);
  load_limbs16(vay, ay, lane, B);
  load_limbs16(vrx, rx, lane, B);
  load_limbs16(vry, ry, lane, B);
  load_limbs16(vs, s, lane, B);
  load_limbs16(vk, k, lane, B);
  const bool ok = verify_lane_ed25519(vax, vay, vrx, vry, vs, vk, btab);
  if (live) out[b] = ok ? 1 : 0;
}

// threads a lane in this build
constexpr int LANE_THREADS = 1;
constexpr size_t LANE_SMEM = 0;
#else
// a block is one warp; at 16 an SM (128 registers a thread) the 132 SMs
// hold the 2048 blocks of 8192 lanes in one wave. A group past B runs
// lane B - 1 as filler and stores nothing.
__global__ void __launch_bounds__(32, 16)
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
  const bool ok = grp::verify_ed25519_group<grp::ed_field>(
      g, st, ax, ay, rx, ry, s, k, btab, live ? b : B - 1, B);
  if (grp::votes(g.share, live)) out[b] = ok ? 1 : 0;
}

constexpr int LANE_THREADS = grp::GROUP;
constexpr size_t LANE_SMEM = sizeof(grp::ed_state);
#endif

}  // namespace bdls

// Threads a lane in this build: grp::GROUP (vpu), 1 (mxu). A block of
// `threads` threads carries threads / bdls_ed25519_lane_threads() lanes.
extern "C" int bdls_ed25519_lane_threads() { return bdls::LANE_THREADS; }

// Bytes of dynamic shared memory a lane in this build (its ed_state).
extern "C" int bdls_ed25519_lane_smem() { return (int)bdls::LANE_SMEM; }

// btab: the (32, 256, 3, 8) positioned B tables, (y - x, y + x, 2d·xy)
// mod p in plain form (ops/ed25519.py:device_b_table). threads: a block's
// threads, a multiple of bdls_ed25519_lane_threads(), at most 32 in the
// vpu build. out: B bytes, 1 = valid.
extern "C" int bdls_verify_ed25519(const void* ax, const void* ay,
                                   const void* rx, const void* ry,
                                   const void* s, const void* k,
                                   const void* btab, void* out, int B,
                                   int threads, void* stream) {
  if (B <= 0) return 0;
  if (threads <= 0 || threads > 1024 || threads % bdls::LANE_THREADS != 0)
    return (int)cudaErrorInvalidValue;
#ifdef BDLS_MUL_MXU
  // K5's shared buffers hold BDLS_MXU_WARPS full warps a block
  if (threads % 32 != 0 || threads > 32 * BDLS_MXU_WARPS)
    return (int)cudaErrorInvalidValue;
#else
  // the kernel's launch bounds: one warp a block at most
  if (threads > 32) return (int)cudaErrorInvalidValue;
#endif
  const int lanes = threads / bdls::LANE_THREADS;
  const size_t smem = (size_t)lanes * bdls::LANE_SMEM;
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  const dim3 grid((B + lanes - 1) / lanes);
  bdls::ed25519_kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
      (const int32_t*)ax, (const int32_t*)ay, (const int32_t*)rx,
      (const int32_t*)ry, (const int32_t*)s, (const int32_t*)k,
      (const uint32_t*)btab, (uint8_t*)out, B);
  return (int)cudaGetLastError();
}
