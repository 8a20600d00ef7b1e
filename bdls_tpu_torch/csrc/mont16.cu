// The gen-1 ECDSA verify (K4) for Hopper (sm_90a), one kernel per curve.
//
// Replaces the TPU program bdls_tpu/ops/ecdsa.py:verify_kernel with
// field="mont16" (jitted at ops/ecdsa.py:167 for a non-fold field): the
// reference's first kernel generation, 16-bit-limb CIOS Montgomery
// arithmetic (ops/mont.py) under the Jacobian windowed dual ladder
// (ops/jacobian.py), one batch inversion of s across the launch and the
// inversion-free final check. The TPU shaped it for its vector unit (16
// limbs a lane on sublanes, lax.scan over the windows, one-hot table
// lookups, an associative scan for the batch inverse); here 8 x 32-bit
// Montgomery limbs (csrc/field.cuh, the same R = 2^256) carry a lane.
//
// A thread group carries a lane (csrc/mont16_group.cuh, on the step
// engine of K1's csrc/verify_group.cuh): GROUP threads share the lane's
// state in shared memory (the inputs, the [1..15]·Q table, the
// accumulator, the window's sum, the products) and split each formula's
// levels of independent Montgomery products. Each window's 4 doublings
// carry the sum of its Q entry and G entry in their spare shares, then
// one addition; an exceptional double runs only in a warp where some
// lane needs it. s^-1 is a binary extended Euclid on one share. A block
// is one warp, 32 / GROUP lanes. What bounds it: the latency of a step (a
// task's operand sums and its product on one thread, a __syncwarp) times
// some 1,400 (P-256) or 1,160 (secp256k1) steps; at 8192 lanes the issue
// of some 5,000 products a lane. A lane reads 320 bytes and 64 G entries
// of 64 bytes (the 1 KB table stays in the cache) and writes one byte.
//
// A mesh shard (K10) launches mont16_kernel_count: the same body, then,
// after every lane of the block stored its verdict, the block's masked
// valid count (mesh.cuh:count_epilogue), share 0 of a live lane voting;
// COUNT is a template parameter of the body.
//
// Interface: plain C, bound with ctypes (bdls_tpu_torch/ops/_build.py).
// The launch goes on the caller's stream, does not synchronise, and
// returns cudaGetLastError().
#include <cuda_runtime.h>

#include "mesh.cuh"
#include "mont16_group.cuh"

namespace bdls {

// a block is one warp; at 16 an SM (128 registers a thread) the 132 SMs
// hold the 2048 blocks of 8192 lanes in one wave
#define BDLS_M16_BOUNDS __launch_bounds__(32, 16)

// The lane body of both kernels, a group of grp::GROUP threads a lane,
// the lanes' states in dynamic shared memory: COUNT adds K10's epilogue
// (mesh.cuh), share 0 of a live lane voting. A group past B runs lane
// B - 1 as filler and stores nothing.
template <class C, bool COUNT>
__device__ __forceinline__ void mont16_body(
    const int32_t* __restrict__ qx, const int32_t* __restrict__ qy,
    const int32_t* __restrict__ r, const int32_t* __restrict__ s,
    const int32_t* __restrict__ e, const uint32_t* __restrict__ gtab,
    uint8_t* __restrict__ out, const uint8_t* __restrict__ mask,
    uint32_t* __restrict__ partial, int B) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int group = threadIdx.x / grp::GROUP;
  const int b = blockIdx.x * (blockDim.x / grp::GROUP) + group;
  const bool live = b < B;
  grp::m16_state& st = reinterpret_cast<grp::m16_state*>(smem)[group];
  const grp::gctx g{(int)(threadIdx.x % grp::GROUP), grp::warp_mask()};
  const bool ok = grp::verify_lane_mont16_group<C>(
      g, st, qx, qy, r, s, e, gtab, live ? b : B - 1, B);
  const bool vote = grp::votes(g.share, live);
  if (vote) out[b] = ok ? 1 : 0;
  if constexpr (COUNT) count_epilogue(vote, out, mask, b, partial);
}

constexpr int LANE_THREADS = grp::GROUP;
constexpr size_t LANE_SMEM = sizeof(grp::m16_state);

template <class C>
__global__ void BDLS_M16_BOUNDS
    mont16_kernel(const int32_t* __restrict__ qx,
                  const int32_t* __restrict__ qy,
                  const int32_t* __restrict__ r,
                  const int32_t* __restrict__ s,
                  const int32_t* __restrict__ e,
                  const uint32_t* __restrict__ gtab,
                  uint8_t* __restrict__ out, int B) {
  mont16_body<C, false>(qx, qy, r, s, e, gtab, out, nullptr, nullptr, B);
}

// K10's shard program under mont16: the verify, then the block's count
template <class C>
__global__ void BDLS_M16_BOUNDS
    mont16_kernel_count(const int32_t* __restrict__ qx,
                        const int32_t* __restrict__ qy,
                        const int32_t* __restrict__ r,
                        const int32_t* __restrict__ s,
                        const int32_t* __restrict__ e,
                        const uint32_t* __restrict__ gtab,
                        uint8_t* __restrict__ out,
                        const uint8_t* __restrict__ mask,
                        uint32_t* __restrict__ partial, int B) {
  mont16_body<C, true>(qx, qy, r, s, e, gtab, out, mask, partial, B);
}

}  // namespace bdls

namespace {

// both entries: partial == nullptr launches mont16_kernel, else
// mont16_kernel_count with ceil(B / (threads / LANE_THREADS)) partials
int launch_mont16(int curve, const void* qx, const void* qy, const void* r,
                  const void* s, const void* e, const void* gtab, void* out,
                  const void* mask, void* partial, int B, int threads,
                  void* stream) {
  if (B <= 0) return 0;
  // the kernels' launch bounds: one warp a block at most, whole lanes
  if (threads <= 0 || threads > 32 || threads % bdls::LANE_THREADS != 0)
    return (int)cudaErrorInvalidValue;
  const int lanes = threads / bdls::LANE_THREADS;
  const size_t smem = (size_t)lanes * bdls::LANE_SMEM;
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  const dim3 grid((B + lanes - 1) / lanes);
  cudaStream_t st = (cudaStream_t)stream;
  const int32_t* a[5] = {(const int32_t*)qx, (const int32_t*)qy,
                         (const int32_t*)r, (const int32_t*)s,
                         (const int32_t*)e};
  const uint32_t* g = (const uint32_t*)gtab;
  uint8_t* o = (uint8_t*)out;
  const uint8_t* m = (const uint8_t*)mask;
  uint32_t* p = (uint32_t*)partial;
  if (curve == 0 && !p) {
    bdls::mont16_kernel<bdls::CurveP256><<<grid, threads, smem, st>>>(
        a[0], a[1], a[2], a[3], a[4], g, o, B);
  } else if (curve == 1 && !p) {
    bdls::mont16_kernel<bdls::CurveK256><<<grid, threads, smem, st>>>(
        a[0], a[1], a[2], a[3], a[4], g, o, B);
  } else if (curve == 0) {
    bdls::mont16_kernel_count<bdls::CurveP256><<<grid, threads, smem, st>>>(
        a[0], a[1], a[2], a[3], a[4], g, o, m, p, B);
  } else if (curve == 1) {
    bdls::mont16_kernel_count<bdls::CurveK256><<<grid, threads, smem, st>>>(
        a[0], a[1], a[2], a[3], a[4], g, o, m, p, B);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Threads a lane: grp::GROUP. A block of `threads` threads carries
// threads / bdls_mont16_lane_threads() lanes.
extern "C" int bdls_mont16_lane_threads() { return bdls::LANE_THREADS; }

// Bytes of dynamic shared memory a lane (its m16_state).
extern "C" int bdls_mont16_lane_smem() { return (int)bdls::LANE_SMEM; }

// curve: 0 = P-256, 1 = secp256k1. gtab: the curve's host [0..15]·G
// table, (16, 2, 8) words in Montgomery form. threads: a block's threads,
// a multiple of bdls_mont16_lane_threads(), at most 32. out: B bytes,
// 1 = valid.
extern "C" int bdls_verify_mont16(int curve, const void* qx, const void* qy,
                                  const void* r, const void* s,
                                  const void* e, const void* gtab, void* out,
                                  int B, int threads, void* stream) {
  return launch_mont16(curve, qx, qy, r, s, e, gtab, out, nullptr, nullptr,
                       B, threads, stream);
}

// bdls_verify_mont16 with K10's count (a mesh shard): mask B bytes, 1 = a
// real lane; partial receives one uint32 a block (ceil(B / lanes a
// block)), block j's count of lanes both valid and real.
extern "C" int bdls_verify_mont16_masked(int curve, const void* qx,
                                         const void* qy, const void* r,
                                         const void* s, const void* e,
                                         const void* gtab, void* out,
                                         const void* mask, void* partial,
                                         int B, int threads, void* stream) {
  if (mask == nullptr || partial == nullptr)
    return (int)cudaErrorInvalidValue;
  return launch_mont16(curve, qx, qy, r, s, e, gtab, out, mask, partial, B,
                       threads, stream);
}
