// Pinned-key batched ECDSA verify for Hopper (sm_90a), one kernel per
// curve.
//
// Replaces the TPU program bdls_tpu/ops/ecdsa.py:
// _jitted_verify_pinned_cached -> bdls_tpu/ops/verify_fold.py:
// verify_fold_pinned (pinned_ladder, and glv.py:decompose for
// secp256k1): the (B,) verdict of u1·G + u2·Q, x(R) == r, for a key Q
// whose positioned tables (d·16^j)·Q sit in a device pool, lane b
// reading slot[b]. The TPU shaped that program for its vector unit
// (23 x 12-bit lazy limbs, one-hot gathers, a lax.scan over the steps);
// here 8 x 32-bit Montgomery limbs (csrc/field.cuh), the complete RCB
// formulas and the GLV split on the card (csrc/glv.cuh) carry a lane
// from its inputs to its verdict with no doubling: R is a sum of some
// 100 table entries.
//
// The vpu build runs a thread group a lane (csrc/pinned_group.cuh, on
// the step rule of K1's csrc/verify_group.cuh): GROUP threads share the
// lane's state in shared memory and split each step's independent
// Montgomery products through K1's run_step; the sum runs as two chains
// side by side, each addition's addend read from the pool or the G
// tables (addend_put) in the finish step of the addition before. A block
// is one warp, 32 / GROUP lanes.
// What bounds it: the latency of a step (a task's operand sums, its
// Montgomery product, a __syncwarp) times some 200 steps, and the binary
// inverse of s on one share.
//
// The mxu build (-DBDLS_MUL_MXU) runs the same group body with every
// round's products through K5's warp-collective call (csrc/mxu.cuh), a
// block one warp.
//
// A mesh shard (K10) launches pinned_kernel_count: the same lane body,
// then the block's masked valid count (mesh.cuh:count_epilogue), one
// vote a lane; COUNT is a template parameter of the body, so
// pinned_kernel compiles as it did.
//
// Interface: plain C, bound with ctypes (bdls_tpu_torch/ops/_build.py).
// The launch goes on the caller's stream, does not synchronise, and
// returns cudaGetLastError().
#include <cuda_runtime.h>

#include "mesh.cuh"
#include "pinned_group.cuh"

namespace bdls {

// The lane body of both kernels, a group of grp::GROUP threads a lane,
// the lanes' states in dynamic shared memory: COUNT adds K10's epilogue
// (mesh.cuh), share 0 of a live lane voting. A group past B runs lane
// B - 1 as filler and stores nothing.
template <class C, bool COUNT>
__device__ __forceinline__ void pinned_body(
    const int32_t* __restrict__ r, const int32_t* __restrict__ s,
    const int32_t* __restrict__ e, const int32_t* __restrict__ slot,
    const uint32_t* __restrict__ px, const uint32_t* __restrict__ py,
    const uint32_t* __restrict__ ppsi, const uint32_t* __restrict__ g32,
    uint8_t* __restrict__ out, const uint8_t* __restrict__ mask,
    uint32_t* __restrict__ partial, int B, int cap) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int group = threadIdx.x / grp::GROUP;
  const int b = blockIdx.x * (blockDim.x / grp::GROUP) + group;
  const bool live = b < B;
  // a group past B is filler (in the mxu build it makes every K5 call)
  grp::pin_state& st = reinterpret_cast<grp::pin_state*>(smem)[group];
  const grp::gctx g{(int)(threadIdx.x % grp::GROUP), grp::warp_mask()};
  const grp::pin_tabs tabs{px, py, ppsi, g32, cap};
  const bool ok = grp::verify_pinned_group<C>(g, st, r, s, e, slot, tabs,
                                              live ? b : B - 1, B);
  const bool vote = grp::votes(g.share, live);
  if (vote) out[b] = ok ? 1 : 0;
  if constexpr (COUNT) count_epilogue(vote, out, mask, b, partial);
}

constexpr int LANE_THREADS = grp::GROUP;
constexpr size_t LANE_SMEM = sizeof(grp::pin_state);

#ifdef BDLS_MUL_MXU
// a block is BDLS_MXU_WARPS warps at most (K5's static buffers)
#define BDLS_PINNED_BOUNDS __launch_bounds__(32 * BDLS_MXU_WARPS)
#else
// a block is one warp; at 16 an SM (128 registers a thread) the 132 SMs
// hold the 2048 blocks of 8192 lanes in one wave
#define BDLS_PINNED_BOUNDS __launch_bounds__(32, 16)
#endif

template <class C>
__global__ void BDLS_PINNED_BOUNDS pinned_kernel(const int32_t* __restrict__ r,
                              const int32_t* __restrict__ s,
                              const int32_t* __restrict__ e,
                              const int32_t* __restrict__ slot,
                              const uint32_t* __restrict__ px,
                              const uint32_t* __restrict__ py,
                              const uint32_t* __restrict__ ppsi,
                              const uint32_t* __restrict__ g32,
                              uint8_t* __restrict__ out, int B, int cap) {
  pinned_body<C, false>(r, s, e, slot, px, py, ppsi, g32, out, nullptr,
                        nullptr, B, cap);
}

// K10's pinned shard program: the verify, then the block's masked count
template <class C>
__global__ void BDLS_PINNED_BOUNDS pinned_kernel_count(const int32_t* __restrict__ r,
                                    const int32_t* __restrict__ s,
                                    const int32_t* __restrict__ e,
                                    const int32_t* __restrict__ slot,
                                    const uint32_t* __restrict__ px,
                                    const uint32_t* __restrict__ py,
                                    const uint32_t* __restrict__ ppsi,
                                    const uint32_t* __restrict__ g32,
                                    uint8_t* __restrict__ out,
                                    const uint8_t* __restrict__ mask,
                                    uint32_t* __restrict__ partial, int B,
                                    int cap) {
  pinned_body<C, true>(r, s, e, slot, px, py, ppsi, g32, out, mask, partial,
                       B, cap);
}

}  // namespace bdls

namespace {

// both entries: partial == nullptr launches pinned_kernel, else
// pinned_kernel_count with ceil(B / (threads / LANE_THREADS)) partials
int launch_pinned(int curve, const void* r, const void* s, const void* e,
                  const void* slot, const void* px, const void* py,
                  const void* ppsi, const void* g32, void* out,
                  const void* mask, void* partial, int B, int cap,
                  int threads, void* stream) {
  if (B <= 0) return 0;
  if (threads <= 0 || threads > 1024 || cap <= 0 ||
      threads % bdls::LANE_THREADS != 0)
    return (int)cudaErrorInvalidValue;
  // the kernels' launch bounds: one warp a block at most (vpu), whole
  // warps in the mxu build
  if (threads > 32 || !bdls::grp::block_fits(threads))
    return (int)cudaErrorInvalidValue;
  const int lanes = threads / bdls::LANE_THREADS;
  const size_t smem = (size_t)lanes * bdls::LANE_SMEM;
  if (smem + bdls::grp::STATIC_SMEM > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  if (curve == 1 && ppsi == nullptr) return (int)cudaErrorInvalidValue;
  if (curve != 0 && curve != 1) return (int)cudaErrorInvalidValue;
  const dim3 grid((B + lanes - 1) / lanes);
  cudaStream_t st = (cudaStream_t)stream;
  const int32_t* ri = (const int32_t*)r;
  const int32_t* si = (const int32_t*)s;
  const int32_t* ei = (const int32_t*)e;
  const int32_t* sl = (const int32_t*)slot;
  const uint32_t* x = (const uint32_t*)px;
  const uint32_t* y = (const uint32_t*)py;
  // P-256 has no psi table: its kernel never reads the pointer
  const uint32_t* psi = curve == 1 ? (const uint32_t*)ppsi : x;
  const uint32_t* g = (const uint32_t*)g32;
  uint8_t* o = (uint8_t*)out;
  const uint8_t* m = (const uint8_t*)mask;
  uint32_t* p = (uint32_t*)partial;
  if (curve == 0 && !p) {
    bdls::pinned_kernel<bdls::CurveP256><<<grid, threads, smem, st>>>(
        ri, si, ei, sl, x, y, psi, g, o, B, cap);
  } else if (curve == 1 && !p) {
    bdls::pinned_kernel<bdls::CurveK256><<<grid, threads, smem, st>>>(
        ri, si, ei, sl, x, y, psi, g, o, B, cap);
  } else if (curve == 0) {
    bdls::pinned_kernel_count<bdls::CurveP256><<<grid, threads, smem, st>>>(
        ri, si, ei, sl, x, y, psi, g, o, m, p, B, cap);
  } else {
    bdls::pinned_kernel_count<bdls::CurveK256><<<grid, threads, smem, st>>>(
        ri, si, ei, sl, x, y, psi, g, o, m, p, B, cap);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Threads a lane in this build: grp::GROUP in both engines. A block of
// `threads` threads carries threads / bdls_pinned_lane_threads() lanes.
extern "C" int bdls_pinned_lane_threads() { return bdls::LANE_THREADS; }

// curve: 0 = P-256, 1 = secp256k1. r, s, e: (16, B) int32 limbs; slot:
// (B,) int32; px, py (and ppsi for secp256k1, else unused): the pool,
// (cap, npos, 9, 8) words each, Montgomery form; g32: the curve's
// (32, 256, 3, 8) positioned G tables, Montgomery form. threads: a
// block's threads, a multiple of bdls_pinned_lane_threads(), at most 32
// (in the mxu build 32). out: B bytes.
extern "C" int bdls_verify_pinned(int curve, const void* r, const void* s,
                                  const void* e, const void* slot,
                                  const void* px, const void* py,
                                  const void* ppsi, const void* g32,
                                  void* out, int B, int cap, int threads,
                                  void* stream) {
  return launch_pinned(curve, r, s, e, slot, px, py, ppsi, g32, out, nullptr,
                       nullptr, B, cap, threads, stream);
}

// bdls_verify_pinned with K10's count (a mesh shard): mask B bytes, 1 = a
// real lane; partial receives one uint32 a block (ceil(B / lanes a
// block)), block j's count of lanes both valid and real.
extern "C" int bdls_verify_pinned_masked(
    int curve, const void* r, const void* s, const void* e, const void* slot,
    const void* px, const void* py, const void* ppsi, const void* g32,
    void* out, const void* mask, void* partial, int B, int cap, int threads,
    void* stream) {
  if (mask == nullptr || partial == nullptr)
    return (int)cudaErrorInvalidValue;
  return launch_pinned(curve, r, s, e, slot, px, py, ppsi, g32, out, mask,
                       partial, B, cap, threads, stream);
}
