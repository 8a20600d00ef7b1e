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
// here one thread carries one lane from its inputs to its verdict, with
// 8 x 32-bit Montgomery limbs (csrc/field.cuh), the complete RCB
// formulas (csrc/point.cuh), the GLV split on the card (csrc/glv.cuh)
// and the zero-doubling schedule of csrc/pinned.cuh.
//
// What bounds it: 32-bit integer multiply issue, or, now that no
// doubling separates one table read from the next, the latency of
// gathering the table entries. A secp256k1 lane makes 102 complete
// additions (P-256: 98), each waiting on a 64-byte Q entry from its
// key's pool (29.4 KB a key for secp256k1, 38.0 KB for P-256) or a
// 96-byte entry of the curve's 786 KB g32 table; both live in L2, not
// L1, and a lane reads about 7.5 KB a verify, through __ldg as 16-byte
// loads. The design is simple and right first: one lane per thread, a
// per-lane Fermat inverse of s (the reference batch-inverts), full
// complete additions where the entries are affine. Batch inversion
// across a block and mixed additions are later redesigns (ROADMAP.md).
//
// A mesh shard (K10) launches pinned_kernel_count: the same lane body,
// then the block's masked valid count (mesh.cuh:count_epilogue); COUNT is
// a template parameter of the body, so pinned_kernel compiles as it did.
//
// Interface: plain C, bound with ctypes (bdls_tpu_torch/ops/_build.py).
// The launch goes on the caller's stream, does not synchronise, and
// returns cudaGetLastError().
#include <cuda_runtime.h>

#include "mesh.cuh"
#include "pinned.cuh"

namespace bdls {

// The lane body of both kernels: COUNT adds K10's epilogue (mesh.cuh),
// for which every thread of the block stays to the barrier.
template <class C, bool COUNT>
__device__ __forceinline__ void pinned_body(
    const int32_t* __restrict__ r, const int32_t* __restrict__ s,
    const int32_t* __restrict__ e, const int32_t* __restrict__ slot,
    const uint32_t* __restrict__ px, const uint32_t* __restrict__ py,
    const uint32_t* __restrict__ ppsi, const uint32_t* __restrict__ g32,
    uint8_t* __restrict__ out, const uint8_t* __restrict__ mask,
    uint32_t* __restrict__ partial, int B, int cap) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
#ifdef BDLS_MUL_MXU
  // mma.sync needs the whole warp: a thread past B runs lane 0 as
  // filler and stores nothing
  constexpr bool filler = true;
#else
  // a thread past B runs no lane (it still reaches the count's barrier)
  constexpr bool filler = false;
#endif
  const bool live = b < B;
  if (live || filler) {
    const int lane = live ? b : 0;
    fe vr, vs, ve;
    load_limbs16(vr, r, lane, B);
    load_limbs16(vs, s, lane, B);
    load_limbs16(ve, e, lane, B);
    const bool ok = verify_pinned_lane<C>(vr, vs, ve, slot[lane], cap, px,
                                          py, ppsi, g32);
    if (live) out[b] = ok ? 1 : 0;
  }
  if constexpr (COUNT) count_epilogue(live, out, mask, b, partial);
}

template <class C>
__global__ void pinned_kernel(const int32_t* __restrict__ r,
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
__global__ void pinned_kernel_count(const int32_t* __restrict__ r,
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
// pinned_kernel_count with ceil(B / threads) partials
int launch_pinned(int curve, const void* r, const void* s, const void* e,
                  const void* slot, const void* px, const void* py,
                  const void* ppsi, const void* g32, void* out,
                  const void* mask, void* partial, int B, int cap,
                  int threads, void* stream) {
  if (B <= 0) return 0;
  if (threads <= 0 || threads > 1024 || cap <= 0)
    return (int)cudaErrorInvalidValue;
#ifdef BDLS_MUL_MXU
  // K5's shared buffers hold BDLS_MXU_WARPS full warps a block
  if (threads % 32 != 0 || threads > 32 * BDLS_MXU_WARPS)
    return (int)cudaErrorInvalidValue;
#endif
  if (curve == 1 && ppsi == nullptr) return (int)cudaErrorInvalidValue;
  if (curve != 0 && curve != 1) return (int)cudaErrorInvalidValue;
  const dim3 grid((B + threads - 1) / threads);
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
    bdls::pinned_kernel<bdls::CurveP256><<<grid, threads, 0, st>>>(
        ri, si, ei, sl, x, y, psi, g, o, B, cap);
  } else if (curve == 1 && !p) {
    bdls::pinned_kernel<bdls::CurveK256><<<grid, threads, 0, st>>>(
        ri, si, ei, sl, x, y, psi, g, o, B, cap);
  } else if (curve == 0) {
    bdls::pinned_kernel_count<bdls::CurveP256><<<grid, threads, 0, st>>>(
        ri, si, ei, sl, x, y, psi, g, o, m, p, B, cap);
  } else {
    bdls::pinned_kernel_count<bdls::CurveK256><<<grid, threads, 0, st>>>(
        ri, si, ei, sl, x, y, psi, g, o, m, p, B, cap);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// curve: 0 = P-256, 1 = secp256k1. r, s, e: (16, B) int32 limbs; slot:
// (B,) int32; px, py (and ppsi for secp256k1, else unused): the pool,
// (cap, npos, 9, 8) words each, Montgomery form; g32: the curve's
// (32, 256, 3, 8) positioned G tables, Montgomery form. out: B bytes.
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
// real lane; partial receives ceil(B / threads) uint32, block j's count
// of lanes both valid and real.
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
