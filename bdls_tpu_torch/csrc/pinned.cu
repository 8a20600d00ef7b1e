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
// Interface: plain C, bound with ctypes (bdls_tpu_torch/ops/_build.py).
// The launch goes on the caller's stream, does not synchronise, and
// returns cudaGetLastError().
#include <cuda_runtime.h>

#include "pinned.cuh"

namespace bdls {

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
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  fe vr, vs, ve;
  load_limbs16(vr, r, b, B);
  load_limbs16(vs, s, b, B);
  load_limbs16(ve, e, b, B);
  out[b] = verify_pinned_lane<C>(vr, vs, ve, slot[b], cap, px, py, ppsi,
                                 g32) ? 1 : 0;
}

}  // namespace bdls

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
  if (B <= 0) return 0;
  if (threads <= 0 || threads > 1024 || cap <= 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((B + threads - 1) / threads);
  cudaStream_t st = (cudaStream_t)stream;
  const int32_t* ri = (const int32_t*)r;
  const int32_t* si = (const int32_t*)s;
  const int32_t* ei = (const int32_t*)e;
  const int32_t* sl = (const int32_t*)slot;
  const uint32_t* x = (const uint32_t*)px;
  const uint32_t* y = (const uint32_t*)py;
  const uint32_t* g = (const uint32_t*)g32;
  if (curve == 0) {
    bdls::pinned_kernel<bdls::CurveP256><<<grid, threads, 0, st>>>(
        ri, si, ei, sl, x, y, x, g, (uint8_t*)out, B, cap);
  } else if (curve == 1) {
    if (ppsi == nullptr) return (int)cudaErrorInvalidValue;
    bdls::pinned_kernel<bdls::CurveK256><<<grid, threads, 0, st>>>(
        ri, si, ei, sl, x, y, (const uint32_t*)ppsi, g, (uint8_t*)out, B,
        cap);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
