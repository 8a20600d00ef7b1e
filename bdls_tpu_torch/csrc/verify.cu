// Batched ECDSA verify for Hopper (sm_90a), one kernel per curve.
//
// Replaces the TPU program bdls_tpu/ops/ecdsa.py:_jitted_verify_cached
// (kernel field "fold") -> bdls_tpu/ops/verify_fold.py:verify_fold: the
// (B,) verdict of u1·G + u2·Q, x(R) == r for five (16, B) arrays of
// 16-bit limbs. The TPU shaped that program for its vector unit
// (23 x 12-bit redundant limbs, lazy carries, one-hot table lookups);
// here one thread carries one lane from its inputs to its verdict, with
// 8 x 32-bit Montgomery limbs (csrc/field.cuh), the complete RCB
// formulas (csrc/point.cuh) and the generic dual ladder (csrc/verify.cuh).
//
// What bounds it: 32-bit integer multiply issue. A lane reads 320 bytes
// (five arrays of sixteen 16-bit limbs held in int32) and writes one
// byte, against some 5,000 Montgomery products of 64 widening 32x32
// multiplies each; the 24 KB G table per curve stays in L1/L2 behind
// __ldg. The design is simple and right first: one lane per thread, a
// per-lane Fermat inverse, the per-lane [0..8]·Q table in local memory.
// Montgomery's batch inversion and the GLV split for secp256k1 are the
// next redesigns (ROADMAP.md), not part of the verdict.
//
// A mesh shard (K10) launches verify_kernel_count: the same lane body,
// then the block's masked valid count (mesh.cuh:count_epilogue), so the
// shard's count needs no launch of its own. COUNT is a template
// parameter of the body, so verify_kernel compiles as it did without it.
//
// Interface: plain C, bound with ctypes (bdls_tpu_torch/ops/_build.py).
// The launch goes on the caller's stream, does not synchronise, and
// returns cudaGetLastError().
#include <cuda_runtime.h>

#include "mesh.cuh"
#include "verify.cuh"

namespace bdls {

// The lane body of both kernels: COUNT adds K10's epilogue (mesh.cuh),
// for which every thread of the block stays to the barrier.
template <class C, bool COUNT>
__device__ __forceinline__ void verify_body(
    const int32_t* __restrict__ qx, const int32_t* __restrict__ qy,
    const int32_t* __restrict__ r, const int32_t* __restrict__ s,
    const int32_t* __restrict__ e, const uint32_t* __restrict__ gtab,
    uint8_t* __restrict__ out, const uint8_t* __restrict__ mask,
    uint32_t* __restrict__ partial, int B) {
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
    fe vqx, vqy, vr, vs, ve;
    load_limbs16(vqx, qx, lane, B);
    load_limbs16(vqy, qy, lane, B);
    load_limbs16(vr, r, lane, B);
    load_limbs16(vs, s, lane, B);
    load_limbs16(ve, e, lane, B);
    const bool ok = verify_lane<C>(vqx, vqy, vr, vs, ve, gtab);
    if (live) out[b] = ok ? 1 : 0;
  }
  if constexpr (COUNT) count_epilogue(live, out, mask, b, partial);
}

template <class C>
__global__ void verify_kernel(const int32_t* __restrict__ qx,
                              const int32_t* __restrict__ qy,
                              const int32_t* __restrict__ r,
                              const int32_t* __restrict__ s,
                              const int32_t* __restrict__ e,
                              const uint32_t* __restrict__ gtab,
                              uint8_t* __restrict__ out, int B) {
  verify_body<C, false>(qx, qy, r, s, e, gtab, out, nullptr, nullptr, B);
}

// K10's shard program: the verify, then the block's masked valid count
template <class C>
__global__ void verify_kernel_count(const int32_t* __restrict__ qx,
                                    const int32_t* __restrict__ qy,
                                    const int32_t* __restrict__ r,
                                    const int32_t* __restrict__ s,
                                    const int32_t* __restrict__ e,
                                    const uint32_t* __restrict__ gtab,
                                    uint8_t* __restrict__ out,
                                    const uint8_t* __restrict__ mask,
                                    uint32_t* __restrict__ partial, int B) {
  verify_body<C, true>(qx, qy, r, s, e, gtab, out, mask, partial, B);
}

// One Montgomery product a lane (a, b, out: (B, 8) words), for the
// bit-for-bit check of the build's mont_mul (K5's against CIOS).
template <class M>
__global__ void field_mul_kernel(const uint32_t* __restrict__ a,
                                 const uint32_t* __restrict__ b,
                                 uint32_t* __restrict__ out, int B) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int k = i < B ? i : 0;
  fe x, y, z;
  BDLS_UNROLL
  for (int j = 0; j < 8; ++j) {
    x.v[j] = a[(size_t)k * 8 + j];
    y.v[j] = b[(size_t)k * 8 + j];
  }
  mont_mul<M>(z, x, y);
  if (i < B) {
    BDLS_UNROLL
    for (int j = 0; j < 8; ++j) out[(size_t)i * 8 + j] = z.v[j];
  }
}

}  // namespace bdls

namespace {

// both entries: partial == nullptr launches verify_kernel, else
// verify_kernel_count with ceil(B / threads) partials
int launch_verify(int curve, const void* qx, const void* qy, const void* r,
                  const void* s, const void* e, const void* gtab, void* out,
                  const void* mask, void* partial, int B, int threads,
                  void* stream) {
  if (B <= 0) return 0;
  if (threads <= 0 || threads > 1024) return (int)cudaErrorInvalidValue;
#ifdef BDLS_MUL_MXU
  // K5's shared buffers hold BDLS_MXU_WARPS full warps a block
  if (threads % 32 != 0 || threads > 32 * BDLS_MXU_WARPS)
    return (int)cudaErrorInvalidValue;
#endif
  const dim3 grid((B + threads - 1) / threads);
  cudaStream_t st = (cudaStream_t)stream;
  const int32_t* a[5] = {(const int32_t*)qx, (const int32_t*)qy,
                         (const int32_t*)r, (const int32_t*)s,
                         (const int32_t*)e};
  const uint32_t* g = (const uint32_t*)gtab;
  uint8_t* o = (uint8_t*)out;
  const uint8_t* m = (const uint8_t*)mask;
  uint32_t* p = (uint32_t*)partial;
  if (curve == 0 && !p) {
    bdls::verify_kernel<bdls::CurveP256><<<grid, threads, 0, st>>>(
        a[0], a[1], a[2], a[3], a[4], g, o, B);
  } else if (curve == 1 && !p) {
    bdls::verify_kernel<bdls::CurveK256><<<grid, threads, 0, st>>>(
        a[0], a[1], a[2], a[3], a[4], g, o, B);
  } else if (curve == 0) {
    bdls::verify_kernel_count<bdls::CurveP256><<<grid, threads, 0, st>>>(
        a[0], a[1], a[2], a[3], a[4], g, o, m, p, B);
  } else if (curve == 1) {
    bdls::verify_kernel_count<bdls::CurveK256><<<grid, threads, 0, st>>>(
        a[0], a[1], a[2], a[3], a[4], g, o, m, p, B);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// curve: 0 = P-256, 1 = secp256k1. gtab: the curve's (256, 3, 8) G table
// in Montgomery form. out: B bytes, 1 = valid.
extern "C" int bdls_verify(int curve, const void* qx, const void* qy,
                           const void* r, const void* s, const void* e,
                           const void* gtab, void* out, int B, int threads,
                           void* stream) {
  return launch_verify(curve, qx, qy, r, s, e, gtab, out, nullptr, nullptr,
                       B, threads, stream);
}

// bdls_verify with K10's count (a mesh shard): mask B bytes, 1 = a real
// lane; partial receives ceil(B / threads) uint32, block j's count of
// lanes both valid and real (their sum is the shard's count).
extern "C" int bdls_verify_masked(int curve, const void* qx, const void* qy,
                                  const void* r, const void* s,
                                  const void* e, const void* gtab, void* out,
                                  const void* mask, void* partial, int B,
                                  int threads, void* stream) {
  if (mask == nullptr || partial == nullptr)
    return (int)cudaErrorInvalidValue;
  return launch_verify(curve, qx, qy, r, s, e, gtab, out, mask, partial, B,
                       threads, stream);
}

// mod: 0 = P-256 p, 1 = P-256 n, 2 = secp256k1 p, 3 = secp256k1 n,
// 4 = 2^255 - 19. a < 2^256 and b < m a lane; out = a·b·2^-256 mod m.
extern "C" int bdls_field_mul(int mod, const void* a, const void* b,
                              void* out, int B, void* stream) {
  if (B <= 0) return 0;
  const int threads = 64;
  const dim3 grid((B + threads - 1) / threads);
  cudaStream_t st = (cudaStream_t)stream;
  const uint32_t* x = (const uint32_t*)a;
  const uint32_t* y = (const uint32_t*)b;
  uint32_t* z = (uint32_t*)out;
  switch (mod) {
    case 0: bdls::field_mul_kernel<bdls::P256P><<<grid, threads, 0, st>>>(x, y, z, B); break;
    case 1: bdls::field_mul_kernel<bdls::P256N><<<grid, threads, 0, st>>>(x, y, z, B); break;
    case 2: bdls::field_mul_kernel<bdls::K256P><<<grid, threads, 0, st>>>(x, y, z, B); break;
    case 3: bdls::field_mul_kernel<bdls::K256N><<<grid, threads, 0, st>>>(x, y, z, B); break;
    case 4: bdls::field_mul_kernel<bdls::P25519><<<grid, threads, 0, st>>>(x, y, z, B); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// An asynchronous copy of `bytes` bytes on the caller's stream, in
// whichever direction the pointers say (cudaMemcpyDefault): the staging
// copies of the latency tier's captured graphs
// (bdls_tpu_torch/ops/ecdsa.py:LatencySlot), which hold this copy, a
// bdls_verify launch and the copy of the verdict back.
extern "C" int bdls_copy(void* dst, const void* src, size_t bytes,
                         void* stream) {
  return (int)cudaMemcpyAsync(dst, src, bytes, cudaMemcpyDefault,
                              (cudaStream_t)stream);
}
