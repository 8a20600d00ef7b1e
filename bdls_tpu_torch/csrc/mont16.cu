// The gen-1 ECDSA verify (K4) for Hopper (sm_90a), one kernel per curve.
//
// Replaces the TPU program bdls_tpu/ops/ecdsa.py:verify_kernel with
// field="mont16" (jitted at ops/ecdsa.py:167 for a non-fold field): the
// reference's first kernel generation, 16-bit-limb CIOS Montgomery
// arithmetic (ops/mont.py) under the Jacobian windowed dual ladder
// (ops/jacobian.py), one batch inversion of s across the launch and the
// inversion-free final check. The TPU shaped it for its vector unit (16
// limbs a lane on sublanes, lax.scan over the windows, one-hot table
// lookups, an associative scan for the batch inverse); here one thread
// carries one lane, with 8 x 32-bit Montgomery limbs (csrc/field.cuh,
// the same R = 2^256) and the lane body of csrc/mont16.cuh.
//
// The inverse of s is a batch inverse over the lanes of a thread block:
// Montgomery's trick in shared memory (Hillis-Steele prefix and suffix
// products, one Fermat inverse a block by thread 0, two products a lane).
// The inverse is unique, so the verdicts cannot differ from those of the
// reference's launch-wide inversion. A lane with s = 0 or s = n
// (Montgomery s = 0) takes one in the products and gets zero back, as
// ops/mont.py:batch_inv does, so a hostile lane cannot poison its block.
// Every thread of the block takes part in the scan: a thread past B
// enters with s = 1 and stores nothing.
//
// What bounds it: 32-bit integer multiply issue, as K1 (some 6,000
// Montgomery products a lane, of 64 widening multiplies each; a lane
// reads 320 bytes and writes one). The per-lane [1..15]·Q table (1,440
// bytes) sits in local memory, the 1 KB G table behind __ldg.
//
// A mesh shard (K10) launches mont16_kernel_count: the same body, then,
// after the last verdict of the block is stored, its masked valid count
// (mesh.cuh:count_epilogue); COUNT is a template parameter of the body,
// so mont16_kernel compiles as it did.
//
// Interface: plain C, bound with ctypes (bdls_tpu_torch/ops/_build.py).
// The launch goes on the caller's stream, does not synchronise, and
// returns cudaGetLastError().
#include <cuda_runtime.h>

#include "mesh.cuh"
#include "mont16.cuh"

#define BDLS_M16_MAX_THREADS 64

namespace bdls {

// The lane body of both kernels: COUNT adds K10's epilogue (mesh.cuh)
// after the last store of every lane.
template <class C, bool COUNT>
__device__ __forceinline__ void mont16_body(
    const int32_t* __restrict__ qx, const int32_t* __restrict__ qy,
    const int32_t* __restrict__ r, const int32_t* __restrict__ s,
    const int32_t* __restrict__ e, const uint32_t* __restrict__ gtab,
    uint8_t* __restrict__ out, const uint8_t* __restrict__ mask,
    uint32_t* __restrict__ partial, int B) {
  typedef typename C::N FN;
  __shared__ fe pre[BDLS_M16_MAX_THREADS], suf[BDLS_M16_MAX_THREADS];
  __shared__ fe total;
  const int t = threadIdx.x, T = blockDim.x;
  const int b = blockIdx.x * blockDim.x + t;
  const bool live = b < B;

  fe vs, sm, one;
  load_one<FN>(one);
  if (live) {
    load_limbs16(vs, s, b, B);
  } else {
    BDLS_UNROLL
    for (int i = 0; i < 8; ++i) vs.v[i] = i == 0 ? 1u : 0u;
  }
  to_mont<FN>(sm, vs);
  const bool zero = is_zero(sm);
  m16::sel(sm, zero, one, sm);

  // inclusive prefix and suffix products over the block
  pre[t] = sm;
  suf[t] = sm;
  __syncthreads();
  for (int d = 1; d < T; d <<= 1) {
    fe p = pre[t], q = suf[t];
    if (t >= d) mont_mul<FN>(p, p, pre[t - d]);
    if (t + d < T) mont_mul<FN>(q, q, suf[t + d]);
    __syncthreads();
    pre[t] = p;
    suf[t] = q;
    __syncthreads();
  }
  if (t == 0) mont_inv<FN>(total, pre[T - 1]);
  __syncthreads();
  fe inv, x;
  x = t > 0 ? pre[t - 1] : one;
  inv = t + 1 < T ? suf[t + 1] : one;
  mont_mul<FN>(inv, x, inv);
  mont_mul<FN>(inv, inv, total);
  if (zero) {
    BDLS_UNROLL
    for (int i = 0; i < 8; ++i) inv.v[i] = 0;
  }
  // the count's barrier needs the whole block: a thread past B goes on
  // to it without a lane
  if (!COUNT && !live) return;

  if (live) {
    fe vqx, vqy, vr, ve;
    load_limbs16(vqx, qx, b, B);
    load_limbs16(vqy, qy, b, B);
    load_limbs16(vr, r, b, B);
    load_limbs16(ve, e, b, B);
    out[b] = m16::verify_lane_mont16<C>(vqx, vqy, vr, vs, ve, inv, gtab) ? 1
                                                                         : 0;
  }
  if constexpr (COUNT) count_epilogue(live, out, mask, b, partial);
}

template <class C>
__global__ void mont16_kernel(const int32_t* __restrict__ qx,
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
__global__ void mont16_kernel_count(const int32_t* __restrict__ qx,
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
// mont16_kernel_count with ceil(B / threads) partials
int launch_mont16(int curve, const void* qx, const void* qy, const void* r,
                  const void* s, const void* e, const void* gtab, void* out,
                  const void* mask, void* partial, int B, int threads,
                  void* stream) {
  if (B <= 0) return 0;
  if (threads <= 0 || threads > BDLS_M16_MAX_THREADS)
    return (int)cudaErrorInvalidValue;
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
    bdls::mont16_kernel<bdls::CurveP256><<<grid, threads, 0, st>>>(
        a[0], a[1], a[2], a[3], a[4], g, o, B);
  } else if (curve == 1 && !p) {
    bdls::mont16_kernel<bdls::CurveK256><<<grid, threads, 0, st>>>(
        a[0], a[1], a[2], a[3], a[4], g, o, B);
  } else if (curve == 0) {
    bdls::mont16_kernel_count<bdls::CurveP256><<<grid, threads, 0, st>>>(
        a[0], a[1], a[2], a[3], a[4], g, o, m, p, B);
  } else if (curve == 1) {
    bdls::mont16_kernel_count<bdls::CurveK256><<<grid, threads, 0, st>>>(
        a[0], a[1], a[2], a[3], a[4], g, o, m, p, B);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// curve: 0 = P-256, 1 = secp256k1. gtab: the curve's host [0..15]·G
// table, (16, 2, 8) words in Montgomery form. out: B bytes, 1 = valid.
// threads: at most 64 a block.
extern "C" int bdls_verify_mont16(int curve, const void* qx, const void* qy,
                                  const void* r, const void* s,
                                  const void* e, const void* gtab, void* out,
                                  int B, int threads, void* stream) {
  return launch_mont16(curve, qx, qy, r, s, e, gtab, out, nullptr, nullptr,
                       B, threads, stream);
}

// bdls_verify_mont16 with K10's count (a mesh shard): mask B bytes, 1 = a
// real lane; partial receives ceil(B / threads) uint32, block j's count
// of lanes both valid and real.
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
