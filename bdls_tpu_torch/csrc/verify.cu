// Batched ECDSA verify for Hopper (sm_90a), one kernel per curve.
//
// Replaces the TPU program bdls_tpu/ops/ecdsa.py:_jitted_verify_cached
// (kernel field "fold") -> bdls_tpu/ops/verify_fold.py:verify_fold: the
// (B,) verdict of u1·G + u2·Q, x(R) == r for five (16, B) arrays of
// 16-bit limbs. The TPU shaped that program for its vector unit
// (23 x 12-bit redundant limbs, lazy carries, one-hot table lookups);
// here 8 x 32-bit Montgomery limbs (csrc/field.cuh) and the complete RCB
// formulas (csrc/point.cuh) carry a lane from its inputs to its verdict.
//
// The vpu build runs a thread group a lane (csrc/verify_group.cuh):
// GROUP threads share the lane's state in shared memory and split each
// step's independent Montgomery products; u1·G is 32 additions of the
// positioned G byte tables beside u2·Q's doubling chain, and secp256k1
// takes the GLV split (132 doublings, not 264). A block is one warp,
// 32 / GROUP lanes: a 128-lane bucket is 32 blocks, one an SM (blocks
// of one lane measured no faster at 128 lanes and 2-5 times slower at
// 2048 and 8192). What bounds it: the latency of one step, a task's
// operand sums and its Montgomery product on one thread, then a
// __syncwarp, some 1.7-2 µs on the H100, times some 620 (secp256k1) or
// 1,000 (P-256) product steps; at 8192 lanes, four warps a scheduler,
// the issue of those instructions.
//
// The mxu build (-DBDLS_MUL_MXU) runs the same group body with every
// round's products through K5's warp-collective call (csrc/mxu.cuh):
// one warp a block, as the vpu build, with K5's static shared buffers
// beside the lanes' states.
//
// A mesh shard (K10) launches verify_kernel_count: the same lane body,
// then the block's masked valid count (mesh.cuh:count_epilogue), one
// vote a lane, so the shard's count needs no launch of its own. COUNT is
// a template parameter of the body.
//
// Interface: plain C, bound with ctypes (bdls_tpu_torch/ops/_build.py).
// The launch goes on the caller's stream, does not synchronise, and
// returns cudaGetLastError().
#include <cuda_runtime.h>

#include "mesh.cuh"
#include "verify_group.cuh"

namespace bdls {

// The lane body of both kernels, a group of grp::GROUP threads a lane,
// the lanes' states in dynamic shared memory: COUNT adds K10's epilogue
// (mesh.cuh), share 0 of a live lane voting. A group past B runs lane
// B - 1 as filler and stores nothing (in the mxu build it also makes
// every K5 call of the warp).
template <class C, bool COUNT>
__device__ __forceinline__ void verify_body(
    const int32_t* __restrict__ qx, const int32_t* __restrict__ qy,
    const int32_t* __restrict__ r, const int32_t* __restrict__ s,
    const int32_t* __restrict__ e, const uint32_t* __restrict__ g32,
    uint8_t* __restrict__ out, const uint8_t* __restrict__ mask,
    uint32_t* __restrict__ partial, int B) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int group = threadIdx.x / grp::GROUP;
  const int b = blockIdx.x * (blockDim.x / grp::GROUP) + group;
  const bool live = b < B;
  grp::lane_state& st = reinterpret_cast<grp::lane_state*>(smem)[group];
  const grp::gctx g{(int)(threadIdx.x % grp::GROUP), grp::warp_mask()};
  const bool ok = grp::verify_lane_group<C>(g, st, qx, qy, r, s, e, g32,
                                            live ? b : B - 1, B);
  const bool vote = grp::votes(g.share, live);
  if (vote) out[b] = ok ? 1 : 0;
  if constexpr (COUNT) count_epilogue(vote, out, mask, b, partial);
}

constexpr int LANE_THREADS = grp::GROUP;

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
// bit-for-bit check of the build's mont_mul (K5's against CIOS). A block
// is one warp; a thread past B multiplies lane 0's operands as filler (K5
// needs the whole warp) and stores nothing.
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
// verify_kernel_count with ceil(B / (threads / LANE_THREADS)) partials
int launch_verify(int curve, const void* qx, const void* qy, const void* r,
                  const void* s, const void* e, const void* gtab, void* out,
                  const void* mask, void* partial, int B, int threads,
                  void* stream) {
  if (B <= 0) return 0;
  if (threads <= 0 || threads > 1024 || threads % bdls::LANE_THREADS != 0)
    return (int)cudaErrorInvalidValue;
  if (!bdls::grp::block_fits(threads)) return (int)cudaErrorInvalidValue;
  const size_t smem =
      (size_t)(threads / bdls::LANE_THREADS) * sizeof(bdls::grp::lane_state);
  if (smem + bdls::grp::STATIC_SMEM > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  const int lanes = threads / bdls::LANE_THREADS;
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
    bdls::verify_kernel<bdls::CurveP256><<<grid, threads, smem, st>>>(
        a[0], a[1], a[2], a[3], a[4], g, o, B);
  } else if (curve == 1 && !p) {
    bdls::verify_kernel<bdls::CurveK256><<<grid, threads, smem, st>>>(
        a[0], a[1], a[2], a[3], a[4], g, o, B);
  } else if (curve == 0) {
    bdls::verify_kernel_count<bdls::CurveP256><<<grid, threads, smem, st>>>(
        a[0], a[1], a[2], a[3], a[4], g, o, m, p, B);
  } else if (curve == 1) {
    bdls::verify_kernel_count<bdls::CurveK256><<<grid, threads, smem, st>>>(
        a[0], a[1], a[2], a[3], a[4], g, o, m, p, B);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Threads a lane in this build: grp::GROUP in both engines. A block of
// `threads` threads carries threads / bdls_verify_lane_threads() lanes.
extern "C" int bdls_verify_lane_threads() { return bdls::LANE_THREADS; }

// curve: 0 = P-256, 1 = secp256k1. gtab: the curve's (32, 256, 3, 8)
// positioned G tables in Montgomery form. threads: a block's threads, a
// multiple of bdls_verify_lane_threads() (in the mxu build whole warps,
// at most BDLS_MXU_WARPS). out: B bytes, 1 = valid.
extern "C" int bdls_verify(int curve, const void* qx, const void* qy,
                           const void* r, const void* s, const void* e,
                           const void* gtab, void* out, int B, int threads,
                           void* stream) {
  return launch_verify(curve, qx, qy, r, s, e, gtab, out, nullptr, nullptr,
                       B, threads, stream);
}

// bdls_verify with K10's count (a mesh shard): mask B bytes, 1 = a real
// lane; partial receives one uint32 a block (ceil(B / lanes a block)),
// block j's count of lanes both valid and real (their sum is the
// shard's count).
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
  const int threads = 32;
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
