// The masked valid count of one shard for Hopper (sm_90a): K10's own
// kernel.
//
// Replaces the reduction of the TPU mesh programs in
// bdls_tpu/parallel/mesh.py: jnp.sum((ok & mask).astype(uint32)) inside
// sharded_verify_masked (:97) and sharded_verify_pinned (:134), psum'd
// across the batch axis over ICI, and the same global sum that GSPMD
// splits in pjit_verify_masked (:230) and pjit_verify_pinned (:261). On
// the TPU the sum ran as a vector reduction beside the verify and one
// collective; here each shard's count is this kernel, launched on the
// shard's own stream after its verify, and the shards' counts (a handful
// of scalars) are summed by the caller on the first shard's device.
//
// What bounds it: bytes, two bytes a lane in and four out, far below a
// microsecond at the buckets the mesh serves (2,048-8,192 lanes); in
// practice the launch itself. Each thread sums its lanes (grid-stride),
// a warp reduces with shuffles, the block's warps through shared memory,
// and one atomicAdd a block lands in the zeroed uint32 count.
//
// Interface: plain C, bound with ctypes (bdls_tpu_torch/ops/_build.py).
// ok and mask are n bytes (torch bool), count one uint32, zeroed here by
// an async memset before the kernel (no separate fill launch from the
// caller). Both go on the caller's stream, nothing synchronises, and the
// entry returns the first CUDA error.
#include <cuda_runtime.h>

#include "mesh.cuh"

namespace bdls {

constexpr int COUNT_THREADS = 256;
constexpr int COUNT_MAX_BLOCKS = 264;   // two a streaming multiprocessor

__global__ void masked_count_kernel(const uint8_t* __restrict__ ok,
                                    const uint8_t* __restrict__ mask,
                                    uint32_t* __restrict__ count, int n) {
  __shared__ uint32_t warp_sums[COUNT_THREADS / 32];
  uint32_t v = 0;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x)
    v += lane_valid(ok, mask, i);
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xFFFFFFFFu, v, off);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < (int)(blockDim.x >> 5) ? warp_sums[lane] : 0u;
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_down_sync(0xFFFFFFFFu, v, off);
    if (lane == 0 && v) atomicAdd(count, v);
  }
}

}  // namespace bdls

// count = sum over i < n of (ok[i] & mask[i])
extern "C" int bdls_masked_count(const void* ok, const void* mask,
                                 void* count, int n, void* stream) {
  cudaError_t rc = cudaMemsetAsync(count, 0, sizeof(uint32_t),
                                   (cudaStream_t)stream);
  if (rc != cudaSuccess || n <= 0) return (int)rc;
  int blocks = (n + bdls::COUNT_THREADS - 1) / bdls::COUNT_THREADS;
  if (blocks > bdls::COUNT_MAX_BLOCKS) blocks = bdls::COUNT_MAX_BLOCKS;
  bdls::masked_count_kernel<<<blocks, bdls::COUNT_THREADS, 0,
                              (cudaStream_t)stream>>>(
      (const uint8_t*)ok, (const uint8_t*)mask, (uint32_t*)count, n);
  return (int)cudaGetLastError();
}
