// The masked valid count of one shard of the batch split (K10): sum over
// lanes of (ok & mask), the body of the reference's psum / GSPMD sum
// (bdls_tpu/parallel/mesh.py:97, :134, :230, :261).
//
// The count has no launch of its own: the counting builds of the verify
// kernels a shard runs (verify.cu, pinned.cu, mont16.cu: the *_count
// kernels behind bdls_verify_masked, bdls_verify_pinned_masked and
// bdls_verify_mont16_masked) end in count_epilogue, which reduces
// lane_valid over the block once every thread has stored its verdict
// and writes one partial a block; the mesh sums the partials with the
// shards' join (bdls_tpu_torch/parallel/mesh.py). On the TPU the sum ran
// as a vector reduction beside the verify and one collective; here it
// costs one barrier a block in the shard's own launch.
//
// lane_valid is the per-lane term the epilogue sums; masked_count_host
// is that sum a lane at a time, the form g++ checks on the host
// (tests/test_torch_host_kernel.py). Without __CUDACC__ the
// __host__/__device__ qualifiers vanish and the epilogue is left out.
#pragma once

#include <stdint.h>

#ifdef __CUDACC__
#define BDLS_MESH_HD __host__ __device__ __forceinline__
#else
#define BDLS_MESH_HD inline
#endif

namespace bdls {

// 1 where the lane verified and is a real (unpadded) lane
BDLS_MESH_HD uint32_t lane_valid(const uint8_t* ok, const uint8_t* mask,
                                 int i) {
  return (ok[i] != 0 && mask[i] != 0) ? 1u : 0u;
}

inline uint32_t masked_count_host(const uint8_t* ok, const uint8_t* mask,
                                  int n) {
  uint32_t total = 0;
  for (int i = 0; i < n; ++i) total += lane_valid(ok, mask, i);
  return total;
}

#ifdef __CUDACC__
// The block's count of lane_valid over its live lanes, after each lane's
// verdict was stored to out[i] by the thread that votes for it (`live`:
// one thread a lane; in a thread group a lane only share 0, grp::votes):
// __syncthreads_count reduces the predicate across the block in one
// barrier (a warp vote, then the block's warps); thread 0 writes the
// block's partial. Every thread of the block must reach it.
__device__ __forceinline__ void count_epilogue(bool live, const uint8_t* out,
                                               const uint8_t* mask, int i,
                                               uint32_t* partial) {
  const int n = __syncthreads_count(live && lane_valid(out, mask, i));
  if (threadIdx.x == 0) partial[blockIdx.x] = (uint32_t)n;
}
#endif

}  // namespace bdls
