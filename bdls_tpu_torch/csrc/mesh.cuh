// The masked valid count of one shard of the batch split (csrc/mesh.cu,
// K10): sum over lanes of (ok & mask), the body of the reference's
// psum / GSPMD sum (bdls_tpu/parallel/mesh.py:97, :134, :230, :261).
//
// lane_valid is the per-lane term both the CUDA kernel and the host
// loop sum; masked_count_host is that sum a lane at a time, the form g++
// checks on the host (tests/test_torch_host_kernel.py). Without
// __CUDACC__ the __host__/__device__ qualifiers vanish.
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

}  // namespace bdls
