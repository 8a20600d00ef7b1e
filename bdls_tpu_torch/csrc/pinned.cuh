// A table entry's eight words from device memory (the pinned pool, the
// G and B tables), shared by the group bodies (csrc/verify_group.cuh,
// csrc/pinned_group.cuh, csrc/edwards_group.cuh).
#pragma once

#include "glv.cuh"
#include "verify.cuh"

namespace bdls {

// Eight words of one table entry (32-byte aligned in device memory).
BDLS_HD void load_fe(fe& out, const uint32_t* p) {
#ifdef __CUDA_ARCH__
  const uint4 a = __ldg(reinterpret_cast<const uint4*>(p));
  const uint4 b = __ldg(reinterpret_cast<const uint4*>(p) + 1);
  out.v[0] = a.x; out.v[1] = a.y; out.v[2] = a.z; out.v[3] = a.w;
  out.v[4] = b.x; out.v[5] = b.y; out.v[6] = b.z; out.v[7] = b.w;
#else
  for (int l = 0; l < 8; ++l) out.v[l] = p[l];
#endif
}

}  // namespace bdls
