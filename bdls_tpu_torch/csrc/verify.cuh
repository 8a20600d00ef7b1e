// Lane loads of the verify kernels: a lane's 256-bit value from a (16, B)
// array of 16-bit limbs, a word of a value picked at run time. Included
// (through csrc/pinned.cuh) by the group bodies, K4's
// (csrc/mont16_group.cuh) among them.
#pragma once

#include "point.cuh"

#ifdef __CUDA_ARCH__
#define BDLS_LDG(p) __ldg(p)
#else
#define BDLS_LDG(p) (*(p))
#endif

namespace bdls {

// Limb k of a (16, B) array of 16-bit limbs held in int32, lane b.
BDLS_HD void load_limbs16(fe& out, const int32_t* a, int b, int B) {
  BDLS_UNROLL
  for (int k = 0; k < 8; ++k) {
    const uint32_t lo = (uint32_t)a[(size_t)(2 * k) * B + b] & 0xFFFFu;
    const uint32_t hi = (uint32_t)a[(size_t)(2 * k + 1) * B + b] & 0xFFFFu;
    out.v[k] = lo | (hi << 16);
  }
}

// Word j of a (j uniform across the warp, not a compile-time constant):
// a select chain keeps `a` in registers instead of local memory.
BDLS_HD uint32_t word_at(const fe& a, int j) {
  uint32_t w = 0;
  BDLS_UNROLL
  for (int k = 0; k < 8; ++k) w = (k == j) ? a.v[k] : w;
  return w;
}

}  // namespace bdls
