// Batched Ed25519 verify (RFC 8032, cofactorless) for Hopper (sm_90a): K8.
//
// Replaces the TPU program bdls_tpu/ops/ed25519.py:_jitted_verify_cached
// -> verify_ed25519: the (B,) verdict of [S]B + [k](-A) == R for six
// (16, B) arrays of 16-bit limbs (ax, ay, rx, ry, s, k). The TPU shaped
// that program for its vector unit (radix-12 fold limbs, one-hot table
// lookups, a lax.scan over the 33 ladder steps); here one thread carries
// one lane from its inputs to its verdict, with 8 x 32-bit Montgomery
// limbs mod 2^255 - 19 (csrc/field.cuh) and the extended-coordinate
// ladder of csrc/edwards.cuh.
//
// What bounds it: 32-bit integer multiply throughput. A lane reads 384
// bytes (six arrays of sixteen 16-bit limbs held in int32) and writes
// one byte, against some 3,000 Montgomery products of 64 widening 32x32
// multiplies each. The 786 KB B table is read with a data-dependent
// index through __ldg (32 entries of 96 bytes a lane); staging it in
// shared memory is a later redesign. The per-lane [0..8]·(-A) table
// (9 x 4 coordinates x 32 bytes = 1,152 bytes) sits in local memory.
//
// Interface: plain C, bound with ctypes (bdls_tpu_torch/ops/_build.py).
// The launch goes on the caller's stream, does not synchronise, and
// returns cudaGetLastError().
#include <cuda_runtime.h>

#include "edwards.cuh"

namespace bdls {

__global__ void ed25519_kernel(const int32_t* __restrict__ ax,
                               const int32_t* __restrict__ ay,
                               const int32_t* __restrict__ rx,
                               const int32_t* __restrict__ ry,
                               const int32_t* __restrict__ s,
                               const int32_t* __restrict__ k,
                               const uint32_t* __restrict__ btab,
                               uint8_t* __restrict__ out, int B) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  fe vax, vay, vrx, vry, vs, vk;
  load_limbs16(vax, ax, b, B);
  load_limbs16(vay, ay, b, B);
  load_limbs16(vrx, rx, b, B);
  load_limbs16(vry, ry, b, B);
  load_limbs16(vs, s, b, B);
  load_limbs16(vk, k, b, B);
  out[b] = verify_lane_ed25519(vax, vay, vrx, vry, vs, vk, btab) ? 1 : 0;
}

}  // namespace bdls

// btab: the (32, 256, 3, 8) positioned B tables in Montgomery form.
// out: B bytes, 1 = valid.
extern "C" int bdls_verify_ed25519(const void* ax, const void* ay,
                                   const void* rx, const void* ry,
                                   const void* s, const void* k,
                                   const void* btab, void* out, int B,
                                   int threads, void* stream) {
  if (B <= 0) return 0;
  if (threads <= 0 || threads > 1024) return (int)cudaErrorInvalidValue;
  const dim3 grid((B + threads - 1) / threads);
  bdls::ed25519_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)ax, (const int32_t*)ay, (const int32_t*)rx,
      (const int32_t*)ry, (const int32_t*)s, (const int32_t*)k,
      (const uint32_t*)btab, (uint8_t*)out, B);
  return (int)cudaGetLastError();
}
