// Batched SHA-256 for Hopper (sm_90a): the block lane's hash stage (K6).
//
// Replaces the TPU program bdls_tpu/ops/sha256.py:_jitted_sha256_cached
// -> sha256_words: FIPS 180-4 over (NB, 16, B) padded big-endian words
// with a per-lane active block count, (8, B) digest words out. The TPU
// ran it as uint32 vector ops over the batch axis, a lax.scan over the
// 64 round constants and an outer scan over blocks with a per-lane mask;
// here one thread carries one lane through its own blocks only
// (csrc/sha256.cuh), and stops when they are spent.
//
// What bounds it: 32-bit integer issue. A 64-byte block costs some
// 2,000 integer instructions (adds, three-input logic, funnel shifts)
// against 64 bytes read, far above the card's integer-ops-to-bytes
// ratio; the loads of a block's 16 words are coalesced across a warp.
// Lanes of a warp with different block counts idle while the longest
// finishes, as the reference's masked scan computes every block for
// every lane.
//
// Interface: plain C, bound with ctypes (bdls_tpu_torch/ops/_build.py).
// The launch goes on the caller's stream, does not synchronise, and
// returns cudaGetLastError().
#include <cuda_runtime.h>

#include "sha256.cuh"

namespace bdls {

__global__ void sha256_kernel(const uint32_t* __restrict__ words,
                              const int32_t* __restrict__ nblocks,
                              uint32_t* __restrict__ out, int NB, int B) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  uint32_t st[8];
  sha::lane_digest(st, words, nblocks[b], NB, b, B);
  BDLS_SHA_UNROLL
  for (int j = 0; j < 8; ++j) out[(size_t)j * B + b] = st[j];
}

}  // namespace bdls

// words: (NB, 16, B) uint32; nblocks: (B,) int32; out: (8, B) uint32,
// big-endian digest words, word 0 most significant.
extern "C" int bdls_sha256(const void* words, const void* nblocks, void* out,
                           int NB, int B, int threads, void* stream) {
  if (B <= 0) return 0;
  if (threads <= 0 || threads > 1024 || NB <= 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((B + threads - 1) / threads);
  bdls::sha256_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)words, (const int32_t*)nblocks, (uint32_t*)out, NB,
      B);
  return (int)cudaGetLastError();
}
