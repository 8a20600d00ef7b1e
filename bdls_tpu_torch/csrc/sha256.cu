// Batched SHA-256 for Hopper (sm_90a): the block lane's hash stage (K6).
//
// Replaces the TPU program bdls_tpu/ops/sha256.py:_jitted_sha256_cached
// -> sha256_words: FIPS 180-4 over (NB, 16, B) padded big-endian words
// with a per-lane active block count, (8, B) digest words out. The TPU
// ran it as uint32 vector ops over the batch axis, a lax.scan over the
// 64 round constants and an outer scan over blocks with a per-lane mask.
//
// What bounds it: the longest lane's chain of rounds. Each round depends
// on the last, and the main block's longest preimage folds 16 blocks:
// 1,024 rounds in one chain, against a few thousand integer operations a
// block spread over the card. A round is 12 instructions on the 32-bit
// integer pipe, which issues a warp instruction every 2 cycles on a
// sub-partition, so a lone warp takes some 24-30 cycles a round. The
// design keeps the rounds warp's stream down to the rounds themselves:
//
// - one CTA of 64 threads for every 32 lanes: warp 0 is the schedule
//   warp, warp 1 the rounds warp;
// - the schedule warp loads block j's 16 words (coalesced across its
//   lanes) one block ahead, expands W[16..63] and writes K[t] + W[t] for
//   t = 0..63 into one half of a double-buffered ring in shared memory,
//   laid out [t][lane] (2 × 64 × 32 × 4 bytes), while the rounds warp
//   runs block j - 1's 64 rounds from the other half, a + ... + h in
//   registers, one shared load a round (csrc/sha256.cuh: schedule_block,
//   rounds_block);
// - the handshake is one named barrier a block;
// - the loop runs to the CTA's longest clipped count; a lane whose blocks
//   are spent runs the rounds with its warp and keeps its state. Lanes
//   past B take part in every barrier and write nothing.
//
// Measured against one schedule warp for two rounds warps, mbarriers for
// the handshake and a one-thread kernel that only loads the next block
// ahead (PERF.md, §6, K6): this one was the fastest.
//
// Interface: plain C, bound with ctypes (bdls_tpu_torch/ops/_build.py).
// The launch goes on the caller's stream, does not synchronise, and
// returns cudaGetLastError(); threads must be the CTA's thread count, 64
// (ops/sha256.py:THREADS).
#include <cuda_runtime.h>

#include "sha256.cuh"

namespace bdls {

constexpr int kLanes = 32;    // lanes a CTA
constexpr int kThreads = 64;  // the schedule warp, then the rounds warp

// The handshake: named barrier 1 over the CTA's threads. The two roles
// reach it from different code, which bar.sync with a thread count
// allows (each warp reaches it whole).
__device__ __forceinline__ void cta_barrier() {
  asm volatile("bar.sync 1, %0;" ::"n"(kThreads) : "memory");
}

__global__ void __launch_bounds__(kThreads)
    sha256_kernel(const uint32_t* __restrict__ words,
                  const int32_t* __restrict__ nblocks,
                  uint32_t* __restrict__ out, int NB, int B) {
  // ring[half][t][lane]: K[t] + W[t] of one block for each of the lanes
  __shared__ uint32_t ring[2][64][kLanes];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x * kLanes + lane;
  // the CTA's longest lane: both warps reduce the same counts
  const int most =
      __reduce_max_sync(0xffffffffu, sha::lane_blocks(nblocks, NB, b, B));

  if (warp == 0) {
    // The schedule warp: block 0 before the rounds start, then block j
    // beside block j - 1's rounds. Block j + 1's words load while block
    // j's schedule is written, and are read only after the next barrier.
    uint32_t w[16], wn[16];
    if (most > 0) sha::load_block(wn, words, 0, b, B);
    for (int j = 0; j <= most; ++j) {
      if (j < most) {
        BDLS_SHA_UNROLL
        for (int k = 0; k < 16; ++k) w[k] = wn[k];
        if (j + 1 < most) sha::load_block(wn, words, j + 1, b, B);
        sha::schedule_block(&ring[j & 1][0][lane], kLanes, w);
      }
      cta_barrier();
    }
  } else {
    // the rounds warp (its lane's count read here: kept live across the
    // role split, it made the rounds loop some 3 % slower)
    const int nb = sha::lane_blocks(nblocks, NB, b, B);
    uint32_t st[8];
    sha::init(st);
    cta_barrier();
    for (int i = 0; i < most; ++i) {
      sha::rounds_block(st, &ring[i & 1][0][lane], kLanes, i < nb);
      cta_barrier();
    }
    if (b < B) {
      BDLS_SHA_UNROLL
      for (int j = 0; j < 8; ++j) out[(size_t)j * B + b] = st[j];
    }
  }
}

}  // namespace bdls

// words: (NB, 16, B) uint32; nblocks: (B,) int32; out: (8, B) uint32,
// big-endian digest words, word 0 most significant.
extern "C" int bdls_sha256(const void* words, const void* nblocks, void* out,
                           int NB, int B, int threads, void* stream) {
  if (B <= 0) return 0;
  if (threads != bdls::kThreads || NB <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((B + bdls::kLanes - 1) / bdls::kLanes);
  bdls::sha256_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)words, (const int32_t*)nblocks, (uint32_t*)out, NB,
      B);
  return (int)cudaGetLastError();
}
