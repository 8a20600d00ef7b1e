// FIPS 180-4 SHA-256 over one lane's padded blocks, kept in a header so
// the host build of the same code (tests/test_torch_host_kernel.py,
// tests/test_torch_sha256_warp.py) checks it against hashlib.
//
// Input layout (ops/sha256.py:pad_messages): words[(blk·16 + w)·B + b],
// big-endian 32-bit words of lane b's blk-th 512-bit block; lane b folds
// its first nblocks[b] blocks, clipped to [0, NB] (0 leaves the IV). The
// digest comes out as eight big-endian words, word 0 most significant.
//
// Two bodies:
// - compress / lane_digest, one thread carrying a lane through its
//   blocks with the schedule inline: K7's hash (csrc/block.cuh);
// - the two roles of K6 (csrc/sha256.cu), a schedule warp feeding a
//   rounds warp through shared memory: schedule_block turns a block's
//   16 words into its 64 K[t] + W[t] words, rounds_block runs the 64
//   rounds from them. The rounds never see the schedule or a load.
//
// The 64 rounds are unrolled in full, so the 16-word schedule window is
// indexed by compile-time constants and stays in registers (a window
// indexed at run time would go to local memory).
#pragma once

#include <stddef.h>
#include <stdint.h>

#ifdef __CUDACC__
#define BDLS_SHA_HD __host__ __device__ __forceinline__
#define BDLS_SHA_UNROLL _Pragma("unroll")
#else
#define BDLS_SHA_HD inline
#define BDLS_SHA_UNROLL
#endif

// Rotate right by a constant: one funnel shift on the card, two shifts
// and an or on the host.
#ifdef __CUDA_ARCH__
#define BDLS_ROTR(x, n) __funnelshift_r((x), (x), (n))
#else
#define BDLS_ROTR(x, n) (((x) >> (n)) | ((x) << (32 - (n))))
#endif

namespace bdls {
namespace sha {

BDLS_SHA_HD uint32_t k(int t) {
  const uint32_t K[64] = {
      0x428a2f98u, 0x71374491u, 0xb5c0fbcfu, 0xe9b5dba5u, 0x3956c25bu,
      0x59f111f1u, 0x923f82a4u, 0xab1c5ed5u, 0xd807aa98u, 0x12835b01u,
      0x243185beu, 0x550c7dc3u, 0x72be5d74u, 0x80deb1feu, 0x9bdc06a7u,
      0xc19bf174u, 0xe49b69c1u, 0xefbe4786u, 0x0fc19dc6u, 0x240ca1ccu,
      0x2de92c6fu, 0x4a7484aau, 0x5cb0a9dcu, 0x76f988dau, 0x983e5152u,
      0xa831c66du, 0xb00327c8u, 0xbf597fc7u, 0xc6e00bf3u, 0xd5a79147u,
      0x06ca6351u, 0x14292967u, 0x27b70a85u, 0x2e1b2138u, 0x4d2c6dfcu,
      0x53380d13u, 0x650a7354u, 0x766a0abbu, 0x81c2c92eu, 0x92722c85u,
      0xa2bfe8a1u, 0xa81a664bu, 0xc24b8b70u, 0xc76c51a3u, 0xd192e819u,
      0xd6990624u, 0xf40e3585u, 0x106aa070u, 0x19a4c116u, 0x1e376c08u,
      0x2748774cu, 0x34b0bcb5u, 0x391c0cb3u, 0x4ed8aa4au, 0x5b9cca4fu,
      0x682e6ff3u, 0x748f82eeu, 0x78a5636fu, 0x84c87814u, 0x8cc70208u,
      0x90befffau, 0xa4506cebu, 0xbef9a3f7u, 0xc67178f2u};
  return K[t];
}

BDLS_SHA_HD void init(uint32_t st[8]) {
  st[0] = 0x6a09e667u; st[1] = 0xbb67ae85u;
  st[2] = 0x3c6ef372u; st[3] = 0xa54ff53au;
  st[4] = 0x510e527fu; st[5] = 0x9b05688cu;
  st[6] = 0x1f83d9abu; st[7] = 0x5be0cd19u;
}

// One FIPS 180-4 §6.2.2 compression of the 16 words w into st. W[t] for
// t >= 16 overwrites w[t mod 16] as the rounds go.
BDLS_SHA_HD void compress(uint32_t st[8], uint32_t w[16]) {
  uint32_t a = st[0], b = st[1], c = st[2], d = st[3];
  uint32_t e = st[4], f = st[5], g = st[6], h = st[7];
  BDLS_SHA_UNROLL
  for (int t = 0; t < 64; ++t) {
    uint32_t wt;
    if (t < 16) {
      wt = w[t];
    } else {
      const uint32_t w1 = w[(t + 1) & 15], w14 = w[(t + 14) & 15];
      const uint32_t s0 = BDLS_ROTR(w1, 7) ^ BDLS_ROTR(w1, 18) ^ (w1 >> 3);
      const uint32_t s1 =
          BDLS_ROTR(w14, 17) ^ BDLS_ROTR(w14, 19) ^ (w14 >> 10);
      wt = w[t & 15] + s0 + w[(t + 9) & 15] + s1;
      w[t & 15] = wt;
    }
    const uint32_t S1 = BDLS_ROTR(e, 6) ^ BDLS_ROTR(e, 11) ^ BDLS_ROTR(e, 25);
    const uint32_t ch = (e & f) ^ (~e & g);
    const uint32_t t1 = h + S1 + ch + k(t) + wt;
    const uint32_t S0 = BDLS_ROTR(a, 2) ^ BDLS_ROTR(a, 13) ^ BDLS_ROTR(a, 22);
    const uint32_t maj = (a & b) ^ (a & c) ^ (b & c);
    h = g; g = f; f = e; e = d + t1;
    d = c; c = b; b = a; a = t1 + S0 + maj;
  }
  st[0] += a; st[1] += b; st[2] += c; st[3] += d;
  st[4] += e; st[5] += f; st[6] += g; st[7] += h;
}

// Lane b's digest: fold its first min(nblocks, NB) blocks from the
// (NB, 16, B) words. The loads are coalesced across the lanes of a warp.
BDLS_SHA_HD void lane_digest(uint32_t st[8], const uint32_t* words,
                             int nblocks, int NB, int b, int B) {
  init(st);
  const int nb = nblocks < NB ? nblocks : NB;
  for (int blk = 0; blk < nb; ++blk) {
    uint32_t w[16];
    BDLS_SHA_UNROLL
    for (int i = 0; i < 16; ++i) w[i] = words[(size_t)(blk * 16 + i) * B + b];
    compress(st, w);
  }
}

// Lane b's block count clipped to [0, NB]; 0 for a lane past B.
BDLS_SHA_HD int lane_blocks(const int32_t* nblocks, int NB, int b, int B) {
  if (b >= B) return 0;
  const int n = nblocks[b];
  return n < 0 ? 0 : (n < NB ? n : NB);
}

// Lane b's 16 words of block blk (zeros for a lane past B). Across a
// warp's lanes each word is one coalesced 128-byte load.
BDLS_SHA_HD void load_block(uint32_t w[16], const uint32_t* words, int blk,
                            int b, int B) {
  BDLS_SHA_UNROLL
  for (int i = 0; i < 16; ++i)
    w[i] = b < B ? words[(size_t)(blk * 16 + i) * B + b] : 0u;
}

// The schedule warp's part for one lane and one block: W[0..15] are the
// block's words w (overwritten as the window rolls), W[16..63] expanded
// from them; kw[t·stride] = K[t] + W[t] for t = 0..63. In K6, kw is the
// lane's column of one half of the shared ring ([t][lane]: a warp's
// stores of one t fall in 32 consecutive banks).
BDLS_SHA_HD void schedule_block(uint32_t* kw, int stride, uint32_t w[16]) {
  BDLS_SHA_UNROLL
  for (int t = 0; t < 64; ++t) {
    uint32_t wt;
    if (t < 16) {
      wt = w[t];
    } else {
      const uint32_t w1 = w[(t + 1) & 15], w14 = w[(t + 14) & 15];
      const uint32_t s0 = BDLS_ROTR(w1, 7) ^ BDLS_ROTR(w1, 18) ^ (w1 >> 3);
      const uint32_t s1 =
          BDLS_ROTR(w14, 17) ^ BDLS_ROTR(w14, 19) ^ (w14 >> 10);
      wt = w[t & 15] + s0 + w[(t + 9) & 15] + s1;
      w[t & 15] = wt;
    }
    kw[t * stride] = k(t) + wt;
  }
}

// The rounds warp's part for one lane and one block: the 64 rounds of
// FIPS 180-4 §6.2.2 from the block's K[t] + W[t] words kw[t·stride], then
// the feed-forward into st if live (a lane whose blocks are spent runs
// the rounds with its warp and keeps its state).
BDLS_SHA_HD void rounds_block(uint32_t st[8], const uint32_t* kw, int stride,
                              bool live) {
  uint32_t a = st[0], b = st[1], c = st[2], d = st[3];
  uint32_t e = st[4], f = st[5], g = st[6], h = st[7];
  BDLS_SHA_UNROLL
  for (int t = 0; t < 64; ++t) {
    const uint32_t S1 = BDLS_ROTR(e, 6) ^ BDLS_ROTR(e, 11) ^ BDLS_ROTR(e, 25);
    const uint32_t ch = (e & f) ^ (~e & g);
    const uint32_t t1 = h + kw[t * stride] + ch + S1;
    const uint32_t S0 = BDLS_ROTR(a, 2) ^ BDLS_ROTR(a, 13) ^ BDLS_ROTR(a, 22);
    const uint32_t maj = (a & b) ^ (a & c) ^ (b & c);
    h = g; g = f; f = e; e = d + t1;
    d = c; c = b; b = a; a = t1 + S0 + maj;
  }
  if (live) {
    st[0] += a; st[1] += b; st[2] += c; st[3] += d;
    st[4] += e; st[5] += f; st[6] += g; st[7] += h;
  }
}

}  // namespace sha
}  // namespace bdls
