// K5: the 256-bit Montgomery product with its limb product on the tensor
// cores. Included by csrc/field.cuh, after mont_mul_cios; with
// -DBDLS_MUL_MXU every kernel's mont_mul is mxu::mont_mul, so K1, K2, K7
// and K8 (csrc/verify.cu, pinned.cu, block.cu, ed25519.cu) get K5 from
// their own sources.
//
// Replaces the TPU's gen-3 limb engine bdls_tpu/ops/mxu.py:mul_cols (6-bit
// digits, a per-lane outer product, one constant 0/1 anti-diagonal
// contraction (91 x 2116)·(2116 x B) on the matrix unit, recombination),
// which fold.mul_backend binds under every fold program
// (bdls_tpu/ops/fold.py:375-400). The Hopper form keeps the idea, an exact
// integer matrix product of small digits, with a tile layout for mma.sync:
//
// - digits: the 32 bytes of a and of b (8-bit digits, u8 operands);
// - columns: c_k = sum_{i+j=k} a_i·b_j, k = 0..62, each at most
//   32·255·255 < 2^21, exact in the s32 accumulator;
// - tile: D[m][n] = sum_{k<64} A[m][k]·B[k][n] (m < 16, n < 8) with the
//   Toeplitz windows A[m][k] = a_{m+48-k} and B[k][n] = b_{k+16n-48} for
//   n < 4 (0 outside [0, 32), and B = 0 for n >= 4), so D[m][n] =
//   c_{m+16n}: one lane's 63 columns are two mma.sync.m16n8k32 u8 x u8 ->
//   s32 (K = 64 in two steps), half the N columns idle;
// - a warp is 32 lanes a thread: each thread stages its a and b in shared
//   memory, zero-padded so every fragment is a 4-byte window (no bounds
//   test), then the warp walks the 32 lanes, two mma a lane, and each
//   thread stores its accumulator fragment to the lane's 64 columns;
// - each thread then recombines its own columns into the 512-bit product
//   and reduces it (Montgomery SOS, R = 2^256) to the fully reduced value
//   that mont_mul_cios returns, bit for bit (the value a·b·R^-1 mod m is
//   unique in [0, m)).
//
// mma.sync is warp-collective: every thread of the warp must reach every
// product converged. The lane bodies that call mont_mul are branch-free
// with loop counts the same in every lane, and in the mxu builds a tail
// thread past B runs lane 0 as filler and stores nothing. Inside the
// product only the column stores depend on the thread (half the
// accumulator fragments are idle columns), so a __syncwarp precedes each
// lane's two mma. A block has at most BDLS_MXU_WARPS warps (its shared
// buffers are sized so).
//
// What bounds it: shared-memory traffic and fragment assembly, not the
// tensor cores (two mma a lane against some 40 loads, shifts and stores
// a thread a lane). It is the simple, right form first; a later redesign
// would batch many products a tile.
//
// Without __CUDA_ARCH__ (g++ on the host, tests/test_torch_host_k4k5.py)
// the same staging, fragment assembly and column stores run for the 32
// virtual threads of a warp, and mma_emulate forms D from the fragments by
// the PTX layout of m16n8k32 (.row.col, u8): everything but the mma
// instruction itself is checked off the card.
#pragma once

namespace bdls {
namespace mxu {

#ifndef BDLS_MXU_WARPS
#define BDLS_MXU_WARPS 2
#endif

// the exactness budget: a column is a sum of at most 32 byte products
static_assert(32ull * 255 * 255 < (1ull << 31),
              "a column of 32 u8 x u8 products must fit the s32 accumulator");
// recombination: four columns a word, shifted by up to 24 bits, plus the
// carry, inside the 64-bit accumulator
static_assert((4ull * 32 * 255 * 255 << 24) < (1ull << 62),
              "the recombination of the columns must fit 64 bits");

// the staged operands of one lane, in 32-bit words: a at bytes
// A_OFF..A_OFF+31 of a zero region of A_WORDS words, b at bytes
// B_OFF..B_OFF+31 of a zero region of B_WORDS words
constexpr int A_OFF = 16, A_WORDS = 24;
constexpr int B_OFF = 48, B_WORDS = 32;
constexpr int OPW = A_WORDS + B_WORDS;
constexpr int NCOL = 64;

// the m16n8k32 fragment layout (PTX ISA, mma.m16n8k32 with .u8 inputs),
// for thread g = laneid >> 2, q = laneid & 3:
// A register r (4 bytes, element e): row g + 8(r & 1), column
//   4q + 16(r >> 1) + e;
// B register r (element e): row 4q + 16r + e, column g;
// D register i: row g + 8(i >> 1), column 2q + (i & 1).
BDLS_HD int a_row(int r, int g) { return g + 8 * (r & 1); }
BDLS_HD int a_col(int r, int q) { return 4 * q + 16 * (r >> 1); }
BDLS_HD int b_row(int r, int q) { return 4 * q + 16 * r; }
BDLS_HD int d_row(int i, int g) { return g + 8 * (i >> 1); }
BDLS_HD int d_col(int i, int q) { return 2 * q + (i & 1); }

// bytes base..base+3 of a word array, little-endian
BDLS_HD uint32_t window4(const uint32_t* w, int base) {
  const uint64_t pair = (uint64_t)w[base >> 2] |
                        ((uint64_t)w[(base >> 2) + 1] << 32);
  return (uint32_t)(pair >> (8 * (base & 3)));
}

BDLS_HD uint32_t rev4(uint32_t w) {
  return (w >> 24) | ((w >> 8) & 0xFF00u) | ((w << 8) & 0xFF0000u) |
         (w << 24);
}

// one lane's operands into its zero-padded staging words
BDLS_HD void stage_operands(uint32_t* ops, const fe& a, const fe& b) {
  BDLS_UNROLL
  for (int i = 0; i < OPW; ++i) ops[i] = 0;
  BDLS_UNROLL
  for (int i = 0; i < 8; ++i) {
    ops[A_OFF / 4 + i] = a.v[i];
    ops[A_WORDS + B_OFF / 4 + i] = b.v[i];
  }
}

// thread (g, q)'s A and B fragments of k-step s (k = 32s .. 32s + 31)
BDLS_HD void load_fragments(uint32_t fa[4], uint32_t fb[2],
                            const uint32_t* ops, int g, int q, int s) {
  BDLS_UNROLL
  for (int r = 0; r < 4; ++r) {
    // elements e = 0..3 are a_{t-e}, t = row + 48 - k0: the window at
    // t - 3, reversed
    const int t = a_row(r, g) + 48 - (32 * s + a_col(r, q));
    fa[r] = rev4(window4(ops, A_OFF + t - 3));
  }
  BDLS_UNROLL
  for (int r = 0; r < 2; ++r) {
    // elements e = 0..3 are b_{k0+e+16g-48}; columns 4..7 are zero
    const int u = 32 * s + b_row(r, q) + 16 * g - 48;
    const uint32_t w = window4(ops + A_WORDS, B_OFF + (g < 4 ? u : 0));
    fb[r] = g < 4 ? w : 0u;
  }
}

// thread (g, q)'s accumulator fragment -> the lane's columns c_{m+16n}
BDLS_HD void store_cols(uint32_t* cols, const uint32_t d[4], int g, int q) {
  BDLS_UNROLL
  for (int i = 0; i < 4; ++i) {
    const int n = d_col(i, q);
    if (n < 4) cols[d_row(i, g) + 16 * n] = d[i];
  }
}

// columns (64 words, c_63 = 0) -> the 512-bit product -> a·b·R^-1 mod m,
// fully reduced (Montgomery SOS: eight rounds of q = t_i·n0, t += q·m·2^32i)
template <class M>
BDLS_HD void sos_reduce(fe& out, const uint32_t* cols) {
  uint32_t t[16];
  uint64_t acc = 0;
  BDLS_UNROLL
  for (int w = 0; w < 16; ++w) {
    acc += (uint64_t)cols[4 * w] + ((uint64_t)cols[4 * w + 1] << 8) +
           ((uint64_t)cols[4 * w + 2] << 16) +
           ((uint64_t)cols[4 * w + 3] << 24);
    t[w] = (uint32_t)acc;
    acc >>= 32;
  }
  uint32_t hi = 0;
  BDLS_UNROLL
  for (int i = 0; i < 8; ++i) {
    const uint32_t q = t[i] * M::N0;
    uint64_t c = 0;
    BDLS_UNROLL
    for (int j = 0; j < 8; ++j) {
      c += (uint64_t)q * M::m(j) + t[i + j];
      t[i + j] = (uint32_t)c;
      c >>= 32;
    }
    BDLS_UNROLL
    for (int j = i + 8; j < 16; ++j) {
      c += t[j];
      t[j] = (uint32_t)c;
      c >>= 32;
    }
    hi += (uint32_t)c;
  }
  // (a·b + Q·m) / 2^256 < 2m: one conditional subtraction
  reduce_once<M>(out, t + 8, hi);
}

#ifdef __CUDA_ARCH__

__device__ __forceinline__ uint32_t* ops_buf() {
  __shared__ uint32_t s[BDLS_MXU_WARPS * 32 * OPW];
  return s;
}

__device__ __forceinline__ uint32_t* col_buf() {
  __shared__ uint32_t s[BDLS_MXU_WARPS * 32 * NCOL];
  return s;
}

__device__ __forceinline__ void mma_u8(uint32_t d[4], const uint32_t fa[4],
                                       const uint32_t fb[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(fa[0]), "r"(fa[1]), "r"(fa[2]), "r"(fa[3]), "r"(fb[0]),
        "r"(fb[1]));
}

// One product for each thread of the warp. Operands and result go by
// value: with references, a caller whose output aliased an input (the
// Ed25519 kernel's) read wrong values after the call, on the card only.
template <class M>
__device__ __noinline__ fe mont_mul_mma(const fe a, const fe b) {
  fe out;
  const int lane = threadIdx.x & 31;
  uint32_t* ops = ops_buf() + (threadIdx.x >> 5) * 32 * OPW;
  uint32_t* cols = col_buf() + (threadIdx.x >> 5) * 32 * NCOL;
  const int g = lane >> 2, q = lane & 3;
  __syncwarp();        // the warp's last product has read its buffers
  stage_operands(ops + lane * OPW, a, b);
  __syncwarp();
#pragma unroll 1
  for (int L = 0; L < 32; ++L) {
    uint32_t d[4] = {0u, 0u, 0u, 0u};
    __syncwarp();      // converged for the two mma
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      uint32_t fa[4], fb[2];
      load_fragments(fa, fb, ops + L * OPW, g, q, s);
      mma_u8(d, fa, fb);
    }
    store_cols(cols + L * NCOL, d, g, q);
  }
  __syncwarp();
  sos_reduce<M>(out, cols + lane * NCOL);
  return out;
}

#else

// D += A·B for one warp's fragments, by the layout above
BDLS_HD void mma_emulate(uint32_t d[32][4], const uint32_t fa[32][4],
                         const uint32_t fb[32][2]) {
  uint32_t A[16][32], B[32][8];
  for (int t = 0; t < 32; ++t) {
    const int g = t >> 2, q = t & 3;
    for (int r = 0; r < 4; ++r)
      for (int e = 0; e < 4; ++e)
        A[a_row(r, g)][a_col(r, q) + e] = (fa[t][r] >> (8 * e)) & 0xFFu;
    for (int r = 0; r < 2; ++r)
      for (int e = 0; e < 4; ++e)
        B[b_row(r, q) + e][g] = (fb[t][r] >> (8 * e)) & 0xFFu;
  }
  for (int t = 0; t < 32; ++t) {
    const int g = t >> 2, q = t & 3;
    for (int i = 0; i < 4; ++i) {
      uint32_t acc = d[t][i];
      for (int k = 0; k < 32; ++k)
        acc += A[d_row(i, g)][k] * B[k][d_col(i, q)];
      d[t][i] = acc;
    }
  }
}

#endif

// K5's Montgomery product: the same value as mont_mul_cios<M>, with the
// same contract (a < 2^256, b < m).
template <class M>
BDLS_HD void mont_mul(fe& out, const fe& a, const fe& b) {
#ifdef __CUDA_ARCH__
  out = mont_mul_mma<M>(a, b);
#else
  uint32_t ops[OPW], cols[NCOL] = {0};
  uint32_t d[32][4] = {};
  stage_operands(ops, a, b);
  for (int s = 0; s < 2; ++s) {
    uint32_t fa[32][4], fb[32][2];
    for (int t = 0; t < 32; ++t)
      load_fragments(fa[t], fb[t], ops, t >> 2, t & 3, s);
    mma_emulate(d, fa, fb);
  }
  for (int t = 0; t < 32; ++t) store_cols(cols, d[t], t >> 2, t & 3);
  sos_reduce<M>(out, cols);
#endif
}

}  // namespace mxu
}  // namespace bdls
