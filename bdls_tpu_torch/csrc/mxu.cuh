// K5: the 256-bit products of a warp with their digit products on the
// tensor cores. Included by csrc/field.cuh, after mont_mul_cios. The mxu
// builds (-DBDLS_MUL_MXU: csrc/verify.cu, pinned.cu, block.cu,
// ed25519.cu) run their kernels' thread-group bodies over it: every
// product of a step's round goes through one warp-collective call
// (grp::mxu_prod in csrc/verify_group.cuh, grp::ed_field_mxu in
// csrc/edwards_group.cuh).
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
//   c_{m+16n}: one product's 63 columns are two mma.sync.m16n8k32 u8 x u8
//   -> s32 (K = 64 in two steps). A Toeplitz tile is one product's, so
//   two mma a product is the least this shape allows.
//
// One call carries the 32 products of the warp, thread X's a·b as product
// X (warp_columns):
// 1. each thread stages its operands in its region of the warp's shared
//    buffer: a's bytes reversed, in four copies shifted by 0-3 bytes, then
//    b, then a zero word (stage);
// 2. after one __syncwarp the warp runs the products in batches of BATCH,
//    a batch with no bit set in `active` (a ballot, the same in every
//    thread: a thread with no task this round is filler) left out: each
//    thread reads its 8 A and 4 B fragment words of each product of the
//    batch as aligned words at offsets fixed for the call (slots_of: the
//    copy matching its byte alignment, or the zero word outside the
//    operand), the batch's mma run back to back, and after a __syncwarp
//    the threads holding columns 0-3 store them over the batch's operand
//    regions (store_cols), which every thread has read;
// 3. after a last __syncwarp each thread reads its own product's 64
//    columns (16 vector loads; the regions are staggered by 4 banks) as
//    sixteen 64-bit words with no carry between them (columns_to_words).
// The caller reduces in carry-save form: Montgomery SOS mod m (R = 2^256,
// sos_reduce) to the value mont_mul_cios returns, bit for bit (a·b·R^-1
// mod m is unique in [0, m)), or Ed25519's fold through 2^256 = 38
// (edwards_group.cuh:fold_25519). The digit products are the tensor
// cores' (the mma); the staging, the carries and the reduction run on
// each thread's CUDA cores. 8,704 bytes of shared memory a warp.
//
// mma.sync is warp-collective: every thread of the warp must make every
// call converged, with the same `active`. The group bodies call it from
// grp::run_tasks, whose rounds are the same in every group of a warp
// (control flow there depends on public loop counters only); a block is
// BDLS_MXU_WARPS warps at most (the static buffers are sized so).
//
// Without __CUDA_ARCH__ (g++ on the host: tests/test_torch_host_k4k5.py)
// warp_columns_host runs the same staging, slots, fragment loads, column
// stores and carries for the 32 virtual threads of a warp, and
// mma_emulate forms D from the fragments by the PTX layout of m16n8k32
// (.row.col, u8): everything but the mma instruction itself is checked
// off the card.
#pragma once

namespace bdls {
namespace mxu {

#ifndef BDLS_MXU_WARPS
#define BDLS_MXU_WARPS 1
#endif

// the exactness budget: a column is a sum of at most 32 byte products
static_assert(32ull * 255 * 255 < (1ull << 31),
              "a column of 32 u8 x u8 products must fit the s32 accumulator");
// the words: four columns, shifted by up to 24 bits, below 2^46, so the
// reductions' carry-save sums (a word and 16 parts of 32 bits) fit 64 bits
static_assert(32ull * 255 * 255 * (1 + (1ull << 8) + (1ull << 16) +
                                   (1ull << 24)) < (1ull << 46),
              "the words of the columns must stay below 2^46");

// Product X's region of the warp's buffer, in 32-bit words: first thread
// X's operands (stage): copy al (al = 0..3) of a's reversed bytes at
// 9·al .. 9·al + 8 (word j + 1 holds reversed bytes 4j + al .. 4j + al + 3,
// j = -1..7), b at B_OFF, a zero word at ZERO; once every thread has read
// them, the product's 64 columns, c_{m+16n} at word 4m + n. Regions are
// 68 words apart (4 banks), so the 16-byte stores and loads of eight
// threads in a region each fall in distinct banks.
constexpr int B_OFF = 36, ZERO = 44, NCOL = 64, STRIDE = 68;
// one warp's buffer
constexpr int WARP_WORDS = 32 * STRIDE;
// the products whose fragment loads, mma and column stores go together
// (on the H100, 4 ran K1, K2 and K8 faster than 2 or 8, and faster than
// loading a batch while the one before ran its mma, which took the
// kernels to 219 registers)
constexpr int BATCH = 4;

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

// bytes of w reversed
BDLS_HD uint32_t rev4(uint32_t w) {
#ifdef __CUDA_ARCH__
  return __byte_perm(w, 0u, 0x0123u);
#else
  return (w >> 24) | ((w >> 8) & 0xFF00u) | ((w << 8) & 0xFF0000u) |
         (w << 24);
#endif
}

// (hi:lo) >> sh, 0 <= sh < 32
BDLS_HD uint32_t funnel(uint32_t lo, uint32_t hi, int sh) {
#ifdef __CUDA_ARCH__
  return __funnelshift_r(lo, hi, sh);
#else
  return (uint32_t)((((uint64_t)hi << 32) | lo) >> sh);
#endif
}

// Thread X's operand region: a's bytes reversed (byte i = a_{31-i}), in
// four copies shifted by 0-3 bytes, so every A window a thread reads is
// an aligned word of one copy; b; zeros.
BDLS_HD void stage(uint32_t* reg, const fe& a, const fe& b) {
  uint32_t ar[10];
  ar[0] = 0u;
  ar[9] = 0u;
  BDLS_UNROLL
  for (int i = 0; i < 8; ++i) ar[1 + i] = rev4(a.v[7 - i]);
  uint32_t w[ZERO + 4];
  BDLS_UNROLL
  for (int al = 0; al < 4; ++al) {
    BDLS_UNROLL
    for (int j = 0; j < 9; ++j)
      w[9 * al + j] = funnel(ar[j], ar[j + 1], 8 * al);
  }
  BDLS_UNROLL
  for (int i = 0; i < 8; ++i) w[B_OFF + i] = b.v[i];
  BDLS_UNROLL
  for (int i = ZERO; i < ZERO + 4; ++i) w[i] = 0u;
#ifdef __CUDA_ARCH__
  BDLS_UNROLL
  for (int i = 0; i < ZERO + 4; i += 4)
    *reinterpret_cast<uint4*>(reg + i) =
        make_uint4(w[i], w[i + 1], w[i + 2], w[i + 3]);
#else
  for (int i = 0; i < ZERO + 4; ++i) reg[i] = w[i];
#endif
}

// The words of an operand region thread `lane` reads for k-step s: A
// register r at a[s][r], B register r at b[s][r].
struct frag_slots {
  int a[2][4];
  int b[2][2];
};

BDLS_HD frag_slots slots_of(int lane) {
  frag_slots sl;
  const int g = lane >> 2, q = lane & 3;
  // A element e of register r is a_{t-e}, t = row + 48 - (32s + column):
  // reversed byte u + e, u = 31 - t, whose alignment is (3 - g) mod 4
  const int al = 3 - (g & 3);
  BDLS_UNROLL
  for (int s = 0; s < 2; ++s) {
    BDLS_UNROLL
    for (int r = 0; r < 4; ++r) {
      const int t = a_row(r, g) + 48 - (32 * s + a_col(r, q));
      const int j = (31 - t - al) >> 2;   // an exact multiple of 4
      sl.a[s][r] = (j >= -1 && j <= 7) ? 9 * al + j + 1 : ZERO;
    }
    BDLS_UNROLL
    for (int r = 0; r < 2; ++r) {
      // elements e = 0..3 are b_{k0+e+16g-48}, k0 = 32s + 4q + 16r: an
      // aligned word; columns 4..7 are zero
      const int vw = (32 * s + b_row(r, q) + 16 * g - 48) >> 2;
      sl.b[s][r] = (g < 4 && vw >= 0 && vw <= 7) ? B_OFF + vw : ZERO;
    }
  }
  return sl;
}

// thread `lane`'s fragments of k-step s of the product whose operand
// region is reg
BDLS_HD void load_frags(uint32_t fa[4], uint32_t fb[2], const uint32_t* reg,
                        const frag_slots& sl, int s) {
  BDLS_UNROLL
  for (int r = 0; r < 4; ++r) fa[r] = reg[sl.a[s][r]];
  BDLS_UNROLL
  for (int r = 0; r < 2; ++r) fb[r] = reg[sl.b[s][r]];
}

// thread `lane`'s accumulator fragment -> the product's columns
// c_{m+16n} at 4m + n (n < 4: the threads with q < 2)
BDLS_HD void store_cols(uint32_t* cols, const uint32_t d[4], int lane) {
  const int g = lane >> 2, q = lane & 3;
  if (q >= 2) return;
#ifdef __CUDA_ARCH__
  *reinterpret_cast<uint2*>(cols + 4 * g + 2 * q) = make_uint2(d[0], d[1]);
  *reinterpret_cast<uint2*>(cols + 4 * (g + 8) + 2 * q) =
      make_uint2(d[2], d[3]);
#else
  BDLS_UNROLL
  for (int i = 0; i < 4; ++i) cols[4 * d_row(i, g) + d_col(i, q)] = d[i];
#endif
}

// a product's 64 columns (c_63 = 0) -> its 512 bits as sixteen 64-bit
// words T[w] = c_4w + c_4w+1·2^8 + c_4w+2·2^16 + c_4w+3·2^24 (weight
// 2^32w, each < 2^46), with no carry between them: the reductions run
// their carries in carry-save form
BDLS_HD void columns_to_words(uint64_t T[16], const uint32_t* cols) {
  uint32_t c[NCOL];
#ifdef __CUDA_ARCH__
  BDLS_UNROLL
  for (int i = 0; i < NCOL; i += 4) {
    const uint4 v = *reinterpret_cast<const uint4*>(cols + i);
    c[i] = v.x;
    c[i + 1] = v.y;
    c[i + 2] = v.z;
    c[i + 3] = v.w;
  }
#else
  for (int i = 0; i < NCOL; ++i) c[i] = cols[i];
#endif
  BDLS_UNROLL
  for (int w = 0; w < 16; ++w) {
    // columns 4w .. 4w + 3 sit at 4m + n, m = 4(w & 3) + i, n = w >> 2
    const int base = 16 * (w & 3) + (w >> 2);
    T[w] = (uint64_t)c[base] + ((uint64_t)c[base + 4] << 8) +
           ((uint64_t)c[base + 8] << 16) + ((uint64_t)c[base + 12] << 24);
  }
}

// The 512-bit t = sum T[w]·2^32w (< m·2^256) -> t·R^-1 mod m, fully
// reduced: Montgomery SOS in carry-save form (as verify_group.cuh's
// mont_mul_cs), eight rounds of q = T[i]·n0 (T[i] exact mod 2^32 once the
// carry from T[i-1] is in), T += q·m·2^32i, T[i+1] += T[i] >> 32; the
// products of a round do not wait on each other's carries. A word takes
// at most 16 parts of 32 bits and its carry-ins: < 2^47.
template <class M>
BDLS_HD void sos_reduce(fe& out, uint64_t T[16]) {
  BDLS_UNROLL
  for (int i = 0; i < 8; ++i) {
    const uint32_t q = (uint32_t)T[i] * M::N0;
    BDLS_UNROLL
    for (int j = 0; j < 8; ++j) {
      const uint64_t p = (uint64_t)q * M::m(j);
      T[i + j] += (uint32_t)p;
      T[i + j + 1] += p >> 32;
    }
    // T[i] mod 2^32 is 0 now: carry the rest up
    T[i + 1] += T[i] >> 32;
  }
  uint32_t t[8];
  uint64_t c = 0;
  BDLS_UNROLL
  for (int j = 0; j < 8; ++j) {
    c += T[8 + j];
    t[j] = (uint32_t)c;
    c >>= 32;
  }
  // (a·b + Q·m) / 2^256 < 2m: one conditional subtraction
  reduce_once<M>(out, t, (uint32_t)c);
}

#ifdef __CUDA_ARCH__

__device__ __forceinline__ uint32_t* warp_buf() {
  __shared__ __align__(16) uint32_t s[BDLS_MXU_WARPS * WARP_WORDS];
  return s + (threadIdx.x >> 5) * WARP_WORDS;
}

__device__ __forceinline__ void mma_u8(uint32_t d[4], const uint32_t fa[4],
                                       const uint32_t fb[2]) {
  asm(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(fa[0]), "r"(fa[1]), "r"(fa[2]), "r"(fa[3]), "r"(fb[0]),
        "r"(fb[1]));
}

// The 512-bit a·b of this thread (columns_to_words), every thread of the
// warp calling with its own operands and one `active` (the warp's ballot
// of the threads whose product is kept). The products go in batches of
// BATCH, a batch with no active product left out: every thread loads the
// batch's fragments, the 2·BATCH mma run back to back, and after a
// __syncwarp (every thread has read the batch's operands) the columns
// overwrite the batch's operand regions.
// one batch's fragments
struct batch_frags {
  uint32_t fa[BATCH][2][4], fb[BATCH][2][2];
};

__device__ __forceinline__ void load_batch(batch_frags& f,
                                           const uint32_t* buf,
                                           const frag_slots& sl, int X0) {
#pragma unroll
  for (int k = 0; k < BATCH; ++k) {
#pragma unroll
    for (int s = 0; s < 2; ++s)
      load_frags(f.fa[k][s], f.fb[k][s], buf + (X0 + k) * STRIDE, sl, s);
  }
}

__device__ __forceinline__ void warp_columns(uint64_t T[16], const fe& a,
                                             const fe& b, unsigned active) {
  const int lane = threadIdx.x & 31;
  uint32_t* buf = warp_buf();
  // the warp's last call read its columns after its last __syncwarp
  stage(buf + lane * STRIDE, a, b);
  const frag_slots sl = slots_of(lane);
  const unsigned bmask = (1u << BATCH) - 1u;
  __syncwarp();
#pragma unroll
  for (int X0 = 0; X0 < 32; X0 += BATCH) {
    // the same in every thread
    if (!((active >> X0) & bmask)) continue;
    batch_frags f;
    uint32_t d[BATCH][4];
    load_batch(f, buf, sl, X0);
#pragma unroll
    for (int k = 0; k < BATCH; ++k) {
#pragma unroll
      for (int i = 0; i < 4; ++i) d[k][i] = 0u;
#pragma unroll
      for (int s = 0; s < 2; ++s) mma_u8(d[k], f.fa[k][s], f.fb[k][s]);
    }
    __syncwarp();
#pragma unroll
    for (int k = 0; k < BATCH; ++k)
      store_cols(buf + (X0 + k) * STRIDE, d[k], lane);
  }
  __syncwarp();
  columns_to_words(T, buf + lane * STRIDE);
}

// The Montgomery product a·b·R^-1 of this thread, mod MA or, with TWO and
// alt, mod MB (a round whose tasks reduce by two moduli). Operands and
// result go by value and the caller stores the result after the call, so
// an output that aliases an input is never read once written (the first
// K5 took references in a __noinline__ call and read wrong values on the
// card where an output aliased an input). Inlined: on the H100 the builds
// ran 5-20 % faster than with a __noinline__ call, at the same registers.
template <class MA, class MB, bool TWO>
__device__ __forceinline__ fe mont_mul_warp(const fe a, const fe b,
                                             unsigned active, bool alt) {
  uint64_t T[16];
  warp_columns(T, a, b, active);
  fe out;
  if (TWO && alt) sos_reduce<MB>(out, T);
  else sos_reduce<MA>(out, T);
  return out;
}

#else

// D += A·B for one warp's fragments, by the layout above
inline void mma_emulate(uint32_t d[32][4], const uint32_t fa[32][4],
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

// warp_columns for the 32 virtual threads of a warp: thread X's operands
// a[X], b[X], its 512 bits T[X] (garbage where its batch of active is 0,
// as on the card)
inline void warp_columns_host(uint64_t T[32][16], const fe a[32],
                              const fe b[32], unsigned active) {
  static uint32_t buf[WARP_WORDS];
  for (int lane = 0; lane < 32; ++lane)
    stage(buf + lane * STRIDE, a[lane], b[lane]);
  for (int X0 = 0; X0 < 32; X0 += BATCH) {
    if (!((active >> X0) & ((1u << BATCH) - 1u))) continue;
    uint32_t d[BATCH][32][4] = {};
    for (int k = 0; k < BATCH; ++k) {
      for (int s = 0; s < 2; ++s) {
        uint32_t fa[32][4], fb[32][2];
        for (int lane = 0; lane < 32; ++lane)
          load_frags(fa[lane], fb[lane], buf + (X0 + k) * STRIDE,
                     slots_of(lane), s);
        mma_emulate(d[k], fa, fb);
      }
    }
    // every virtual thread has read the batch's operands
    for (int k = 0; k < BATCH; ++k)
      for (int lane = 0; lane < 32; ++lane)
        store_cols(buf + (X0 + k) * STRIDE, d[k][lane], lane);
  }
  for (int lane = 0; lane < 32; ++lane)
    columns_to_words(T[lane], buf + lane * STRIDE);
}

#endif

// One Montgomery product by K5's call, with the contract of
// mont_mul_cios<M> (a < 2^256, b < m): on the card every thread of the
// warp calls it converged (bdls_field_mul's kernel), on the host lane 0
// of an emulated warp carries it.
template <class M>
BDLS_HD void mont_mul(fe& out, const fe& a, const fe& b) {
#ifdef __CUDA_ARCH__
  out = mont_mul_warp<M, M, false>(a, b, 0xFFFFFFFFu, false);
#else
  fe as[32] = {}, bs[32] = {};
  uint64_t T[32][16];
  as[0] = a;
  bs[0] = b;
  warp_columns_host(T, as, bs, 1u);
  sos_reduce<M>(out, T[0]);
#endif
}

}  // namespace mxu
}  // namespace bdls
