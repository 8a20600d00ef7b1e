// GLV split of a secp256k1 scalar, per lane, for the pinned-key kernel
// (csrc/pinned.cu): the counterpart of bdls_tpu/ops/glv.py:decompose.
//
// With g_i = floor(2^384·|b|/n) + 1 and the lattice basis (a1, b1),
// (a2, b2) of (lambda, n):
//   c1 = (k·g1) >> 384, c2 = (k·g2) >> 384   (full 256 x 256-bit product)
//   k1 = k - c1·a1 - c2·a2,  k2 = c1·|b1| - c2·b2
// Both halves satisfy |k_i| < 2^132, so they are computed modulo 2^160
// in two's complement (bit 159 is the sign) and returned as magnitude
// plus sign. Then each half's signed 4-bit digits: w = |k_i| + 0x88…8
// (33 nibbles), d_j = nib_j(w) - 8 for j < 33 and d_33 = the carry
// nibble (bdls_tpu/ops/verify_fold.py:_signed_digits_k).
//
// Plain C++ like csrc/field.cuh: g++ builds it too, and
// tests/test_torch_host_kernel.py holds it against the integer oracle.
#pragma once

#include "field.cuh"

namespace bdls {
namespace glv {

#define BDLS_WORDS(NAME, N_, ...)                                        \
  struct NAME {                                                         \
    static constexpr int N = N_;                                        \
    static BDLS_HD uint32_t w(int i) {                                  \
      const uint32_t t[N_] = {__VA_ARGS__};                             \
      return t[i];                                                      \
    }                                                                   \
  };

BDLS_WORDS(G1, 8, 0x45DBB031u, 0xE893209Au, 0x71E8CA7Fu, 0x3DAA8A14u,
           0x9284EB15u, 0xE86C90E4u, 0xA7D46BCDu, 0x3086D221u)
BDLS_WORDS(G2, 8, 0x8AC47F72u, 0x1571B4AEu, 0x9DF506C6u, 0x221208ACu,
           0x0ABFE4C4u, 0x6F547FA9u, 0x010E8828u, 0xE4437ED6u)
BDLS_WORDS(A1, 4, 0x9284EB15u, 0xE86C90E4u, 0xA7D46BCDu, 0x3086D221u)
BDLS_WORDS(A2, 5, 0x9D44CFD8u, 0x57C1108Du, 0xA8E2F3F6u, 0x14CA50F7u,
           0x00000001u)
BDLS_WORDS(B1ABS, 4, 0x0ABFE4C3u, 0x6F547FA9u, 0x010E8828u, 0xE4437ED6u)
// b2 = a1

constexpr int HALF_WORDS = 5;     // 160 bits

// c = (k·g) >> 384: words 12..15 of the 16-word product.
template <class G>
BDLS_HD void mulshift384(uint32_t c[4], const fe& k) {
  uint32_t t[16];
  BDLS_UNROLL
  for (int i = 0; i < 16; ++i) t[i] = 0;
  BDLS_UNROLL
  for (int i = 0; i < 8; ++i) {
    uint64_t carry = 0;
    BDLS_UNROLL
    for (int j = 0; j < G::N; ++j) {
      carry += (uint64_t)k.v[i] * G::w(j) + t[i + j];
      t[i + j] = (uint32_t)carry;
      carry >>= 32;
    }
    t[i + G::N] = (uint32_t)carry;
  }
  BDLS_UNROLL
  for (int i = 0; i < 4; ++i) c[i] = t[12 + i];
}

// out = c·A mod 2^160.
template <class A>
BDLS_HD void mul_lo(uint32_t out[HALF_WORDS], const uint32_t c[4]) {
  BDLS_UNROLL
  for (int i = 0; i < HALF_WORDS; ++i) out[i] = 0;
  BDLS_UNROLL
  for (int i = 0; i < 4; ++i) {
    uint64_t carry = 0;
    BDLS_UNROLL
    for (int j = 0; i + j < HALF_WORDS; ++j) {
      const uint32_t aj = j < A::N ? A::w(j) : 0u;
      carry += (uint64_t)c[i] * aj + out[i + j];
      out[i + j] = (uint32_t)carry;
      carry >>= 32;
    }
  }
}

// a -= b mod 2^160.
BDLS_HD void sub_lo(uint32_t a[HALF_WORDS], const uint32_t b[HALF_WORDS]) {
  uint64_t borrow = 0;
  BDLS_UNROLL
  for (int i = 0; i < HALF_WORDS; ++i) {
    const uint64_t x = (uint64_t)a[i] - b[i] - borrow;
    a[i] = (uint32_t)x;
    borrow = (x >> 63) & 1;
  }
}

// Two's complement v (mod 2^160) -> |v| and its sign.
BDLS_HD void magnitude(uint32_t mag[HALF_WORDS], bool& neg,
                       const uint32_t v[HALF_WORDS]) {
  neg = (v[HALF_WORDS - 1] >> 31) != 0;
  const uint32_t mask = 0u - (uint32_t)neg;
  uint64_t carry = neg ? 1u : 0u;
  BDLS_UNROLL
  for (int i = 0; i < HALF_WORDS; ++i) {
    carry += (uint64_t)(v[i] ^ mask);
    mag[i] = (uint32_t)carry;
    carry >>= 32;
  }
}

// k < n (canonical, plain form) -> (|k1|, k1 < 0), (|k2|, k2 < 0).
BDLS_HD void decompose(uint32_t k1[HALF_WORDS], bool& k1n,
                       uint32_t k2[HALF_WORDS], bool& k2n, const fe& k) {
  uint32_t c1[4], c2[4], t[HALF_WORDS], u[HALF_WORDS];
  mulshift384<G1>(c1, k);
  mulshift384<G2>(c2, k);
  BDLS_UNROLL
  for (int i = 0; i < HALF_WORDS; ++i) u[i] = k.v[i];
  mul_lo<A1>(t, c1);
  sub_lo(u, t);
  mul_lo<A2>(t, c2);
  sub_lo(u, t);
  magnitude(k1, k1n, u);
  mul_lo<B1ABS>(u, c1);
  mul_lo<A1>(t, c2);
  sub_lo(u, t);
  magnitude(k2, k2n, u);
}

// w = |k_i| + 0x88…8 (33 nibbles); |k_i| < 2^132, so w < 2^133.
BDLS_HD void digit_words(uint32_t w[HALF_WORDS],
                         const uint32_t mag[HALF_WORDS]) {
  uint64_t c = 0;
  BDLS_UNROLL
  for (int i = 0; i < HALF_WORDS; ++i) {
    c += (uint64_t)mag[i] + (i < 4 ? 0x88888888u : 0x8u);
    w[i] = (uint32_t)c;
    c >>= 32;
  }
}

// Signed digit j (0 <= j < 34) of a half: returns |d_j| (0..8), sets
// its sign. j is uniform across the warp but not a compile-time
// constant: a select chain keeps w in registers.
BDLS_HD uint32_t digit(const uint32_t w[HALF_WORDS], int j, bool& neg) {
  uint32_t word = 0;
  BDLS_UNROLL
  for (int i = 0; i < HALF_WORDS; ++i) word = (i == (j >> 3)) ? w[i] : word;
  const uint32_t nib = (word >> ((j & 7) * 4)) & 0xFu;
  if (j == 33) {                   // the carry nibble, unsigned
    neg = false;
    return nib;
  }
  neg = nib < 8;
  return neg ? 8u - nib : nib - 8u;
}

}  // namespace glv
}  // namespace bdls
