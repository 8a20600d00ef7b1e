// The BLS12-381 base field for the pairing kernel (csrc/bls.cu, K9).
//
// p < 2^381. A field element is twelve 32-bit limbs, little-endian, in
// Montgomery form (R = 2^384) and always fully reduced to [0, p).
// Multiplication is CIOS with 64-bit column accumulators, as in
// csrc/field.cuh (which stays fixed at eight limbs for the 256-bit
// moduli): plain C++ that nvcc turns into IMAD.WIDE chains and g++
// compiles too, so tests/test_torch_host_kernel.py checks this code on
// the host before it runs on the card.
#pragma once

#include "field.cuh"

namespace bdls {

struct fp {
  uint32_t v[12];
};

namespace p381 {

constexpr uint32_t N0 = 0xFFFCFFFDu;   // -p^-1 mod 2^32

#define BDLS_L12(...) { __VA_ARGS__ }
#define BDLS_P381_TABLE(NAME, ...)                                     \
  BDLS_HD uint32_t NAME(int i) {                                      \
    const uint32_t t[12] = BDLS_L12(__VA_ARGS__);                     \
    return t[i];                                                      \
  }

// p
BDLS_P381_TABLE(m, 0xFFFFAAABu, 0xB9FEFFFFu, 0xB153FFFFu, 0x1EABFFFEu,
                0xF6B0F624u, 0x6730D2A0u, 0xF38512BFu, 0x64774B84u,
                0x434BACD7u, 0x4B1BA7B6u, 0x397FE69Au, 0x1A0111EAu)
// R^2 mod p
BDLS_P381_TABLE(r2, 0x1C341746u, 0xF4DF1F34u, 0x09D104F1u, 0x0A76E6A6u,
                0x4C95B6D5u, 0x8DE5476Cu, 0x939D83C0u, 0x67EB88A9u,
                0xB519952Du, 0x9A793E85u, 0x92CAE3AAu, 0x11988FE5u)
// R mod p: the Montgomery form of 1
BDLS_P381_TABLE(one, 0x0002FFFDu, 0x76090000u, 0xC40C0002u, 0xEBF4000Bu,
                0x53C758BAu, 0x5F489857u, 0x70525745u, 0x77CE5853u,
                0xA256EC6Du, 0x5C071A97u, 0xFA80E493u, 0x15F65EC3u)
// p - 2, the Fermat exponent
BDLS_P381_TABLE(e, 0xFFFFAAA9u, 0xB9FEFFFFu, 0xB153FFFFu, 0x1EABFFFEu,
                0xF6B0F624u, 0x6730D2A0u, 0xF38512BFu, 0x64774B84u,
                0x434BACD7u, 0x4B1BA7B6u, 0x397FE69Au, 0x1A0111EAu)

}  // namespace p381

BDLS_HD void fp_zero(fp& out) {
  BDLS_UNROLL
  for (int i = 0; i < 12; ++i) out.v[i] = 0;
}

BDLS_HD void fp_one(fp& out) {
  BDLS_UNROLL
  for (int i = 0; i < 12; ++i) out.v[i] = p381::one(i);
}

BDLS_HD bool fp_is_zero(const fp& a) {
  uint32_t acc = 0;
  BDLS_UNROLL
  for (int i = 0; i < 12; ++i) acc |= a.v[i];
  return acc == 0;
}

// out = (hi·2^384 + t) mod p for a value < 2p held as 12 limbs + hi.
BDLS_HD void fp_reduce_once(fp& out, const uint32_t* t, uint32_t hi) {
  uint32_t d[12];
  uint64_t borrow = 0;
  BDLS_UNROLL
  for (int i = 0; i < 12; ++i) {
    uint64_t x = (uint64_t)t[i] - p381::m(i) - borrow;
    d[i] = (uint32_t)x;
    borrow = (x >> 63) & 1;
  }
  const bool take = hi != 0 || borrow == 0;
  BDLS_UNROLL
  for (int i = 0; i < 12; ++i) out.v[i] = take ? d[i] : t[i];
}

BDLS_HD void fp_add(fp& out, const fp& a, const fp& b) {
  uint32_t t[12];
  uint64_t c = 0;
  BDLS_UNROLL
  for (int i = 0; i < 12; ++i) {
    c += (uint64_t)a.v[i] + b.v[i];
    t[i] = (uint32_t)c;
    c >>= 32;
  }
  fp_reduce_once(out, t, (uint32_t)c);
}

BDLS_HD void fp_sub(fp& out, const fp& a, const fp& b) {
  uint32_t t[12];
  uint64_t borrow = 0;
  BDLS_UNROLL
  for (int i = 0; i < 12; ++i) {
    uint64_t x = (uint64_t)a.v[i] - b.v[i] - borrow;
    t[i] = (uint32_t)x;
    borrow = (x >> 63) & 1;
  }
  const uint32_t mask = 0u - (uint32_t)borrow;
  uint64_t c = 0;
  BDLS_UNROLL
  for (int i = 0; i < 12; ++i) {
    c += (uint64_t)t[i] + (p381::m(i) & mask);
    out.v[i] = (uint32_t)c;
    c >>= 32;
  }
}

// Montgomery product a·b·R^-1 mod p (CIOS). Needs a·b < p·R, which
// holds for any a < 2^384 and b < p; the result is fully reduced.
BDLS_HD void fp_mul(fp& out, const fp& a, const fp& b) {
  uint32_t t[14];
  BDLS_UNROLL
  for (int i = 0; i < 14; ++i) t[i] = 0;
  BDLS_UNROLL
  for (int i = 0; i < 12; ++i) {
    uint64_t c = 0;
    BDLS_UNROLL
    for (int j = 0; j < 12; ++j) {
      c += (uint64_t)a.v[j] * b.v[i] + t[j];
      t[j] = (uint32_t)c;
      c >>= 32;
    }
    c += t[12];
    t[12] = (uint32_t)c;
    t[13] = (uint32_t)(c >> 32);
    const uint32_t q = t[0] * p381::N0;
    c = ((uint64_t)q * p381::m(0) + t[0]) >> 32;
    BDLS_UNROLL
    for (int j = 1; j < 12; ++j) {
      c += (uint64_t)q * p381::m(j) + t[j];
      t[j - 1] = (uint32_t)c;
      c >>= 32;
    }
    c += t[12];
    t[11] = (uint32_t)c;
    t[12] = t[13] + (uint32_t)(c >> 32);
  }
  fp_reduce_once(out, t, t[12]);
}

// x (any value < 2^384) -> x·R mod p
BDLS_HD void fp_to_mont(fp& out, const fp& x) {
  fp r2;
  BDLS_UNROLL
  for (int i = 0; i < 12; ++i) r2.v[i] = p381::r2(i);
  fp_mul(out, x, r2);
}

// Montgomery form -> the canonical value in [0, p)
BDLS_HD void fp_from_mont(fp& out, const fp& x) {
  fp one;
  fp_zero(one);
  one.v[0] = 1;
  fp_mul(out, x, one);
}

// x^(p-2) = x^-1 in Montgomery form (0 -> 0), square-and-multiply over
// the public exponent, most significant bit first.
BDLS_HD void fp_inv(fp& out, const fp& x) {
  fp acc;
  fp_one(acc);
  BDLS_NOUNROLL
  for (int w = 11; w >= 0; --w) {
    const uint32_t word = p381::e(w);
    BDLS_NOUNROLL
    for (int bit = 31; bit >= 0; --bit) {
      fp_mul(acc, acc, acc);
      if ((word >> bit) & 1u) fp_mul(acc, acc, x);
    }
  }
  out = acc;
}

}  // namespace bdls
