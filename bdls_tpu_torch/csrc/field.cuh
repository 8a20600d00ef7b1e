// 256-bit modular arithmetic for the verify kernels (csrc/verify.cu,
// csrc/pinned.cu, csrc/block.cu, csrc/ed25519.cu).
//
// A field element is eight 32-bit limbs, little-endian, always fully
// reduced to [0, m). Multiplication is Montgomery CIOS (R = 2^256) with
// 64-bit column accumulators: plain C++ that nvcc turns into IMAD.WIDE
// chains, and that g++ compiles too, so the same code is checked on the
// host (tests/test_torch_host_kernel.py) before it runs on the card.
// Without __CUDACC__ the __host__/__device__ qualifiers vanish.
//
// Built with -DBDLS_MUL_MXU, mont_mul forms the 512-bit product on the
// tensor cores instead (K5, csrc/mxu.cuh) and returns the same fully
// reduced value; mont_mul_cios is the CIOS product in every build.
//
// One template covers the five moduli (P-256 p and n, secp256k1 p and
// n, Ed25519's p = 2^255 - 19); each is a struct of constant limb
// functions, so every constant folds into an immediate once the loops
// unroll. CIOS and the conditional subtraction only need m odd and
// m < 2^256, so 2^255 - 19 takes the same code.
#pragma once

#include <stddef.h>
#include <stdint.h>

#ifdef __CUDACC__
#define BDLS_HD __host__ __device__ __forceinline__
#define BDLS_UNROLL _Pragma("unroll")
#define BDLS_NOUNROLL _Pragma("unroll 1")
#else
#define BDLS_HD inline
#define BDLS_UNROLL
#define BDLS_NOUNROLL
#endif

namespace bdls {

struct fe {
  uint32_t v[8];
};

// Per-modulus constants: m, n0 = -m^-1 mod 2^32, R^2 mod m, R mod m
// (Montgomery 1) and the Fermat exponent m - 2.
#define BDLS_MODULUS(NAME, M_, N0_, R2_, ONE_, E_)                          \
  struct NAME {                                                            \
    static constexpr uint32_t N0 = N0_;                                    \
    static BDLS_HD uint32_t m(int i) { const uint32_t t[8] = M_; return t[i]; }     \
    static BDLS_HD uint32_t r2(int i) { const uint32_t t[8] = R2_; return t[i]; }   \
    static BDLS_HD uint32_t one(int i) { const uint32_t t[8] = ONE_; return t[i]; } \
    static BDLS_HD uint32_t e(int i) { const uint32_t t[8] = E_; return t[i]; }     \
  };

#define BDLS_L8(a, b, c, d, e, f, g, h) {a, b, c, d, e, f, g, h}

BDLS_MODULUS(P256P,
  BDLS_L8(0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000001u, 0xFFFFFFFFu),
  0x00000001u,
  BDLS_L8(0x00000003u, 0x00000000u, 0xFFFFFFFFu, 0xFFFFFFFBu, 0xFFFFFFFEu, 0xFFFFFFFFu, 0xFFFFFFFDu, 0x00000004u),
  BDLS_L8(0x00000001u, 0x00000000u, 0x00000000u, 0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFEu, 0x00000000u),
  BDLS_L8(0xFFFFFFFDu, 0xFFFFFFFFu, 0xFFFFFFFFu, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000001u, 0xFFFFFFFFu))

BDLS_MODULUS(P256N,
  BDLS_L8(0xFC632551u, 0xF3B9CAC2u, 0xA7179E84u, 0xBCE6FAADu, 0xFFFFFFFFu, 0xFFFFFFFFu, 0x00000000u, 0xFFFFFFFFu),
  0xEE00BC4Fu,
  BDLS_L8(0xBE79EEA2u, 0x83244C95u, 0x49BD6FA6u, 0x4699799Cu, 0x2B6BEC59u, 0x2845B239u, 0xF3D95620u, 0x66E12D94u),
  BDLS_L8(0x039CDAAFu, 0x0C46353Du, 0x58E8617Bu, 0x43190552u, 0x00000000u, 0x00000000u, 0xFFFFFFFFu, 0x00000000u),
  BDLS_L8(0xFC63254Fu, 0xF3B9CAC2u, 0xA7179E84u, 0xBCE6FAADu, 0xFFFFFFFFu, 0xFFFFFFFFu, 0x00000000u, 0xFFFFFFFFu))

BDLS_MODULUS(K256P,
  BDLS_L8(0xFFFFFC2Fu, 0xFFFFFFFEu, 0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu),
  0xD2253531u,
  BDLS_L8(0x000E90A1u, 0x000007A2u, 0x00000001u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u),
  BDLS_L8(0x000003D1u, 0x00000001u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u),
  BDLS_L8(0xFFFFFC2Du, 0xFFFFFFFEu, 0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu))

BDLS_MODULUS(K256N,
  BDLS_L8(0xD0364141u, 0xBFD25E8Cu, 0xAF48A03Bu, 0xBAAEDCE6u, 0xFFFFFFFEu, 0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu),
  0x5588B13Fu,
  BDLS_L8(0x67D7D140u, 0x896CF214u, 0x0E7CF878u, 0x741496C2u, 0x5BCD07C6u, 0xE697F5E4u, 0x81C69BC5u, 0x9D671CD5u),
  BDLS_L8(0x2FC9BEBFu, 0x402DA173u, 0x50B75FC4u, 0x45512319u, 0x00000001u, 0x00000000u, 0x00000000u, 0x00000000u),
  BDLS_L8(0xD036413Fu, 0xBFD25E8Cu, 0xAF48A03Bu, 0xBAAEDCE6u, 0xFFFFFFFEu, 0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu))

BDLS_MODULUS(P25519,
  BDLS_L8(0xFFFFFFEDu, 0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu, 0x7FFFFFFFu),
  0x286BCA1Bu,
  BDLS_L8(0x000005A4u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u),
  BDLS_L8(0x00000026u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u),
  BDLS_L8(0xFFFFFFEBu, 0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu, 0x7FFFFFFFu))

// ---------------------------------------------------------- raw integers

BDLS_HD bool is_zero(const fe& a) {
  uint32_t acc = 0;
  BDLS_UNROLL
  for (int i = 0; i < 8; ++i) acc |= a.v[i];
  return acc == 0;
}

BDLS_HD bool eq(const fe& a, const fe& b) {
  uint32_t acc = 0;
  BDLS_UNROLL
  for (int i = 0; i < 8; ++i) acc |= a.v[i] ^ b.v[i];
  return acc == 0;
}

// a < m, as integers.
template <class M>
BDLS_HD bool lt_mod(const fe& a) {
  uint64_t borrow = 0;
  BDLS_UNROLL
  for (int i = 0; i < 8; ++i) {
    uint64_t d = (uint64_t)a.v[i] - M::m(i) - borrow;
    borrow = (d >> 63) & 1;
  }
  return borrow != 0;
}

// out = a + m (mod 2^256); returns the carry out of bit 256.
template <class M>
BDLS_HD uint32_t add_m(fe& out, const fe& a) {
  uint64_t c = 0;
  BDLS_UNROLL
  for (int i = 0; i < 8; ++i) {
    c += (uint64_t)a.v[i] + M::m(i);
    out.v[i] = (uint32_t)c;
    c >>= 32;
  }
  return (uint32_t)c;
}

// ----------------------------------------------------- modular, reduced

// out = (hi·2^256 + t) mod m for a value < 2m held as 8 limbs + hi bit.
template <class M>
BDLS_HD void reduce_once(fe& out, const uint32_t* t, uint32_t hi) {
  uint32_t d[8];
  uint64_t borrow = 0;
  BDLS_UNROLL
  for (int i = 0; i < 8; ++i) {
    uint64_t x = (uint64_t)t[i] - M::m(i) - borrow;
    d[i] = (uint32_t)x;
    borrow = (x >> 63) & 1;
  }
  // t >= m iff the high bit is set or the subtraction did not borrow
  const bool take = hi != 0 || borrow == 0;
  BDLS_UNROLL
  for (int i = 0; i < 8; ++i) out.v[i] = take ? d[i] : t[i];
}

template <class M>
BDLS_HD void add_mod(fe& out, const fe& a, const fe& b) {
  uint32_t t[8];
  uint64_t c = 0;
  BDLS_UNROLL
  for (int i = 0; i < 8; ++i) {
    c += (uint64_t)a.v[i] + b.v[i];
    t[i] = (uint32_t)c;
    c >>= 32;
  }
  reduce_once<M>(out, t, (uint32_t)c);
}

template <class M>
BDLS_HD void sub_mod(fe& out, const fe& a, const fe& b) {
  uint32_t t[8];
  uint64_t borrow = 0;
  BDLS_UNROLL
  for (int i = 0; i < 8; ++i) {
    uint64_t x = (uint64_t)a.v[i] - b.v[i] - borrow;
    t[i] = (uint32_t)x;
    borrow = (x >> 63) & 1;
  }
  // a < b: add m back (the carry out of that addition is dropped)
  const uint32_t mask = 0u - (uint32_t)borrow;
  uint64_t c = 0;
  BDLS_UNROLL
  for (int i = 0; i < 8; ++i) {
    c += (uint64_t)t[i] + (M::m(i) & mask);
    out.v[i] = (uint32_t)c;
    c >>= 32;
  }
}

// Montgomery product a·b·R^-1 mod m (CIOS). Needs a·b < m·R, which holds
// for any a < 2^256 and b < m, and returns a fully reduced result.
template <class M>
BDLS_HD void mont_mul_cios(fe& out, const fe& a, const fe& b) {
  uint32_t t[10];
  BDLS_UNROLL
  for (int i = 0; i < 10; ++i) t[i] = 0;
  BDLS_UNROLL
  for (int i = 0; i < 8; ++i) {
    uint64_t c = 0;
    BDLS_UNROLL
    for (int j = 0; j < 8; ++j) {
      c += (uint64_t)a.v[j] * b.v[i] + t[j];
      t[j] = (uint32_t)c;
      c >>= 32;
    }
    c += t[8];
    t[8] = (uint32_t)c;
    t[9] = (uint32_t)(c >> 32);
    const uint32_t q = t[0] * M::N0;
    c = ((uint64_t)q * M::m(0) + t[0]) >> 32;
    BDLS_UNROLL
    for (int j = 1; j < 8; ++j) {
      c += (uint64_t)q * M::m(j) + t[j];
      t[j - 1] = (uint32_t)c;
      c >>= 32;
    }
    c += t[8];
    t[7] = (uint32_t)c;
    t[8] = t[9] + (uint32_t)(c >> 32);
  }
  reduce_once<M>(out, t, t[8]);
}

}  // namespace bdls

#include "mxu.cuh"

namespace bdls {

// The product every kernel calls: CIOS, or K5's tensor-core product in
// the mxu builds (the same value, bit for bit).
template <class M>
BDLS_HD void mont_mul(fe& out, const fe& a, const fe& b) {
#ifdef BDLS_MUL_MXU
  mxu::mont_mul<M>(out, a, b);
#else
  mont_mul_cios<M>(out, a, b);
#endif
}

template <class M>
BDLS_HD void mont_sqr(fe& out, const fe& a) { mont_mul<M>(out, a, a); }

template <class M>
BDLS_HD void load_r2(fe& out) {
  BDLS_UNROLL
  for (int i = 0; i < 8; ++i) out.v[i] = M::r2(i);
}

template <class M>
BDLS_HD void load_one(fe& out) {
  BDLS_UNROLL
  for (int i = 0; i < 8; ++i) out.v[i] = M::one(i);
}

// x (any value < 2^256) -> x·R mod m
template <class M>
BDLS_HD void to_mont(fe& out, const fe& x) {
  fe r2;
  load_r2<M>(r2);
  mont_mul<M>(out, x, r2);
}

// Montgomery-form x -> x^(m-2) = x^-1 (Fermat; 0 -> 0), square-and-
// multiply over the public exponent, most significant bit first.
template <class M>
BDLS_HD void mont_inv(fe& out, const fe& x) {
  fe acc;
  load_one<M>(acc);
  BDLS_UNROLL
  for (int w = 7; w >= 0; --w) {
    const uint32_t word = M::e(w);
    BDLS_NOUNROLL
    for (int bit = 31; bit >= 0; --bit) {
      mont_sqr<M>(acc, acc);
      if ((word >> bit) & 1u) mont_mul<M>(acc, acc, x);
    }
  }
  out = acc;
}

}  // namespace bdls
