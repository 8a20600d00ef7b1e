// Complete projective point formulas (Renes–Costello–Batina 2015) over
// the Montgomery field of csrc/field.cuh: one branch-free sequence that
// is right for every input on a prime-order short-Weierstrass curve,
// with infinity = (0 : 1 : 0). These are the sequences of
// bdls_tpu/ops/proj.py (add_a3/dbl_a3 for P-256, add_a0/dbl_a0 for
// secp256k1), operation for operation.
#pragma once

#include "field.cuh"

namespace bdls {

struct pt {
  fe x, y, z;
};

#define BDLS_CURVE(NAME, P_, N_, AZERO, B_, B3_)                               \
  struct NAME {                                                                \
    typedef P_ P;                                                              \
    typedef N_ N;                                                              \
    static constexpr bool a_zero = AZERO;                                      \
    /* b·R and 3b·R mod p (Montgomery form) */                                 \
    static BDLS_HD uint32_t b(int i) { const uint32_t t[8] = B_; return t[i]; }   \
    static BDLS_HD uint32_t b3(int i) { const uint32_t t[8] = B3_; return t[i]; } \
  };

BDLS_CURVE(CurveP256, P256P, P256N, false,
  BDLS_L8(0x29C4BDDFu, 0xD89CDF62u, 0x78843090u, 0xACF005CDu, 0xF7212ED6u, 0xE5A220ABu, 0x04874834u, 0xDC30061Du),
  BDLS_L8(0x7D4E399Fu, 0x89D69E26u, 0x698C91B2u, 0x06D01166u, 0xE5638C84u, 0xB0E66203u, 0x0D95D89Cu, 0x94901259u))

BDLS_CURVE(CurveK256, K256P, K256N, true,
  BDLS_L8(0x00001AB7u, 0x00000007u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u),
  BDLS_L8(0x00005025u, 0x00000015u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u))

template <class C>
BDLS_HD void load_b(fe& out) {
  BDLS_UNROLL
  for (int i = 0; i < 8; ++i) out.v[i] = C::b(i);
}

template <class C>
BDLS_HD void load_b3(fe& out) {
  BDLS_UNROLL
  for (int i = 0; i < 8; ++i) out.v[i] = C::b3(i);
}

// Complete addition, a = -3 (RCB Algorithm 4).
template <class C>
BDLS_HD void add_a3(pt& out, const pt& p1, const pt& p2) {
  typedef typename C::P F;
  fe t0, t1, t2, t3, t4, t5, x3, y3, z3, bc;
  load_b<C>(bc);
  mont_mul<F>(t0, p1.x, p2.x);
  mont_mul<F>(t1, p1.y, p2.y);
  mont_mul<F>(t2, p1.z, p2.z);
  add_mod<F>(t3, p1.x, p1.y);
  add_mod<F>(t4, p2.x, p2.y);
  mont_mul<F>(t3, t3, t4);
  add_mod<F>(t4, t0, t1);
  sub_mod<F>(t3, t3, t4);
  add_mod<F>(t4, p1.y, p1.z);
  add_mod<F>(t5, p2.y, p2.z);
  mont_mul<F>(t4, t4, t5);
  add_mod<F>(t5, t1, t2);
  sub_mod<F>(t4, t4, t5);
  add_mod<F>(x3, p1.x, p1.z);
  add_mod<F>(y3, p2.x, p2.z);
  mont_mul<F>(x3, x3, y3);
  add_mod<F>(y3, t0, t2);
  sub_mod<F>(y3, x3, y3);
  mont_mul<F>(z3, bc, t2);
  sub_mod<F>(x3, y3, z3);
  add_mod<F>(z3, x3, x3);
  add_mod<F>(x3, x3, z3);
  sub_mod<F>(z3, t1, x3);
  add_mod<F>(x3, t1, x3);
  mont_mul<F>(y3, bc, y3);
  add_mod<F>(t1, t2, t2);
  add_mod<F>(t2, t1, t2);
  sub_mod<F>(y3, y3, t2);
  sub_mod<F>(y3, y3, t0);
  add_mod<F>(t1, y3, y3);
  add_mod<F>(y3, t1, y3);
  add_mod<F>(t1, t0, t0);
  add_mod<F>(t0, t1, t0);
  sub_mod<F>(t0, t0, t2);
  mont_mul<F>(t1, t4, y3);
  mont_mul<F>(t2, t0, y3);
  mont_mul<F>(y3, x3, z3);
  add_mod<F>(y3, y3, t2);
  mont_mul<F>(x3, t3, x3);
  sub_mod<F>(x3, x3, t1);
  mont_mul<F>(z3, t4, z3);
  mont_mul<F>(t1, t3, t0);
  add_mod<F>(z3, z3, t1);
  out.x = x3;
  out.y = y3;
  out.z = z3;
}

// Complete doubling, a = -3 (RCB Algorithm 6).
template <class C>
BDLS_HD void dbl_a3(pt& out, const pt& p) {
  typedef typename C::P F;
  fe t0, t1, t2, t3, x3, y3, z3, bc;
  load_b<C>(bc);
  mont_sqr<F>(t0, p.x);
  mont_sqr<F>(t1, p.y);
  mont_sqr<F>(t2, p.z);
  mont_mul<F>(t3, p.x, p.y);
  add_mod<F>(t3, t3, t3);
  mont_mul<F>(z3, p.x, p.z);
  add_mod<F>(z3, z3, z3);
  mont_mul<F>(y3, bc, t2);
  sub_mod<F>(y3, y3, z3);
  add_mod<F>(x3, y3, y3);
  add_mod<F>(y3, x3, y3);
  sub_mod<F>(x3, t1, y3);
  add_mod<F>(y3, t1, y3);
  mont_mul<F>(y3, x3, y3);
  mont_mul<F>(x3, x3, t3);
  add_mod<F>(t3, t2, t2);
  add_mod<F>(t2, t2, t3);
  mont_mul<F>(z3, bc, z3);
  sub_mod<F>(z3, z3, t2);
  sub_mod<F>(z3, z3, t0);
  add_mod<F>(t3, z3, z3);
  add_mod<F>(z3, z3, t3);
  add_mod<F>(t3, t0, t0);
  add_mod<F>(t0, t3, t0);
  sub_mod<F>(t0, t0, t2);
  mont_mul<F>(t0, t0, z3);
  add_mod<F>(y3, y3, t0);
  mont_mul<F>(t0, p.y, p.z);
  add_mod<F>(t0, t0, t0);
  mont_mul<F>(z3, t0, z3);
  sub_mod<F>(x3, x3, z3);
  mont_mul<F>(z3, t0, t1);
  add_mod<F>(z3, z3, z3);
  add_mod<F>(z3, z3, z3);
  out.x = x3;
  out.y = y3;
  out.z = z3;
}

// Complete addition, a = 0 (RCB Algorithm 7), b3 = 3b.
template <class C>
BDLS_HD void add_a0(pt& out, const pt& p1, const pt& p2) {
  typedef typename C::P F;
  fe t0, t1, t2, t3, t4, x3, y3, z3, b3;
  load_b3<C>(b3);
  mont_mul<F>(t0, p1.x, p2.x);
  mont_mul<F>(t1, p1.y, p2.y);
  mont_mul<F>(t2, p1.z, p2.z);
  add_mod<F>(t3, p1.x, p1.y);
  add_mod<F>(t4, p2.x, p2.y);
  mont_mul<F>(t3, t3, t4);
  add_mod<F>(t4, t0, t1);
  sub_mod<F>(t3, t3, t4);
  add_mod<F>(t4, p1.y, p1.z);
  add_mod<F>(x3, p2.y, p2.z);
  mont_mul<F>(t4, t4, x3);
  add_mod<F>(x3, t1, t2);
  sub_mod<F>(t4, t4, x3);
  add_mod<F>(x3, p1.x, p1.z);
  add_mod<F>(y3, p2.x, p2.z);
  mont_mul<F>(x3, x3, y3);
  add_mod<F>(y3, t0, t2);
  sub_mod<F>(y3, x3, y3);
  add_mod<F>(x3, t0, t0);
  add_mod<F>(t0, x3, t0);
  mont_mul<F>(t2, b3, t2);
  add_mod<F>(z3, t1, t2);
  sub_mod<F>(t1, t1, t2);
  mont_mul<F>(y3, b3, y3);
  mont_mul<F>(x3, t4, y3);
  mont_mul<F>(t2, t3, t1);
  sub_mod<F>(x3, t2, x3);
  mont_mul<F>(y3, y3, t0);
  mont_mul<F>(t1, t1, z3);
  add_mod<F>(y3, t1, y3);
  mont_mul<F>(t0, t0, t3);
  mont_mul<F>(z3, z3, t4);
  add_mod<F>(z3, z3, t0);
  out.x = x3;
  out.y = y3;
  out.z = z3;
}

// Complete doubling, a = 0 (RCB Algorithm 9), b3 = 3b.
template <class C>
BDLS_HD void dbl_a0(pt& out, const pt& p) {
  typedef typename C::P F;
  fe t0, t1, t2, x3, y3, z3, b3;
  load_b3<C>(b3);
  mont_sqr<F>(t0, p.y);
  add_mod<F>(z3, t0, t0);
  add_mod<F>(z3, z3, z3);
  add_mod<F>(z3, z3, z3);
  mont_mul<F>(t1, p.y, p.z);
  mont_sqr<F>(t2, p.z);
  mont_mul<F>(t2, b3, t2);
  mont_mul<F>(x3, t2, z3);
  add_mod<F>(y3, t0, t2);
  mont_mul<F>(z3, t1, z3);
  add_mod<F>(t1, t2, t2);
  add_mod<F>(t2, t1, t2);
  sub_mod<F>(t0, t0, t2);
  mont_mul<F>(y3, t0, y3);
  add_mod<F>(y3, x3, y3);
  mont_mul<F>(t1, p.x, p.y);
  mont_mul<F>(x3, t0, t1);
  add_mod<F>(x3, x3, x3);
  out.x = x3;
  out.y = y3;
  out.z = z3;
}

template <class C>
BDLS_HD void point_add(pt& out, const pt& p1, const pt& p2) {
  if (C::a_zero) add_a0<C>(out, p1, p2);
  else add_a3<C>(out, p1, p2);
}

template <class C>
BDLS_HD void point_dbl(pt& out, const pt& p) {
  if (C::a_zero) dbl_a0<C>(out, p);
  else dbl_a3<C>(out, p);
}

}  // namespace bdls
