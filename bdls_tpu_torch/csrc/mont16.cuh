// The gen-1 ECDSA verify's formulas (K4) a thread at a time, the
// reference's in Jacobian coordinates (infinity: Z = 0), as
// bdls_tpu/ops/jacobian.py has them: dbl-2007-bl (jdouble), add-2007-bl
// (jadd) and madd-2007-bl (jadd_mixed), each with the reference's selects
// for an operand at infinity, P == Q and P == -Q, over csrc/field.cuh's
// Montgomery field (R = 2^256, the R of the reference's gen-1 field).
// The kernel (csrc/mont16.cu) runs them split into levels of independent
// products a thread group a lane (csrc/mont16_group.cuh); these stay as
// the host tests' oracle, word for word
// (tests/test_torch_mont16_group.py).
#pragma once

#include "verify.cuh"

namespace bdls {
namespace m16 {

struct jpt {
  fe x, y, z;
};

BDLS_HD void sel(fe& out, bool c, const fe& a, const fe& b) {
  BDLS_UNROLL
  for (int i = 0; i < 8; ++i) out.v[i] = c ? a.v[i] : b.v[i];
}

BDLS_HD void sel(jpt& out, bool c, const jpt& a, const jpt& b) {
  sel(out.x, c, a.x, b.x);
  sel(out.y, c, a.y, b.y);
  sel(out.z, c, a.z, b.z);
}

// dbl-2007-bl; a = -3 takes 3·(X - ZZ)·(X + ZZ), a = 0 takes 3·XX
template <class C>
BDLS_HD void jdouble(jpt& out, const jpt& p) {
  typedef typename C::P F;
  fe xx, yy, yyyy, zz, s, m, t, y8, y3, z3, u;
  mont_sqr<F>(xx, p.x);
  mont_sqr<F>(yy, p.y);
  mont_sqr<F>(yyyy, yy);
  mont_sqr<F>(zz, p.z);
  add_mod<F>(u, p.x, yy);
  mont_sqr<F>(s, u);
  sub_mod<F>(s, s, xx);
  sub_mod<F>(s, s, yyyy);
  add_mod<F>(s, s, s);
  if (C::a_zero) {
    add_mod<F>(m, xx, xx);
    add_mod<F>(m, m, xx);
  } else {
    fe v;
    add_mod<F>(u, p.x, zz);
    sub_mod<F>(v, p.x, zz);
    mont_mul<F>(m, u, v);
    add_mod<F>(v, m, m);
    add_mod<F>(m, v, m);
  }
  mont_sqr<F>(t, m);
  add_mod<F>(u, s, s);
  sub_mod<F>(t, t, u);
  add_mod<F>(y8, yyyy, yyyy);
  add_mod<F>(y8, y8, y8);
  add_mod<F>(y8, y8, y8);
  sub_mod<F>(u, s, t);
  mont_mul<F>(y3, m, u);
  sub_mod<F>(y3, y3, y8);
  add_mod<F>(u, p.y, p.z);
  mont_sqr<F>(z3, u);
  sub_mod<F>(z3, z3, yy);
  sub_mod<F>(z3, z3, zz);
  out.x = t;
  out.y = y3;
  out.z = z3;
}

// add-2007-bl, then P = inf -> Q, Q = inf -> P, P == Q -> the double
// (P == -Q gives H = 0, so Z3 = 0)
template <class C>
BDLS_HD void jadd(jpt& out, const jpt& p, const jpt& q) {
  typedef typename C::P F;
  fe z1z1, z2z2, u1, u2, s1, s2, h, i, j, r, v, x3, y3, z3, t;
  mont_sqr<F>(z1z1, p.z);
  mont_sqr<F>(z2z2, q.z);
  mont_mul<F>(u1, p.x, z2z2);
  mont_mul<F>(u2, q.x, z1z1);
  mont_mul<F>(t, q.z, z2z2);
  mont_mul<F>(s1, p.y, t);
  mont_mul<F>(t, p.z, z1z1);
  mont_mul<F>(s2, q.y, t);
  sub_mod<F>(h, u2, u1);
  add_mod<F>(t, h, h);
  mont_sqr<F>(i, t);
  mont_mul<F>(j, h, i);
  sub_mod<F>(r, s2, s1);
  add_mod<F>(r, r, r);
  mont_mul<F>(v, u1, i);
  mont_sqr<F>(x3, r);
  sub_mod<F>(x3, x3, j);
  add_mod<F>(t, v, v);
  sub_mod<F>(x3, x3, t);
  mont_mul<F>(t, s1, j);
  add_mod<F>(t, t, t);
  sub_mod<F>(y3, v, x3);
  mont_mul<F>(y3, r, y3);
  sub_mod<F>(y3, y3, t);
  add_mod<F>(t, p.z, q.z);
  mont_sqr<F>(z3, t);
  sub_mod<F>(z3, z3, z1z1);
  sub_mod<F>(z3, z3, z2z2);
  mont_mul<F>(z3, z3, h);
  jpt added, dbl;
  added.x = x3;
  added.y = y3;
  added.z = z3;
  const bool inf1 = is_zero(p.z), inf2 = is_zero(q.z);
  const bool same = eq(u1, u2) && eq(s1, s2) && !inf1 && !inf2;
  jdouble<C>(dbl, p);
  sel(out, same, dbl, added);
  sel(out, inf2, p, out);
  sel(out, inf1, q, out);
}

// madd-2007-bl p + (qx, qy, 1), then P = inf -> Q, P == Q -> the double
template <class C>
BDLS_HD void jadd_mixed(jpt& out, const jpt& p, const fe& qx, const fe& qy) {
  typedef typename C::P F;
  fe z1z1, u2, s2, h, hh, i4, j, r, v, x3, y3, z3, t;
  mont_sqr<F>(z1z1, p.z);
  mont_mul<F>(u2, qx, z1z1);
  mont_mul<F>(t, p.z, z1z1);
  mont_mul<F>(s2, qy, t);
  sub_mod<F>(h, u2, p.x);
  mont_sqr<F>(hh, h);
  add_mod<F>(i4, hh, hh);
  add_mod<F>(i4, i4, i4);
  mont_mul<F>(j, h, i4);
  sub_mod<F>(r, s2, p.y);
  add_mod<F>(r, r, r);
  mont_mul<F>(v, p.x, i4);
  mont_sqr<F>(x3, r);
  sub_mod<F>(x3, x3, j);
  add_mod<F>(t, v, v);
  sub_mod<F>(x3, x3, t);
  mont_mul<F>(t, p.y, j);
  add_mod<F>(t, t, t);
  sub_mod<F>(y3, v, x3);
  mont_mul<F>(y3, r, y3);
  sub_mod<F>(y3, y3, t);
  add_mod<F>(t, p.z, p.z);
  mont_mul<F>(z3, t, h);
  jpt added, dbl, qa;
  added.x = x3;
  added.y = y3;
  added.z = z3;
  const bool inf1 = is_zero(p.z);
  const bool same = eq(u2, p.x) && eq(s2, p.y) && !inf1;
  jdouble<C>(dbl, p);
  qa.x = qx;
  qa.y = qy;
  load_one<F>(qa.z);
  sel(out, same, dbl, added);
  sel(out, inf1, qa, out);
}

// 4-bit digit w (0 = most significant) of a fully reduced scalar
BDLS_HD uint32_t nibble_msb(const fe& k, int w) {
  const int i = 63 - w;
  return (word_at(k, i >> 3) >> ((i & 7) * 4)) & 0xFu;
}

}  // namespace m16
}  // namespace bdls
