// The gen-1 ECDSA verify (K4) a lane at a time: the body of the kernel in
// csrc/mont16.cu, in a header so the host build of the same code
// (tests/test_torch_host_kernel.py) checks it against the plain PyTorch
// twin, bdls_tpu_torch/ops/ecdsa.py:verify_kernel.
//
// The verdict is that of bdls_tpu/ops/ecdsa.py:verify_kernel with
// field="mont16", inv="batch", ladder="windowed":
//   r, s in [1, n); Qx, Qy < p; Q on the curve and not (0, 0);
//   R = u1·G + u2·Q != infinity with u1 = e/s, u2 = r/s (mod n);
//   X(R) == r·Z(R)^2 or, where r + n < p, X(R) == (r + n)·Z(R)^2.
// R comes in Jacobian coordinates (infinity: Z = 0) from the 4-bit
// windowed dual ladder of bdls_tpu/ops/jacobian.py:windowed_dual_mul: a
// per-lane [1..15]·Q table (one doubling, 13 mixed additions), then 64
// windows of 4 doublings, one complete addition of the Q entry and one
// mixed addition of the host [1..15]·G entry, each kept only for a
// nonzero digit. The exceptional cases of an addition (an operand at
// infinity, P == Q, P == -Q) are resolved by selects, in the reference's
// order. The field is csrc/field.cuh's (R = 2^256, the R of the
// reference's gen-1 field), so the host G table is the reference's
// fixed_base_table in 32-bit words.
//
// s^-1 comes from outside the lane body: csrc/mont16.cu inverts s across
// its thread block (block_inv below is the same scan, run serially).
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

// R = u1·G + u2·Q, the 4-bit windowed dual ladder. q: Q in Montgomery
// affine form; gtab: the host [0..15]·G table, (16, 2, 8) words,
// Montgomery form (entry 0 unused).
template <class C>
BDLS_HD void windowed_dual(jpt& acc, const fe& u1, const fe& u2,
                           const fe& qx, const fe& qy,
                           const uint32_t* gtab) {
  typedef typename C::P F;
  jpt tab[15];                       // [1..15]·Q, Jacobian
  tab[0].x = qx;
  tab[0].y = qy;
  load_one<F>(tab[0].z);
  jdouble<C>(tab[1], tab[0]);
  BDLS_NOUNROLL
  for (int k = 2; k < 15; ++k) jadd_mixed<C>(tab[k], tab[k - 1], qx, qy);
  BDLS_UNROLL
  for (int i = 0; i < 8; ++i) {
    acc.x.v[i] = i == 0 ? 1u : 0u;
    acc.y.v[i] = i == 0 ? 1u : 0u;
    acc.z.v[i] = 0u;
  }
  BDLS_NOUNROLL
  for (int w = 0; w < 64; ++w) {
    BDLS_NOUNROLL
    for (int d = 0; d < 4; ++d) jdouble<C>(acc, acc);
    const uint32_t dq = nibble_msb(u2, w), dg = nibble_msb(u1, w);
    jpt sum;
    jadd<C>(sum, acc, tab[dq == 0 ? 0 : dq - 1]);
    sel(acc, dq == 0, acc, sum);
    fe gx, gy;
    const uint32_t* g = gtab + (size_t)dg * 16;
    BDLS_UNROLL
    for (int l = 0; l < 8; ++l) {
      gx.v[l] = BDLS_LDG(g + l);
      gy.v[l] = BDLS_LDG(g + 8 + l);
    }
    jadd_mixed<C>(sum, acc, gx, gy);
    sel(acc, dg == 0, acc, sum);
  }
}

// The lane body after the inverse: sinv = s^-1·R mod n (0 for s = 0 or
// s = n, which the range screen rejects anyway).
template <class C>
BDLS_HD bool verify_lane_mont16(const fe& qx, const fe& qy, const fe& r,
                                const fe& s, const fe& e, const fe& sinv,
                                const uint32_t* gtab) {
  typedef typename C::P FP;
  typedef typename C::N FN;
  const bool r_ok = !is_zero(r) && lt_mod<FN>(r);
  const bool s_ok = !is_zero(s) && lt_mod<FN>(s);
  const bool q_ok = lt_mod<FP>(qx) && lt_mod<FP>(qy);

  // u1 = e/s, u2 = r/s (mod n), plain form
  fe u1, u2;
  mont_mul<FN>(u1, e, sinv);
  mont_mul<FN>(u2, r, sinv);

  // Q on the curve: y^2 == x^3 + a·x + b
  fe x, y, lhs, rhs, t;
  to_mont<FP>(x, qx);
  to_mont<FP>(y, qy);
  mont_sqr<FP>(lhs, y);
  mont_sqr<FP>(rhs, x);
  mont_mul<FP>(rhs, rhs, x);
  load_b<C>(t);
  add_mod<FP>(rhs, rhs, t);
  if (!C::a_zero) {                // a = -3
    add_mod<FP>(t, x, x);
    add_mod<FP>(t, t, x);
    sub_mod<FP>(rhs, rhs, t);
  }
  const bool on_curve = eq(lhs, rhs) && !(is_zero(qx) && is_zero(qy));

  jpt R;
  windowed_dual<C>(R, u1, u2, x, y, gtab);
  const bool not_inf = !is_zero(R.z);

  // x(R) == r (mod n), inversion-free: X == r·Z^2 or X == (r + n)·Z^2
  fe z2, rm, rz, rn;
  mont_sqr<FP>(z2, R.z);
  to_mont<FP>(rm, r);
  mont_mul<FP>(rz, rm, z2);
  const bool ok1 = eq(R.x, rz);
  const uint32_t rn_carry = add_m<FN>(rn, r);
  const bool rn_fits = rn_carry == 0 && lt_mod<FP>(rn);
  to_mont<FP>(rm, rn);
  mont_mul<FP>(rz, rm, z2);
  const bool ok2 = rn_fits && eq(R.x, rz);

  return r_ok && s_ok && q_ok && on_curve && not_inf && (ok1 || ok2);
}

// Montgomery's batch inverse of x[0..n) (Montgomery form, mod FN), as
// csrc/mont16.cu runs it over a thread block: zero entries take one in the
// products and get zero back; Hillis-Steele prefix and suffix products,
// one Fermat inverse of the total, two products an entry. The inverse is
// unique, so the values equal those of one inversion across the launch.
template <class FN>
BDLS_HD void block_inv(fe* inv, const fe* x, int n, fe* pre, fe* suf) {
  fe one;
  load_one<FN>(one);
  for (int t = 0; t < n; ++t) {
    sel(pre[t], is_zero(x[t]), one, x[t]);
    suf[t] = pre[t];
  }
  for (int d = 1; d < n; d <<= 1) {
    for (int t = n - 1; t >= d; --t) mont_mul<FN>(pre[t], pre[t], pre[t - d]);
    for (int t = 0; t + d < n; ++t) mont_mul<FN>(suf[t], suf[t], suf[t + d]);
  }
  fe total;
  mont_inv<FN>(total, pre[n - 1]);
  for (int t = 0; t < n; ++t) {
    fe a, b, z;
    sel(a, t > 0, t > 0 ? pre[t - 1] : one, one);
    sel(b, t + 1 < n, t + 1 < n ? suf[t + 1] : one, one);
    mont_mul<FN>(a, a, b);
    mont_mul<FN>(a, a, total);
    BDLS_UNROLL
    for (int i = 0; i < 8; ++i) z.v[i] = 0;
    sel(inv[t], is_zero(x[t]), z, a);
  }
}

}  // namespace m16
}  // namespace bdls
