// The one-thread Ed25519 formulas over the Montgomery field of
// csrc/field.cuh (p = 2^255 - 19), extended coordinates (X : Y : Z : T),
// T = XY/Z: the unified addition (add-2008-hwcd-3, complete since a = -1
// is a square mod p and d is not), the mixed addition of a positioned B
// entry kept as (y - x, y + x, 2d·xy) in plain form, the doubling, as the
// reference's ed25519.py has them. K8's body (csrc/edwards_group.cuh)
// splits the same formulas into levels of a thread group; the host tests
// (tests/test_torch_ed25519_group.py) hold its levels against these.
#pragma once

#include "verify.cuh"

namespace bdls {

struct ept {
  fe x, y, z, t;
};

// L, the prime order of B (only compared against: S < L).
struct Ed25519L {
  static BDLS_HD uint32_t m(int i) {
    const uint32_t t[8] = BDLS_L8(0x5CF5D3EDu, 0x5812631Au, 0xA2F79CD6u,
                                  0x14DEF9DEu, 0x00000000u, 0x00000000u,
                                  0x00000000u, 0x10000000u);
    return t[i];
  }
};

// 2d·R mod p (Montgomery form).
BDLS_HD void ed_load_2d(fe& out) {
  const uint32_t t[8] = BDLS_L8(0xBE8FD3F4u, 0x01DB17FDu, 0x5F8C52E7u,
                                0x21430EEFu, 0x78310D20u, 0xCB27240Fu,
                                0xE53F8A4Du, 0x590456B4u);
  BDLS_UNROLL
  for (int i = 0; i < 8; ++i) out.v[i] = t[i];
}

// Unified addition, a = -1 (add-2008-hwcd-3), 9 products.
BDLS_HD void ed_add(ept& out, const ept& p, const ept& q, const fe& k2d) {
  typedef P25519 F;
  fe a, b, c, d, e, f, g, h, t0, t1;
  sub_mod<F>(t0, p.y, p.x);
  sub_mod<F>(t1, q.y, q.x);
  mont_mul<F>(a, t0, t1);
  add_mod<F>(t0, p.y, p.x);
  add_mod<F>(t1, q.y, q.x);
  mont_mul<F>(b, t0, t1);
  mont_mul<F>(t0, p.t, k2d);
  mont_mul<F>(c, t0, q.t);
  mont_mul<F>(t0, p.z, q.z);
  add_mod<F>(d, t0, t0);
  sub_mod<F>(e, b, a);
  sub_mod<F>(f, d, c);
  add_mod<F>(g, d, c);
  add_mod<F>(h, b, a);
  mont_mul<F>(out.x, e, f);
  mont_mul<F>(out.y, g, h);
  mont_mul<F>(out.z, f, g);
  mont_mul<F>(out.t, e, h);
}

// Mixed addition of a B entry kept as (y - x, y + x, 2d·xy) in plain
// form, Z = 1 (add-2008-hwcd-3 with D = 2·Z1), 8 products. A product by
// a plain value comes out divided by R, and so does D, a product by the
// plain 2: every coordinate of the sum comes out divided by R^2, the same
// projective point.
BDLS_HD void ed_madd(ept& out, const ept& p, const fe& ymx, const fe& ypx,
                     const fe& t2d) {
  typedef P25519 F;
  fe a, b, c, d, e, f, g, h, t0;
  sub_mod<F>(t0, p.y, p.x);
  mont_mul<F>(a, t0, ymx);
  add_mod<F>(t0, p.y, p.x);
  mont_mul<F>(b, t0, ypx);
  mont_mul<F>(c, p.t, t2d);
  BDLS_UNROLL
  for (int i = 0; i < 8; ++i) t0.v[i] = i == 0 ? 2u : 0u;
  mont_mul<F>(d, p.z, t0);
  sub_mod<F>(e, b, a);
  sub_mod<F>(f, d, c);
  add_mod<F>(g, d, c);
  add_mod<F>(h, b, a);
  mont_mul<F>(out.x, e, f);
  mont_mul<F>(out.y, g, h);
  mont_mul<F>(out.z, f, g);
  mont_mul<F>(out.t, e, h);
}

// Doubling, a = -1 (dbl-2008-hwcd), 4 squares and 4 products; F and H
// negated as in ed25519.py:ed_dbl (the same projective point).
BDLS_HD void ed_dbl(ept& out, const ept& p) {
  typedef P25519 F;
  fe a, b, c, e, g, fn, hn, t0;
  mont_sqr<F>(a, p.x);
  mont_sqr<F>(b, p.y);
  mont_sqr<F>(t0, p.z);
  add_mod<F>(c, t0, t0);
  add_mod<F>(t0, p.x, p.y);
  mont_sqr<F>(e, t0);
  add_mod<F>(hn, a, b);
  sub_mod<F>(e, e, hn);            // 2XY
  sub_mod<F>(g, b, a);
  sub_mod<F>(fn, c, g);
  mont_mul<F>(out.x, e, fn);
  mont_mul<F>(out.y, g, hn);
  mont_mul<F>(out.z, fn, g);
  mont_mul<F>(out.t, e, hn);
}

}  // namespace bdls
