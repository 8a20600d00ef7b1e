// One Ed25519 verify, per lane: the body of K8 (csrc/ed25519.cu), kept
// in a header so the host build of the same code
// (tests/test_torch_host_kernel.py) checks it lane for lane against the
// plain PyTorch version and the RFC 8032 oracle.
//
// The verdict is that of bdls_tpu/ops/ed25519.py:verify_ed25519
// (cofactorless RFC 8032 §5.1.7):
//   S < L; A and R: coordinates < p and on the curve
//   -x^2 + y^2 = 1 + d x^2 y^2 (undecodable points arrive as (0, 0));
//   [S]B + [k](-A) == R, compared projectively: X == x_R·Z, Y == y_R·Z.
// k arrives reduced mod L from the host, so L is only a range constant.
//
// Extended coordinates (X : Y : Z : T), T = XY/Z, over the Montgomery
// field of csrc/field.cuh with p = 2^255 - 19. a = -1 is a square mod p
// and d is not, so the unified addition (add-2008-hwcd-3, constant 2d)
// is complete: the ladder needs no branch on the points. The ladder is
// ed25519.py:ed_dual_ladder's: 33 steps of 2 x (4 doublings + one
// signed 4-bit add from a per-lane [0..8]·(-A) table), and S's 32 bytes
// from positioned tables tab[j][d] = (d·2^{8j})·B, affine and kept as
// (y - x, y + x, 2d·xy) (plain form, as the group body reads them),
// added into a second accumulator that is never doubled.
//
// K8's vpu build runs the group body of csrc/edwards_group.cuh; this
// one-thread body is the mxu build's (K5's mont_mul).
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

// d·R and 2d·R mod p (Montgomery form).
BDLS_HD void ed_load_d(fe& out) {
  const uint32_t t[8] = BDLS_L8(0xDF47E9FAu, 0x80ED8BFEu, 0xAFC62973u,
                                0x10A18777u, 0xBC188690u, 0xE5939207u,
                                0x729FC526u, 0x2C822B5Au);
  BDLS_UNROLL
  for (int i = 0; i < 8; ++i) out.v[i] = t[i];
}

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

// -x^2 + y^2 == 1 + d·x^2·y^2 for Montgomery-form x, y.
BDLS_HD bool ed_on_curve(const fe& x, const fe& y) {
  typedef P25519 F;
  fe x2, y2, lhs, rhs, d, one;
  mont_sqr<F>(x2, x);
  mont_sqr<F>(y2, y);
  sub_mod<F>(lhs, y2, x2);
  mont_mul<F>(rhs, x2, y2);
  ed_load_d(d);
  mont_mul<F>(rhs, rhs, d);
  load_one<F>(one);
  add_mod<F>(rhs, rhs, one);
  return eq(lhs, rhs);
}

// ax, ay, rx, ry, s, k: the lane's raw 256-bit inputs. btab: the 32
// positioned B tables, (32, 256, 3, 8) words, (y - x, y + x, 2d·xy) in
// plain form (ed_madd reads them as they are).
BDLS_HD bool verify_lane_ed25519(const fe& ax, const fe& ay, const fe& rx,
                                 const fe& ry, const fe& s, const fe& k,
                                 const uint32_t* btab) {
  typedef P25519 F;

  // --- range screens on the raw integers --------------------------------
  const bool s_ok = lt_mod<Ed25519L>(s);
  const bool a_rng = lt_mod<F>(ax) && lt_mod<F>(ay);
  const bool r_rng = lt_mod<F>(rx) && lt_mod<F>(ry);

  fe x, y, one, zero, k2d;
  to_mont<F>(x, ax);
  to_mont<F>(y, ay);
  load_one<F>(one);
  ed_load_2d(k2d);
  BDLS_UNROLL
  for (int i = 0; i < 8; ++i) zero.v[i] = 0;
  const bool a_curve = ed_on_curve(x, y);
  fe xr, yr;
  to_mont<F>(xr, rx);
  to_mont<F>(yr, ry);
  const bool r_curve = ed_on_curve(xr, yr);

  // --- per-lane table [0..8]·(-A) ----------------------------------------
  ept qt[9];
  qt[0].x = zero; qt[0].y = one; qt[0].z = one; qt[0].t = zero;
  sub_mod<F>(qt[1].x, zero, x);
  qt[1].y = y;
  qt[1].z = one;
  mont_mul<F>(qt[1].t, qt[1].x, y);
  ed_dbl(qt[2], qt[1]);
  BDLS_NOUNROLL
  for (int j = 3; j < 9; ++j) ed_add(qt[j], qt[j - 1], qt[1], k2d);

  // --- signed 4-bit digits of k: w = k + 0x88..8 ------------------------
  fe w;
  uint32_t wcarry;
  {
    uint64_t c = 0;
    BDLS_UNROLL
    for (int i = 0; i < 8; ++i) {
      c += (uint64_t)k.v[i] + 0x88888888u;
      w.v[i] = (uint32_t)c;
      c >>= 32;
    }
    wcarry = (uint32_t)c;
  }

  // --- [k](-A) into accq, [S]B into accb ---------------------------------
  ept accq, accb;
  accq = qt[0];
  accb = qt[0];
  BDLS_NOUNROLL
  for (int st = 0; st < 33; ++st) {
    BDLS_NOUNROLL
    for (int h = 0; h < 2; ++h) {
      BDLS_NOUNROLL
      for (int dd = 0; dd < 4; ++dd) ed_dbl(accq, accq);
      // digit 65 - 2·st (h = 0) then 64 - 2·st (h = 1), MSB first;
      // digit 65 is 0 and digit 64 the carry nibble of w
      const int i = 65 - 2 * st - h;
      uint32_t mag;
      bool neg = false;
      if (i >= 64) {
        mag = (i == 64) ? wcarry : 0u;
      } else {
        const int nib =
            (int)((word_at(w, i >> 3) >> ((i & 7) * 4)) & 0xFu) - 8;
        neg = nib < 0;
        mag = (uint32_t)(neg ? -nib : nib);
      }
      ept add = qt[mag];
      fe nx, nt;
      sub_mod<F>(nx, zero, add.x);
      sub_mod<F>(nt, zero, add.t);
      BDLS_UNROLL
      for (int j = 0; j < 8; ++j) {
        add.x.v[j] = neg ? nx.v[j] : add.x.v[j];
        add.t.v[j] = neg ? nt.v[j] : add.t.v[j];
      }
      ed_add(accq, accq, add, k2d);
    }
    if (st < 32) {
      // byte st of S from the positioned table st
      const uint32_t byte = (word_at(s, st >> 2) >> ((st & 3) * 8)) & 0xFFu;
      const uint32_t* g = btab + ((size_t)st * 256 + byte) * 24;
      fe e[3];
      BDLS_UNROLL
      for (int c = 0; c < 3; ++c) {
        BDLS_UNROLL
        for (int l = 0; l < 8; ++l) e[c].v[l] = BDLS_LDG(g + 8 * c + l);
      }
      ed_madd(accb, accb, e[0], e[1], e[2]);
    }
  }
  ept u;
  ed_add(u, accq, accb, k2d);

  // --- X == x_R·Z and Y == y_R·Z -----------------------------------------
  fe rz;
  mont_mul<F>(rz, xr, u.z);
  const bool ok_x = eq(u.x, rz);
  mont_mul<F>(rz, yr, u.z);
  const bool ok_y = eq(u.y, rz);

  return s_ok && a_rng && r_rng && a_curve && r_curve && ok_x && ok_y;
}

}  // namespace bdls
