// One ECDSA verify, per lane: the body of the kernel in csrc/verify.cu,
// kept in a header so the host build of the same code
// (tests/test_torch_host_kernel.py) checks it lane for lane against the
// plain PyTorch version.
//
// The verdict is that of bdls_tpu/ops/verify_fold.py:verify_fold:
//   r, s in [1, n); Qx, Qy < p; Q != (0, 0); Q on the curve;
//   R = u1·G + u2·Q != infinity with u1 = e/s, u2 = r/s (mod n);
//   X(R) == r·Z(R) or, where r + n < p, X(R) == (r + n)·Z(R).
// R comes from the generic dual ladder of verify_fold.py:dual_ladder:
// 33 steps of [4 doublings, a signed 4-bit Q-window add] x 2 and one
// 8-bit G-table add, over a per-lane [0..8]·Q table (entry 0 = infinity).
#pragma once

#include "point.cuh"

#ifdef __CUDA_ARCH__
#define BDLS_LDG(p) __ldg(p)
#else
#define BDLS_LDG(p) (*(p))
#endif

namespace bdls {

// Limb k of a (16, B) array of 16-bit limbs held in int32, lane b.
BDLS_HD void load_limbs16(fe& out, const int32_t* a, int b, int B) {
  BDLS_UNROLL
  for (int k = 0; k < 8; ++k) {
    const uint32_t lo = (uint32_t)a[(size_t)(2 * k) * B + b] & 0xFFFFu;
    const uint32_t hi = (uint32_t)a[(size_t)(2 * k + 1) * B + b] & 0xFFFFu;
    out.v[k] = lo | (hi << 16);
  }
}

// Word j of a (j uniform across the warp, not a compile-time constant):
// a select chain keeps `a` in registers instead of local memory.
BDLS_HD uint32_t word_at(const fe& a, int j) {
  uint32_t w = 0;
  BDLS_UNROLL
  for (int k = 0; k < 8; ++k) w = (k == j) ? a.v[k] : w;
  return w;
}

template <class C>
BDLS_HD bool verify_lane(const fe& qx, const fe& qy, const fe& r,
                         const fe& s, const fe& e, const uint32_t* gtab) {
  typedef typename C::P FP;
  typedef typename C::N FN;

  // --- range screens on the raw integers --------------------------------
  const bool r_ok = !is_zero(r) && lt_mod<FN>(r);
  const bool s_ok = !is_zero(s) && lt_mod<FN>(s);
  const bool q_ok = lt_mod<FP>(qx) && lt_mod<FP>(qy) &&
                    !(is_zero(qx) && is_zero(qy));

  // --- u1 = e/s, u2 = r/s (mod n): one Fermat inverse per lane ----------
  fe sm, sinv, u1, u2;
  to_mont<FN>(sm, s);
  mont_inv<FN>(sinv, sm);          // s^-1·R
  mont_mul<FN>(u1, e, sinv);       // e·s^-1, plain form
  mont_mul<FN>(u2, r, sinv);

  // --- Q on the curve: y^2 == x^3 + a·x + b -----------------------------
  fe x, y, one, zero, lhs, rhs, t;
  to_mont<FP>(x, qx);
  to_mont<FP>(y, qy);
  load_one<FP>(one);
  BDLS_UNROLL
  for (int i = 0; i < 8; ++i) zero.v[i] = 0;
  mont_sqr<FP>(lhs, y);
  mont_sqr<FP>(rhs, x);
  mont_mul<FP>(rhs, rhs, x);
  if (!C::a_zero) {                // a = -3
    add_mod<FP>(t, x, x);
    add_mod<FP>(t, t, x);
    sub_mod<FP>(rhs, rhs, t);
  }
  load_b<C>(t);
  add_mod<FP>(rhs, rhs, t);
  const bool on_curve = eq(lhs, rhs);

  // --- per-lane table [0..8]·Q -------------------------------------------
  pt qt[9];
  qt[0].x = zero; qt[0].y = one; qt[0].z = zero;
  qt[1].x = x; qt[1].y = y; qt[1].z = one;
  point_dbl<C>(qt[2], qt[1]);
  BDLS_NOUNROLL
  for (int k = 3; k < 9; ++k) point_add<C>(qt[k], qt[k - 1], qt[1]);

  // --- signed 4-bit digits of u2: w = u2 + 0x88..8 ----------------------
  fe w;
  uint32_t wcarry;
  {
    uint64_t c = 0;
    BDLS_UNROLL
    for (int i = 0; i < 8; ++i) {
      c += (uint64_t)u2.v[i] + 0x88888888u;
      w.v[i] = (uint32_t)c;
      c >>= 32;
    }
    wcarry = (uint32_t)c;
  }

  // --- R = u1·G + u2·Q ---------------------------------------------------
  pt acc;
  acc.x = zero; acc.y = one; acc.z = zero;
  BDLS_NOUNROLL
  for (int k = 0; k < 33; ++k) {
    BDLS_NOUNROLL
    for (int h = 0; h < 3; ++h) {
      pt add;
      if (h < 2) {
        BDLS_NOUNROLL
        for (int d = 0; d < 4; ++d) point_dbl<C>(acc, acc);
        // digit 65 - 2k (h = 0) then 64 - 2k (h = 1), MSB first;
        // digit 65 is 0 and digit 64 the carry nibble of w
        const int i = 65 - 2 * k - h;
        uint32_t mag;
        bool neg = false;
        if (i >= 64) {
          mag = (i == 64) ? wcarry : 0u;
        } else {
          const int nib = (int)((word_at(w, i >> 3) >> ((i & 7) * 4)) & 0xFu) - 8;
          neg = nib < 0;
          mag = (uint32_t)(neg ? -nib : nib);
        }
        add = qt[mag];
        fe ny;
        sub_mod<FP>(ny, zero, add.y);
        BDLS_UNROLL
        for (int j = 0; j < 8; ++j) add.y.v[j] = neg ? ny.v[j] : add.y.v[j];
      } else {
        // byte 32 - k of u1, MSB first (byte 32 is 0)
        const int j = 32 - k;
        const uint32_t byte =
            (j == 32) ? 0u : (word_at(u1, j >> 2) >> ((j & 3) * 8)) & 0xFFu;
        const uint32_t* g = gtab + (size_t)byte * 24;
        BDLS_UNROLL
        for (int l = 0; l < 8; ++l) {
          add.x.v[l] = BDLS_LDG(g + l);
          add.y.v[l] = BDLS_LDG(g + 8 + l);
          add.z.v[l] = BDLS_LDG(g + 16 + l);
        }
      }
      point_add<C>(acc, acc, add);
    }
  }
  const bool not_inf = !is_zero(acc.z);

  // --- x(R) == r (mod n), inversion-free --------------------------------
  fe rm, rz, rn;
  to_mont<FP>(rm, r);
  mont_mul<FP>(rz, rm, acc.z);
  const bool ok1 = eq(acc.x, rz);
  const uint32_t rn_carry = add_m<FN>(rn, r);
  const bool rn_fits = rn_carry == 0 && lt_mod<FP>(rn);
  to_mont<FP>(rm, rn);
  mont_mul<FP>(rz, rm, acc.z);
  const bool ok2 = rn_fits && eq(acc.x, rz);

  return r_ok && s_ok && q_ok && on_curve && not_inf && (ok1 || ok2);
}

}  // namespace bdls
