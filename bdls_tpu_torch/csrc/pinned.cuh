// One pinned-key ECDSA verify, one thread a lane: the body of the mxu
// build of csrc/pinned.cu (-DBDLS_MUL_MXU; the vpu build runs
// csrc/pinned_group.cuh), kept in a header so the host build of the
// same code (tests/test_torch_host_kernel.py) checks it lane for lane
// against the plain PyTorch version (bdls_tpu_torch/ops/verify_fold.py:
// verify_fold_pinned).
//
// The verdict is that of bdls_tpu/ops/verify_fold.py:verify_fold_pinned:
//   r, s in [1, n); R = u1·G + u2·Q != infinity with u1 = e/s,
//   u2 = r/s (mod n); X(R) == r·Z(R) or, where r + n < p,
//   X(R) == (r + n)·Z(R). A slot outside [0, cap) gives false.
// Q's own checks ran when it was pinned. R is a chain of complete
// additions of position-absolute table entries, with no doubling:
// - secp256k1: u2 = k1 + k2·lambda (csrc/glv.cuh); 17 steps of four Q
//   entries (x then psi_x at position 33 - 2·step, then at
//   32 - 2·step; the sign of an entry is its digit's sign XOR its
//   half's) and two G bytes (positions 2·step and 2·step + 1);
// - P-256: 33 steps of two Q entries (positions 65 - 2·step and
//   64 - 2·step of u2's signed digits) and one G byte (position step).
// A Q entry is pool[slot][pos][|d|] with z = (d != 0) and y -> p - y
// for a negative digit; a G entry is g32[pos][byte] (x, y, z). Adds of
// the always-infinite entries past the last G byte are left out.
#pragma once

#include "glv.cuh"
#include "verify.cuh"

namespace bdls {

// Eight words of one table entry (32-byte aligned in device memory).
BDLS_HD void load_fe(fe& out, const uint32_t* p) {
#ifdef __CUDA_ARCH__
  const uint4 a = __ldg(reinterpret_cast<const uint4*>(p));
  const uint4 b = __ldg(reinterpret_cast<const uint4*>(p) + 1);
  out.v[0] = a.x; out.v[1] = a.y; out.v[2] = a.z; out.v[3] = a.w;
  out.v[4] = b.x; out.v[5] = b.y; out.v[6] = b.z; out.v[7] = b.w;
#else
  for (int l = 0; l < 8; ++l) out.v[l] = p[l];
#endif
}

// Q entry `entry` (a flat index into the pool's (cap·npos·9) entries).
template <class C>
BDLS_HD void pool_entry(pt& out, const uint32_t* xs, const uint32_t* ys,
                        size_t entry, uint32_t mag, bool neg, const fe& one,
                        const fe& zero) {
  typedef typename C::P FP;
  load_fe(out.x, xs + entry * 8);
  load_fe(out.y, ys + entry * 8);
  fe ny;
  sub_mod<FP>(ny, zero, out.y);
  BDLS_UNROLL
  for (int j = 0; j < 8; ++j) {
    out.y.v[j] = neg ? ny.v[j] : out.y.v[j];
    out.z.v[j] = mag ? one.v[j] : 0u;
  }
}

// G byte table entry: g32 is (32, 256, 3, 8) words.
BDLS_HD void g_entry(pt& out, const uint32_t* g32, int pos, uint32_t byte) {
  const uint32_t* g = g32 + ((size_t)pos * 256 + byte) * 24;
  load_fe(out.x, g);
  load_fe(out.y, g + 8);
  load_fe(out.z, g + 16);
}

BDLS_HD uint32_t byte_at(const fe& a, int j) {
  return (word_at(a, j >> 2) >> ((j & 3) * 8)) & 0xFFu;
}

template <class C>
BDLS_HD bool verify_pinned_lane(const fe& r, const fe& s, const fe& e,
                                int slot, int cap, const uint32_t* px,
                                const uint32_t* py, const uint32_t* ppsi,
                                const uint32_t* g32) {
  typedef typename C::P FP;
  typedef typename C::N FN;
  const int npos = C::a_zero ? 34 : 66;

  const bool r_ok = !is_zero(r) && lt_mod<FN>(r);
  const bool s_ok = !is_zero(s) && lt_mod<FN>(s);
  const bool slot_ok = slot >= 0 && slot < cap;
  const size_t base = (size_t)(slot_ok ? slot : 0) * npos;

  // --- u1 = e/s, u2 = r/s (mod n): one Fermat inverse per lane ----------
  fe sm, sinv, u1, u2;
  to_mont<FN>(sm, s);
  mont_inv<FN>(sinv, sm);
  mont_mul<FN>(u1, e, sinv);
  mont_mul<FN>(u2, r, sinv);

  fe one, zero;
  load_one<FP>(one);
  BDLS_UNROLL
  for (int i = 0; i < 8; ++i) zero.v[i] = 0;
  pt acc;
  acc.x = zero; acc.y = one; acc.z = zero;

  if (C::a_zero) {
    // --- secp256k1: GLV halves, 17 steps x (4 Q entries + 2 G bytes) ---
    uint32_t k1[glv::HALF_WORDS], k2[glv::HALF_WORDS];
    uint32_t w1[glv::HALF_WORDS], w2[glv::HALF_WORDS];
    bool k1n, k2n;
    glv::decompose(k1, k1n, k2, k2n, u2);
    glv::digit_words(w1, k1);
    glv::digit_words(w2, k2);
    BDLS_NOUNROLL
    for (int st = 0; st < 17; ++st) {
      BDLS_NOUNROLL
      for (int a = 0; a < 6; ++a) {
        pt add;
        if (a < 4) {
          const int pos = 33 - 2 * st - (a >> 1);
          const bool psi = (a & 1) != 0;
          bool n1, n2;
          const uint32_t m1 = glv::digit(w1, pos, n1);
          const uint32_t m2 = glv::digit(w2, pos, n2);
          const uint32_t mag = psi ? m2 : m1;
          const bool neg = psi ? (n2 != k2n) : (n1 != k1n);
          pool_entry<C>(add, psi ? ppsi : px, py, (base + pos) * 9 + mag,
                        mag, neg, one, zero);
        } else {
          const int j = 2 * st + (a - 4);
          if (j >= 32) continue;
          g_entry(add, g32, j, byte_at(u1, j));
        }
        point_add<C>(acc, acc, add);
      }
    }
  } else {
    // --- P-256: 66 signed digits of u2, 33 steps x (2 Q + 1 G byte) ----
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
    BDLS_NOUNROLL
    for (int st = 0; st < 33; ++st) {
      BDLS_NOUNROLL
      for (int a = 0; a < 3; ++a) {
        pt add;
        if (a < 2) {
          // digit 65 - 2·st (a = 0), then 64 - 2·st; digit 65 is 0 and
          // digit 64 the carry nibble of w
          const int i = 65 - 2 * st - a;
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
          pool_entry<C>(add, px, py, (base + i) * 9 + mag, mag, neg, one,
                        zero);
        } else {
          if (st >= 32) continue;
          g_entry(add, g32, st, byte_at(u1, st));
        }
        point_add<C>(acc, acc, add);
      }
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

  return r_ok && s_ok && slot_ok && not_inf && (ok1 || ok2);
}

}  // namespace bdls
