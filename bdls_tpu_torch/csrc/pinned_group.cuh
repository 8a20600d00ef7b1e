// One pinned-key ECDSA verify a thread group: the lane body of K2's
// builds (csrc/pinned.cu: pinned_kernel and its counting build; the mxu
// build makes each round's products in one K5 call), kept in a header so
// g++ runs the same code a share at a time
// (tests/test_torch_pinned_group.py, tests/test_torch_host_k4k5.py).
//
// The verdict is the reference's bdls_tpu/ops/verify_fold.py:
// verify_fold_pinned: r, s in
// [1, n); slot in [0, cap); R = u1·G + u2·Q != infinity with u1 = e/s,
// u2 = r/s (mod n); X(R) == r·Z(R) or, where r + n < p,
// X(R) == (r + n)·Z(R). Q's own checks ran when it was pinned.
//
// R is a sum of table entries with no doubling, in any order (the
// complete RCB formulas give the same point, and the check does not
// depend on its representation):
//   - secp256k1: the GLV halves u2 = k1 + k2·λ (csrc/glv.cuh), 34 signed
//     digits each: entry 2j + h is position j of half h, x from the
//     pool's x (h = 0) or ψ(Q)'s x (h = 1); then the 32 bytes of u1,
//     g32[j][byte j]: 100 entries;
//   - P-256: u2's signed digits 0..64 (digit 65 is always 0 and left
//     out), then the 32 bytes of u1: 97 entries.
// A Q entry is pool[slot][pos][|d|] with z = (d != 0) and y -> p - y
// for a negative digit (XOR its half's sign); a G entry is
// g32[pos][byte] (x, y, z).
//
// The entries are dealt round-robin to two chains, entry k to chain
// k mod 2; a chain starts as its first entry and adds the rest with the
// group's step rule (csrc/verify_group.cuh: run_step, each complete
// addition three levels of independent Montgomery products, 6, 2 and 6,
// and a finish level of additions that also writes the chain's next
// addend through addend_put, so the addend's L2 read leaves the product
// path). Chain 1 runs a level behind chain 0, so a step holds 6 + 0,
// 2 + 6, 6 + 2 or 0 + 6 products: one round of a group of 8. One
// complete addition joins the chains (a partial sum may be infinity, or
// equal or opposite to the other). Control flow depends on loop counters
// only, never on a digit: every group of a warp runs the same steps.
//
// Before the sum: the binary inverse of s on one share (grp::inv_binary,
// not a Fermat inverse of 384 dependent products; no product) beside
// e·R and r·R mod n and r·R and (r + n)·R mod p; then u1 = s^-1·(e·R)
// and u2 = s^-1·(r·R) (a round of two products); then u2's digit words
// (the GLV split on secp256k1).
#pragma once

#include "verify_group.cuh"

namespace bdls {
namespace grp {

// chains of the pinned sum
constexpr int CHAINS = 2;

// the pinned pool and the G tables (global memory)
struct pin_tabs {
  const uint32_t* px;    // (cap, npos, 9, 8) words each, Montgomery form
  const uint32_t* py;
  const uint32_t* ppsi;  // secp256k1 only
  const uint32_t* g32;   // (32, 256, 3, 8) words
  int cap;
};

// the lane's values. Every field has one writer a step.
struct pin_state {
  fe in[3];            // r, s, e: the raw integers
  fe sinv;             // s^-1 mod n, plain
  fe em[2];            // e·R, r·R mod n
  fe u1, u2;           // e/s, r/s mod n, plain
  fe rm[2];            // r·R, (r + n)·R mod p
  fe rz[2];            // rm·Z(R)
  pt acc[CHAINS];      // each chain's partial sum
  pt add[CHAINS];      // each chain's next addend
  fe sl[CHAINS][15];   // each chain's products: levels 0, 1, 2 at 0, 6, 9
  uint32_t w[10];      // digit words: P-256 u2 + 0x88…8 and its carry;
                       // secp256k1 |k1| + 0x88…8, |k2| + 0x88…8
  int slot;            // the slot, 0 where it is off the pool
  uint8_t slot_ok;     // slot in [0, cap)
  uint8_t screen;      // r, s in [1, n); slot_ok
  uint8_t rn_fits;     // r + n < p
  uint8_t kneg[2];     // the GLV halves' signs
  uint8_t ok;          // the verdict
};

// table entries of the sum and pool positions a key holds
template <class C>
BDLS_HD constexpr int pin_q_entries() { return C::a_zero ? 68 : 65; }
template <class C>
BDLS_HD constexpr int pin_entries() { return pin_q_entries<C>() + 32; }
template <class C>
BDLS_HD constexpr int pin_npos() { return C::a_zero ? 34 : 66; }

// entries of chain c, and the steps of the sum: chain c's op j (adding
// its entry j + 1) runs its levels at steps c + 4j .. c + 4j + 3
template <class C>
BDLS_HD constexpr int chain_len(int c) {
  return (pin_entries<C>() - c + CHAINS - 1) / CHAINS;
}
template <class C>
BDLS_HD constexpr int sum_steps() {
  return 4 * (chain_len<C>(0) - 1) > 1 + 4 * (chain_len<C>(1) - 1)
             ? 4 * (chain_len<C>(0) - 1)
             : 1 + 4 * (chain_len<C>(1) - 1);
}

// entry k of the lane's sum, to be written to dst: a pool entry (x from
// the pool's x or ψ(Q)'s x, y negated by select, z from the digit) or a
// G entry
template <class C>
BDLS_HD addsrc entry_src(const pin_state& st, const pin_tabs& T, int k,
                         pt* dst) {
  addsrc a = no_addend();
  a.dst = dst;
  if (k < pin_q_entries<C>()) {
    int pos;
    uint32_t mag;
    bool neg;
    const uint32_t* xs = T.px;
    if (C::a_zero) {
      const int half = k & 1;
      pos = k >> 1;
      bool nd;
      mag = glv::digit(st.w + 5 * half, pos, nd);
      neg = nd != (st.kneg[half] != 0);
      if (half) xs = T.ppsi;
    } else if (k == 64) {            // the carry nibble, unsigned
      pos = 64;
      mag = st.w[8];
      neg = false;
    } else {
      pos = k;
      const int nib = (int)((st.w[k >> 3] >> ((k & 7) * 4)) & 0xFu) - 8;
      neg = nib < 0;
      mag = (uint32_t)(neg ? -nib : nib);
    }
    const size_t e =
        ((size_t)st.slot * pin_npos<C>() + (size_t)pos) * 9 + mag;
    a.g = xs + e * 8;
    a.gy = T.py + e * 8;
    a.nz = mag != 0;
    a.neg = neg;
  } else {
    const int j = k - pin_q_entries<C>();
    const uint32_t byte = (st.u1.v[j >> 2] >> ((j & 3) * 8)) & 0xFFu;
    a.g = T.g32 + ((size_t)j * 256 + byte) * 24;
  }
  return a;
}

// chain c's addition acc[c] += add[c]
BDLS_HD op chain_op(pin_state& st, int c) {
  return make_op(OP_ADD, &st.acc[c], &st.add[c], &st.acc[c], st.sl[c]);
}

// acc[0] += acc[1]: one complete addition
template <class C>
BDLS_HD void join_chains(const gctx& g, pin_state& st) {
  const op j = make_op(OP_ADD, &st.acc[0], &st.acc[1], &st.acc[0],
                       st.sl[0]);
  run_ops<C>(g, &j, 1);
}

// ------------------------------------------------------------- the body

// Lane b of the (16, B) limb arrays r, s, e and the (B,) slots. Returns
// the verdict; every share of the group returns the same.
template <class C>
BDLS_HD bool verify_pinned_group(const gctx& g, pin_state& st,
                                 const int32_t* r, const int32_t* s,
                                 const int32_t* e, const int32_t* slot,
                                 const pin_tabs& T, int b, int B) {
  typedef typename C::P FP;
  typedef typename C::N FN;

  step(g, 4, [&](int t) {
    if (t < 3) {
      const int32_t* in[3] = {r, s, e};
      load_limbs16(st.in[t], in[t], b, B);
    } else {
      const int k = slot[b];
      const bool ok = k >= 0 && k < T.cap;
      st.slot_ok = ok ? 1 : 0;
      st.slot = ok ? k : 0;
    }
  });

  // e·R and r·R mod n, r·R and (r + n)·R mod p, beside the screens and
  // s^-1 (plain) on one share
  run_tasks(
      g, field_prod<FN, FP>{2}, 4, 1,
      [&](int t, fe& a, fe& b) {
        a = st.in[t == 0 ? 2 : 0];
        if (t == 3) {
          fe rn;
          const uint32_t carry = add_m<FN>(rn, st.in[0]);
          const bool fits = carry == 0 && lt_mod<FP>(rn);
          st.rn_fits = fits ? 1 : 0;
          if (!fits) set_small(rn, 0u);
          a = rn;
        }
        if (t < 2) load_r2<FN>(b);
        else load_r2<FP>(b);
        return t < 2 ? &st.em[t] : &st.rm[t - 2];
      },
      [&](int) {
        const fe rr = st.in[0], ss = st.in[1];
        const bool r_ok = !is_zero(rr) && lt_mod<FN>(rr);
        const bool s_ok = !is_zero(ss) && lt_mod<FN>(ss);
        st.screen = (r_ok && s_ok && st.slot_ok) ? 1 : 0;
        fe a;
        if (s_ok) a = ss;
        else set_small(a, 1u);
        inv_binary<FN>(st.sinv, a);
      });

  // u1 = e·s^-1, u2 = r·s^-1 (plain, fully reduced)
  run_tasks(
      g, field_prod<FN>{0}, 2, 0,
      [&](int t, fe& a, fe& b) {
        a = st.sinv;
        b = st.em[t];
        return t == 0 ? &st.u1 : &st.u2;
      },
      [](int) {});

  // u2's digit words
  step(g, 1, [&](int) {
    if (C::a_zero) {
      uint32_t k1[glv::HALF_WORDS], k2[glv::HALF_WORDS];
      uint32_t w1[glv::HALF_WORDS], w2[glv::HALF_WORDS];
      bool n1, n2;
      glv::decompose(k1, n1, k2, n2, st.u2);
      glv::digit_words(w1, k1);
      glv::digit_words(w2, k2);
      for (int i = 0; i < glv::HALF_WORDS; ++i) {
        st.w[i] = w1[i];
        st.w[5 + i] = w2[i];
      }
      st.kneg[0] = n1 ? 1 : 0;
      st.kneg[1] = n2 ? 1 : 0;
    } else {
      uint64_t c = 0;
      for (int i = 0; i < 8; ++i) {
        c += (uint64_t)st.u2.v[i] + 0x88888888u;
        st.w[i] = (uint32_t)c;
        c >>= 32;
      }
      st.w[8] = (uint32_t)c;
    }
  });

  // each chain's first entry as its sum, its second as its addend
  step(g, 6 * CHAINS, [&](int t) {
    const int c = t / 6, k = t % 6;
    pt* dst = k < 3 ? &st.acc[c] : &st.add[c];
    addend_put<C>(entry_src<C>(st, T, k < 3 ? c : c + CHAINS, dst), k % 3);
  });

  // the sum: chain c's op j adds its entry j + 1 (entry c + (j + 1)·
  // CHAINS), its level 3 writes the entry after
  BDLS_NOUNROLL
  for (int t = 0; t < sum_steps<C>(); ++t) {
    part p[CHAINS];
    BDLS_UNROLL
    for (int c = 0; c < CHAINS; ++c) {
      const int ph = t - c, j = ph >> 2, level = ph & 3;
      const bool on = ph >= 0 && j < chain_len<C>(c) - 1;
      const bool fetch = on && level == 3 && j + 2 < chain_len<C>(c);
      p[c] = make_part(chain_op(st, c), on, level,
                       fetch ? entry_src<C>(st, T, c + (j + 2) * CHAINS,
                                            &st.add[c])
                             : no_addend());
    }
    run_step<C>(g, p[0], p[1]);
  }

  join_chains<C>(g, st);

  // X(R) == r·Z(R) or (r + n)·Z(R)
  rz_step<FP>(g, st.rz, st.rm, st.acc[0].z);
  step(g, 1, [&](int) {
    const pt& R = st.acc[0];
    const bool ok1 = eq(R.x, st.rz[0]);
    const bool ok2 = st.rn_fits && eq(R.x, st.rz[1]);
    st.ok = (st.screen && !is_zero(R.z) && (ok1 || ok2)) ? 1 : 0;
  });
  return st.ok != 0;
}

}  // namespace grp
}  // namespace bdls
