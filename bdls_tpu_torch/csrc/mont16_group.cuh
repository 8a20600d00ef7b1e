// One gen-1 ECDSA verify (K4) a thread group: the lane body of
// csrc/mont16.cu, kept in a header so g++ runs the same code a share at a
// time (tests/test_torch_mont16_group.py, tests/test_torch_host_k4k5.py).
//
// The verdict is that of bdls_tpu/ops/ecdsa.py:verify_kernel with
// field="mont16", inv="batch", ladder="windowed":
//   r, s in [1, n); Qx, Qy < p; Q on the curve and not (0, 0);
//   R = u1·G + u2·Q != infinity with u1 = e/s, u2 = r/s (mod n);
//   X(R) == r·Z(R)^2 or, where r + n < p, X(R) == (r + n)·Z(R)^2.
// The generation is the reference's: the CIOS Montgomery field with
// R = 2^256 (csrc/field.cuh; each product fully reduced, so a value is
// the same words however its products are grouped), Jacobian
// coordinates with dbl-2007-bl, add-2007-bl and madd-2007-bl and the
// reference's selects for an operand at infinity, P == Q and P == -Q
// (csrc/mont16.cuh holds them a thread at a time, the host tests' oracle),
// the per-lane [1..15]·Q table (one doubling, 13 mixed additions), and 64
// windows of 4 doublings and the 4-bit digits of u2 (Q entry) and u1
// (host G entry, device_mont16_table).
//
// GROUP threads carry one lane on the step engine of csrc/verify_group.cuh
// (grp::run_tasks): a step is a set of independent tasks, share k runs
// tasks k, k + GROUP, ..., and __syncwarp ends the step; under g++ the
// shares of a step run one after another, forward or reversed. The lane's
// values live in its m16_state (dynamic shared memory on the card: the
// table too, which one thread a lane had to keep in local memory), 3,336
// bytes, so that 16 one-warp blocks fit an SM.
//
// Each formula is split into levels of independent products (at most 5),
// its operand sums computed by the task that needs them:
//   - a doubling: X^2, Y^2, Z^2, (Y + Z)^2; YY^2, (X + YY)^2 and
//     (X + ZZ)(X - ZZ) (P-256) or M^2 (secp256k1, M = 3XX); M^2 (P-256);
//     M·(S - T): 4 levels on P-256, 3 on secp256k1;
//   - an addition: Z1^2, Z2^2, Y1·Z2, Y2·Z1, (Z1 + Z2)^2; U1, U2, S1, S2;
//     (2H)^2, r^2, Z3, S1·H; J = H·I, V = U1·I, S1·J = (S1·H)·I;
//     r·(V - X3).
//     A mixed addition drops what Z2 = 1 makes needless (12 products in
//     5 levels, against 17). S1·J comes from S1·H so that the last level
//     is one product.
// The task of the last level's product writes the result's Y itself (the
// product policy m16_prod runs m16_post after it: less 8·YYYY or 2·S1·J,
// then the selects), beside two light tasks that write X and Z: a formula
// needs no step of additions after its products. The selects read flags
// (infinity, P == Q) that a light task of level 2 stores.
//
// The ladder, a window at a time: chain 0 doubles the accumulator 4 times,
// then adds the window's sum; chain 1 makes that sum, [dq]·Q + [dg]·G, one
// mixed addition of the G entry into the table entry, in the spare shares
// of the doublings (a G digit of 0 keeps the Q entry, a Q digit of 0 gives
// the G entry). R is the reference's point: (acc + Q entry) + G entry
// became acc + (Q entry + G entry), the same on the curve, but its
// Jacobian representative differs, so the tests compare R in affine form
// against the reference (and word for word against this order run by the
// one-thread formulas). The reason: 5 steps a window fewer (21 a window on
// P-256 instead of 26, 17 on secp256k1 instead of 22), some 1,420 and
// 1,160 steps a verify.
//
// The exceptional double (P == Q) stays off the common path:
//   - chain 1's (Q entry == G entry, e.g. Q = G and u1 = u2) is a
//     doubling of the Q entry beside the mixed addition, in the spare
//     shares, which cost no step;
//   - chain 0's and the table's are a doubling run only when some lane of
//     the warp takes it (__any_sync, a warp-uniform branch, so every group
//     of the warp runs the same steps), between levels 3 and 4, in 4 (or
//     3) steps of their own; honest lanes never take it.
// The steps after the setup are one loop (m16_program) whose every step
// is one m16_run of up to three parts, each part a few bytes (an op's
// kind and level and the indices of its points and products in the lane
// state), so the step code is inlined once.
//
// s^-1 is a binary extended Euclid of s mod n on one share (no Fermat
// chain, no inverse across the block), so u1 and u2 are the reference's
// word for word, and s = 0 or s = n gives 0. Control flow depends only on
// public loop counters and warp-wide votes, so every group of a warp runs
// the same steps.
#pragma once

#include "mont16.cuh"
#include "verify_group.cuh"

namespace bdls {
namespace grp {

using m16::jpt;

// the points of the lane state: the table [1..15]·Q (PT_TAB + k - 1 holds
// k·Q), infinity (0 : 1 : 0), chain 0's accumulator (at the end R), chain
// 1's sum (the window's Q entry + G entry) and an exceptional double
enum { PT_TAB = 0, PT_O = 15, PT_ACC = 16, PT_SUM = 17, PT_DBL = 18,
       PT_N = 19 };
// the products' banks: chain 0's, chain 1's and a doubling's beside or
// after an addition (chain 1's doubling, an exceptional double)
enum { BANK0 = 0, BANK1 = 16, BANKD = 32, SLOTS = 40 };
// before the ladder bank 1 holds the setup's values: the raw inputs (qx,
// qy, r, s, e), (s mod n)^-1 (plain), y^2, x^2, x^3; after it the final
// check's Z(R)^2 and r·Z(R)^2, (r + n)·Z(R)^2
enum { S_IN = BANK1, S_SINV = BANK1 + 5, S_SQ = BANK1 + 6, F_Z2 = BANK1,
       F_RZ = BANK1 + 1 };
// the selects' flags of an addition, stored at its level 2
enum { M16_INF1 = 1, M16_INF2 = 2, M16_SAME = 4 };

// the lane's values. Every field has one writer a step.
struct m16_state {
  fe sm;             // s^-1·R mod n (0 for s = 0 or s = n)
  fe u1, u2;         // e/s, r/s mod n, plain
  fe rm[2];          // r·R, (r + n)·R mod p
  jpt pt[PT_N];      // PT_*; Q in Montgomery form is pt[PT_TAB] (Z = R)
  fe ge[2];          // the window's G entry, x and y
  fe sl[SLOTS];      // the products (BANK*), the setup's values (S_*)
  uint8_t flags[2];  // each chain's M16_* flags
  uint8_t screen;    // r, s in [1, n); Qx, Qy < p; Q != (0, 0)
  uint8_t on_curve;
  uint8_t rn_fits;   // r + n < p
  uint8_t ok;        // the verdict
};

enum { M16_DBL = 1, M16_ADD = 2, M16_MADD = 3, M16_FETCH = 4 };

// one chain's part of a step: an op at a level, by indices into the state
struct m16_part {
  uint8_t kind;      // M16_*; 0: no part
  uint8_t level;
  uint8_t p, out;    // P and the result (PT_*)
  uint8_t q;         // ADD: Q (PT_*)
  uint8_t bank;      // the op's products (BANK*)
  uint8_t chain;     // ADD, MADD: its flags; MADD: its affine Q, the
                     // table's (0) or the G entry (1)
  uint8_t keep;      // MADD: a G digit of 0, the result P
  uint8_t dg;        // FETCH: the G digit
};

BDLS_HD m16_part m16_op(int kind, int level, int p, int out, int bank,
                        int chain = 0, int q = 0) {
  m16_part o;
  o.kind = (uint8_t)kind;
  o.level = (uint8_t)level;
  o.p = (uint8_t)p;
  o.out = (uint8_t)out;
  o.q = (uint8_t)q;
  o.bank = (uint8_t)bank;
  o.chain = (uint8_t)chain;
  o.keep = 0;
  o.dg = 0;
  return o;
}

BDLS_HD m16_part m16_off() { return m16_op(0, 0, 0, 0, 0); }

BDLS_HD const fe& jcoord(const jpt& p, int c) { return (&p.x)[c]; }
BDLS_HD fe& jcoord(jpt& p, int c) { return (&p.x)[c]; }

template <class C>
BDLS_HD constexpr int m16_levels(int kind) {
  return kind == M16_DBL ? (C::a_zero ? 3 : 4) : kind == M16_FETCH ? 1 : 5;
}

template <class C>
BDLS_HD int m16_products(const m16_part& p) {
  if (p.kind == 0 || p.kind == M16_FETCH) return 0;
  const int L = p.level;
  if (p.kind == M16_DBL) return L == 0 ? 4 : L == 1 ? 3 : 1;
  const bool add = p.kind == M16_ADD;
  return L == 0 ? (add ? 5 : 2) : L == 1 ? (add ? 4 : 2)
       : L == 2 ? 4 : L == 3 ? 3 : 1;
}

// light tasks: a FETCH's x and y; a doubling's X and Z at its last level;
// an addition's flags at level 2, X and Z at level 4
template <class C>
BDLS_HD int m16_lights(const m16_part& p) {
  if (p.kind == 0) return 0;
  if (p.kind == M16_FETCH) return 2;
  if (p.kind == M16_DBL)
    return p.level == m16_levels<C>(M16_DBL) - 1 ? 2 : 0;
  return p.level == 2 ? 1 : p.level == 4 ? 2 : 0;
}

// a doubling's S = 2((X + YY)^2 - XX - YYYY) and T = M^2 - 2S
template <class C>
BDLS_HD void m16_st(fe& s, fe& t, const fe* sl) {
  typedef typename C::P F;
  sub_mod<F>(s, sl[5], sl[0]);
  sub_mod<F>(s, s, sl[4]);
  dbl_mod<F>(s, s);
  fe s2;
  dbl_mod<F>(s2, s);
  sub_mod<F>(t, sl[C::a_zero ? 6 : 7], s2);
}

// an addition's X3 = r^2 - J - 2V
template <class C>
BDLS_HD void m16_x3(fe& x3, const fe* sl) {
  typedef typename C::P F;
  fe v2;
  dbl_mod<F>(v2, sl[14]);
  sub_mod<F>(x3, sl[10], sl[13]);
  sub_mod<F>(x3, x3, v2);
}

// a mixed addition's affine Q, x (c = 0) or y
BDLS_HD const fe& m16_qa(const m16_state& st, const m16_part& p, int c) {
  return p.chain ? st.ge[c] : jcoord(st.pt[PT_TAB], c);
}

// The operands a, b of product task t of p; returns where the product
// goes (the result's Y for the last level's task, which m16_post
// finishes). Every task of a level computes the level's few sums and
// picks its operands by value.
template <class C>
BDLS_HD fe* m16_operands(m16_state& st, const m16_part& p, int t, fe& a,
                         fe& b) {
  typedef typename C::P F;
  const jpt& P = st.pt[p.p];
  fe* sl = st.sl + p.bank;
  const int L = p.level;
  if (p.kind == M16_DBL) {
    if (L == 0) {                    // X·X, Y·Y, Z·Z, (Y + Z)^2
      fe yz;
      add_mod<F>(yz, P.y, P.z);
      a = pick(t, P.x, P.y, P.z, yz, yz, yz);
      b = a;
      return sl + t;
    }
    if (L == 1) {
      // YY·YY, (X + YY)^2; P-256 (X + ZZ)·(X - ZZ), secp256k1 M^2
      fe xy, u, v;
      add_mod<F>(xy, P.x, sl[1]);
      if (C::a_zero) {
        tpl_mod<F>(u, sl[0]);
        v = u;
      } else {
        add_mod<F>(u, P.x, sl[2]);
        sub_mod<F>(v, P.x, sl[2]);
      }
      a = pick(t, sl[1], xy, u, u, u, u);
      b = pick(t, sl[1], xy, v, v, v, v);
      return sl + 4 + t;
    }
    fe m;                            // M = 3XX or 3(X + ZZ)(X - ZZ)
    tpl_mod<F>(m, sl[C::a_zero ? 0 : 6]);
    a = m;
    if (!C::a_zero && L == 2) {      // P-256: M^2
      b = m;
      return sl + 7;
    }
    fe s, tt;                        // M·(S - T)
    m16_st<C>(s, tt, sl);
    sub_mod<F>(b, s, tt);
    return &st.pt[p.out].y;
  }
  const bool add = p.kind == M16_ADD;
  if (L == 0) {
    if (add) {                       // Z1^2, Z2^2, Y1·Z2, Y2·Z1, (Z1 + Z2)^2
      const jpt& Q = st.pt[p.q];
      fe zz;
      add_mod<F>(zz, P.z, Q.z);
      a = pick(t, P.z, Q.z, P.y, Q.y, zz, zz);
      b = pick(t, P.z, Q.z, Q.z, P.z, zz, zz);
      return sl + t;
    }
    a = sel(t == 0, P.z, m16_qa(st, p, 1));   // Z1^2, y2·Z1
    b = P.z;
    return sl + (t == 0 ? 0 : 3);
  }
  if (L == 1) {
    if (add) {                       // X1·Z2Z2, X2·Z1Z1, Y1Z2·Z2Z2,
                                     // Y2Z1·Z1Z1
      a = pick(t, P.x, st.pt[p.q].x, sl[2], sl[3], sl[3], sl[3]);
      b = pick(t, sl[1], sl[0], sl[1], sl[0], sl[0], sl[0]);
      return sl + 5 + t;
    }
    a = sel(t == 0, m16_qa(st, p, 0), sl[3]);   // x2·Z1Z1, y2Z1·Z1Z1
    b = sl[0];
    return sl + (t == 0 ? 6 : 8);
  }
  // S1 (Y1 for a mixed addition), r = 2(S2 - S1)
  const fe s1 = sel(add, sl[7], P.y);
  fe rr;
  sub_mod<F>(rr, sl[8], s1);
  dbl_mod<F>(rr, rr);
  if (L == 4) {                      // r·(V - X3); P's X and Z are being
    fe x3;                           // written: read neither
    m16_x3<C>(x3, sl);
    a = rr;
    sub_mod<F>(b, sl[14], x3);
    return &st.pt[p.out].y;
  }
  // U1 (X1 for a mixed addition), H = U2 - U1
  const fe u1 = sel(add, sl[5], P.x);
  fe h;
  sub_mod<F>(h, sl[6], u1);
  if (L == 2) {                      // (2H)^2, r^2, Z3 = zf·H, S1·H
    fe h2, zf;
    dbl_mod<F>(h2, h);
    if (add) {                       // (Z1 + Z2)^2 - Z1Z1 - Z2Z2
      sub_mod<F>(zf, sl[4], sl[0]);
      sub_mod<F>(zf, zf, sl[1]);
    } else {                         // 2·Z1
      dbl_mod<F>(zf, P.z);
    }
    a = pick(t, h2, rr, zf, s1, s1, s1);
    b = pick(t, h2, rr, h, h, h, h);
    return sl + 9 + t;
  }
  a = pick(t, h, u1, sl[12], sl[12], sl[12], sl[12]);   // H·I, U1·I,
  b = sl[9];                                             // (S1·H)·I
  return sl + 13 + t;
}

// coordinate c of an addition's result: the formula's value v, then the
// reference's selects in its order (jadd: P == Q, Q = inf, P = inf;
// jadd_mixed: P == Q, P = inf), then a G digit of 0
template <class C>
BDLS_HD fe m16_select(const m16_state& st, const m16_part& p, int c, fe v) {
  typedef typename C::P F;
  const uint8_t f = st.flags[p.chain];
  const jpt& P = st.pt[p.p];
  v = sel((f & M16_SAME) != 0, jcoord(st.pt[PT_DBL], c), v);
  if (p.kind == M16_ADD) {
    v = sel((f & M16_INF2) != 0, jcoord(P, c), v);
    return sel((f & M16_INF1) != 0, jcoord(st.pt[p.q], c), v);
  }
  fe one;
  load_one<F>(one);
  v = sel((f & M16_INF1) != 0, c < 2 ? m16_qa(st, p, c) : one, v);
  return sel(p.keep != 0, jcoord(P, c), v);
}

// the last level's product v (the result's Y before its last addition)
// finished: a doubling's less 8·YYYY, an addition's less 2·S1·J and its
// selects
template <class C>
BDLS_HD void m16_post(const m16_state& st, const m16_part& p, fe& v) {
  typedef typename C::P F;
  const fe* sl = st.sl + p.bank;
  fe k;
  if (p.kind == M16_DBL) {
    dbl_mod<F>(k, sl[4]);
    dbl_mod<F>(k, k);
    dbl_mod<F>(k, k);
    sub_mod<F>(v, v, k);
    return;
  }
  dbl_mod<F>(k, sl[15]);
  sub_mod<F>(v, v, k);
  v = m16_select<C>(st, p, 1, v);
}

// Light task k of p: a FETCH's x (k = 0) or y; a doubling's X = T or
// Z = (Y + Z)^2 - YY - ZZ; an addition's flags (level 2) or its X3 or Z3
// with the selects (level 4).
template <class C>
BDLS_HD void m16_light(m16_state& st, const uint32_t* gtab,
                       const m16_part& p, int k) {
  typedef typename C::P F;
  const fe* sl = st.sl + p.bank;
  jpt& out = st.pt[p.out];
  if (p.kind == M16_FETCH) {
    load_fe(st.ge[k], gtab + (size_t)p.dg * 16 + 8 * k);
    return;
  }
  if (p.kind == M16_DBL) {
    fe v;
    if (k == 0) {
      fe s;
      m16_st<C>(s, v, sl);
      out.x = v;
    } else {
      sub_mod<F>(v, sl[3], sl[1]);
      sub_mod<F>(v, v, sl[2]);
      out.z = v;
    }
    return;
  }
  if (p.level == 2) {
    const jpt& P = st.pt[p.p];
    const bool add = p.kind == M16_ADD;
    const bool inf1 = is_zero(P.z);
    const bool inf2 = add && is_zero(st.pt[p.q].z);
    const bool same = add ? eq(sl[5], sl[6]) && eq(sl[7], sl[8])
                          : eq(sl[6], P.x) && eq(sl[8], P.y);
    st.flags[p.chain] =
        (uint8_t)((inf1 ? M16_INF1 : 0) | (inf2 ? M16_INF2 : 0) |
                  (same && !inf1 && !inf2 ? M16_SAME : 0));
    return;
  }
  fe v;
  if (k == 0) m16_x3<C>(v, sl);
  else v = sl[11];
  const int c = k == 0 ? 0 : 2;
  jcoord(out, c) = m16_select<C>(st, p, c, v);
}

// The product of every task of the group body (mont_prod's, the vpu
// engine: K4 has no mxu build), then post(s, v) before the store
template <class M, class Post>
struct m16_prod {
  static constexpr bool collective = false;
  const Post* post;
  BDLS_HD void run(fe& dst, const fe& a, const fe& b, int s) const {
    fe t;
    mont_prod<M>{0}.run(t, a, b, s);
    (*post)(s, t);
    dst = t;
  }
};

// One step of up to three parts (chain 0; chain 1's mixed addition and
// its doubling, or its G entry's fetch), through run_tasks. A task's part
// is picked by value, so the operand and light code is inlined once.
template <class C>
BDLS_HD void m16_run(const gctx& g, m16_state& st, const uint32_t* gtab,
                     const m16_part& p0, const m16_part& p1,
                     const m16_part& p2) {
  typedef typename C::P F;
  const int n0 = m16_products<C>(p0), n1 = n0 + m16_products<C>(p1);
  const int n = n1 + m16_products<C>(p2);
  const int l0 = m16_lights<C>(p0), l1 = l0 + m16_lights<C>(p1);
  const int nl = l1 + m16_lights<C>(p2);
  const auto post = [&](int s, fe& v) {
    const int q = s >= n1 ? 2 : s >= n0 ? 1 : 0;
    const m16_part p = q == 2 ? p2 : q == 1 ? p1 : p0;
    const int t = s - (q == 2 ? n1 : q == 1 ? n0 : 0);
    if (t == 0 && p.level == m16_levels<C>(p.kind) - 1)
      m16_post<C>(st, p, v);
  };
  run_tasks(
      g, m16_prod<F, decltype(post)>{&post}, n, nl,
      [&](int s, fe& a, fe& b) {
        const int q = s >= n1 ? 2 : s >= n0 ? 1 : 0;
        const m16_part p = q == 2 ? p2 : q == 1 ? p1 : p0;
        return m16_operands<C>(st, p, s - (q == 2 ? n1 : q == 1 ? n0 : 0),
                               a, b);
      },
      [&](int k) {
        const int q = k >= l1 ? 2 : k >= l0 ? 1 : 0;
        const m16_part p = q == 2 ? p2 : q == 1 ? p1 : p0;
        m16_light<C>(st, gtab, p, k - (q == 2 ? l1 : q == 1 ? l0 : 0));
      });
}

// whether `pred` holds for some lane of the warp (on the host: this lane)
BDLS_HD bool m16_any(const gctx& g, bool pred) {
#ifdef __CUDA_ARCH__
  return __any_sync(g.wmask, pred);
#else
  (void)g;
  return pred;
#endif
}

// Window w's chain 1 at phase ph: -1 the G entry's fetch; 0-4 the levels
// of sum = Q entry + G entry, the Q entry's doubling beside (levels 0-2
// or 0-3). a: the fetch or the mixed addition; b: the doubling or none.
template <class C>
BDLS_HD void m16_chain1(int ph, uint32_t dq, uint32_t dg, m16_part& a,
                        m16_part& b) {
  const int pq = dq ? PT_TAB + (int)dq - 1 : PT_O;
  if (ph < 0) {
    a = m16_op(M16_FETCH, 0, pq, PT_SUM, BANK1, 1);
    a.dg = (uint8_t)dg;
    b = m16_off();
    return;
  }
  a = m16_op(M16_MADD, ph, pq, PT_SUM, BANK1, 1);
  a.keep = dg == 0;
  b = ph < m16_levels<C>(M16_DBL) ? m16_op(M16_DBL, ph, pq, PT_DBL, BANKD)
                                  : m16_off();
}

// The steps after the setup, a loop of one m16_run a step: the table
// ([2..15]·Q: a doubling, 13 mixed additions), then the 64 windows of the
// ladder. An addition alone runs levels 0-3, then P's doubling into
// PT_DBL when some lane of the warp has P == Q, then level 4.
template <class C>
BDLS_HD void m16_program(const gctx& g, m16_state& st,
                         const uint32_t* gtab) {
  constexpr int DL = m16_levels<C>(M16_DBL);
  int k = 1;          // the table entry being built (k·Q at PT_TAB + k);
                      // 15: the ladder
  int w = 0;          // the window
  int op = 0;         // the window's op: 0-3 the doublings, 4 chain 1
                      // alone, 5 the addition
  int level = 0;      // the op's level
  bool exc = false;   // the exceptional double of the addition at hand
  int c1 = -1;        // chain 1's phase: -1 the fetch, 0-4, 5 done
  uint32_t dq = 0, dg = 0;
  BDLS_NOUNROLL
  for (;;) {
    m16_part p0, p1 = m16_off(), p2 = m16_off();
    bool ride = false;
    const bool add_op = k < 15 ? k > 1 : op == 5;
    if (exc) {                       // P of the addition at hand, doubled
      p0 = m16_op(M16_DBL, level, k < 15 ? PT_TAB + k - 1 : PT_ACC, PT_DBL,
                  BANKD);
    } else if (k == 1) {
      p0 = m16_op(M16_DBL, level, PT_TAB, PT_TAB + 1, BANK0);
    } else if (k < 15) {
      p0 = m16_op(M16_MADD, level, PT_TAB + k - 1, PT_TAB + k, BANK0);
    } else if (op == 5) {
      p0 = m16_op(M16_ADD, level, PT_ACC, PT_ACC, BANK0, 0, PT_SUM);
    } else if (op == 4) {
      m16_chain1<C>(c1, dq, dg, p0, p1);
    } else {
      p0 = m16_op(M16_DBL, level, PT_ACC, PT_ACC, BANK0);
      if (c1 < 5) {
        m16_chain1<C>(c1, dq, dg, p1, p2);
        ride = m16_products<C>(p0) + m16_products<C>(p1) +
               m16_products<C>(p2) <= GROUP;
        if (!ride) p1 = p2 = m16_off();
      }
    }
    m16_run<C>(g, st, gtab, p0, p1, p2);

    // the next step
    if (add_op && !exc && level == 3) {
      exc = m16_any(g, (st.flags[0] & M16_SAME) != 0);
      level = exc ? 0 : 4;
      continue;
    }
    if (exc) {
      if (++level == DL) {
        exc = false;
        level = 4;
      }
      continue;
    }
    if (k < 15) {
      if (++level == m16_levels<C>(k == 1 ? M16_DBL : M16_MADD)) {
        level = 0;
        ++k;
      }
      if (k < 15) continue;
    } else if (op == 4) {
      if (++c1 == 5) op = 5;
      continue;
    } else if (op < 4) {
      if (ride) ++c1;
      if (++level == DL) {
        level = 0;
        ++op;
        if (op == 4 && c1 == 5) op = 5;
      }
      continue;
    } else if (++level == 5) {       // the window's addition is done
      if (++w == 64) break;
      level = 0;
    } else {
      continue;
    }
    // a new window (or the first, after the table)
    op = 0;
    c1 = -1;
    dq = m16::nibble_msb(st.u2, w);
    dg = m16::nibble_msb(st.u1, w);
  }
}

// ------------------------------------------------------------- the body

// Loads (t, fe&) sets input t (qx, qy, r, s, e) of the lane; gtab: the
// host [0..15]·G table, (16, 2, 8) words in Montgomery form (entry 0
// unused). Returns the verdict; every share of the group returns the same.
template <class C, class Load>
BDLS_HD bool verify_mont16_group(const gctx& g, m16_state& st,
                                 const Load& load, const uint32_t* gtab) {
  typedef typename C::P FP;
  typedef typename C::N FN;
  fe* in = st.sl + S_IN;
  fe* sq = st.sl + S_SQ;
  jpt& Q = st.pt[PT_TAB];

  step(g, 5, [&](int t) { load(t, in[t]); });

  // Q, r and r + n into Montgomery form mod p beside the screens and
  // (s mod n)^-1 on one share
  run_tasks(
      g, mont_prod<FP>{0}, 4, 1,
      [&](int t, fe& a, fe& b) {
        a = in[t < 2 ? t : 2];
        if (t == 3) {
          fe rn;
          const uint32_t carry = add_m<FN>(rn, in[2]);
          const bool fits = carry == 0 && lt_mod<FP>(rn);
          st.rn_fits = fits ? 1 : 0;
          if (!fits) set_small(rn, 0u);
          a = rn;
        }
        load_r2<FP>(b);
        return t == 0 ? &Q.x : t == 1 ? &Q.y : &st.rm[t - 2];
      },
      [&](int) {
        const fe r = in[2], qx = in[0], qy = in[1];
        fe s = in[3];
        const bool r_ok = !is_zero(r) && lt_mod<FN>(r);
        const bool s_ok = !is_zero(s) && lt_mod<FN>(s);
        const bool q_ok = lt_mod<FP>(qx) && lt_mod<FP>(qy) &&
                          !(is_zero(qx) && is_zero(qy));
        st.screen = (r_ok && s_ok && q_ok) ? 1 : 0;
        if (!lt_mod<FN>(s)) {        // s < 2^256 < 2n: one subtraction
          fe n;
          BDLS_UNROLL
          for (int i = 0; i < 8; ++i) n.v[i] = FN::m(i);
          sub_raw(s, n);
        }
        inv_binary<FN>(st.sl[S_SINV], s);
      });

  // s^-1·R mod n beside y^2 and x^2; Q's Z, infinity and the
  // accumulator's start
  run_tasks(
      g, mont_prod<FN, FP>{1}, 3, 1,
      [&](int t, fe& a, fe& b) {
        if (t == 0) {
          a = st.sl[S_SINV];
          load_r2<FN>(b);
          return &st.sm;
        }
        a = t == 1 ? Q.y : Q.x;
        b = a;
        return &sq[t - 1];
      },
      [&](int) {
        fe one, zero;
        load_one<FP>(one);
        set_small(zero, 0u);
        Q.z = one;
        jpt& o = st.pt[PT_O];
        o.x = zero;
        o.y = one;
        o.z = zero;
        st.pt[PT_ACC] = o;
      });

  // u1 = e·s^-1, u2 = r·s^-1 (plain, fully reduced) mod n, x^3 mod p
  run_tasks(
      g, mont_prod<FN, FP>{2}, 3, 0,
      [&](int t, fe& a, fe& b) {
        a = t == 0 ? in[4] : t == 1 ? in[2] : sq[1];
        b = t < 2 ? st.sm : Q.x;
        return t == 0 ? &st.u1 : t == 1 ? &st.u2 : &sq[2];
      },
      [](int) {});

  // Q on the curve: y^2 == x^3 + a·x + b
  step(g, 1, [&](int) {
    fe rhs = sq[2], u;
    if (!C::a_zero) {                // a = -3
      tpl_mod<FP>(u, Q.x);
      sub_mod<FP>(rhs, rhs, u);
    }
    load_b<C>(u);
    add_mod<FP>(rhs, rhs, u);
    st.on_curve = eq(sq[0], rhs) ? 1 : 0;
  });

  m16_program<C>(g, st, gtab);

  // X(R) == r·Z(R)^2 or (r + n)·Z(R)^2
  const jpt& R = st.pt[PT_ACC];
  run_tasks(
      g, mont_prod<FP>{0}, 1, 0,
      [&](int, fe& a, fe& b) {
        a = R.z;
        b = a;
        return &st.sl[F_Z2];
      },
      [](int) {});
  run_tasks(
      g, mont_prod<FP>{0}, 2, 0,
      [&](int t, fe& a, fe& b) {
        a = st.rm[t];
        b = st.sl[F_Z2];
        return &st.sl[F_RZ + t];
      },
      [](int) {});
  step(g, 1, [&](int) {
    const bool ok1 = eq(R.x, st.sl[F_RZ]);
    const bool ok2 = st.rn_fits && eq(R.x, st.sl[F_RZ + 1]);
    st.ok = (st.screen && st.on_curve && !is_zero(R.z) && (ok1 || ok2))
                ? 1 : 0;
  });
  return st.ok != 0;
}

// K4's lane b of five (16, B) limb arrays
template <class C>
BDLS_HD bool verify_lane_mont16_group(const gctx& g, m16_state& st,
                                      const int32_t* qx, const int32_t* qy,
                                      const int32_t* r, const int32_t* s,
                                      const int32_t* e,
                                      const uint32_t* gtab, int b, int B) {
  return verify_mont16_group<C>(
      g, st,
      [&](int t, fe& v) {
        const int32_t* a = t == 0 ? qx : t == 1 ? qy : t == 2 ? r
                         : t == 3 ? s : e;
        load_limbs16(v, a, b, B);
      },
      gtab);
}

}  // namespace grp
}  // namespace bdls
