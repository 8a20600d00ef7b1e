// One Ed25519 verify a thread group: the lane body of K8's builds
// (csrc/ed25519.cu: ed_field in the vpu build, ed_field_mxu, each round's
// products in one K5 call, in the mxu build), kept in a header so g++
// runs the same code a share at a time (tests/test_torch_ed25519_group.py,
// tests/test_torch_host_k4k5.py).
//
// The verdict is the reference's bdls_tpu/ops/ed25519.py:verify_ed25519
// (cofactorless RFC
// 8032 §5.1.7): S < L; A's and R's coordinates < p and on the curve
// (an undecodable point arrives as (0, 0) and fails); [S]B + [k](-A) ==
// R, compared projectively: X == x_R·Z and Y == y_R·Z. k arrives reduced
// mod L, but any k < 2^256 gives the reference's verdict.
//
// GROUP threads carry one lane on the step rule of csrc/verify_group.cuh
// (grp::step, grp::run_tasks): a step is a set of independent tasks,
// share k runs tasks k, k + GROUP, ..., and __syncwarp ends the step;
// under g++ the shares of a step run one after another, forward or
// reversed. Control flow depends on public loop counters only: every
// group of a warp runs the same steps. The lane's values live in its
// ed_state (dynamic shared memory on the card).
//
// Each Edwards formula (a = -1, extended coordinates (X : Y : Z : T)) is
// two levels of independent products:
//   - a doubling (dbl-2008-hwcd, F and H negated as edwards.cuh:ed_dbl):
//     X^2, Y^2, Z^2, (X + Y)^2; then E·F, G·H, F·G, E·H;
//   - an addition (add-2008-hwcd-3) of an addend kept as (Y - X, Y + X,
//     2Z, 2d·T): (Y1 - X1)(Y2 - X2), (Y1 + X1)(Y2 + X2), T1·2dT2,
//     Z1·2Z2; then the same four products. A B entry is affine, (y - x,
//     y + x, 2d·xy), its 2Z the constant 2 (a mixed addition);
// the second level leaves T out where the next op does not read it (a
// doubling reads X, Y, Z only). Every product task of a level computes
// the level's few sums and selects its operands by value, so the shares
// of a warp stay on one path whatever op each chain runs.
//
// Two chains:
//   - chain 0, [k](-A): w = k + 0x88…8 gives 64 signed 4-bit digits and
//     a carry nibble (0 or 1); the chain starts at [carry](-A) (the four
//     doublings of the identity left out), then per digit, most
//     significant first, 4 doublings and the addition of [|d|](±A) from
//     the lane's [0..8]·(-A) table: 320 ops, 640 steps;
//   - chain 1, [S]B: 32 mixed additions of the positioned B entries
//     tab[j][byte j of S], never doubled. Each entry is read from global
//     memory into the lane state by three shares (FETCH, 8 words each)
//     in a step after the addition before it; the last addition's sum is
//     converted to the addend form (CONV) for the join.
// Chain 1 takes the spare shares of chain 0's steps: each of its levels
// rides beside the same level of chain 0 (its FETCH and CONV beside level
// 0), at most 4 + 4 products, one round of a group of 8 or more; it ends
// after 64 of chain 0's 320 ops. One addition joins the chains.
//
// Before the ladder: the screens and the digit words on one share
// beside the four coordinates into the field's form; A's and R's curve
// equations (three levels of products); the table, [2..8]·(-A) in four
// rounds of two ops (2 = 2·1; 3 = 2 + 1, 4 = 2·2; 5 = 4 + 1, 6 = 2·3;
// 7 = 6 + 1, 8 = 2·4), each entry built in place and converted to the
// addend form after its last use as an extended point.
//
// The field: plain form mod p = 2^255 - 19 and a product reduced through
// 2^256 = 38 (mod p) (mul_25519: 64 widening multiplies and a fold,
// against the Montgomery product's 128; in the mxu build K5's 512 bits
// and the same fold); its B table is the plain one.
#pragma once

#include "edwards.cuh"
#include "verify_group.cuh"

namespace bdls {
namespace grp {

static_assert(GROUP >= 8, "chain 1 rides beside chain 0: 4 + 4 products "
                          "a step");

// A 512-bit value in sixteen 64-bit columns T[j] (weight 2^32j, each
// < 2^46: mul_25519's carry-save columns, K5's words) mod p, plain form,
// fully reduced: the high half folded in times 38 (2^256 = 38 mod p)
// before the carries run (a column < 39·2^46 < 2^52), the carry out
// folded again.
BDLS_HD void fold_25519(fe& out, const uint64_t T[16]) {
  uint32_t t[8];
  uint64_t c = 0;
  BDLS_UNROLL
  for (int j = 0; j < 8; ++j) {
    c += T[j] + 38u * T[j + 8];
    t[j] = (uint32_t)c;
    c >>= 32;
  }
  // value = t + c·2^256 = t + 38c (mod p)
  c *= 38u;
  BDLS_UNROLL
  for (int j = 0; j < 8; ++j) {
    c += t[j];
    t[j] = (uint32_t)c;
    c >>= 32;
  }
  // a carry out leaves t < 38·2^20: adding 38 more cannot carry
  t[0] += (uint32_t)c * 38u;
  // bit 255: 2^255 = 19 (mod p), then t < 2^255 + 19 < 2p
  const uint32_t h = t[7] >> 31;
  t[7] &= 0x7FFFFFFFu;
  c = (uint64_t)h * 19u;
  BDLS_UNROLL
  for (int j = 0; j < 8; ++j) {
    c += t[j];
    t[j] = (uint32_t)c;
    c >>= 32;
  }
  reduce_once<P25519>(out, t, 0u);
}

// a·b mod p, plain form, fully reduced: the 512-bit product in carry-save
// columns (each < 2^36), then fold_25519.
BDLS_HD void mul_25519(fe& out, const fe& a, const fe& b) {
  uint64_t T[16];
  BDLS_UNROLL
  for (int j = 0; j < 16; ++j) T[j] = 0;
  BDLS_UNROLL
  for (int i = 0; i < 8; ++i) {
    BDLS_UNROLL
    for (int j = 0; j < 8; ++j) {
      const uint64_t p = (uint64_t)a.v[j] * b.v[i];
      T[i + j] += (uint32_t)p;
      T[i + j + 1] += p >> 32;
    }
  }
  fold_25519(out, T);
}

#ifdef __CUDA_ARCH__
// a·b mod p by K5's call (csrc/mxu.cuh), every thread of the warp calling
// (by value and inlined, as mxu::mont_mul_warp)
__device__ __forceinline__ fe mul_25519_warp(const fe a, const fe b,
                                          unsigned active) {
  uint64_t T[16];
  mxu::warp_columns(T, a, b, active);
  fe out;
  fold_25519(out, T);
  return out;
}
#endif

// x mod p for any x < 2^256, plain form
BDLS_HD void reduce_25519(fe& out, const fe& x) {
  uint32_t t[8];
  uint64_t c = (uint64_t)(x.v[7] >> 31) * 19u;
  BDLS_UNROLL
  for (int j = 0; j < 8; ++j) {
    c += j == 7 ? (x.v[7] & 0x7FFFFFFFu) : x.v[j];
    t[j] = (uint32_t)c;
    c >>= 32;
  }
  reduce_once<P25519>(out, t, 0u);
}

// The field of the group body: its product (the product policy of
// run_tasks), the form the inputs take, its constants 1, d and 2d.
struct ed_field {
  static constexpr bool collective = false;
  static BDLS_HD void mul(fe& out, const fe& a, const fe& b) {
    mul_25519(out, a, b);
  }
  static BDLS_HD void from_int(fe& out, const fe& x) { reduce_25519(out, x); }
  static BDLS_HD void one(fe& out) { set_small(out, 1u); }
  static BDLS_HD void d2(fe& out) {
    const uint32_t t[8] = BDLS_L8(0x26B2F159u, 0xEBD69B94u, 0x8283B156u,
                                  0x00E0149Au, 0xEEF3D130u, 0x198E80F2u,
                                  0x56DFFCE7u, 0x2406D9DCu);
    BDLS_UNROLL
    for (int i = 0; i < 8; ++i) out.v[i] = t[i];
  }
  static BDLS_HD void d(fe& out) {
    const uint32_t t[8] = BDLS_L8(0x135978A3u, 0x75EB4DCAu, 0x4141D8ABu,
                                  0x00700A4Du, 0x7779E898u, 0x8CC74079u,
                                  0x2B6FFE73u, 0x52036CEEu);
    BDLS_UNROLL
    for (int i = 0; i < 8; ++i) out.v[i] = t[i];
  }
  static BDLS_HD void run(fe& dst, const fe& a, const fe& b, int) {
    fe t;
    mul(t, a, b);
    dst = t;
  }
};

// ed_field on K5: the same forms and constants, each round's products
// through one warp-collective call, then fold_25519 (the mxu builds)
struct ed_field_mxu : ed_field {
  static constexpr bool collective = true;
#ifdef __CUDA_ARCH__
  __device__ fe warp(const fe& a, const fe& b, unsigned active, int) const {
    return mul_25519_warp(a, b, active);
  }
#else
  void host(fe out[32], const fe a[32], const fe b[32], unsigned active,
            const int*) const {
    uint64_t T[32][16];
    mxu::warp_columns_host(T, a, b, active);
    for (int k = 0; k < 32; ++k)
      if ((active >> k) & 1u) fold_25519(out[k], T[k]);
  }
#endif
};

// the field of the build's engine
#ifdef BDLS_MUL_MXU
typedef ed_field_mxu ed_engine;
#else
typedef ed_field ed_engine;
#endif

// the lane's values. Every field has one writer a step.
struct ed_state {
  fe in[6];         // ax, ay, rx, ry, s, k: the raw integers
  fe pm[4];         // ax, ay, rx, ry in the field's form
  fe oc[2][3];      // A's, R's x^2, y^2, then d·x^2·y^2
  ept tab[9];       // [0..8]·(-A) as (Y - X, Y + X, 2Z, 2d·T); extended
                    // while it is built
  ept acc[2];       // chain 0 ([k](-A)), chain 1 ([S]B), extended
  ept bq;           // chain 1's addend: a B entry (y - x, y + x, -,
                    // 2d·xy), at the end chain 1's sum as an addend
  fe sl[2][4];      // each chain's first-level products
  fe rz[2];         // x_R·Z, y_R·Z
  uint32_t w[9];    // the digit words of k + 0x88…8 and its carry nibble
  uint8_t screen;   // S < L; A's and R's coordinates < p
  uint8_t ok;       // the verdict
};

// ------------------------------------------------ the formulas as levels

enum { ED_DBL = 1, ED_ADD = 2, ED_MADD = 3, ED_CONV = 4, ED_FETCH = 5 };

struct ed_op {
  int kind;
  const ept* p;        // DBL, ADD, MADD: the point (extended); CONV: the
                       // point converted
  const ept* q;        // ADD: an addend (Y - X, Y + X, 2Z, 2d·T); MADD: a
                       // B entry
  ept* out;            // the result; CONV: the addend form; FETCH: the
                       // entry's slot
  fe* sl;              // the first level's products
  const uint32_t* g;   // FETCH: the B entry in global memory (24 words)
  bool neg;            // ADD: the addend negated
  bool want_t;         // the second level computes T
};

// one chain's part of a step: o at `level`
struct ed_part {
  ed_op o;
  int level;
  bool on;             // false: no part
};

BDLS_HD fe& ecoord(ept* p, int c) { return (&p->x)[c]; }

BDLS_HD ed_op ed_make(int kind, const ept* p, const ept* q, ept* out, fe* sl,
                      bool want_t) {
  ed_op o;
  o.kind = kind;
  o.p = p;
  o.q = q;
  o.out = out;
  o.sl = sl;
  o.g = nullptr;
  o.neg = false;
  o.want_t = want_t;
  return o;
}

BDLS_HD ed_part ed_at(const ed_op& o, int level, bool on = true) {
  ed_part p;
  p.o = o;
  p.level = level;
  p.on = on;
  return p;
}

BDLS_HD int ed_products(const ed_part& p) {
  if (!p.on || p.o.kind == ED_FETCH) return 0;
  if (p.o.kind == ED_CONV) return 1;
  return p.level == 0 || p.o.want_t ? 4 : 3;
}

BDLS_HD int ed_lights(const ed_part& p) {
  if (!p.on) return 0;
  return p.o.kind == ED_FETCH ? 3 : p.o.kind == ED_CONV ? 2 : 0;
}

BDLS_HD fe pick4(int t, const fe& v0, const fe& v1, const fe& v2,
                 const fe& v3) {
  fe r;
  BDLS_UNROLL
  for (int i = 0; i < 8; ++i)
    r.v[i] = t == 0 ? v0.v[i] : t == 1 ? v1.v[i] : t == 2 ? v2.v[i]
                                                          : v3.v[i];
  return r;
}

// The operands a, b of product task t of p; returns the product's slot.
template <class Fd>
BDLS_HD fe* ed_operands(const ed_part& p, int t, fe& a, fe& b) {
  typedef P25519 F;
  const ed_op& o = p.o;
  if (o.kind == ED_CONV) {           // 2d·T
    a = o.p->t;
    Fd::d2(b);
    return &o.out->t;
  }
  if (p.level == 0) {
    const ept& P = *o.p;
    fe m, s;
    sub_mod<F>(m, P.y, P.x);
    add_mod<F>(s, P.y, P.x);
    if (o.kind == ED_DBL) {          // X^2, Y^2, Z^2, (X + Y)^2
      a = pick4(t, P.x, P.y, P.z, s);
      b = a;
    } else {
      // (Y1 - X1)·(Y2 - X2), (Y1 + X1)·(Y2 + X2), T1·2dT2, Z1·2Z2; the
      // addend negated swaps Y - X and Y + X and negates 2dT
      const ept& Q = *o.q;
      fe nt, two;
      set_small(nt, 0u);
      sub_mod<F>(nt, nt, Q.t);
      Fd::one(two);
      add_mod<F>(two, two, two);
      a = pick4(t, m, s, P.t, P.z);
      b = pick4(t, sel(o.neg, Q.y, Q.x), sel(o.neg, Q.x, Q.y),
                sel(o.neg, nt, Q.t), sel(o.kind == ED_MADD, two, Q.z));
    }
    return o.sl + t;
  }
  // E, F, G, H from the first level, then X = E·F, Y = G·H, Z = F·G,
  // T = E·H. Doubling: E = (X+Y)^2 - (X^2 + Y^2), F = 2Z^2 - G,
  // G = Y^2 - X^2, H = X^2 + Y^2; addition: E = B - A, F = D - C,
  // G = D + C, H = B + A.
  const fe* sl = o.sl;
  const bool dbl = o.kind == ED_DBL;
  fe u, v, e, f, g, z2;
  sub_mod<F>(u, sl[1], sl[0]);
  add_mod<F>(v, sl[1], sl[0]);
  sub_mod<F>(e, sl[3], v);
  dbl_mod<F>(z2, sl[2]);
  sub_mod<F>(f, sel(dbl, z2, sl[3]), sel(dbl, u, sl[2]));
  add_mod<F>(g, sl[3], sl[2]);
  e = sel(dbl, e, u);
  g = sel(dbl, u, g);
  a = pick4(t, e, g, f, e);
  b = pick4(t, f, v, g, v);
  return &ecoord(o.out, t);
}

// Light task k of p: FETCH's coordinate k (y - x, y + x, 2d·xy) of the
// B entry; CONV's Y - X and Y + X (k = 0) or 2Z (k = 1).
BDLS_HD void ed_light(const ed_part& p, int k) {
  typedef P25519 F;
  const ed_op& o = p.o;
  if (o.kind == ED_FETCH) {
    load_fe(ecoord(o.out, k == 2 ? 3 : k), o.g + 8 * k);
  } else if (k == 0) {
    fe m, s;
    sub_mod<F>(m, o.p->y, o.p->x);
    add_mod<F>(s, o.p->y, o.p->x);
    o.out->x = m;
    o.out->y = s;
  } else {
    fe z;
    dbl_mod<F>(z, o.p->z);
    o.out->z = z;
  }
}

// One step of two chains' parts through run_tasks, each task's part
// picked by value (one inlined copy of the operand and light code).
template <class Fd>
BDLS_HD void ed_step(const gctx& g, const ed_part& p0, const ed_part& p1) {
  const int n0 = ed_products(p0), n = n0 + ed_products(p1);
  const int l0 = ed_lights(p0), nl = l0 + ed_lights(p1);
  run_tasks(
      g, Fd{}, n, nl,
      [&](int s, fe& a, fe& b) {
        const bool q = s >= n0;
        const ed_part p = q ? p1 : p0;
        return ed_operands<Fd>(p, q ? s - n0 : s, a, b);
      },
      [&](int k) {
        const bool q = k >= l0;
        const ed_part p = q ? p1 : p0;
        ed_light(p, q ? k - l0 : k);
      });
}

// both levels of o, and of o1 beside it when `two`
template <class Fd>
BDLS_HD void ed_ops(const gctx& g, const ed_op& o, const ed_op& o1,
                    bool two) {
  for (int level = 0; level < 2; ++level)
    ed_step<Fd>(g, ed_at(o, level), ed_at(o1, level, two));
}

// ------------------------------------------------------------ the chains

// chain 0's ops, and the steps of the ladder
constexpr int ED_Q_OPS = 64 * 5;

// op i of chain 0: digit 63 - i / 5, four doublings then the addition;
// T is wanted before an addition reads it (the fourth doubling's) and
// from the last addition, which the join reads
BDLS_HD ed_op ed_q_op(ed_state& st, int i) {
  const int d = 63 - i / 5, k = i % 5;
  ed_op o = ed_make(k < 4 ? ED_DBL : ED_ADD, &st.acc[0], nullptr,
                    &st.acc[0], st.sl[0], k == 3 || (k == 4 && d == 0));
  if (k == 4) {
    const int nib = (int)((st.w[d >> 3] >> ((d & 7) * 4)) & 0xFu) - 8;
    o.q = &st.tab[nib < 0 ? -nib : nib];
    o.neg = nib < 0;
  }
  return o;
}

// chain 1's op j at phase ph: 0 and 1 the levels of acc[1] += B entry j
// (in st.bq), 2 the read of entry j + 1 into st.bq or, after the last
// addition, acc[1] into st.bq as an addend; 3 nothing
BDLS_HD ed_part ed_b_part(ed_state& st, const uint32_t* btab, int j,
                          int ph) {
  ed_op o = ed_make(ED_MADD, &st.acc[1], &st.bq, &st.acc[1], st.sl[1],
                    true);
  if (ph < 2) return ed_at(o, ph);
  if (j < 31) {
    const int n = j + 1;
    const uint32_t byte = (st.in[4].v[n >> 2] >> ((n & 3) * 8)) & 0xFFu;
    o.kind = ED_FETCH;
    o.out = &st.bq;
    o.g = btab + ((size_t)n * 256 + byte) * 24;
  } else {
    o.kind = ED_CONV;
    o.out = &st.bq;
  }
  return ed_at(o, 0, ph == 2);
}

// ------------------------------------------------------------- the body

// Lane b of the six (16, B) limb arrays ax, ay, rx, ry, s, k; btab: the
// (32, 256, 3, 8) positioned B tables (y - x, y + x, 2d·xy) in the
// field's form. Returns the verdict; every share of the group returns
// the same.
template <class Fd>
BDLS_HD bool verify_ed25519_group(const gctx& g, ed_state& st,
                                  const int32_t* ax, const int32_t* ay,
                                  const int32_t* rx, const int32_t* ry,
                                  const int32_t* s, const int32_t* k,
                                  const uint32_t* btab, int b, int B) {
  typedef P25519 F;

  // an input picked by value: no pointer array in local memory
  step(g, 6, [&](int t) {
    const int32_t* a = t == 0 ? ax : t == 1 ? ay : t == 2 ? rx
                     : t == 3 ? ry : t == 4 ? s : k;
    load_limbs16(st.in[t], a, b, B);
  });

  // the screens and k's digit words; the coordinates into the field's
  // form; B entry 0 (byte 0 of S); the identity as entry 0 and as
  // chain 1's start
  step(g, 9, [&](int t) {
    fe a;
    if (t == 0) {
      const bool rng = lt_mod<F>(st.in[0]) && lt_mod<F>(st.in[1]) &&
                       lt_mod<F>(st.in[2]) && lt_mod<F>(st.in[3]);
      st.screen = (rng && lt_mod<Ed25519L>(st.in[4])) ? 1 : 0;
      uint64_t c = 0;
      for (int i = 0; i < 8; ++i) {
        c += (uint64_t)st.in[5].v[i] + 0x88888888u;
        st.w[i] = (uint32_t)c;
        c >>= 32;
      }
      st.w[8] = (uint32_t)c;
    } else if (t < 5) {
      Fd::from_int(a, st.in[t - 1]);
      st.pm[t - 1] = a;
    } else if (t < 8) {
      const uint32_t byte = st.in[4].v[0] & 0xFFu;
      load_fe(a, btab + byte * 24 + 8 * (t - 5));
      ecoord(&st.bq, t == 7 ? 3 : t - 5) = a;
    } else {
      fe one, zero;
      Fd::one(one);
      set_small(zero, 0u);
      ept& e = st.tab[0];
      e.x = one;
      e.y = one;
      add_mod<F>(e.z, one, one);
      e.t = zero;
      st.acc[1].x = zero;
      st.acc[1].y = one;
      st.acc[1].z = one;
      st.acc[1].t = zero;
    }
  });

  // A's and R's x^2, y^2; entry 1 = -A extended, T = (-x)·y; chain 0's
  // start [carry](-A) (a doubling comes next: no T)
  run_tasks(
      g, Fd{}, 5, 1,
      [&](int t, fe& a, fe& b) {
        fe nx, zero;
        set_small(zero, 0u);
        sub_mod<F>(nx, zero, st.pm[0]);
        a = t < 4 ? st.pm[t] : nx;
        b = st.pm[t < 4 ? t : 1];
        return t < 4 ? &st.oc[t >> 1][t & 1] : &st.tab[1].t;
      },
      [&](int) {
        fe nx, one, zero;
        set_small(zero, 0u);
        sub_mod<F>(nx, zero, st.pm[0]);
        Fd::one(one);
        st.tab[1].x = nx;
        st.tab[1].y = st.pm[1];
        st.tab[1].z = one;
        const bool c = st.w[8] != 0;
        st.acc[0].x = sel(c, nx, zero);
        st.acc[0].y = sel(c, st.pm[1], one);
        st.acc[0].z = one;
      });
  // x^2·y^2, then d·x^2·y^2
  run_tasks(
      g, Fd{}, 2, 0,
      [&](int t, fe& a, fe& b) {
        a = st.oc[t][0];
        b = st.oc[t][1];
        return &st.oc[t][2];
      },
      [](int) {});
  run_tasks(
      g, Fd{}, 2, 0,
      [&](int t, fe& a, fe& b) {
        a = st.oc[t][2];
        Fd::d(b);
        return &st.oc[t][2];
      },
      [](int) {});

  // [2..8]·(-A), in place; entry 1 converted beside 2 = 2·1's second
  // level, the others once built
  {
    ept* T = st.tab;
    const ed_op c1 = ed_make(ED_CONV, &T[1], nullptr, &T[1], nullptr,
                             false);
    const ed_op d2 = ed_make(ED_DBL, &T[1], nullptr, &T[2], st.sl[0], true);
    ed_step<Fd>(g, ed_at(d2, 0), ed_at(c1, 0, false));
    ed_step<Fd>(g, ed_at(d2, 1), ed_at(c1, 0));
    ed_ops<Fd>(g, ed_make(ED_ADD, &T[2], &T[1], &T[3], st.sl[0], true),
               ed_make(ED_DBL, &T[2], nullptr, &T[4], st.sl[1], true), true);
    ed_ops<Fd>(g, ed_make(ED_ADD, &T[4], &T[1], &T[5], st.sl[0], true),
               ed_make(ED_DBL, &T[3], nullptr, &T[6], st.sl[1], true), true);
    ed_ops<Fd>(g, ed_make(ED_ADD, &T[6], &T[1], &T[7], st.sl[0], true),
               ed_make(ED_DBL, &T[4], nullptr, &T[8], st.sl[1], true), true);
    run_tasks(
        g, Fd{}, 7, 7,
        [&](int t, fe& a, fe& b) {
          a = T[2 + t].t;
          Fd::d2(b);
          return &T[2 + t].t;
        },
        [&](int t) {
          ept& e = T[2 + t];
          fe m, s, z;
          sub_mod<F>(m, e.y, e.x);
          add_mod<F>(s, e.y, e.x);
          dbl_mod<F>(z, e.z);
          e.x = m;
          e.y = s;
          e.z = z;
        });
  }

  // the ladder: chain 0's ops, chain 1's phases in the spare shares (a
  // phase at every level of its parity: two of chain 0's ops an entry)
  int bj = 0, bph = 0;
  BDLS_NOUNROLL
  for (int i = 0; i < ED_Q_OPS; ++i) {
    const ed_op q = ed_q_op(st, i);
    BDLS_NOUNROLL
    for (int lq = 0; lq < 2; ++lq) {
      ed_part p1 = ed_b_part(st, btab, bj < 32 ? bj : 31, bph);
      const bool ride = bj < 32 && (bph & 1) == lq;
      p1.on = p1.on && ride;
      ed_step<Fd>(g, ed_at(q, lq), p1);
      if (ride && ++bph == 4) {
        bph = 0;
        ++bj;
      }
    }
  }

  // [k](-A) + [S]B, then X == x_R·Z and Y == y_R·Z
  {
    const ed_op j = ed_make(ED_ADD, &st.acc[0], &st.bq, &st.acc[0],
                            st.sl[0], false);
    ed_ops<Fd>(g, j, j, false);
  }
  run_tasks(
      g, Fd{}, 2, 0,
      [&](int t, fe& a, fe& b) {
        a = st.pm[2 + t];
        b = st.acc[0].z;
        return &st.rz[t];
      },
      [](int) {});
  step(g, 1, [&](int) {
    fe one;
    Fd::one(one);
    bool curve = true;
    for (int c = 0; c < 2; ++c) {    // -x^2 + y^2 == 1 + d·x^2·y^2
      fe lhs, rhs;
      sub_mod<F>(lhs, st.oc[c][1], st.oc[c][0]);
      add_mod<F>(rhs, one, st.oc[c][2]);
      curve = curve && eq(lhs, rhs);
    }
    const ept& U = st.acc[0];
    st.ok = (st.screen && curve && eq(U.x, st.rz[0]) && eq(U.y, st.rz[1]))
                ? 1 : 0;
  });
  return st.ok != 0;
}

}  // namespace grp
}  // namespace bdls
