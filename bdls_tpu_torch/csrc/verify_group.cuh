// One ECDSA verify a thread group: the lane body of K1 (csrc/verify.cu)
// and of K7's lane kernel (csrc/block.cu) on both engines, kept in a
// header so g++ runs the same code a share at a time
// (tests/test_torch_verify_group.py, tests/test_torch_host_k4k5.py).
//
// The verdict is the reference's bdls_tpu/ops/verify_fold.py:
// verify_fold: r, s in [1, n); Qx, Qy < p;
// Q != (0, 0); Q on the curve; R = u1·G + u2·Q != infinity; X(R) == r·Z(R)
// or, where r + n < p, X(R) == (r + n)·Z(R).
//
// GROUP threads carry one lane. The lane's values live in its
// lane_state (shared memory on the card): the inputs, the [0..8]·Q table
// (and ψ(Q)'s x on secp256k1), two accumulators and their products. The
// work is a sequence of steps; a step is a set of tasks, task s run by
// share s mod GROUP. On the card thread k of the group runs share k and
// __syncwarp() ends the step; on the host (g++) the shares of a step run
// one after another, forward or in reverse (host_reverse). The tasks of
// a step write distinct values and read none that another task of the
// step writes, so every order gives the same values. Control flow
// depends on nothing but public loop counters, so every group of a warp
// runs the same steps.
//
// A task is mostly one Montgomery product, made by the build's product
// policy (field_prod: mont_mul_cs on the share's own thread in the vpu
// builds, one K5 call of the warp a round in the mxu builds, whose
// every thread reaches every round): each complete
// RCB formula (csrc/point.cuh, the same values operation for operation)
// is split into three levels of independent products (op_operands) and
// a finish level of three additions (op_finish), which also writes the
// chain's next addend into the lane state (addend_put). Two chains run
// side by side:
//   - chain 0, u2·Q on the doubling chain: P-256 the 66 signed 4-bit
//     digits of u2 (the top one, 0, left out; 256 doublings); secp256k1
//     the GLV halves u2 = k1 + k2·λ (csrc/glv.cuh), 34 digits each, x
//     and ψ(Q) = (β·X : Y : Z) entries (132 doublings), as the
//     reference's dual_ladder_glv;
//   - chain 1, u1·G with no doubling: 32 complete additions of the
//     positioned byte tables g32[j][byte j of u1] (K2's table, (x, y, z)
//     an entry);
// chain 1 takes a step's spare shares: its next level rides along
// whenever both chains' products fit in one round of the group. One
// complete addition joins them. s^-1 comes from a binary extended
// Euclid on one share (a Fermat inverse would be 384 dependent
// products), beside K7's SHA-256 on another; neither has a product.
#pragma once

#include <type_traits>

#include "pinned.cuh"

#ifndef BDLS_VERIFY_GROUP
#define BDLS_VERIFY_GROUP 8
#endif

namespace bdls {
namespace grp {

// threads a lane; a group never spans two warps
constexpr int GROUP = BDLS_VERIFY_GROUP;
static_assert(GROUP >= 1 && GROUP <= 32 && 32 % GROUP == 0,
              "GROUP must divide a warp");

#ifndef __CUDA_ARCH__
// the host build's share order within a step (the tests run both)
inline bool& host_reverse() {
  static bool reverse = false;
  return reverse;
}
#endif

struct gctx {
  int share;        // this thread's share, 0..GROUP-1 (card only)
  unsigned wmask;   // the warp's threads, for __syncwarp (card only)
};

#ifdef __CUDACC__
// the threads of the calling thread's warp that exist in its block
__device__ __forceinline__ unsigned warp_mask() {
  const int n = min(32, (int)blockDim.x - (int)(threadIdx.x & ~31u));
  return n == 32 ? 0xFFFFFFFFu : (1u << n) - 1u;
}
#endif

// the static shared memory of the build's product (K5's buffers in the
// mxu builds), on top of the lanes' states
#ifdef BDLS_MUL_MXU
constexpr size_t STATIC_SMEM =
    sizeof(uint32_t) * mxu::WARP_WORDS * BDLS_MXU_WARPS;
#else
constexpr size_t STATIC_SMEM = 0;
#endif

// whether a block of `threads` threads (whole lanes) suits the build's
// product: in the mxu builds whole warps, at most BDLS_MXU_WARPS
inline bool block_fits(int threads) {
#ifdef BDLS_MUL_MXU
  return threads % 32 == 0 && threads <= 32 * BDLS_MXU_WARPS;
#else
  return threads > 0;
#endif
}

// whether a thread stores its lane's verdict and votes in K10's count
// (mesh.cuh:count_epilogue): share 0 of a live lane, so a lane counts
// once however many threads carry it
BDLS_HD bool votes(int share, bool live) { return live && share == 0; }

// one step of ntask tasks: share k runs tasks k, k + GROUP, ...
template <class F>
BDLS_HD void step(const gctx& g, int ntask, const F& f) {
#ifdef __CUDA_ARCH__
  for (int s = g.share; s < ntask; s += GROUP) f(s);
  __syncwarp(g.wmask);
#else
  (void)g;
  const bool rev = host_reverse();
  for (int k0 = 0; k0 < GROUP; ++k0) {
    const int k = rev ? GROUP - 1 - k0 : k0;
    for (int s = k; s < ntask; s += GROUP) f(s);
  }
#endif
}

// the lane's values. Every field has one writer a step.
struct lane_state {
  fe in[5];          // qx, qy, r, s, e: the raw integers
  fe sinv;           // s^-1 mod n, plain
  fe sm;             // s^-1·R mod n
  fe u1, u2;         // e/s, r/s mod n, plain
  fe xm, ym;         // Q in Montgomery form mod p
  fe sq[3];          // y^2, x^2, x^3
  fe rm[2];          // r·R, (r + n)·R mod p
  fe rz[2];          // rm·Z(R)
  pt tab[9];         // [0..8]·Q, entry 0 = (0 : 1 : 0)
  fe psi[9];         // β·X of each entry (secp256k1)
  pt acc[2];         // chain 0 (u2·Q), chain 1 (u1·G)
  pt add[2];         // each chain's next addend
  fe sl[2][15];      // each chain's products: levels 0, 1, 2 at 0, 6, 9
  uint32_t w[10];    // digit words: P-256 u2 + 0x88…8 and its carry;
                     // secp256k1 |k1| + 0x88…8, |k2| + 0x88…8
  uint8_t screen;    // r, s in [1, n); Qx, Qy < p; Q != (0, 0)
  uint8_t on_curve;
  uint8_t rn_fits;   // r + n < p
  uint8_t kneg[2];   // the GLV halves' signs
  uint8_t ok;        // the verdict
};

// ------------------------------------------------------------- helpers

// secp256k1's β (β^3 = 1 mod p, ψ(x, y) = (β·x, y) = λ·(x, y)) times
// 2^256 mod p: Montgomery form
BDLS_WORDS(BetaMont, 8, 0x8E81894Eu, 0x58A4361Cu, 0x1C4B80AFu, 0x03FDE163u,
           0xD02E3905u, 0xF8E98978u, 0xBCBB3D53u, 0x7A4A36AEu)

// Montgomery product a·b·2^-256 mod M (a·b < M·2^256, fully reduced
// out, the value of field.cuh's mont_mul), CIOS with the running sum in
// carry-save form: nine 64-bit column sums T[j] of 32-bit parts, so the
// products of a round do not wait on each other's carries; a round's one
// dependent chain is q = T[0]·n0 and the shift by a limb. A column takes
// at most 4 parts a round for at most 9 rounds: < 2^38. More
// instructions than CIOS's carry chain, a far shorter dependent path:
// the trade a latency-bound launch wants.
template <class M>
BDLS_HD void mont_mul_cs(fe& out, const fe& a, const fe& b) {
  uint64_t T[9];
  BDLS_UNROLL
  for (int j = 0; j < 9; ++j) T[j] = 0;
  BDLS_UNROLL
  for (int i = 0; i < 8; ++i) {
    BDLS_UNROLL
    for (int j = 0; j < 8; ++j) {
      const uint64_t p = (uint64_t)a.v[j] * b.v[i];
      T[j] += (uint32_t)p;
      T[j + 1] += p >> 32;
    }
    const uint32_t q = (uint32_t)T[0] * M::N0;
    BDLS_UNROLL
    for (int j = 0; j < 8; ++j) {
      const uint64_t p = (uint64_t)q * M::m(j);
      T[j] += (uint32_t)p;
      T[j + 1] += p >> 32;
    }
    // T[0] mod 2^32 is 0 now: divide by 2^32
    T[1] += T[0] >> 32;
    BDLS_UNROLL
    for (int j = 0; j < 8; ++j) T[j] = T[j + 1];
    T[8] = 0;
  }
  uint32_t t[8];
  uint64_t c = 0;
  BDLS_UNROLL
  for (int j = 0; j < 8; ++j) {
    c += T[j];
    t[j] = (uint32_t)c;
    c >>= 32;
  }
  reduce_once<M>(out, t, (uint32_t)c);
}

// every product of the group body
template <class M>
BDLS_HD void mul_to(fe& dst, fe a, fe b) {
  fe t;
  mont_mul_cs<M>(t, a, b);
  dst = t;
}

template <class M>
BDLS_HD void dbl_mod(fe& out, const fe& a) { add_mod<M>(out, a, a); }

template <class M>
BDLS_HD void tpl_mod(fe& out, const fe& a) {
  fe t;
  add_mod<M>(t, a, a);
  add_mod<M>(out, t, a);
}

BDLS_HD void set_small(fe& a, uint32_t x) {
  BDLS_UNROLL
  for (int i = 0; i < 8; ++i) a.v[i] = i ? 0u : x;
}

BDLS_HD bool is_one(const fe& a) {
  uint32_t acc = a.v[0] ^ 1u;
  BDLS_UNROLL
  for (int i = 1; i < 8; ++i) acc |= a.v[i];
  return acc == 0;
}

// a >= b, as integers
BDLS_HD bool geq(const fe& a, const fe& b) {
  uint64_t borrow = 0;
  BDLS_UNROLL
  for (int i = 0; i < 8; ++i) {
    const uint64_t d = (uint64_t)a.v[i] - b.v[i] - borrow;
    borrow = (d >> 63) & 1;
  }
  return borrow == 0;
}

// a -= b, as integers (a >= b)
BDLS_HD void sub_raw(fe& a, const fe& b) {
  uint64_t borrow = 0;
  BDLS_UNROLL
  for (int i = 0; i < 8; ++i) {
    const uint64_t d = (uint64_t)a.v[i] - b.v[i] - borrow;
    a.v[i] = (uint32_t)d;
    borrow = (d >> 63) & 1;
  }
}

// a >>= 1, with `top` shifted in at bit 255
BDLS_HD void shr1(fe& a, uint32_t top) {
  BDLS_UNROLL
  for (int i = 0; i < 7; ++i) a.v[i] = (a.v[i] >> 1) | (a.v[i + 1] << 31);
  a.v[7] = (a.v[7] >> 1) | (top << 31);
}

// x / 2 mod M, x < M
template <class M>
BDLS_HD void half_mod(fe& x) {
  if (x.v[0] & 1u) {
    const uint32_t carry = add_m<M>(x, x);
    shr1(x, carry);
  } else {
    shr1(x, 0u);
  }
}

// a^-1 mod M, plain form, for 0 < a < M (M an odd prime): the binary
// extended Euclid, x1·a == u and x2·a == v (mod M) throughout. a = 0
// gives 0.
template <class M>
BDLS_HD void inv_binary(fe& out, const fe& a) {
  if (is_zero(a)) {
    out = a;
    return;
  }
  fe u = a, v, x1, x2;
  BDLS_UNROLL
  for (int i = 0; i < 8; ++i) v.v[i] = M::m(i);
  set_small(x1, 1u);
  set_small(x2, 0u);
  BDLS_NOUNROLL
  while (!is_one(u) && !is_one(v)) {
    if (!(u.v[0] & 1u)) {
      shr1(u, 0u);
      half_mod<M>(x1);
    } else if (!(v.v[0] & 1u)) {
      shr1(v, 0u);
      half_mod<M>(x2);
    } else if (geq(u, v)) {
      sub_raw(u, v);
      sub_mod<M>(x1, x1, x2);
    } else {
      sub_raw(v, u);
      sub_mod<M>(x2, x2, x1);
    }
  }
  out = is_one(u) ? x1 : x2;
}

// --------------------------------------------- the formulas as levels
//
// An op is one complete doubling or addition of csrc/point.cuh. Levels
// 0-2 are independent Montgomery products (op_products of them); level 3
// the three coordinates of the result, additions only. A level reads the
// op's inputs (level 0) or its own earlier products, never what its own
// level writes; the result goes to `out`, which may be p1. A product task
// picks its two operands (op_operands: every task of a level computes the
// level's few sums, then selects, so the shares of a warp stay on one
// path; a sum that only some tasks computed would issue apart for them),
// then runs the one product code every share runs.

enum { OP_DBL = 1, OP_ADD = 2 };

struct op {
  int kind;
  const pt* p1;
  const pt* p2;      // the addend (OP_ADD)
  pt* out;
  fe* sl;            // products: level 0 at 0..5, 1 at 6..8, 2 at 9..14
};

// where the chain's next addend comes from, written to dst at the end of
// the op before it (light tasks of level 3)
struct addsrc {
  pt* dst;              // nullptr: nothing to write
  const pt* p;          // a table entry of the lane state, or
  const uint32_t* g;    // an entry in global memory: a G byte-table entry
                        // (x, y, z: 24 words), or a pinned pool entry's x
  const uint32_t* gy;   // a pool entry's y words (nullptr: not a pool one)
  const fe* x;          // the entry's x replaced (ψ(Q)), or nullptr
  bool neg;             // y -> p - y
  bool nz;              // a pool entry's z: 1 (its digit != 0) or 0
};

BDLS_HD const fe& coord(const pt* p, int c) { return (&p->x)[c]; }
BDLS_HD fe& coord(pt* p, int c) { return (&p->x)[c]; }

template <class C>
BDLS_HD int op_products(int kind, int level) {
  if (level >= 3) return 0;
  if (kind == OP_ADD) return level == 1 ? 2 : 6;
  if (C::a_zero) return level == 1 ? 1 : 4;
  return level == 0 ? 6 : level == 1 ? 3 : 4;
}

// value selects, word by word: the values stay in registers
BDLS_HD fe sel(bool c, const fe& v1, const fe& v0) {
  fe r;
  BDLS_UNROLL
  for (int i = 0; i < 8; ++i) r.v[i] = c ? v1.v[i] : v0.v[i];
  return r;
}

BDLS_HD fe pick(int t, const fe& v0, const fe& v1, const fe& v2,
                const fe& v3, const fe& v4, const fe& v5) {
  fe r;
  BDLS_UNROLL
  for (int i = 0; i < 8; ++i)
    r.v[i] = t == 0 ? v0.v[i] : t == 1 ? v1.v[i] : t == 2 ? v2.v[i]
           : t == 3 ? v3.v[i] : t == 4 ? v4.v[i] : v5.v[i];
  return r;
}

// The operands a, b of product task t of o's level (0-2); returns the
// slot the product goes to.
template <class C>
BDLS_HD fe* op_operands(const op& o, int level, int t, fe& a, fe& b) {
  typedef typename C::P F;
  const fe* sl = o.sl;
  fe k, x, y;
  if (level == 0) {
    if (o.kind == OP_ADD) {
      // X1X2, Y1Y2, Z1Z2, (X1+Y1)(X2+Y2), (Y1+Z1)(Y2+Z2), (X1+Z1)(X2+Z2)
      const int i = (t == 1 || t == 4) ? 1 : t == 2 ? 2 : 0;
      const int j = t < 3 ? t : t == 3 ? 1 : 2;
      x = coord(o.p1, j);
      y = coord(o.p2, j);
      if (t < 3) {
        set_small(x, 0u);
        set_small(y, 0u);
      }
      add_mod<F>(a, coord(o.p1, i), x);
      add_mod<F>(b, coord(o.p2, i), y);
    } else if (C::a_zero) {
      // Y·Y, Y·Z, Z·Z, X·Y
      const int i = t == 2 ? 2 : t == 3 ? 0 : 1;
      const int j = (t == 0 || t == 3) ? 1 : 2;
      a = coord(o.p1, i);
      b = coord(o.p1, j);
    } else {
      // X·X, Y·Y, Z·Z, X·Y, X·Z, Y·Z
      const int i = t < 3 ? t : t == 5 ? 1 : 0;
      const int j = t < 3 ? t : t == 3 ? 1 : 2;
      a = coord(o.p1, i);
      b = coord(o.p1, j);
    }
    return o.sl + t;
  }
  if (level == 1) {
    if (C::a_zero) load_b3<C>(k);
    else load_b<C>(k);
    if (o.kind == OP_ADD) {          // b·m2, b·(m5 - m0 - m2)
      add_mod<F>(x, sl[0], sl[2]);
      sub_mod<F>(x, sl[5], x);
      a = k;
      b = sel(t == 0, sl[2], x);
    } else if (C::a_zero) {          // 3b·Z^2
      a = k;
      b = sl[2];
    } else {                         // b·Z^2, b·2XZ, 2YZ·Y^2
      dbl_mod<F>(x, sl[4]);
      dbl_mod<F>(y, sl[5]);
      a = sel(t == 2, y, k);
      b = pick(t, sl[2], x, sl[1], sl[1], sl[1], sl[1]);
    }
    return o.sl + 6 + t;
  }
  if (o.kind == OP_ADD && C::a_zero) {
    // t4·y3, t3·t1, y3·t0, t1·z3, t0·t3, z3·t4 (RCB Algorithm 7)
    fe t4, t3, t1, z3, t0;
    add_mod<F>(x, sl[1], sl[2]);
    sub_mod<F>(t4, sl[4], x);
    add_mod<F>(x, sl[0], sl[1]);
    sub_mod<F>(t3, sl[3], x);
    sub_mod<F>(t1, sl[1], sl[6]);
    add_mod<F>(z3, sl[1], sl[6]);
    tpl_mod<F>(t0, sl[0]);
    a = pick(t, t4, t3, sl[7], t1, t0, z3);
    b = pick(t, sl[7], t1, t0, z3, t3, t4);
  } else if (o.kind == OP_ADD) {
    // RCB Algorithm 4: y3a = m5 - m0 - m2, xa = 3(y3a - n0),
    // z3a = m1 - xa, x3a = m1 + xa, yb = 3(n1 - 3m2 - m0),
    // t0 = 3m0 - 3m2, t4 = m4 - m1 - m2, t3 = m3 - m0 - m1;
    // t4·yb, t0·yb, x3a·z3a, t3·x3a, t4·z3a, t3·t0
    fe xa, z3a, x3a, yb, t0, t4, t3, m23;
    add_mod<F>(x, sl[0], sl[2]);
    sub_mod<F>(x, sl[5], x);
    sub_mod<F>(x, x, sl[6]);
    tpl_mod<F>(xa, x);
    sub_mod<F>(z3a, sl[1], xa);
    add_mod<F>(x3a, sl[1], xa);
    tpl_mod<F>(m23, sl[2]);
    sub_mod<F>(x, sl[7], m23);
    sub_mod<F>(x, x, sl[0]);
    tpl_mod<F>(yb, x);
    tpl_mod<F>(t0, sl[0]);
    sub_mod<F>(t0, t0, m23);
    add_mod<F>(x, sl[1], sl[2]);
    sub_mod<F>(t4, sl[4], x);
    add_mod<F>(x, sl[0], sl[1]);
    sub_mod<F>(t3, sl[3], x);
    a = pick(t, t4, t0, x3a, t3, t4, t3);
    b = pick(t, yb, yb, z3a, x3a, z3a, t0);
  } else if (C::a_zero) {
    // RCB Algorithm 9: n0·8Y^2, YZ·8Y^2, t0·(Y^2 + n0), t0·XY with
    // t0 = Y^2 - 3n0
    fe z3, t0;
    dbl_mod<F>(z3, sl[0]);
    dbl_mod<F>(z3, z3);
    dbl_mod<F>(z3, z3);
    add_mod<F>(y, sl[0], sl[6]);
    tpl_mod<F>(x, sl[6]);
    sub_mod<F>(t0, sl[0], x);
    a = pick(t, sl[6], sl[1], t0, t0, t0, t0);
    b = pick(t, z3, z3, y, sl[3], sl[3], sl[3]);
  } else {
    // RCB Algorithm 6: ya = 3(n0 - 2XZ), xa = Y^2 - ya, yb = Y^2 + ya,
    // zb = 3(n1 - 3Z^2 - X^2), t0 = 3X^2 - 3Z^2; xa·yb, xa·2XY, t0·zb,
    // 2YZ·zb
    fe xa, yb, zb, t0, z23;
    dbl_mod<F>(x, sl[4]);
    sub_mod<F>(x, sl[6], x);
    tpl_mod<F>(x, x);
    sub_mod<F>(xa, sl[1], x);
    add_mod<F>(yb, sl[1], x);
    tpl_mod<F>(z23, sl[2]);
    sub_mod<F>(x, sl[7], z23);
    sub_mod<F>(x, x, sl[0]);
    tpl_mod<F>(zb, x);
    tpl_mod<F>(t0, sl[0]);
    sub_mod<F>(t0, t0, z23);
    dbl_mod<F>(x, sl[3]);
    dbl_mod<F>(y, sl[5]);
    a = pick(t, xa, xa, t0, y, y, y);
    b = pick(t, yb, x, zb, zb, zb, zb);
  }
  return o.sl + 9 + t;
}

// Light task t (0 x, 1 y, 2 z) of o's level 3: the result's coordinate.
template <class C>
BDLS_HD void op_finish(const op& o, int t) {
  typedef typename C::P F;
  const fe* sl = o.sl;
  fe v;
  if (o.kind == OP_ADD) {
    const int i = C::a_zero ? (t == 0 ? 10 : t == 1 ? 12 : 14)
                            : (t == 0 ? 12 : t == 1 ? 11 : 13);
    const int j = C::a_zero ? (t == 0 ? 9 : t == 1 ? 11 : 13)
                            : (t == 0 ? 9 : t == 1 ? 10 : 14);
    if (t == 0) sub_mod<F>(v, sl[i], sl[j]);
    else add_mod<F>(v, sl[i], sl[j]);
  } else if (C::a_zero) {            // 2·t0·XY, n0·8Y^2 + t0·y3a, YZ·8Y^2
    if (t == 0) dbl_mod<F>(v, sl[12]);
    else if (t == 1) add_mod<F>(v, sl[9], sl[11]);
    else v = sl[10];
  } else {        // xa·2XY - 2YZ·zb, xa·yb + t0·zb, 4·(2YZ·Y^2)
    if (t == 0) {
      sub_mod<F>(v, sl[10], sl[12]);
    } else if (t == 1) {
      add_mod<F>(v, sl[9], sl[11]);
    } else {
      dbl_mod<F>(v, sl[8]);
      dbl_mod<F>(v, v);
    }
  }
  coord(o.out, t) = v;
}

// Light task c of an addsrc: coordinate c of the next addend.
template <class C>
BDLS_HD void addend_put(const addsrc& a, int c) {
  typedef typename C::P FP;
  fe v;
  if (a.gy) {                        // a pool entry (csrc/pinned_group.cuh)
    fe one, zero;
    set_small(zero, 0u);
    if (c == 0) {
      load_fe(v, a.g);
    } else if (c == 1) {
      fe y, ny;
      load_fe(y, a.gy);
      sub_mod<FP>(ny, zero, y);
      v = sel(a.neg, ny, y);
    } else {
      load_one<FP>(one);
      v = sel(a.nz, one, zero);
    }
  } else if (a.g) {
    load_fe(v, a.g + 8 * c);
  } else if (c == 0) {
    v = a.x ? *a.x : a.p->x;
  } else if (c == 1) {
    const fe y = a.p->y;
    fe zero;
    set_small(zero, 0u);
    if (a.neg) sub_mod<FP>(v, zero, y);
    else v = y;
  } else {
    v = a.p->z;
  }
  coord(a.dst, c) = v;
}

// one chain's part of a step: op o at `level`; at level 3 also the next
// addend's three coordinates
struct part {
  op o;
  bool on;           // false: no part
  int level;
  addsrc next;
};

template <class C>
BDLS_HD int part_products(const part& p) {
  return p.on ? op_products<C>(p.o.kind, p.level) : 0;
}

template <class C>
BDLS_HD int part_lights(const part& p) {
  if (!p.on || p.level < 3) return 0;
  return p.next.dst ? 6 : 3;
}

template <class C>
BDLS_HD void part_light(const part& p, int k) {
  if (k < 3) op_finish<C>(p.o, k);
  else addend_put<C>(p.next, k - 3);
}

// The products of the group bodies' steps, one policy an engine:
// - mont_prod (vpu): each share's product on its own thread (mul_to);
// - mxu_prod (mxu, -DBDLS_MUL_MXU): K5's warp-collective call
//   (csrc/mxu.cuh), every thread of the warp in every round, a share with
//   no task as filler.
// A round of two moduli (M, then M2) reduces its tasks below `na` mod M
// and the others mod M2; with M2 = M every task is mod M.
template <class M, class M2 = M>
struct mont_prod {
  static constexpr bool collective = false;
  int na;
  BDLS_HD void run(fe& dst, const fe& a, const fe& b, int s) const {
    if (std::is_same<M, M2>::value || s < na) mul_to<M>(dst, a, b);
    else mul_to<M2>(dst, a, b);
  }
};

template <class M, class M2 = M>
struct mxu_prod {
  static constexpr bool collective = true;
  int na;
#ifdef __CUDA_ARCH__
  __device__ fe warp(const fe& a, const fe& b, unsigned active,
                     int s) const {
    return mxu::mont_mul_warp<M, M2, !std::is_same<M, M2>::value>(
        a, b, active, s >= na);
  }
#else
  // the warp's round on the host: thread k's operands a[k], b[k], its
  // task s[k]
  void host(fe out[32], const fe a[32], const fe b[32], unsigned active,
            const int s[32]) const {
    uint64_t T[32][16];
    mxu::warp_columns_host(T, a, b, active);
    for (int k = 0; k < 32; ++k) {
      if (!((active >> k) & 1u)) continue;
      if (std::is_same<M, M2>::value || s[k] < na)
        mxu::sos_reduce<M>(out[k], T[k]);
      else
        mxu::sos_reduce<M2>(out[k], T[k]);
    }
  }
#endif
};

#ifdef BDLS_MUL_MXU
template <class M, class M2 = M>
using field_prod = mxu_prod<M, M2>;
#else
template <class M, class M2 = M>
using field_prod = mont_prod<M, M2>;
#endif

// The step code of every group body: a step of n product tasks and nl
// light tasks. Share k runs product tasks k, k + GROUP, ... a round of
// the group at a time (operands(s, a, b) picks task s's two operands and
// returns the slot its product goes to; every share runs the one product
// of `prod`), then the light tasks on the shares after the last product
// (light(k)); __syncwarp ends the step. With a collective product every
// thread of the warp makes each round's call, a share past n with zero
// operands, and its result is dropped. On the host the shares run one
// after another, forward or reversed; a collective round first gathers
// every share's operands, then runs the emulated warp once.
template <class Prod, class Operands, class Light>
BDLS_HD void run_tasks(const gctx& g, const Prod& prod, int n, int nl,
                       const Operands& operands, const Light& light) {
#ifdef __CUDA_ARCH__
  for (int base = 0; base < n; base += GROUP) {
    const int s = base + g.share;
    fe a, b;
    fe* dst = s < n ? operands(s, a, b) : nullptr;
    if constexpr (Prod::collective) {
      if (!dst) {
        set_small(a, 0u);
        set_small(b, 0u);
      }
      const fe r = prod.warp(a, b, __ballot_sync(g.wmask, dst != nullptr), s);
      if (dst) *dst = r;
    } else {
      if (dst) prod.run(*dst, a, b, s);
    }
  }
  for (int k = ((g.share - n) % GROUP + GROUP) % GROUP; k < nl; k += GROUP)
    light(k);
  __syncwarp(g.wmask);
#else
  (void)g;
  const bool rev = host_reverse();
  if constexpr (Prod::collective) {
    for (int base = 0; base < n; base += GROUP) {
      fe a[32] = {}, b[32] = {}, out[32];
      fe* dst[32] = {};
      int ts[32] = {};
      unsigned active = 0;
      for (int k0 = 0; k0 < GROUP; ++k0) {
        const int k = rev ? GROUP - 1 - k0 : k0;
        ts[k] = base + k;
        if (ts[k] < n) {
          dst[k] = operands(ts[k], a[k], b[k]);
          active |= 1u << k;
        }
      }
      prod.host(out, a, b, active, ts);
      for (int k = 0; k < GROUP; ++k)
        if (dst[k]) *dst[k] = out[k];
    }
    for (int k0 = 0; k0 < GROUP; ++k0) {
      const int k = rev ? GROUP - 1 - k0 : k0;
      for (int j = ((k - n) % GROUP + GROUP) % GROUP; j < nl; j += GROUP)
        light(j);
    }
  } else {
    for (int k0 = 0; k0 < GROUP; ++k0) {
      const int k = rev ? GROUP - 1 - k0 : k0;
      for (int s = k; s < n; s += GROUP) {
        fe a, b;
        fe* dst = operands(s, a, b);
        prod.run(*dst, a, b, s);
      }
      for (int j = ((k - n) % GROUP + GROUP) % GROUP; j < nl; j += GROUP)
        light(j);
    }
  }
#endif
}

// One step of two chains' parts: the products of p0 and p1, then the
// parts' light tasks, through run_tasks. A task's part is picked by
// value, so the operand and light code is inlined once: shares of both
// parts run it side by side, not one part's copy after the other's.
template <class C>
BDLS_HD void run_step(const gctx& g, const part& p0, const part& p1) {
  const int n0 = part_products<C>(p0), n = n0 + part_products<C>(p1);
  const int l0 = part_lights<C>(p0), nl = l0 + part_lights<C>(p1);
  run_tasks(
      g, field_prod<typename C::P>{0}, n, nl,
      [&](int s, fe& a, fe& b) {
        const bool q = s >= n0;
        const op o = q ? p1.o : p0.o;
        return op_operands<C>(o, q ? p1.level : p0.level, q ? s - n0 : s, a,
                              b);
      },
      [&](int k) {
        const bool q = k >= l0;
        const part p = q ? p1 : p0;
        part_light<C>(p, q ? k - l0 : k);
      });
}

BDLS_HD addsrc no_addend() {
  addsrc a;
  a.dst = nullptr;
  a.p = nullptr;
  a.g = nullptr;
  a.gy = nullptr;
  a.x = nullptr;
  a.neg = false;
  a.nz = false;
  return a;
}

BDLS_HD part make_part(const op& o, bool on, int level, addsrc next) {
  part p;
  p.o = o;
  p.on = on;
  p.level = level;
  p.next = next;
  return p;
}

// ops[0..n) side by side (n <= 2), all four levels
template <class C>
BDLS_HD void run_ops(const gctx& g, const op* ops, int n) {
  for (int level = 0; level < 4; ++level)
    run_step<C>(g, make_part(ops[0], true, level, no_addend()),
                make_part(ops[n > 1 ? 1 : 0], n > 1, level, no_addend()));
}

// ------------------------------------------------------------ the chains

BDLS_HD op make_op(int kind, const pt* p1, const pt* p2, pt* out, fe* sl) {
  op o;
  o.kind = kind;
  o.p1 = p1;
  o.p2 = p2;
  o.out = out;
  o.sl = sl;
  return o;
}

// Q-chain ops: P-256 1 + 64·5 (the carry digit's add, then per digit
// 63..0 four doublings and an add); secp256k1 2 + 33·6 (digit 33 of k1
// and k2, then per digit 32..0 four doublings and the two halves' adds)
template <class C>
BDLS_HD constexpr int q_ops() {
  return C::a_zero ? 2 + 33 * 6 : 1 + 64 * 5;
}

// op i of chain 0 (its addend is st.add[0]), and where that addend
// comes from
template <class C>
BDLS_HD op q_op(lane_state& st, int i, addsrc* src) {
  op o = make_op(OP_ADD, &st.acc[0], &st.add[0], &st.acc[0], st.sl[0]);
  addsrc a = no_addend();
  a.dst = &st.add[0];
  if (C::a_zero) {
    int half, d;
    if (i < 2) {
      half = i;
      d = 33;
    } else {
      const int k = (i - 2) % 6;
      d = 32 - (i - 2) / 6;
      half = k - 4;
      if (k < 4) o.kind = OP_DBL;
    }
    if (o.kind == OP_ADD) {
      bool nd;
      const uint32_t mag = glv::digit(st.w + 5 * half, d, nd);
      a.p = &st.tab[mag];
      a.x = half ? &st.psi[mag] : nullptr;
      a.neg = nd != (st.kneg[half] != 0);
    }
  } else if (i == 0) {
    a.p = &st.tab[st.w[8]];          // digit 64: the carry nibble
  } else {
    const int d = 63 - (i - 1) / 5;
    if ((i - 1) % 5 < 4) {
      o.kind = OP_DBL;
    } else {
      const int nib = (int)((st.w[d >> 3] >> ((d & 7) * 4)) & 0xFu) - 8;
      a.p = &st.tab[nib < 0 ? -nib : nib];
      a.neg = nib < 0;
    }
  }
  if (src) *src = o.kind == OP_ADD ? a : no_addend();
  return o;
}

// op j of chain 1, acc[1] += g32[j][byte j of u1], and its addend's
// source
template <class C>
BDLS_HD op g_op(lane_state& st, const uint32_t* g32, int j, addsrc* src) {
  if (src) {
    *src = no_addend();
    src->dst = &st.add[1];
    const uint32_t byte = (st.u1.v[j >> 2] >> ((j & 3) * 8)) & 0xFFu;
    src->g = g32 + ((size_t)j * 256 + byte) * 24;
  }
  return make_op(OP_ADD, &st.acc[1], &st.add[1], &st.acc[1], st.sl[1]);
}

// rz[t] = rm[t]·z, t = 0, 1: r·Z(R) and (r + n)·Z(R)
template <class FP>
BDLS_HD void rz_step(const gctx& g, fe* rz, const fe* rm, const fe& z) {
  run_tasks(
      g, field_prod<FP>{0}, 2, 0,
      [&](int t, fe& a, fe& b) {
        a = rm[t];
        b = z;
        return &rz[t];
      },
      [](int) {});
}

// ------------------------------------------------------------- the body

// Loads (t, fe&) for t < 5 (t < 4 with HASH) sets input t of the lane;
// with HASH, hash(fe&) sets e, on its own share beside the inverse.
// Returns the verdict; every share of the group returns the same.
template <class C, bool HASH, class Load, class Hash>
BDLS_HD bool verify_group(const gctx& g, lane_state& st, const Load& load,
                          const Hash& hash, const uint32_t* g32) {
  typedef typename C::P FP;
  typedef typename C::N FN;

  step(g, HASH ? 4 : 5, [&](int t) { load(t, st.in[t]); });

  // Q, r and r + n into Montgomery form mod p beside the screens and
  // s^-1 (plain) on one share (and K7's hash on another)
  run_tasks(
      g, field_prod<FP>{0}, 4, HASH ? 2 : 1,
      [&](int t, fe& a, fe& b) {
        a = st.in[t < 2 ? t : 2];
        if (t == 3) {
          fe rn;
          const uint32_t carry = add_m<FN>(rn, st.in[2]);
          const bool fits = carry == 0 && lt_mod<FP>(rn);
          st.rn_fits = fits ? 1 : 0;
          if (!fits) set_small(rn, 0u);
          a = rn;
        }
        load_r2<FP>(b);
        return t == 0 ? &st.xm : t == 1 ? &st.ym : &st.rm[t - 2];
      },
      [&](int k) {
        if (k) {
          hash(st.in[4]);
          return;
        }
        const fe r = st.in[2], s = st.in[3];
        const fe qx = st.in[0], qy = st.in[1];
        const bool r_ok = !is_zero(r) && lt_mod<FN>(r);
        const bool s_ok = !is_zero(s) && lt_mod<FN>(s);
        const bool q_ok = lt_mod<FP>(qx) && lt_mod<FP>(qy) &&
                          !(is_zero(qx) && is_zero(qy));
        st.screen = (r_ok && s_ok && q_ok) ? 1 : 0;
        fe a;
        if (s_ok) a = s;
        else set_small(a, 1u);
        inv_binary<FN>(st.sinv, a);
      });

  // s^-1·R mod n beside y^2 and x^2; the table's entries 0 and 1 and the
  // accumulators' start
  run_tasks(
      g, field_prod<FN, FP>{1}, 3, 2,
      [&](int t, fe& a, fe& b) {
        if (t == 0) {
          a = st.sinv;
          load_r2<FN>(b);
          return &st.sm;
        }
        a = t == 1 ? st.ym : st.xm;
        b = a;
        return &st.sq[t - 1];
      },
      [&](int k) {
        fe one, zero;
        load_one<FP>(one);
        set_small(zero, 0u);
        if (k == 0) {
          st.tab[0].x = zero; st.tab[0].y = one; st.tab[0].z = zero;
          st.tab[1].x = st.xm; st.tab[1].y = st.ym; st.tab[1].z = one;
        } else {
          for (int c = 0; c < 2; ++c) {
            st.acc[c].x = zero; st.acc[c].y = one; st.acc[c].z = zero;
          }
        }
      });

  // u1 = e·s^-1, u2 = r·s^-1 (plain, fully reduced) mod n, x^3 mod p
  run_tasks(
      g, field_prod<FN, FP>{2}, 3, 0,
      [&](int t, fe& a, fe& b) {
        a = t == 0 ? st.in[4] : t == 1 ? st.in[2] : st.sq[1];
        b = t < 2 ? st.sm : st.xm;
        return t == 0 ? &st.u1 : t == 1 ? &st.u2 : &st.sq[2];
      },
      [](int) {});

  // Q on the curve; u2's digit words
  step(g, 2, [&](int t) {
    if (t == 0) {
      fe rhs = st.sq[2], u;
      if (!C::a_zero) {              // a = -3
        tpl_mod<FP>(u, st.xm);
        sub_mod<FP>(rhs, rhs, u);
      }
      load_b<C>(u);
      add_mod<FP>(rhs, rhs, u);
      st.on_curve = eq(st.sq[0], rhs) ? 1 : 0;
    } else if (C::a_zero) {
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

  // [2..8]·Q, two chains: 2Q; 3Q, 4Q; 5Q, 6Q; 7Q = 4Q + 3Q, 8Q
  {
    pt* T = st.tab;
    op ops[2];
    ops[0] = make_op(OP_DBL, &T[1], nullptr, &T[2], st.sl[0]);
    run_ops<C>(g, ops, 1);
    ops[0] = make_op(OP_ADD, &T[2], &T[1], &T[3], st.sl[0]);
    ops[1] = make_op(OP_DBL, &T[2], nullptr, &T[4], st.sl[1]);
    run_ops<C>(g, ops, 2);
    ops[0] = make_op(OP_ADD, &T[4], &T[1], &T[5], st.sl[0]);
    ops[1] = make_op(OP_DBL, &T[3], nullptr, &T[6], st.sl[1]);
    run_ops<C>(g, ops, 2);
    ops[0] = make_op(OP_ADD, &T[4], &T[3], &T[7], st.sl[0]);
    ops[1] = make_op(OP_DBL, &T[4], nullptr, &T[8], st.sl[1]);
    run_ops<C>(g, ops, 2);
  }
  if (C::a_zero) {                   // ψ(Q)'s x: β·X, β in Montgomery form
    run_tasks(
        g, field_prod<FP>{0}, 9, 0,
        [&](int t, fe& a, fe& b) {
          for (int i = 0; i < 8; ++i) a.v[i] = BetaMont::w(i);
          b = st.tab[t].x;
          return &st.psi[t];
        },
        [](int) {});
  }

  // the first addend of each chain
  {
    addsrc a0, a1;
    q_op<C>(st, 0, &a0);
    g_op<C>(st, g32, 0, &a1);
    step(g, 6, [&](int t) { addend_put<C>(t < 3 ? a0 : a1, t % 3); });
  }

  // the ladder: chain 0's ops, chain 1's levels in the spare shares;
  // each op's last level writes its chain's next addend
  int gj = 0, gl = 0;
  BDLS_NOUNROLL
  for (int i = 0; i < q_ops<C>(); ++i) {
    addsrc qnext = no_addend();
    const op q = q_op<C>(st, i, nullptr);
    if (i + 1 < q_ops<C>()) q_op<C>(st, i + 1, &qnext);
    BDLS_NOUNROLL
    for (int lq = 0; lq < 4; ++lq) {
      const bool with_g =
          gj < 32 && op_products<C>(q.kind, lq) +
                         op_products<C>(OP_ADD, gl) <= GROUP;
      addsrc gnext = no_addend();
      const op gop = g_op<C>(st, g32, gj < 32 ? gj : 31, nullptr);
      if (with_g && gl == 3 && gj + 1 < 32) g_op<C>(st, g32, gj + 1, &gnext);
      run_step<C>(g, make_part(q, true, lq, qnext),
                  make_part(gop, with_g, gl, gnext));
      if (with_g && ++gl == 4) {
        gl = 0;
        ++gj;
      }
    }
  }
  BDLS_NOUNROLL
  while (gj < 32) {                  // what is left of chain 1, alone
    addsrc gnext = no_addend();
    const op gop = g_op<C>(st, g32, gj, nullptr);
    if (gl == 3 && gj + 1 < 32) g_op<C>(st, g32, gj + 1, &gnext);
    run_step<C>(g, make_part(gop, true, gl, gnext),
                make_part(gop, false, 0, no_addend()));
    if (++gl == 4) {
      gl = 0;
      ++gj;
    }
  }

  // R = chain 0 + chain 1
  {
    const op j = make_op(OP_ADD, &st.acc[0], &st.acc[1], &st.acc[0],
                         st.sl[0]);
    run_ops<C>(g, &j, 1);
  }

  // X(R) == r·Z(R) or (r + n)·Z(R)
  rz_step<FP>(g, st.rz, st.rm, st.acc[0].z);
  step(g, 1, [&](int) {
    const pt& R = st.acc[0];
    const bool ok1 = eq(R.x, st.rz[0]);
    const bool ok2 = st.rn_fits && eq(R.x, st.rz[1]);
    st.ok = (st.screen && st.on_curve && !is_zero(R.z) && (ok1 || ok2))
                ? 1 : 0;
  });
  return st.ok != 0;
}

// K1's lane b of five (16, B) limb arrays
template <class C>
BDLS_HD bool verify_lane_group(const gctx& g, lane_state& st,
                               const int32_t* qx, const int32_t* qy,
                               const int32_t* r, const int32_t* s,
                               const int32_t* e, const uint32_t* g32, int b,
                               int B) {
  const int32_t* in[5] = {qx, qy, r, s, e};
  return verify_group<C, false>(
      g, st, [&](int t, fe& v) { load_limbs16(v, in[t], b, B); },
      [](fe&) {}, g32);
}

}  // namespace grp
}  // namespace bdls
