// BLS12-381 pairing check for the pairing kernels (csrc/bls.cu, K9 and
// K11): FQ12 arithmetic, the Miller loop as numerator/denominator a warp
// a (Q, P) pair, the final exponentiation a warp a side (K9's x-chain and
// K11's full exponent share one body), and the compare.
//
// Each step computes the value the reference computes
// (bdls_tpu/ops/bls_kernel.py), in the reference's representation:
//
// - FQ12 is Fp[w]/(w^12 - 2w^6 + 2), twelve Fp coefficients
//   (bdls_tpu/ops/bls_host.py). A dense product is the schoolbook
//   convolution (144 Montgomery products; a square 78) and the reduction
//   by w^12 = 2w^6 - 2 from the top degree down, as bls_host.FQ12.__mul__.
//   Frobenius^k is a 12 x 12 constant matrix, built on the host in
//   Montgomery form (bdls_tpu_torch/ops/bls_kernel.py:frob_table_host).
// - The Miller loop keeps miller_nd's num/den formulas, the tangent and
//   chord lines at P and the complete RCB a = 0 point formulas over FQ12
//   (dbl_a0, add_a0 with b3 = 12), so (n, d) equal the reference's after
//   canonicalisation. The loop bits are public, so the chord is computed
//   only where a bit is set (the reference computes both arms and
//   selects). See "K9's Miller loop" below for the twisted path.
// - The final exponentiations differ from the reference's only in the
//   inverse: the reference inverts across lanes (_batch_inv12); here each
//   side inverts alone through its norm, and a zero side gives zero. See
//   "the final exponentiation" below.
// - The compare is _compare_tail: (lhs - rhs == 0) and (lhs != 0).
//
// Every value is an exact field element, so the order of commuting
// products and sums does not matter; multiplications by the small
// constants 2, 3, 8, 12 and 36 are additions.
//
// The dense one-thread operations (f12_*, miller_nd) run on no kernel:
// the host tests hold the warp code against them.
#pragma once

#include "fp381.cuh"

#ifdef __CUDACC__
#define BDLS_NOINL __host__ __device__ __noinline__
#else
#define BDLS_NOINL inline
#endif

namespace bdls {

struct fq12 {
  fp c[12];
};

// |x|, the BLS parameter; its bits below the leading one drive the
// Miller loop and every x-power of the final exponentiation
constexpr uint64_t ATE_LOOP = 0xD201000000010000ull;
constexpr int ATE_TOP = 63;

BDLS_HD void f12_zero(fq12& out) {
  BDLS_NOUNROLL
  for (int i = 0; i < 12; ++i) fp_zero(out.c[i]);
}

BDLS_HD void f12_one(fq12& out) {
  f12_zero(out);
  fp_one(out.c[0]);
}

BDLS_HD bool f12_is_zero(const fq12& a) {
  bool z = true;
  BDLS_NOUNROLL
  for (int i = 0; i < 12; ++i) z = z && fp_is_zero(a.c[i]);
  return z;
}

BDLS_NOINL void f12_add(fq12& out, const fq12& a, const fq12& b) {
  BDLS_NOUNROLL
  for (int i = 0; i < 12; ++i) fp_add(out.c[i], a.c[i], b.c[i]);
}

BDLS_NOINL void f12_sub(fq12& out, const fq12& a, const fq12& b) {
  BDLS_NOUNROLL
  for (int i = 0; i < 12; ++i) fp_sub(out.c[i], a.c[i], b.c[i]);
}

// out = k·a for a small public k >= 1, by double-and-add
BDLS_HD void fp_mul_small(fp& out, const fp& a, int k) {
  fp acc = a;
  int top = 31;
  while (!((k >> top) & 1)) --top;
  for (int bit = top - 1; bit >= 0; --bit) {
    fp_add(acc, acc, acc);
    if ((k >> bit) & 1) fp_add(acc, acc, a);
  }
  out = acc;
}

BDLS_NOINL void f12_mul_small(fq12& out, const fq12& a, int k) {
  BDLS_NOUNROLL
  for (int i = 0; i < 12; ++i) fp_mul_small(out.c[i], a.c[i], k);
}

// the 23 convolution coefficients -> reduced by w^12 = 2w^6 - 2
BDLS_HD void f12_reduce(fq12& out, fp* acc) {
  BDLS_NOUNROLL
  for (int k = 22; k >= 12; --k) {
    fp two;
    fp_add(two, acc[k], acc[k]);
    fp_add(acc[k - 6], acc[k - 6], two);
    fp_sub(acc[k - 12], acc[k - 12], two);
  }
  BDLS_NOUNROLL
  for (int i = 0; i < 12; ++i) out.c[i] = acc[i];
}

BDLS_NOINL void f12_mul(fq12& out, const fq12& a, const fq12& b) {
  fp acc[23];
  BDLS_NOUNROLL
  for (int k = 0; k < 23; ++k) fp_zero(acc[k]);
  BDLS_NOUNROLL
  for (int i = 0; i < 12; ++i) {
    BDLS_NOUNROLL
    for (int j = 0; j < 12; ++j) {
      fp t;
      fp_mul(t, a.c[i], b.c[j]);
      fp_add(acc[i + j], acc[i + j], t);
    }
  }
  f12_reduce(out, acc);
}

BDLS_NOINL void f12_sqr(fq12& out, const fq12& a) {
  fp acc[23];
  BDLS_NOUNROLL
  for (int k = 0; k < 23; ++k) fp_zero(acc[k]);
  BDLS_NOUNROLL
  for (int i = 0; i < 12; ++i) {
    BDLS_NOUNROLL
    for (int j = i + 1; j < 12; ++j) {
      fp t;
      fp_mul(t, a.c[i], a.c[j]);
      fp_add(acc[i + j], acc[i + j], t);
    }
  }
  BDLS_NOUNROLL
  for (int k = 0; k < 23; ++k) fp_add(acc[k], acc[k], acc[k]);
  BDLS_NOUNROLL
  for (int i = 0; i < 12; ++i) {
    fp t;
    fp_mul(t, a.c[i], a.c[i]);
    fp_add(acc[2 * i], acc[2 * i], t);
  }
  f12_reduce(out, acc);
}

// one Fp constant of a Montgomery-form table: 12 words at p
BDLS_HD void fp_load_words(fp& out, const uint32_t* p) {
  BDLS_UNROLL
  for (int w = 0; w < 12; ++w) out.v[w] = p[w];
}

// Frobenius^k through its (12, 12, 12 words) Montgomery matrix M:
// out_j = sum_i a_i · M[i][j]
BDLS_NOINL void f12_frob(fq12& out, const fq12& a, const uint32_t* M) {
  fq12 r;
  f12_zero(r);
  BDLS_NOUNROLL
  for (int i = 0; i < 12; ++i) {
    BDLS_NOUNROLL
    for (int j = 0; j < 12; ++j) {
      fp m, t;
      fp_load_words(m, M + (i * 12 + j) * 12);
      fp_mul(t, a.c[i], m);
      fp_add(r.c[j], r.c[j], t);
    }
  }
  out = r;
}

// The dense Frobenius tables (k = 1, 2, 6), one (12, 12, 12)-word matrix
// each, in that order.
struct frob_tables {
  const uint32_t* k1;
  const uint32_t* k2;
  const uint32_t* k6;
};

BDLS_HD frob_tables frob_at(const uint32_t* base) {
  return frob_tables{base, base + 1728, base + 2 * 1728};
}

// a^-1 = (a^p · ... · a^(p^11)) · N(a)^-1, N(a) = a · a^p · ... ∈ Fp;
// zero -> zero
BDLS_NOINL void f12_inv(fq12& out, const fq12& a, const uint32_t* frob1) {
  fq12 t, prod, nrm;
  f12_frob(t, a, frob1);
  prod = t;
  BDLS_NOUNROLL
  for (int k = 2; k <= 11; ++k) {
    f12_frob(t, t, frob1);
    f12_mul(prod, prod, t);
  }
  f12_mul(nrm, a, prod);
  fp ninv;
  fp_inv(ninv, nrm.c[0]);
  BDLS_NOUNROLL
  for (int i = 0; i < 12; ++i) fp_mul(out.c[i], prod.c[i], ninv);
}

// _compare_tail: lhs == rhs and lhs != 0 (the zero-collapse guard)
BDLS_HD bool compare_tail(const fq12& lhs, const fq12& rhs) {
  fq12 diff;
  f12_sub(diff, lhs, rhs);
  return f12_is_zero(diff) && !f12_is_zero(lhs);
}

// ------------------------------------------------ loads and stores

// coefficient c of lane t of a (12 words, 12 coefficients, N) int32
// canonical-layout array -> Montgomery form (any 384-bit value is read
// mod p)
BDLS_HD void fp_load_coeff(fp& out, const int32_t* a, int c, int t, int N) {
  fp x;
  BDLS_UNROLL
  for (int w = 0; w < 12; ++w)
    x.v[w] = (uint32_t)a[(size_t)(w * 12 + c) * N + t];
  fp_to_mont(out, x);
}

// one Montgomery-form coefficient -> canonical words in the same layout
BDLS_HD void fp_store_coeff(int32_t* a, const fp& x, int c, int t, int N) {
  fp y;
  fp_from_mont(y, x);
  BDLS_UNROLL
  for (int w = 0; w < 12; ++w)
    a[(size_t)(w * 12 + c) * N + t] = (int32_t)y.v[w];
}

BDLS_HD void f12_load(fq12& out, const int32_t* a, int t, int N) {
  BDLS_NOUNROLL
  for (int c = 0; c < 12; ++c) fp_load_coeff(out.c[c], a, c, t, N);
}

BDLS_HD void f12_store(int32_t* a, const fq12& x, int t, int N) {
  BDLS_NOUNROLL
  for (int c = 0; c < 12; ++c) fp_store_coeff(a, x.c[c], c, t, N);
}

// ------------------------------------- the Miller loop's dense formulas
//
// Written once over an FQ12 operation set: thread_ops (the one-thread
// f12_* above, miller_nd below) or warp_ops (each product a warp's
// tower product, the dense path of K9's Miller launch). ops.mul and
// ops.sqr may write an operand; the others are coefficient-wise.

// Complete doubling, a = 0 (RCB Algorithm 9), b3 = 12: the sequence of
// bdls_tpu/ops/proj.py:dbl_a0 over FQ12; tmp holds 6 values
template <class Ops>
BDLS_HD void dbl_a0_ops(const Ops& op, fq12* tmp, fq12& X, fq12& Y,
                        fq12& Z) {
  fq12 &t0 = tmp[0], &t1 = tmp[1], &t2 = tmp[2];
  fq12 &x3 = tmp[3], &y3 = tmp[4], &z3 = tmp[5];
  op.sqr(t0, Y);
  op.add(z3, t0, t0);
  op.add(z3, z3, z3);
  op.add(z3, z3, z3);
  op.mul(t1, Y, Z);
  op.sqr(t2, Z);
  op.small(t2, t2, 12);
  op.mul(x3, t2, z3);
  op.add(y3, t0, t2);
  op.mul(z3, t1, z3);
  op.add(t1, t2, t2);
  op.add(t2, t1, t2);
  op.sub(t0, t0, t2);
  op.mul(y3, t0, y3);
  op.add(y3, x3, y3);
  op.mul(t1, X, Y);
  op.mul(x3, t0, t1);
  op.add(x3, x3, x3);
  op.copy(X, x3);
  op.copy(Y, y3);
  op.copy(Z, z3);
}

// Complete addition, a = 0 (RCB Algorithm 7), b3 = 12, Z2 = 1: the
// sequence of bdls_tpu/ops/proj.py:add_a0 over FQ12 (Z1·Z2 is Z1); tmp
// holds 8 values
template <class Ops>
BDLS_HD void add_a0_ops(const Ops& op, fq12* tmp, fq12& X, fq12& Y, fq12& Z,
                        const fq12& X2, const fq12& Y2) {
  fq12 &t0 = tmp[0], &t1 = tmp[1], &t2 = tmp[2], &t3 = tmp[3];
  fq12 &t4 = tmp[4], &X3 = tmp[5], &Y3 = tmp[6], &Z3 = tmp[7];
  op.mul(t0, X, X2);
  op.mul(t1, Y, Y2);
  op.copy(t2, Z);
  op.add(t3, X, Y);
  op.add(t4, X2, Y2);
  op.mul(t3, t3, t4);
  op.add(t4, t0, t1);
  op.sub(t3, t3, t4);
  op.add(t4, Y, Z);
  op.one(X3);
  op.add(X3, Y2, X3);
  op.mul(t4, t4, X3);
  op.add(X3, t1, t2);
  op.sub(t4, t4, X3);
  op.add(X3, X, Z);
  op.one(Y3);
  op.add(Y3, X2, Y3);
  op.mul(X3, X3, Y3);
  op.add(Y3, t0, t2);
  op.sub(Y3, X3, Y3);
  op.add(X3, t0, t0);
  op.add(t0, X3, t0);
  op.small(t2, t2, 12);
  op.add(Z3, t1, t2);
  op.sub(t1, t1, t2);
  op.small(Y3, Y3, 12);
  op.mul(X3, t4, Y3);
  op.mul(t2, t3, t1);
  op.sub(X3, t2, X3);
  op.mul(Y3, Y3, t0);
  op.mul(t1, t1, Z3);
  op.add(Y3, t1, Y3);
  op.mul(t0, t0, t3);
  op.mul(Z3, Z3, t4);
  op.add(Z3, Z3, t0);
  op.copy(X, X3);
  op.copy(Y, Y3);
  op.copy(Z, Z3);
}

// the dense loop's work space: X, Y, Z, A, C, t, u, l, then the point
// formulas' 8 temporaries
constexpr int DENSE_SLOTS = 16;

// f_{|x|,Q}(P) as (numerator, denominator), Q and P affine in E(FQ12):
// bdls_tpu/ops/bls_kernel.py:miller_nd, step for step
template <class Ops>
BDLS_HD void miller_dense(const Ops& op, fq12& fn, fq12& fd, const fq12& Qx,
                          const fq12& Qy, const fq12& Px, const fq12& Py,
                          fq12* s) {
  fq12 &X = s[0], &Y = s[1], &Z = s[2], &A = s[3], &C = s[4];
  fq12 &t = s[5], &u = s[6], &l = s[7];
  fq12* tmp = s + 8;
  op.copy(X, Qx);
  op.copy(Y, Qy);
  op.one(Z);
  op.one(fn);
  op.one(fd);
  BDLS_NOUNROLL
  for (int i = ATE_TOP - 1; i >= 0; --i) {
    // tangent at T, at P: l = A·(Px·Z - X) - C·(Py·Z - Y), over C·Z
    op.sqr(A, X);
    op.small(A, A, 3);
    op.mul(C, Y, Z);
    op.small(C, C, 2);
    op.mul(t, Px, Z);
    op.sub(t, t, X);
    op.mul(t, A, t);
    op.mul(u, Py, Z);
    op.sub(u, u, Y);
    op.mul(u, C, u);
    op.sub(l, t, u);
    op.sqr(fn, fn);
    op.mul(fn, fn, l);
    op.mul(l, C, Z);
    op.sqr(fd, fd);
    op.mul(fd, fd, l);
    dbl_a0_ops(op, tmp, X, Y, Z);
    if ((ATE_LOOP >> i) & 1) {
      // chord through T2 and Q, at P:
      // [(Qy·Z - Y)(Px - Qx) - (Qx·Z - X)(Py - Qy)] / (Qx·Z - X)
      op.mul(t, Qy, Z);
      op.sub(t, t, Y);
      op.sub(u, Px, Qx);
      op.mul(t, t, u);
      op.mul(A, Qx, Z);
      op.sub(A, A, X);
      op.sub(u, Py, Qy);
      op.mul(u, A, u);
      op.sub(t, t, u);
      op.mul(fn, fn, t);
      op.mul(fd, fd, A);
      add_a0_ops(op, tmp, X, Y, Z, Qx, Qy);
    }
  }
}

// the one-thread operations
struct thread_ops {
  BDLS_HD void mul(fq12& c, const fq12& a, const fq12& b) const {
    f12_mul(c, a, b);
  }
  BDLS_HD void sqr(fq12& c, const fq12& a) const { f12_sqr(c, a); }
  BDLS_HD void add(fq12& c, const fq12& a, const fq12& b) const {
    f12_add(c, a, b);
  }
  BDLS_HD void sub(fq12& c, const fq12& a, const fq12& b) const {
    f12_sub(c, a, b);
  }
  BDLS_HD void small(fq12& c, const fq12& a, int k) const {
    f12_mul_small(c, a, k);
  }
  BDLS_HD void one(fq12& c) const { f12_one(c); }
  BDLS_HD void copy(fq12& c, const fq12& a) const { c = a; }
};

// the dense formulas on one thread
inline void miller_nd(fq12& fn, fq12& fd, const fq12& Qx, const fq12& Qy,
                      const fq12& Px, const fq12& Py) {
  fq12 s[DENSE_SLOTS];
  miller_dense(thread_ops{}, fn, fd, Qx, Qy, Px, Py, s);
}

// ------------------------------------------------------- the warp's code
//
// A warp runs one computation: K9's Miller loop of one (Q, P) pair, or
// one side's final exponentiation (K9's x-chain, K11's full exponent).
// Its values live in the warp's work space (shared memory on the card),
// each coefficient canonical in Montgomery form. Each operation is a few
// steps; a step is a set of tasks, task s run by share s mod 32. On the
// card lane k runs share k and __syncwarp() separates the steps; on the
// host (g++) a loop runs the shares of a step in turn. The tasks of a
// step write distinct values and read none that another task of the step
// writes, so both orders give the same values. Public loop bits and the
// warp-uniform pair class keep every lane of a warp on one path.
//
// The flat basis is already the tower Fp2[w]/(w^6 - (1+i)): w^6 = 1 + i,
// so a_k + a_(k+6)·w^6 = (a_k + a_(k+6)) + a_(k+6)·i, additions both
// ways (tw_coeff, tw_store). A tower product is 36 Fp2 products of
// Karatsuba's 3 Fp products (108 tasks), a square 21 (63 tasks), each
// output coefficient summed by one lane.

constexpr int WARP = 32;
// Karatsuba's three Fp products for each of a product's 36 Fp2 pairs
constexpr int MUL_TASKS = 108;
// a square's pairs (i <= j) of tower coefficients
constexpr int SQR_PAIRS = 21;

// one step: share k of it on lane k, or every share in turn on the host
template <class S>
BDLS_HD void warp_step(int lane, const S& share) {
#ifdef __CUDA_ARCH__
  share(lane);
  __syncwarp();
#else
  (void)lane;
  for (int k = 0; k < WARP; ++k) share(k);
#endif
}

// one step over the 12 coefficients of a value
template <class F>
BDLS_HD void w_each(int lane, const F& f) {
  warp_step(lane, [&](int k) {
    if (k < 12) f(k);
  });
}

// an Fp2 value re + im·i; at tower degree k it stands for (re + im·i)·w^k
struct tw1 {
  fp re, im;
};

// tower coefficient k of a flat value: re + im·i
BDLS_HD void tw_coeff(fp& re, fp& im, const fq12& a, int k) {
  fp_add(re, a.c[k], a.c[k + 6]);
  im = a.c[k + 6];
}

BDLS_HD void tw1_get(tw1& out, const fq12& a, int k) {
  tw_coeff(out.re, out.im, a, k);
}

// tower coefficient k -> flat coefficients k and k + 6
BDLS_HD void tw_store(fq12& c, const fp& re, const fp& im, int k) {
  fp_sub(c.c[k], re, im);
  c.c[k + 6] = im;
}

// Karatsuba part of a·b: 0 re·re, 1 im·im, 2 (re + im)·(re + im)
BDLS_HD void fp2_part(fp& out, const tw1& a, const tw1& b, int part) {
  fp x, y;
  if (part == 0) {
    x = a.re;
    y = b.re;
  } else if (part == 1) {
    x = a.im;
    y = b.im;
  } else {
    fp_add(x, a.re, a.im);
    fp_add(y, b.re, b.im);
  }
  fp_mul(out, x, y);
}

// flat coefficient k (or k + 6 when high) of one term of a tower product,
// from its Karatsuba parts v0, v1, v2 (re = v0 - v1, im = v2 - v0 - v1):
// re - im is 2v0 - v2, im is v2 - v0 - v1; times 1 + i when the degrees
// wrap past w^6, re - im is 2v0 + 2v1 - 2v2 and im is v2 - 2v1
BDLS_HD void flat_term(fp& u, const fp* v, bool wrap, bool high) {
  if (!wrap && high) {
    fp_sub(u, v[2], v[0]);
    fp_sub(u, u, v[1]);
  } else if (!wrap) {
    fp_add(u, v[0], v[0]);
    fp_sub(u, u, v[2]);
  } else if (high) {
    fp_sub(u, v[2], v[1]);
    fp_sub(u, u, v[1]);
  } else {
    fp_add(u, v[0], v[1]);
    fp_sub(u, u, v[2]);
    fp_add(u, u, u);
  }
}

// product task s: pair q = 6i + j, Karatsuba part s % 3 of A_i·B_j
BDLS_HD void mul_task(fp* prod, int s, const fq12& a, const fq12& b) {
  const int q = s / 3;
  tw1 x, y;
  tw1_get(x, a, q / 6);
  tw1_get(y, b, q % 6);
  fp2_part(prod[s], x, y, s % 3);
}

// combine task t: flat coefficient t of C = A·B, C_k = sum over i of
// A_i·B_((k-i) mod 6), wrapped (times 1 + i) where i > k
BDLS_HD void mul_combine(fq12& c, const fp* prod, int t) {
  const int k = t % 6;
  fp acc, u;
  fp_zero(acc);
  BDLS_NOUNROLL
  for (int i = 0; i < 6; ++i) {
    flat_term(u, &prod[3 * (6 * i + (k - i + 6) % 6)], i > k, t >= 6);
    fp_add(acc, acc, u);
  }
  c.c[t] = acc;
}

// c = a·b (c may be a or b)
BDLS_NOINL void w_mul(fp* prod, int lane, fq12& c, const fq12& a,
                      const fq12& b) {
  warp_step(lane, [&](int k) {
    for (int s = k; s < MUL_TASKS; s += WARP) mul_task(prod, s, a, b);
  });
  w_each(lane, [&](int k) { mul_combine(c, prod, k); });
}

// a square's pair q -> (i, j), i <= j, by i then j
BDLS_HD void sqr_pair(int q, int& i, int& j) {
  i = 0;
  while (q >= 6 - i) {
    q -= 6 - i;
    ++i;
  }
  j = i + q;
}

BDLS_HD int sqr_index(int i, int j) { return 6 * i - i * (i - 1) / 2 + j - i; }

// square task s < 3·SQR_PAIRS: Karatsuba part s % 3 of A_i·A_j
BDLS_HD void sqr_task(fp* prod, int s, const fq12& a) {
  int i, j;
  sqr_pair(s / 3, i, j);
  tw1 x, y;
  tw1_get(x, a, i);
  tw1_get(y, a, j);
  fp2_part(prod[s], x, y, s % 3);
}

// combine task t: flat coefficient t of A², the pairs i <= j with
// i + j = k (mod 6), each twice where i < j
BDLS_HD void sqr_combine(fq12& c, const fp* prod, int t) {
  const int k = t % 6;
  fp acc, u;
  fp_zero(acc);
  BDLS_NOUNROLL
  for (int i = 0; i < 6; ++i) {
    const int j = (k - i + 6) % 6;
    if (j < i) continue;
    flat_term(u, &prod[3 * sqr_index(i, j)], i + j >= 6, t >= 6);
    if (i < j) fp_add(u, u, u);
    fp_add(acc, acc, u);
  }
  c.c[t] = acc;
}

// c = a² (c may be a)
BDLS_NOINL void w_sqr(fp* prod, int lane, fq12& c, const fq12& a) {
  warp_step(lane, [&](int k) {
    for (int s = k; s < 3 * SQR_PAIRS; s += WARP) sqr_task(prod, s, a);
  });
  w_each(lane, [&](int k) { sqr_combine(c, prod, k); });
}

// cyclotomic-square task s < 18: Fp2 square q = s / 2 of pair g = q / 3
// (A_g, A_(g+3)): which = q % 3 squares A_g, A_(g+3) or their sum; part
// s % 2 takes (x + y)(x - y) or x·y of x + y·i
BDLS_HD void cyclo_task(fp* prod, int s, const fq12& a) {
  const int q = s / 2, g = q / 3, which = q % 3;
  fp x, y, x2, y2;
  tw_coeff(x, y, a, which == 1 ? g + 3 : g);
  if (which == 2) {
    tw_coeff(x2, y2, a, g + 3);
    fp_add(x, x, x2);
    fp_add(y, y, y2);
  }
  if (s % 2 == 0) {
    fp_add(x2, x, y);
    fp_sub(y2, x, y);
    fp_mul(prod[s], x2, y2);
  } else {
    fp_mul(prod[s], x, y);
  }
}

// the square of cyclo_task's pair g, which: re + im·i
BDLS_HD void cyclo_sq(fp& re, fp& im, const fp* prod, int g, int which) {
  const int q = 3 * g + which;
  re = prod[2 * q];
  fp_add(im, prod[2 * q + 1], prod[2 * q + 1]);
}

// combine task k < 6: tower coefficient k of the square (Granger-Scott
// over Fp4 = Fp2[y]/(y^2 - (1+i)) on the pairs (A_g, A_(g+3))):
// Fp4 square (T0, T1) = ((1+i)·t1 + t0, t2 - t0 - t1) with t0, t1, t2
// the squares of A_g, A_(g+3), A_g + A_(g+3); then C_k = 3·T0 - 2·A_k
// for even k (pair k/2) and C_k = 3·T1 + 2·A_k for odd k (pair
// ((k+3) mod 6)/2, T1 times 1 + i for k = 1)
BDLS_HD void cyclo_combine(fq12& c, const fp* prod, const fq12& a, int k) {
  fp re, im, t0r, t0i, t1r, t1i, u, v;
  const bool odd = k & 1;
  const int g = odd ? (k + 3) % 6 / 2 : k / 2;
  cyclo_sq(t0r, t0i, prod, g, 0);
  cyclo_sq(t1r, t1i, prod, g, 1);
  if (!odd) {
    fp_sub(re, t1r, t1i);
    fp_add(re, re, t0r);
    fp_add(im, t1r, t1i);
    fp_add(im, im, t0i);
  } else {
    cyclo_sq(re, im, prod, g, 2);
    fp_sub(re, re, t0r);
    fp_sub(re, re, t1r);
    fp_sub(im, im, t0i);
    fp_sub(im, im, t1i);
    if (k == 1) {
      fp_sub(u, re, im);
      fp_add(im, re, im);
      re = u;
    }
  }
  fp_add(u, re, re);
  fp_add(re, u, re);
  fp_add(u, im, im);
  fp_add(im, u, im);
  tw_coeff(u, v, a, k);
  fp_add(u, u, u);
  fp_add(v, v, v);
  if (odd) {
    fp_add(re, re, u);
    fp_add(im, im, v);
  } else {
    fp_sub(re, re, u);
    fp_sub(im, im, v);
  }
  tw_store(c, re, im, k);
}

// c = a^2 for a in the cyclotomic subgroup (c may be a)
BDLS_NOINL void w_cyclo_sqr(fp* prod, int lane, fq12& c, const fq12& a) {
  warp_step(lane, [&](int k) {
    if (k < 18) cyclo_task(prod, k, a);
  });
  warp_step(lane, [&](int k) {
    if (k < 6) cyclo_combine(c, prod, a, k);
  });
}

// c = conj(a) = frob6(a): the odd coefficients negated
BDLS_NOINL void w_conj(int lane, fq12& c, const fq12& a) {
  w_each(lane, [&](int k) {
    if (k & 1) {
      fp zero;
      fp_zero(zero);
      fp_sub(c.c[k], zero, a.c[k]);
    } else {
      c.c[k] = a.c[k];
    }
  });
}

// the sparse Frobenius table: entries (row i, column j, the constant's 12
// Montgomery words) of frob1, then of frob2, each by column
constexpr int FROB1_NNZ = 19;
constexpr int FROB2_NNZ = 12;
constexpr int FROB_ENTRY = 14;

// c = a·M over the nnz entries of a sparse Frobenius table (c may be a)
BDLS_NOINL void w_frob(fp* prod, int lane, fq12& c, const fq12& a,
                       const uint32_t* tab, int nnz) {
  warp_step(lane, [&](int k) {
    if (k >= nnz) return;
    const uint32_t* e = tab + k * FROB_ENTRY;
    fp m;
    fp_load_words(m, e + 2);
    fp_mul(prod[k], a.c[e[0]], m);
  });
  w_each(lane, [&](int k) {
    fp acc;
    fp_zero(acc);
    for (int e = 0; e < nnz; ++e)
      if ((int)tab[e * FROB_ENTRY + 1] == k) fp_add(acc, acc, prod[e]);
    c.c[k] = acc;
  });
}

// dst = base^e, e's top bit at top, by cyclotomic squares (dst != base)
BDLS_NOINL void w_pow_cyclo(fp* prod, int lane, fq12& dst, const fq12& base,
                            uint64_t e, int top) {
  w_each(lane, [&](int k) { dst.c[k] = base.c[k]; });
  BDLS_NOUNROLL
  for (int i = top - 1; i >= 0; --i) {
    w_cyclo_sqr(prod, lane, dst, dst);
    if ((e >> i) & 1) w_mul(prod, lane, dst, dst, base);
  }
}

// ------------------------------------- K9's Miller loop, a warp a pair
//
// A certificate lane's pairs have the twisted form: Q = sig or H(m), an
// image of the sextic twist, has Qx = X'·w^4 and Qy = Y'·w^3 with X', Y'
// in Fp2 (flat coefficients {4, 10} and {3, 9}); P = g1 or pk lies in
// E(Fp) (coefficient 0). Give w^k the weight k mod 6: RCB's formulas and
// the lines are weighted-homogeneous, so every value of the loop is one
// tower coefficient at a weight fixed by the public loop bits (T's X, Y,
// Z at 4, 3, 0 before the first doubling, at 1, 0, 3 after it; fd one
// coefficient throughout), except fn and the lines: a tangent or chord
// numerator has three tower coefficients. The form follows from the zero
// pattern alone, on the curve or off it, and every value is an exact
// field element, so the twisted path gives the reference's (n, d) word
// for word. It runs the reference's formulas in Fp2 with the zeros left
// out: a doubling bit is three product steps (fn's tower square beside
// the 8 Fp2 products of the tangent's first level, then 9 Fp2 products,
// then fn times the line's 3 coefficients, 87 + 27 + 57 Fp products
// over the warp), a chord bit three more (18 + 33 + 54), some 11,300 Fp
// products a pair where the dense formulas take some 124,000.
//
// Any other pair (a forged signature off the twist's image that still
// lies on E(FQ12), a degenerate y = 0 point) is dense: the warp runs the
// dense formulas (miller_dense) with tower products and squares, in the
// same launch. The class is read from the loaded values by every lane
// (warp-uniform); the all-zero pair is twisted.

// the twisted inputs' weights
constexpr int QX_DEG = 4;
constexpr int QY_DEG = 3;

BDLS_HD int wdeg(int a, int b) { return (a + b) % 6; }
BDLS_HD bool wraps(int a, int b) { return a + b >= 6; }

BDLS_HD void fp2_add(tw1& c, const tw1& a, const tw1& b) {
  fp_add(c.re, a.re, b.re);
  fp_add(c.im, a.im, b.im);
}

BDLS_HD void fp2_sub(tw1& c, const tw1& a, const tw1& b) {
  fp_sub(c.re, a.re, b.re);
  fp_sub(c.im, a.im, b.im);
}

BDLS_HD void fp2_small(tw1& c, const tw1& a, int k) {
  fp_mul_small(c.re, a.re, k);
  fp_mul_small(c.im, a.im, k);
}

// Fp2 product q of a step from its Karatsuba parts, times 1 + i when
// its operands' weights wrap past w^6
BDLS_HD void fp2_join(tw1& c, const fp* prod, int q, bool wrap) {
  const fp* v = prod + 3 * q;
  fp re, im;
  fp_sub(re, v[0], v[1]);
  fp_sub(im, v[2], v[0]);
  fp_sub(im, im, v[1]);
  if (wrap) {
    fp_sub(c.re, re, im);
    fp_add(c.im, re, im);
  } else {
    c.re = re;
    c.im = im;
  }
}

// one step of Fp2 products: pair(q, a, b) gives the operands of pair q
template <class P>
BDLS_HD void fp2_tasks(fp* prod, int lane, int pairs, const P& pair) {
  warp_step(lane, [&](int k) {
    for (int s = k; s < 3 * pairs; s += WARP) {
      tw1 a, b;
      pair(s / 3, a, b);
      fp2_part(prod[s], a, b, s % 3);
    }
  });
}

// the weights of the twisted loop's state
struct tw_deg {
  int fd, X, Y, Z;
};

// the three tower coefficients of a line and their weights
struct line_deg {
  int e[3];
};

// the twisted loop's values: fn (flat), the single-coefficient ones,
// and a bit's intermediates
constexpr int TW_VALS = 12;
struct tw_state {
  fq12 fn;
  tw1 fd, X, Y, Z, Qx, Qy, Px, Py;
  tw1 L[3];
  tw1 v[TW_VALS];
};

// fn times the line: pairs q = 6j + i (fn's A_i, the line's L_j) from
// prod[0], plus one more pair (fd's product) at q = 18
constexpr int LINE_PAIRS = 18;

BDLS_HD void line_pair(const tw_state& s, int q, tw1& a, tw1& b) {
  tw1_get(a, s.fn, q % 6);
  b = s.L[q / 6];
}

// combine task t: flat coefficient t of fn·line
BDLS_HD void line_combine(fq12& c, const fp* prod, line_deg g, int t) {
  const int k = t % 6;
  fp acc, u;
  fp_zero(acc);
  BDLS_NOUNROLL
  for (int j = 0; j < 3; ++j) {
    const int i = (k - g.e[j] + 6) % 6;
    flat_term(u, &prod[3 * (6 * j + i)], i + g.e[j] >= 6, t >= 6);
    fp_add(acc, acc, u);
  }
  c.c[t] = acc;
}

// the intermediates of a doubling bit
enum { V_A, V_C, V_YZ, V_PXZ, V_PYZ, V_Z3, V_Y3, V_T0, V_XY, V_FD2, V_T2,
       V_LDEN };

// a doubling bit: fn = fn²·l, fd = fd²·(C·Z), T = 2T (dbl_a0), the
// tangent l = A·(Px·Z - X) - C·(Py·Z - Y), A = 3X², C = 2YZ
BDLS_NOINL tw_deg tw_double(fp* prod, tw_state& s, int lane, tw_deg g) {
  const int P = SQR_PAIRS;
  // fn's square (pairs 0-20) and X², YZ, Px·Z, Py·Z, Y², Z², XY, fd²
  fp2_tasks(prod, lane, P + 8, [&](int q, tw1& a, tw1& b) {
    if (q < P) {
      int i, j;
      sqr_pair(q, i, j);
      tw1_get(a, s.fn, i);
      tw1_get(b, s.fn, j);
      return;
    }
    switch (q - P) {
      case 0: a = s.X; b = s.X; break;
      case 1: a = s.Y; b = s.Z; break;
      case 2: a = s.Px; b = s.Z; break;
      case 3: a = s.Py; b = s.Z; break;
      case 4: a = s.Y; b = s.Y; break;
      case 5: a = s.Z; b = s.Z; break;
      case 6: a = s.X; b = s.Y; break;
      default: a = s.fd; b = s.fd; break;
    }
  });
  const bool wXX = wraps(g.X, g.X), wYZ = wraps(g.Y, g.Z);
  const bool wYY = wraps(g.Y, g.Y), wZZ = wraps(g.Z, g.Z);
  warp_step(lane, [&](int k) {
    tw1 x, y;
    if (k < 12) {
      sqr_combine(s.fn, prod, k);
      return;
    }
    switch (k) {
      case 12:                                        // A = 3X²
        fp2_join(x, prod, P, wXX);
        fp2_small(s.v[V_A], x, 3);
        break;
      case 13:                                        // C = 2YZ
        fp2_join(x, prod, P + 1, wYZ);
        fp2_add(s.v[V_C], x, x);
        break;
      case 14: fp2_join(s.v[V_YZ], prod, P + 1, wYZ); break;
      case 15: fp2_join(s.v[V_PXZ], prod, P + 2, false); break;
      case 16: fp2_join(s.v[V_PYZ], prod, P + 3, false); break;
      case 17:                                        // z3 = 8Y²
        fp2_join(x, prod, P + 4, wYY);
        fp2_small(s.v[V_Z3], x, 8);
        break;
      case 18:                                        // t2 = 12Z²
        fp2_join(x, prod, P + 5, wZZ);
        fp2_small(s.v[V_T2], x, 12);
        break;
      case 19:                                        // y3 = Y² + 12Z²
        fp2_join(x, prod, P + 4, wYY);
        fp2_join(y, prod, P + 5, wZZ);
        fp2_small(y, y, 12);
        fp2_add(s.v[V_Y3], x, y);
        break;
      case 20:                                        // t0 = Y² - 36Z²
        fp2_join(x, prod, P + 4, wYY);
        fp2_join(y, prod, P + 5, wZZ);
        fp2_small(y, y, 36);
        fp2_sub(s.v[V_T0], x, y);
        break;
      case 21: fp2_join(s.v[V_XY], prod, P + 6, wraps(g.X, g.Y)); break;
      case 22: fp2_join(s.v[V_FD2], prod, P + 7, wraps(g.fd, g.fd)); break;
      default: break;
    }
  });
  const int dA = wdeg(g.X, g.X), dC = wdeg(g.Y, g.Z), dZ3 = wdeg(g.Y, g.Y);
  const int dT2 = wdeg(g.Z, g.Z), dXY = wdeg(g.X, g.Y);
  const int dFD2 = wdeg(g.fd, g.fd);
  // A·Px·Z, A·X, C·Py·Z, C·Y, C·Z, t2·z3, YZ·z3, t0·y3, t0·XY
  fp2_tasks(prod, lane, 9, [&](int q, tw1& a, tw1& b) {
    switch (q) {
      case 0: a = s.v[V_A]; b = s.v[V_PXZ]; break;
      case 1: a = s.v[V_A]; b = s.X; break;
      case 2: a = s.v[V_C]; b = s.v[V_PYZ]; break;
      case 3: a = s.v[V_C]; b = s.Y; break;
      case 4: a = s.v[V_C]; b = s.Z; break;
      case 5: a = s.v[V_T2]; b = s.v[V_Z3]; break;
      case 6: a = s.v[V_YZ]; b = s.v[V_Z3]; break;
      case 7: a = s.v[V_T0]; b = s.v[V_Y3]; break;
      default: a = s.v[V_T0]; b = s.v[V_XY]; break;
    }
  });
  line_deg l;
  l.e[0] = wdeg(dA, g.Z);
  l.e[1] = wdeg(dC, g.Y);                      // = wdeg(dA, g.X)
  l.e[2] = wdeg(dC, g.Z);
  const bool w1 = wraps(dA, g.X), w3 = wraps(dC, g.Y);
  const bool wZ3 = wraps(dT2, dZ3), wY3 = wraps(dZ3, dZ3);
  warp_step(lane, [&](int k) {
    tw1 x, y;
    switch (k) {
      case 0: fp2_join(s.L[0], prod, 0, wraps(dA, g.Z)); break;
      case 1:
        fp2_join(x, prod, 3, w3);
        fp2_join(y, prod, 1, w1);
        fp2_sub(s.L[1], x, y);
        break;
      case 2:
        fp2_join(x, prod, 2, wraps(dC, g.Z));
        fp_zero(y.re);
        fp_zero(y.im);
        fp2_sub(s.L[2], y, x);
        break;
      case 3: fp2_join(s.v[V_LDEN], prod, 4, wraps(dC, g.Z)); break;
      case 4:                                          // X = 2·t0·XY
        fp2_join(x, prod, 8, wraps(dZ3, dXY));
        fp2_add(s.X, x, x);
        break;
      case 5:                                          // Y = x3 + t0·y3
        fp2_join(x, prod, 5, wZ3);
        fp2_join(y, prod, 7, wY3);
        fp2_add(s.Y, x, y);
        break;
      case 6: fp2_join(s.Z, prod, 6, wraps(dC, dZ3)); break;
      default: break;
    }
  });
  const int dLDEN = l.e[2];
  tw_deg out{wdeg(dFD2, dLDEN), wdeg(dZ3, dXY), wdeg(dT2, dZ3),
             wdeg(dC, dZ3)};
  // fn² · l and fd² · C·Z
  fp2_tasks(prod, lane, LINE_PAIRS + 1, [&](int q, tw1& a, tw1& b) {
    if (q < LINE_PAIRS) {
      line_pair(s, q, a, b);
    } else {
      a = s.v[V_FD2];
      b = s.v[V_LDEN];
    }
  });
  const bool wFD = wraps(dFD2, dLDEN);
  warp_step(lane, [&](int k) {
    if (k < 12) line_combine(s.fn, prod, l, k);
    else if (k == 12) fp2_join(s.fd, prod, LINE_PAIRS, wFD);
  });
  return out;
}

// the intermediates of a chord bit
enum { V_CT, V_CA, V_T3, V_T4, V_C0, V_CZ3, V_C1, V_CY3 };

// a chord bit after its doubling: fn = fn·c, fd = fd·A with the chord
// c = (Qy·Z - Y)(Px - Qx) - A·(Py - Qy), A = Qx·Z - X; T = T + Q
// (add_a0 with Z2 = 1)
BDLS_NOINL tw_deg tw_chord(fp* prod, tw_state& s, int lane, tw_deg g) {
  // Qy·Z, Qx·Z, X·Qx, Y·Qy, X·Qy, Qx·Y
  fp2_tasks(prod, lane, 6, [&](int q, tw1& a, tw1& b) {
    switch (q) {
      case 0: a = s.Qy; b = s.Z; break;
      case 1: a = s.Qx; b = s.Z; break;
      case 2: a = s.X; b = s.Qx; break;
      case 3: a = s.Y; b = s.Qy; break;
      case 4: a = s.X; b = s.Qy; break;
      default: a = s.Qx; b = s.Y; break;
    }
  });
  const bool w0 = wraps(QY_DEG, g.Z), w1 = wraps(QX_DEG, g.Z);
  const bool w3 = wraps(g.Y, QY_DEG);
  warp_step(lane, [&](int k) {
    tw1 x, y;
    switch (k) {
      case 0:                                          // t = Qy·Z - Y
        fp2_join(x, prod, 0, w0);
        fp2_sub(s.v[V_CT], x, s.Y);
        break;
      case 1:                                          // A = Qx·Z - X
        fp2_join(x, prod, 1, w1);
        fp2_sub(s.v[V_CA], x, s.X);
        break;
      case 2:                                          // t3 = X·Qy + Qx·Y
        fp2_join(x, prod, 4, wraps(g.X, QY_DEG));
        fp2_join(y, prod, 5, wraps(QX_DEG, g.Y));
        fp2_add(s.v[V_T3], x, y);
        break;
      case 3:                                          // t4 = Y + Qy·Z
        fp2_join(x, prod, 0, w0);
        fp2_add(s.v[V_T4], s.Y, x);
        break;
      case 4:                                          // t0 = 3X·Qx
        fp2_join(x, prod, 2, wraps(g.X, QX_DEG));
        fp2_small(s.v[V_C0], x, 3);
        break;
      case 5:                                          // Z3 = Y·Qy + 12Z
        fp2_join(x, prod, 3, w3);
        fp2_small(y, s.Z, 12);
        fp2_add(s.v[V_CZ3], x, y);
        break;
      case 6:                                          // t1 = Y·Qy - 12Z
        fp2_join(x, prod, 3, w3);
        fp2_small(y, s.Z, 12);
        fp2_sub(s.v[V_C1], x, y);
        break;
      case 7:                                          // Y3 = 12(X + Qx·Z)
        fp2_join(x, prod, 1, w1);
        fp2_add(x, s.X, x);
        fp2_small(s.v[V_CY3], x, 12);
        break;
      default: break;
    }
  });
  const int dT = g.Y, dA = g.X, dT3 = wdeg(g.X, QY_DEG), dT4 = g.Y;
  const int dT0 = wdeg(g.X, QX_DEG), dZ3 = g.Z, dY3 = g.X;
  // t·Px, t·Qx, A·Py, A·Qy, fd·A, t3·t1, t4·Y3, t1·Z3, Y3·t0, Z3·t4, t0·t3
  fp2_tasks(prod, lane, 11, [&](int q, tw1& a, tw1& b) {
    switch (q) {
      case 0: a = s.v[V_CT]; b = s.Px; break;
      case 1: a = s.v[V_CT]; b = s.Qx; break;
      case 2: a = s.v[V_CA]; b = s.Py; break;
      case 3: a = s.v[V_CA]; b = s.Qy; break;
      case 4: a = s.fd; b = s.v[V_CA]; break;
      case 5: a = s.v[V_T3]; b = s.v[V_C1]; break;
      case 6: a = s.v[V_T4]; b = s.v[V_CY3]; break;
      case 7: a = s.v[V_C1]; b = s.v[V_CZ3]; break;
      case 8: a = s.v[V_CY3]; b = s.v[V_C0]; break;
      case 9: a = s.v[V_CZ3]; b = s.v[V_T4]; break;
      default: a = s.v[V_C0]; b = s.v[V_T3]; break;
    }
  });
  line_deg l;
  l.e[0] = dT;
  l.e[1] = dA;
  l.e[2] = wdeg(dA, QY_DEG);                   // = wdeg(dT, QX_DEG)
  warp_step(lane, [&](int k) {
    tw1 x, y;
    switch (k) {
      case 0: fp2_join(s.L[0], prod, 0, false); break;
      case 1:
        fp2_join(x, prod, 2, false);
        fp_zero(y.re);
        fp_zero(y.im);
        fp2_sub(s.L[1], y, x);
        break;
      case 2:
        fp2_join(x, prod, 3, wraps(dA, QY_DEG));
        fp2_join(y, prod, 1, wraps(dT, QX_DEG));
        fp2_sub(s.L[2], x, y);
        break;
      case 3: fp2_join(s.fd, prod, 4, wraps(g.fd, dA)); break;
      case 4:                                          // X = t3·t1 - t4·Y3
        fp2_join(x, prod, 5, wraps(dT3, dZ3));
        fp2_join(y, prod, 6, wraps(dT4, dY3));
        fp2_sub(s.X, x, y);
        break;
      case 5:                                          // Y = t1·Z3 + Y3·t0
        fp2_join(x, prod, 7, wraps(dZ3, dZ3));
        fp2_join(y, prod, 8, wraps(dY3, dT0));
        fp2_add(s.Y, x, y);
        break;
      case 6:                                          // Z = Z3·t4 + t0·t3
        fp2_join(x, prod, 9, wraps(dZ3, dT4));
        fp2_join(y, prod, 10, wraps(dT0, dT3));
        fp2_add(s.Z, x, y);
        break;
      default: break;
    }
  });
  tw_deg out{wdeg(g.fd, dA), wdeg(dT3, dZ3), wdeg(dZ3, dZ3), wdeg(dZ3, dT4)};
  fp2_tasks(prod, lane, LINE_PAIRS, [&](int q, tw1& a, tw1& b) {
    line_pair(s, q, a, b);
  });
  w_each(lane, [&](int k) { line_combine(s.fn, prod, l, k); });
  return out;
}

// twisted: Qx zero outside coefficients {4, 10}, Qy outside {3, 9}, Px
// and Py outside {0}; in holds Qx, Qy, Px, Py
BDLS_HD bool pair_twisted(const fq12* in) {
  bool ok = true;
  BDLS_NOUNROLL
  for (int c = 0; c < 12; ++c) {
    ok = ok && (c == 4 || c == 10 || fp_is_zero(in[0].c[c]));
    ok = ok && (c == 3 || c == 9 || fp_is_zero(in[1].c[c]));
    ok = ok && (c == 0 || (fp_is_zero(in[2].c[c]) && fp_is_zero(in[3].c[c])));
  }
  return ok;
}

// the twisted loop over in = (Qx, Qy, Px, Py): s.fn, and s.fd at the
// weight it returns
BDLS_NOINL int miller_twisted(fp* prod, tw_state& s, int lane,
                              const fq12* in) {
  warp_step(lane, [&](int k) {
    if (k < 12) {
      if (k == 0) fp_one(s.fn.c[0]);
      else fp_zero(s.fn.c[k]);
      return;
    }
    switch (k) {
      case 12: fp_one(s.fd.re); fp_zero(s.fd.im); break;
      case 13: fp_one(s.Z.re); fp_zero(s.Z.im); break;
      case 14: tw1_get(s.Qx, in[0], QX_DEG); s.X = s.Qx; break;
      case 15: tw1_get(s.Qy, in[1], QY_DEG); s.Y = s.Qy; break;
      case 16: tw1_get(s.Px, in[2], 0); break;
      case 17: tw1_get(s.Py, in[3], 0); break;
      default: break;
    }
  });
  tw_deg g{0, QX_DEG, QY_DEG, 0};
  BDLS_NOUNROLL
  for (int i = ATE_TOP - 1; i >= 0; --i) {
    g = tw_double(prod, s, lane, g);
    if ((ATE_LOOP >> i) & 1) g = tw_chord(prod, s, lane, g);
  }
  return g.fd;
}

// the warp's operations for the dense formulas
struct warp_ops {
  fp* prod;
  int lane;
  BDLS_HD void mul(fq12& c, const fq12& a, const fq12& b) const {
    w_mul(prod, lane, c, a, b);
  }
  BDLS_HD void sqr(fq12& c, const fq12& a) const { w_sqr(prod, lane, c, a); }
  BDLS_HD void add(fq12& c, const fq12& a, const fq12& b) const {
    w_each(lane, [&](int k) { fp_add(c.c[k], a.c[k], b.c[k]); });
  }
  BDLS_HD void sub(fq12& c, const fq12& a, const fq12& b) const {
    w_each(lane, [&](int k) { fp_sub(c.c[k], a.c[k], b.c[k]); });
  }
  BDLS_HD void small(fq12& c, const fq12& a, int m) const {
    w_each(lane, [&](int k) { fp_mul_small(c.c[k], a.c[k], m); });
  }
  BDLS_HD void one(fq12& c) const {
    w_each(lane, [&](int k) {
      if (k == 0) fp_one(c.c[0]);
      else fp_zero(c.c[k]);
    });
  }
  BDLS_HD void copy(fq12& c, const fq12& a) const {
    w_each(lane, [&](int k) { c.c[k] = a.c[k]; });
  }
};

struct dense_state {
  fq12 fn, fd, s[DENSE_SLOTS];
};

// one pair's work space: 17,856 bytes
struct miller_warp {
  fp prod[MUL_TASKS];
  fq12 in[4];                  // Qx, Qy, Px, Py
  union {
    tw_state tw;
    dense_state dn;
  } u;
};

// K9's Miller body: pair t of the (12, 12, N) arrays qx, qy, px, py ->
// (n, d) of miller_nd, canonical words, at lane t of n_out and d_out
BDLS_NOINL void miller_pair(miller_warp& w, int lane, const int32_t* qx,
                            const int32_t* qy, const int32_t* px,
                            const int32_t* py, int t, int N, int32_t* n_out,
                            int32_t* d_out) {
  warp_step(lane, [&](int k) {
    for (int s = k; s < 48; s += WARP) {
      const int32_t* src = s < 12 ? qx : s < 24 ? qy : s < 36 ? px : py;
      fp_load_coeff(w.in[s / 12].c[s % 12], src, s % 12, t, N);
    }
  });
  if (pair_twisted(w.in)) {
    tw_state& s = w.u.tw;
    const int dfd = miller_twisted(w.prod, s, lane, w.in);
    warp_step(lane, [&](int k) {
      if (k < 12) {
        fp_store_coeff(n_out, s.fn.c[k], k, t, N);
      } else if (k < 24) {
        const int c = k - 12;
        fp x;
        if (c == dfd) fp_sub(x, s.fd.re, s.fd.im);
        else if (c == dfd + 6) x = s.fd.im;
        else fp_zero(x);
        fp_store_coeff(d_out, x, c, t, N);
      }
    });
  } else {
    dense_state& s = w.u.dn;
    miller_dense(warp_ops{w.prod, lane}, s.fn, s.fd, w.in[0], w.in[1],
                 w.in[2], w.in[3], s.s);
    warp_step(lane, [&](int k) {
      if (k < 12) fp_store_coeff(n_out, s.fn.c[k], k, t, N);
      else if (k < 24) fp_store_coeff(d_out, s.fd.c[k - 12], k - 12, t, N);
    });
  }
}

// ------------------------------- the final exponentiation, a warp a side
//
// One warp computes one side's final exponentiation of X·Y, by one of two
// chains that share every step but the first power and the last product:
//
// - K11, the full exponent (p^12 - 1)/r, the value of the reference's
//   final_exp (bls_kernel.py:456-474), without square-and-multiply over
//   the exponent's 4,314 bits; K9, the x-chain 3(p^12 - 1)/r of the
//   reference's _compose_fe_fast (:433), K11's value cubed.
// - The easy part: m = frob2(m1)·m1, m1 = conj(f)·f^-1. The inverse goes
//   through the norm with 5 products: u = f·conj(f), u' = u^(p^2)·
//   u^(p^4), u2 = u·u', N(f) = u2·u2^p in Fp and f^-1 = conj(f)·u'·u2^p·
//   N(f)^-1 (zero -> zero).
// - The hard part. K11, by the exact chain: since 3 | x - 1,
//   (p^4 - p^2 + 1)/r = (x-1)^2/3·(x+p)·(x^2+p^2-1) + 1, so a = m^((x-1)/3)
//   = conj(m^((|x|+1)/3)), b = a^(x-1). K9, by the x-chain: 3H =
//   (x-1)^2·(x+p)·(x^2+p^2-1) + 3, so b = t2 = m^((x-1)^2): t1 =
//   conj(m^|x|·m), t2 = conj(t1^|x|·t1). Then both: t3 = conj(b^|x|)·
//   frob1(b) = b^(x+p), and t3^(x^2)·frob2(t3)·conj(t3) times m (K11) or
//   m^3 (K9).
// - After the easy part every value lies in the cyclotomic subgroup, so
//   every square there is Granger-Scott's cyclotomic square: 18 Fp
//   products in place of a dense square's 63. It maps 0 to 0, so a zero
//   side stays zero, as in the reference.
// - conj (frob6) flips the sign of the odd coefficients; frob1 and frob2
//   run over their nonzero entries only (19 and 12 of 144, a table the
//   host builds: bdls_tpu_torch/ops/bls_kernel.py:frob_sparse_host).

// (|x| + 1)/3 = |x - 1|/3, 63 bits, 28 of them set
constexpr uint64_t X_M1_3 = 0x460055555555AAABull;
constexpr int X_M1_3_TOP = 62;
constexpr int FW_SLOTS = 7;
constexpr int FW_OUT = 5;

// one side's work space
struct fe_warp {
  fq12 v[FW_SLOTS];
  fp prod[MUL_TASKS];
  fp inv;
};

// slot FW_OUT = slot 0 ^ ((p^12 - 1)/r), cubed when CUBE (K9's x-chain);
// frob is the sparse Frobenius table (FROB1_NNZ entries of frob1, then
// FROB2_NNZ of frob2)
template <bool CUBE>
BDLS_NOINL void final_exp_exact(fe_warp& w, int lane, const uint32_t* frob) {
  const uint32_t* frob1 = frob;
  const uint32_t* frob2 = frob + FROB1_NNZ * FROB_ENTRY;
  fq12* v = w.v;
  fp* prod = w.prod;
  // easy part, the inverse through the norm
  w_conj(lane, v[1], v[0]);                        // conj(f)
  w_mul(prod, lane, v[2], v[0], v[1]);             // u
  w_frob(prod, lane, v[3], v[2], frob2, FROB2_NNZ);
  w_frob(prod, lane, v[4], v[3], frob2, FROB2_NNZ);
  w_mul(prod, lane, v[3], v[3], v[4]);             // u'
  w_mul(prod, lane, v[2], v[2], v[3]);             // u2
  w_frob(prod, lane, v[4], v[2], frob1, FROB1_NNZ);   // u2^p
  w_mul(prod, lane, v[2], v[2], v[4]);             // N(f), in Fp
  w_mul(prod, lane, v[3], v[1], v[3]);
  w_mul(prod, lane, v[3], v[3], v[4]);             // N(f)/f
  warp_step(lane, [&](int k) {
    if (k == 0) fp_inv(w.inv, v[2].c[0]);          // one lane: Fermat
  });
  w_each(lane, [&](int k) { fp_mul(v[3].c[k], v[3].c[k], w.inv); });  // f^-1
  w_mul(prod, lane, v[0], v[1], v[3]);             // m1
  w_frob(prod, lane, v[1], v[0], frob2, FROB2_NNZ);
  w_mul(prod, lane, v[0], v[1], v[0]);             // m
  if (CUBE) {
    w_pow_cyclo(prod, lane, v[1], v[0], ATE_LOOP, ATE_TOP);
    w_mul(prod, lane, v[1], v[1], v[0]);
    w_conj(lane, v[1], v[1]);                      // t1 = m^(x-1)
  } else {
    w_pow_cyclo(prod, lane, v[1], v[0], X_M1_3, X_M1_3_TOP);
    w_conj(lane, v[1], v[1]);                      // a = m^((x-1)/3)
  }
  w_pow_cyclo(prod, lane, v[2], v[1], ATE_LOOP, ATE_TOP);
  w_mul(prod, lane, v[2], v[2], v[1]);
  w_conj(lane, v[2], v[2]);                        // b = v1^(x-1)
  w_pow_cyclo(prod, lane, v[3], v[2], ATE_LOOP, ATE_TOP);
  w_conj(lane, v[3], v[3]);
  w_frob(prod, lane, v[4], v[2], frob1, FROB1_NNZ);
  w_mul(prod, lane, v[3], v[3], v[4]);             // t3 = b^(x+p)
  w_pow_cyclo(prod, lane, v[4], v[3], ATE_LOOP, ATE_TOP);
  w_pow_cyclo(prod, lane, v[5], v[4], ATE_LOOP, ATE_TOP);   // t3^(x^2)
  w_frob(prod, lane, v[6], v[3], frob2, FROB2_NNZ);
  w_mul(prod, lane, v[5], v[5], v[6]);
  w_conj(lane, v[6], v[3]);
  w_mul(prod, lane, v[5], v[5], v[6]);             // t3^(x^2+p^2-1)
  if (CUBE) {
    w_cyclo_sqr(prod, lane, v[6], v[0]);
    w_mul(prod, lane, v[6], v[6], v[0]);
    w_mul(prod, lane, v[5], v[5], v[6]);           // ·m^3
  } else {
    w_mul(prod, lane, v[5], v[5], v[0]);           // ·m
  }
}

// one side: slot FW_OUT = FE(X·Y) for X lane tx of x and Y lane ty of y
// ((12, 12, N) canonical words), stored to lane tf of fe
template <bool CUBE>
BDLS_NOINL void final_side(fe_warp& w, int lane, const int32_t* x, int tx,
                           const int32_t* y, int ty, int N,
                           const uint32_t* frob, int32_t* fe, int tf) {
  warp_step(lane, [&](int k) {
    if (k < 12) fp_load_coeff(w.v[0].c[k], x, k, tx, N);
    else if (k < 24) fp_load_coeff(w.v[1].c[k - 12], y, k - 12, ty, N);
  });
  w_mul(w.prod, lane, w.v[0], w.v[0], w.v[1]);
  final_exp_exact<CUBE>(w, lane, frob);
  w_each(lane, [&](int k) { fp_store_coeff(fe, w.v[FW_OUT].c[k], k, tf, N); });
}

}  // namespace bdls
