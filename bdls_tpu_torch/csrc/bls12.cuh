// BLS12-381 pairing check for the pairing kernels (csrc/bls.cu, K9 and
// K11): FQ12 arithmetic, the Miller loop as numerator/denominator, the
// x-chain final exponentiation (K9), one lane a thread; the full-exponent
// one (K11), a warp a side; and the compare.
//
// Each step computes the value the reference computes
// (bdls_tpu/ops/bls_kernel.py), in the reference's representation:
//
// - FQ12 is Fp[w]/(w^12 - 2w^6 + 2), twelve Fp coefficients
//   (bdls_tpu/ops/bls_host.py). A product is the schoolbook convolution
//   (144 Montgomery products; a square 78) and the reduction by
//   w^12 = 2w^6 - 2 from the top degree down, as bls_host.FQ12.__mul__.
//   Frobenius^k is a 12 x 12 constant matrix, built on the host in
//   Montgomery form (bdls_tpu_torch/ops/bls_kernel.py:frob_table).
// - The Miller loop keeps miller_nd's num/den formulas in their order,
//   the tangent and chord lines at P and the complete RCB a = 0 point
//   formulas over FQ12 (dbl_a0, add_a0 with b3 = 12), so (n, d) equal
//   the reference's after canonicalisation. The loop bits are public,
//   so the chord is computed only where a bit is set (the reference
//   computes both arms and selects).
// - The final exponentiation is _compose_fe_fast's x-chain, except the
//   inverse: the reference inverts across lanes (_batch_inv12, one
//   Fermat inverse over p^12 - 2); here each lane inverts alone through
//   its norm, a^-1 = (a^p ... a^(p^11)) · N(a)^-1 with N(a) in Fp, and a
//   zero lane gives zero.
// - The full-exponent final exponentiation (K11) has the value of the
//   reference's final_exp (bls_kernel.py:456-474), x^((p^12 - 1)/r),
//   reached through the exact x-chain in place of square-and-multiply
//   over the exponent's 4,314 bits; see "K11" below.
// - The compare is _compare_tail: (lhs - rhs == 0) and (lhs != 0).
//
// Every value is an exact field element, so the order of commuting
// products does not matter; multiplications by the small constants 2, 3
// and 12 are additions.
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
BDLS_NOINL void f12_mul_small(fq12& out, const fq12& a, int k) {
  BDLS_NOUNROLL
  for (int i = 0; i < 12; ++i) {
    fp acc = a.c[i];
    int top = 31;
    while (!((k >> top) & 1)) --top;
    for (int bit = top - 1; bit >= 0; --bit) {
      fp_add(acc, acc, acc);
      if ((k >> bit) & 1) fp_add(acc, acc, a.c[i]);
    }
    out.c[i] = acc;
  }
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

// The Frobenius tables the final exponentiation reads: k = 1, 2, 6, one
// (12, 12, 12)-word matrix each, in that order.
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

// ------------------------------------------------------- the Miller loop

// Complete doubling, a = 0 (RCB Algorithm 9), b3 = 12: the sequence of
// bdls_tpu/ops/proj.py:dbl_a0 over FQ12.
BDLS_NOINL void f12_dbl_a0(fq12& X3, fq12& Y3, fq12& Z3, const fq12& X,
                           const fq12& Y, const fq12& Z) {
  fq12 t0, t1, t2, x3, y3, z3;
  f12_sqr(t0, Y);
  f12_add(z3, t0, t0);
  f12_add(z3, z3, z3);
  f12_add(z3, z3, z3);
  f12_mul(t1, Y, Z);
  f12_sqr(t2, Z);
  f12_mul_small(t2, t2, 12);
  f12_mul(x3, t2, z3);
  f12_add(y3, t0, t2);
  f12_mul(z3, t1, z3);
  f12_add(t1, t2, t2);
  f12_add(t2, t1, t2);
  f12_sub(t0, t0, t2);
  f12_mul(y3, t0, y3);
  f12_add(y3, x3, y3);
  f12_mul(t1, X, Y);
  f12_mul(x3, t0, t1);
  f12_add(x3, x3, x3);
  X3 = x3;
  Y3 = y3;
  Z3 = z3;
}

// Complete addition, a = 0 (RCB Algorithm 7), b3 = 12, Z2 = 1: the
// sequence of bdls_tpu/ops/proj.py:add_a0 over FQ12 (Z1·Z2 is Z1).
BDLS_NOINL void f12_add_a0(fq12& X, fq12& Y, fq12& Z, const fq12& X2,
                           const fq12& Y2) {
  fq12 t0, t1, t2, t3, t4, X3, Y3, Z3;
  f12_mul(t0, X, X2);
  f12_mul(t1, Y, Y2);
  t2 = Z;
  f12_add(t3, X, Y);
  f12_add(t4, X2, Y2);
  f12_mul(t3, t3, t4);
  f12_add(t4, t0, t1);
  f12_sub(t3, t3, t4);
  f12_add(t4, Y, Z);
  f12_one(X3);
  f12_add(X3, Y2, X3);
  f12_mul(t4, t4, X3);
  f12_add(X3, t1, t2);
  f12_sub(t4, t4, X3);
  f12_add(X3, X, Z);
  f12_one(Y3);
  f12_add(Y3, X2, Y3);
  f12_mul(X3, X3, Y3);
  f12_add(Y3, t0, t2);
  f12_sub(Y3, X3, Y3);
  f12_add(X3, t0, t0);
  f12_add(t0, X3, t0);
  f12_mul_small(t2, t2, 12);
  f12_add(Z3, t1, t2);
  f12_sub(t1, t1, t2);
  f12_mul_small(Y3, Y3, 12);
  f12_mul(X3, t4, Y3);
  f12_mul(t2, t3, t1);
  f12_sub(X3, t2, X3);
  f12_mul(Y3, Y3, t0);
  f12_mul(t1, t1, Z3);
  f12_add(Y3, t1, Y3);
  f12_mul(t0, t0, t3);
  f12_mul(Z3, Z3, t4);
  f12_add(Z3, Z3, t0);
  X = X3;
  Y = Y3;
  Z = Z3;
}

// f_{|x|,Q}(P) as (numerator, denominator), Q and P affine in E(FQ12):
// bdls_tpu/ops/bls_kernel.py:miller_nd, step for step.
BDLS_NOINL void miller_nd(fq12& fn, fq12& fd, const fq12& Qx, const fq12& Qy,
                          const fq12& Px, const fq12& Py) {
  fq12 X = Qx, Y = Qy, Z, A, C, t, u, l;
  f12_one(Z);
  f12_one(fn);
  f12_one(fd);
  BDLS_NOUNROLL
  for (int i = ATE_TOP - 1; i >= 0; --i) {
    // tangent at T, at P: l = A·(Px·Z - X) - C·(Py·Z - Y), over C·Z
    f12_sqr(A, X);
    f12_mul_small(A, A, 3);
    f12_mul(C, Y, Z);
    f12_mul_small(C, C, 2);
    f12_mul(t, Px, Z);
    f12_sub(t, t, X);
    f12_mul(t, A, t);
    f12_mul(u, Py, Z);
    f12_sub(u, u, Y);
    f12_mul(u, C, u);
    f12_sub(l, t, u);
    f12_sqr(fn, fn);
    f12_mul(fn, fn, l);
    f12_mul(l, C, Z);
    f12_sqr(fd, fd);
    f12_mul(fd, fd, l);
    f12_dbl_a0(X, Y, Z, X, Y, Z);
    if ((ATE_LOOP >> i) & 1) {
      // chord through T2 and Q, at P:
      // [(Qy·Z - Y)(Px - Qx) - (Qx·Z - X)(Py - Qy)] / (Qx·Z - X)
      f12_mul(t, Qy, Z);
      f12_sub(t, t, Y);
      f12_sub(u, Px, Qx);
      f12_mul(t, t, u);
      f12_mul(A, Qx, Z);
      f12_sub(A, A, X);
      f12_sub(u, Py, Qy);
      f12_mul(u, A, u);
      f12_sub(t, t, u);
      f12_mul(fn, fn, t);
      f12_mul(fd, fd, A);
      f12_add_a0(X, Y, Z, Qx, Qy);
    }
  }
}

// --------------------------------------------- the final exponentiation

// m^|x| over the loop bits
BDLS_NOINL void f12_pow_abs_x(fq12& out, const fq12& m) {
  fq12 acc = m;
  BDLS_NOUNROLL
  for (int i = ATE_TOP - 1; i >= 0; --i) {
    f12_sqr(acc, acc);
    if ((ATE_LOOP >> i) & 1) f12_mul(acc, acc, m);
  }
  out = acc;
}

// f^(3(p^12 - 1)/r) by the BLS12 x-chain of _compose_fe_fast:
// 3H = (x-1)^2 (x+p) (x^2+p^2-1) + 3 after the easy part (p^6-1)(p^2+1).
BDLS_NOINL void final_exp(fq12& out, const fq12& f, frob_tables fr) {
  fq12 m, t1, t2, t3, u;
  // easy part: m = frob2(m1)·m1, m1 = frob6(f)·f^-1
  f12_inv(u, f, fr.k1);
  f12_frob(m, f, fr.k6);
  f12_mul(m, m, u);
  f12_frob(u, m, fr.k2);
  f12_mul(m, u, m);
  // t1 = conj(m^|x|·m) = m^(x-1); t2 = t1^(x-1)
  f12_pow_abs_x(t1, m);
  f12_mul(t1, t1, m);
  f12_frob(t1, t1, fr.k6);
  f12_pow_abs_x(t2, t1);
  f12_mul(t2, t2, t1);
  f12_frob(t2, t2, fr.k6);
  // t3 = conj(t2^|x|)·frob1(t2) = t2^(x+p)
  f12_pow_abs_x(t3, t2);
  f12_frob(t3, t3, fr.k6);
  f12_frob(u, t2, fr.k1);
  f12_mul(t3, t3, u);
  // t1 = t3^(x^2) = conj(conj(t3^|x|)^|x|)
  f12_pow_abs_x(t1, t3);
  f12_frob(t1, t1, fr.k6);
  f12_pow_abs_x(t1, t1);
  f12_frob(t1, t1, fr.k6);
  // hard tail: t3^(x^2)·frob2(t3)·conj(t3)·m^3
  f12_frob(u, t3, fr.k2);
  f12_mul(t1, t1, u);
  f12_frob(u, t3, fr.k6);
  f12_mul(t1, t1, u);
  f12_sqr(u, m);
  f12_mul(u, u, m);
  f12_mul(out, t1, u);
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

// ------------------------------- K11: the exact x-chain, a warp a side
//
// One warp computes one side's (X·Y)^((p^12 - 1)/r), the value of the
// reference's final_exp, without square-and-multiply over the exponent:
//
// - The easy part, as in final_exp above: m = frob2(m1)·m1, m1 =
//   conj(f)·f^-1. The inverse goes through the norm with 5 products:
//   u = f·conj(f), u' = u^(p^2)·u^(p^4), u2 = u·u', N(f) = u2·u2^p in Fp
//   and f^-1 = conj(f)·u'·u2^p·N(f)^-1 (zero -> zero).
// - The hard part by the exact chain: since 3 | x - 1,
//   (p^4 - p^2 + 1)/r = (x-1)^2/3·(x+p)·(x^2+p^2-1) + 1, so
//   a = m^((x-1)/3) = conj(m^((|x|+1)/3)), b = a^(x-1), then K9's steps
//   from t2 on (final_exp above) with b for t2, ending with ·m in place
//   of ·m^3. That is 314 squares and 47 products in the five powers.
// - After the easy part every value lies in the cyclotomic subgroup, so
//   every square there is Granger-Scott's cyclotomic square: 18 Fp
//   products in place of a dense square's 78. It runs over the tower
//   Fp2[w]/(w^6 - (1+i)) that the flat basis already is: w^6 = 1 + i,
//   so a_k + a_(k+6)·w^6 = (a_k + a_(k+6)) + a_(k+6)·i, additions both
//   ways. It maps 0 to 0, so a zero side stays zero, as in the
//   reference.
// - conj (frob6) flips the sign of the odd coefficients; frob1 and frob2
//   run over their nonzero entries only (19 and 12 of 144, a table the
//   host builds: bdls_tpu_torch/ops/bls_kernel.py:frob_sparse_host).
// - A general product runs in the tower too: 36 Fp2 products of
//   Karatsuba's 3 Fp products each (108), summed per coefficient.
//
// Every value is an FQ12 in the flat basis, each coefficient canonical
// in Montgomery form, in the warp's work space (shared memory on the
// card). Each operation is a few steps; a step is a set of tasks, task s
// run by share s mod 32. On the card lane k runs share k and
// __syncwarp() separates the steps; on the host (g++) a loop runs the
// shares of a step in turn. The tasks of a step write distinct values
// and read none that another task of the step writes, so both orders
// give the same values. The public exponents keep every lane of a warp
// on one path.

constexpr int WARP = 32;
// (|x| + 1)/3 = |x - 1|/3, 63 bits, 28 of them set
constexpr uint64_t X_M1_3 = 0x460055555555AAABull;
constexpr int X_M1_3_TOP = 62;
// the Frobenius table: entries (row i, column j, the constant's 12
// Montgomery words) of frob1, then of frob2, each by column
constexpr int FROB1_NNZ = 19;
constexpr int FROB2_NNZ = 12;
constexpr int FROB_ENTRY = 14;
// Karatsuba's three Fp products for each of a product's 36 Fp2 pairs
constexpr int MUL_TASKS = 108;
constexpr int FW_SLOTS = 7;
constexpr int FW_OUT = 5;

// one side's work space
struct fe_warp {
  fq12 v[FW_SLOTS];
  fp prod[MUL_TASKS];
  fp inv;
};

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

// tower coefficient k of a flat value: re + im·i
BDLS_HD void tw_coeff(fp& re, fp& im, const fq12& a, int k) {
  fp_add(re, a.c[k], a.c[k + 6]);
  im = a.c[k + 6];
}

// tower coefficient k -> flat coefficients k and k + 6
BDLS_HD void tw_store(fq12& c, const fp& re, const fp& im, int k) {
  fp_sub(c.c[k], re, im);
  c.c[k + 6] = im;
}

// product task s: pair q = 6i + j, Karatsuba operand s % 3 (re·re,
// im·im, (re + im)·(re + im)) of A_i·B_j
BDLS_HD void mul_task(fe_warp& w, int s, const fq12& a, const fq12& b) {
  const int q = s / 3, part = s % 3;
  fp x, xi, y, yi;
  tw_coeff(x, xi, a, q / 6);
  tw_coeff(y, yi, b, q % 6);
  if (part == 1) {
    x = xi;
    y = yi;
  } else if (part == 2) {
    fp_add(x, x, xi);
    fp_add(y, y, yi);
  }
  fp_mul(w.prod[s], x, y);
}

// combine task t: flat coefficient t of C = A·B, C_k = sum over i of
// A_i·B_((k-i) mod 6), times 1 + i where i > k (w^6 wraps); with v0, v1,
// v2 a pair's Karatsuba products, re - im of a term is 2v0 - v2 (wrapped
// 2v0 + 2v1 - 2v2) and im is v2 - v0 - v1 (wrapped v2 - 2v1)
BDLS_HD void mul_combine(fq12& c, const fe_warp& w, int t) {
  const int k = t % 6;
  const bool im = t >= 6;
  fp acc, u;
  fp_zero(acc);
  BDLS_NOUNROLL
  for (int i = 0; i < 6; ++i) {
    const fp* v = &w.prod[3 * (6 * i + (k - i + 6) % 6)];
    if (i <= k && im) {
      fp_sub(u, v[2], v[0]);
      fp_sub(u, u, v[1]);
    } else if (i <= k) {
      fp_add(u, v[0], v[0]);
      fp_sub(u, u, v[2]);
    } else if (im) {
      fp_sub(u, v[2], v[1]);
      fp_sub(u, u, v[1]);
    } else {
      fp_add(u, v[0], v[1]);
      fp_sub(u, u, v[2]);
      fp_add(u, u, u);
    }
    fp_add(acc, acc, u);
  }
  c.c[im ? k + 6 : k] = acc;
}

// c = a·b (c may be a or b)
BDLS_NOINL void w_mul(fe_warp& w, int lane, fq12& c, const fq12& a,
                      const fq12& b) {
  warp_step(lane, [&](int k) {
    for (int s = k; s < MUL_TASKS; s += WARP) mul_task(w, s, a, b);
  });
  warp_step(lane, [&](int k) {
    if (k < 12) mul_combine(c, w, k);
  });
}

// cyclotomic-square task s < 18: Fp2 square q = s / 2 of pair g = q / 3
// (A_g, A_(g+3)): which = q % 3 squares A_g, A_(g+3) or their sum; part
// s % 2 takes (x + y)(x - y) or x·y of x + y·i
BDLS_HD void cyclo_task(fe_warp& w, int s, const fq12& a) {
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
    fp_mul(w.prod[s], x2, y2);
  } else {
    fp_mul(w.prod[s], x, y);
  }
}

// the square of cyclo_task's pair g, which: re + im·i
BDLS_HD void cyclo_sq(fp& re, fp& im, const fe_warp& w, int g, int which) {
  const int q = 3 * g + which;
  re = w.prod[2 * q];
  fp_add(im, w.prod[2 * q + 1], w.prod[2 * q + 1]);
}

// combine task k < 6: tower coefficient k of the square (Granger-Scott
// over Fp4 = Fp2[y]/(y^2 - (1+i)) on the pairs (A_g, A_(g+3))):
// Fp4 square (T0, T1) = ((1+i)·t1 + t0, t2 - t0 - t1) with t0, t1, t2
// the squares of A_g, A_(g+3), A_g + A_(g+3); then C_k = 3·T0 - 2·A_k
// for even k (pair k/2) and C_k = 3·T1 + 2·A_k for odd k (pair
// ((k+3) mod 6)/2, T1 times 1 + i for k = 1)
BDLS_HD void cyclo_combine(fq12& c, const fe_warp& w, const fq12& a,
                           int k) {
  fp re, im, t0r, t0i, t1r, t1i, u, v;
  const bool odd = k & 1;
  const int g = odd ? (k + 3) % 6 / 2 : k / 2;
  cyclo_sq(t0r, t0i, w, g, 0);
  cyclo_sq(t1r, t1i, w, g, 1);
  if (!odd) {
    fp_sub(re, t1r, t1i);
    fp_add(re, re, t0r);
    fp_add(im, t1r, t1i);
    fp_add(im, im, t0i);
  } else {
    cyclo_sq(re, im, w, g, 2);
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
BDLS_NOINL void w_cyclo_sqr(fe_warp& w, int lane, fq12& c, const fq12& a) {
  warp_step(lane, [&](int k) {
    if (k < 18) cyclo_task(w, k, a);
  });
  warp_step(lane, [&](int k) {
    if (k < 6) cyclo_combine(c, w, a, k);
  });
}

// c = conj(a) = frob6(a): the odd coefficients negated
BDLS_NOINL void w_conj(int lane, fq12& c, const fq12& a) {
  warp_step(lane, [&](int k) {
    if (k >= 12) return;
    if (k & 1) {
      fp zero;
      fp_zero(zero);
      fp_sub(c.c[k], zero, a.c[k]);
    } else {
      c.c[k] = a.c[k];
    }
  });
}

// c = a·M over the nnz entries of a sparse Frobenius table (c may be a)
BDLS_NOINL void w_frob(fe_warp& w, int lane, fq12& c, const fq12& a,
                       const uint32_t* tab, int nnz) {
  warp_step(lane, [&](int k) {
    if (k >= nnz) return;
    const uint32_t* e = tab + k * FROB_ENTRY;
    fp m;
    fp_load_words(m, e + 2);
    fp_mul(w.prod[k], a.c[e[0]], m);
  });
  warp_step(lane, [&](int k) {
    if (k >= 12) return;
    fp acc;
    fp_zero(acc);
    for (int e = 0; e < nnz; ++e)
      if ((int)tab[e * FROB_ENTRY + 1] == k) fp_add(acc, acc, w.prod[e]);
    c.c[k] = acc;
  });
}

// dst = base^e, e's top bit at top, by cyclotomic squares (dst != base)
BDLS_NOINL void w_pow_cyclo(fe_warp& w, int lane, fq12& dst,
                            const fq12& base, uint64_t e, int top) {
  warp_step(lane, [&](int k) {
    if (k < 12) dst.c[k] = base.c[k];
  });
  BDLS_NOUNROLL
  for (int i = top - 1; i >= 0; --i) {
    w_cyclo_sqr(w, lane, dst, dst);
    if ((e >> i) & 1) w_mul(w, lane, dst, dst, base);
  }
}

// slot FW_OUT = slot 0 ^ ((p^12 - 1)/r); frob is the sparse Frobenius
// table (FROB1_NNZ entries of frob1, then FROB2_NNZ of frob2)
BDLS_NOINL void final_exp_exact(fe_warp& w, int lane, const uint32_t* frob) {
  const uint32_t* frob1 = frob;
  const uint32_t* frob2 = frob + FROB1_NNZ * FROB_ENTRY;
  fq12* v = w.v;
  // easy part, the inverse through the norm
  w_conj(lane, v[1], v[0]);                     // conj(f)
  w_mul(w, lane, v[2], v[0], v[1]);                // u
  w_frob(w, lane, v[3], v[2], frob2, FROB2_NNZ);
  w_frob(w, lane, v[4], v[3], frob2, FROB2_NNZ);
  w_mul(w, lane, v[3], v[3], v[4]);                // u'
  w_mul(w, lane, v[2], v[2], v[3]);                // u2
  w_frob(w, lane, v[4], v[2], frob1, FROB1_NNZ);   // u2^p
  w_mul(w, lane, v[2], v[2], v[4]);                // N(f), in Fp
  w_mul(w, lane, v[3], v[1], v[3]);
  w_mul(w, lane, v[3], v[3], v[4]);                // N(f)/f
  warp_step(lane, [&](int k) {
    if (k == 0) fp_inv(w.inv, v[2].c[0]);          // one lane: Fermat
  });
  warp_step(lane, [&](int k) {
    if (k < 12) fp_mul(v[3].c[k], v[3].c[k], w.inv);
  });                                              // f^-1
  w_mul(w, lane, v[0], v[1], v[3]);                // m1
  w_frob(w, lane, v[1], v[0], frob2, FROB2_NNZ);
  w_mul(w, lane, v[0], v[1], v[0]);                // m
  // hard part: m^((x-1)^2/3·(x+p)·(x^2+p^2-1) + 1)
  w_pow_cyclo(w, lane, v[1], v[0], X_M1_3, X_M1_3_TOP);
  w_conj(lane, v[1], v[1]);                     // a = m^((x-1)/3)
  w_pow_cyclo(w, lane, v[2], v[1], ATE_LOOP, ATE_TOP);
  w_mul(w, lane, v[2], v[2], v[1]);
  w_conj(lane, v[2], v[2]);                     // b = a^(x-1)
  w_pow_cyclo(w, lane, v[3], v[2], ATE_LOOP, ATE_TOP);
  w_conj(lane, v[3], v[3]);
  w_frob(w, lane, v[4], v[2], frob1, FROB1_NNZ);
  w_mul(w, lane, v[3], v[3], v[4]);                // t3 = b^(x+p)
  w_pow_cyclo(w, lane, v[4], v[3], ATE_LOOP, ATE_TOP);
  w_pow_cyclo(w, lane, v[5], v[4], ATE_LOOP, ATE_TOP);   // t3^(x^2)
  w_frob(w, lane, v[6], v[3], frob2, FROB2_NNZ);
  w_mul(w, lane, v[5], v[5], v[6]);
  w_conj(lane, v[6], v[3]);
  w_mul(w, lane, v[5], v[5], v[6]);                // t3^(x^2+p^2-1)
  w_mul(w, lane, v[5], v[5], v[0]);                // ·m
}

// K11's side: slot FW_OUT = (X·Y)^((p^12 - 1)/r) for X lane tx of x and
// Y lane ty of y ((12, 12, N) canonical words), stored to lane tf of fe
BDLS_NOINL void final_full_side(fe_warp& w, int lane, const int32_t* x,
                                int tx, const int32_t* y, int ty, int N,
                                const uint32_t* frob, int32_t* fe, int tf) {
  warp_step(lane, [&](int k) {
    if (k < 12) fp_load_coeff(w.v[0].c[k], x, k, tx, N);
    else if (k < 24) fp_load_coeff(w.v[1].c[k - 12], y, k - 12, ty, N);
  });
  w_mul(w, lane, w.v[0], w.v[0], w.v[1]);
  final_exp_exact(w, lane, frob);
  warp_step(lane, [&](int k) {
    if (k < 12) fp_store_coeff(fe, w.v[FW_OUT].c[k], k, tf, N);
  });
}

}  // namespace bdls
