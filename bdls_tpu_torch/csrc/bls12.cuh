// BLS12-381 pairing check for the pairing kernels (csrc/bls.cu, K9 and
// K11): FQ12 arithmetic, the Miller loop as numerator/denominator, the
// x-chain final exponentiation (K9), the full-exponent one (K11) and the
// compare, one lane a thread.
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
// - The full-exponent final exponentiation (K11) is the reference's
//   final_exp (bls_kernel.py:456-474): square-and-multiply over the bits
//   of (p^12 - 1)/r, starting from x for the leading one. The bits are
//   data (a device array the host builds from p and r), so no 4,314-bit
//   literal sits in the source; the product is skipped on a zero bit,
//   where the reference computes it and selects the square.
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

// x^e for e = (p^12 - 1)/r, by square-and-multiply over e's nbits bits,
// most significant first (bits[0] is the leading one): the reference's
// final_exp. Its value is the x-chain's cube root (final_exp above
// computes x^(3e)).
BDLS_NOINL void final_exp_full(fq12& out, const fq12& x,
                               const uint8_t* bits, int nbits) {
  fq12 acc = x;
  BDLS_NOUNROLL
  for (int i = 1; i < nbits; ++i) {
    f12_sqr(acc, acc);
    if (bits[i]) f12_mul(acc, acc, x);
  }
  out = acc;
}

// _compare_tail: lhs == rhs and lhs != 0 (the zero-collapse guard)
BDLS_HD bool compare_tail(const fq12& lhs, const fq12& rhs) {
  fq12 diff;
  f12_sub(diff, lhs, rhs);
  return f12_is_zero(diff) && !f12_is_zero(lhs);
}

// ------------------------------------------------ loads and stores

// (12 words, 12 coefficients, N) int32 canonical-layout array -> one
// Montgomery-form FQ12 (any 384-bit coefficient is read mod p)
BDLS_HD void f12_load(fq12& out, const int32_t* a, int t, int N) {
  BDLS_NOUNROLL
  for (int c = 0; c < 12; ++c) {
    fp x;
    BDLS_UNROLL
    for (int w = 0; w < 12; ++w)
      x.v[w] = (uint32_t)a[(size_t)(w * 12 + c) * N + t];
    fp_to_mont(out.c[c], x);
  }
}

// one Montgomery-form FQ12 -> canonical words in the same layout
BDLS_HD void f12_store(int32_t* a, const fq12& x, int t, int N) {
  BDLS_NOUNROLL
  for (int c = 0; c < 12; ++c) {
    fp y;
    fp_from_mont(y, x.c[c]);
    BDLS_UNROLL
    for (int w = 0; w < 12; ++w)
      a[(size_t)(w * 12 + c) * N + t] = (int32_t)y.v[w];
  }
}

}  // namespace bdls
