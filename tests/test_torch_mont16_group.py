"""K4's thread-group body (``csrc/mont16_group.cuh``), built for the host
with g++.

On the card GROUP threads carry one gen-1 lane, a step's tasks split
over them and a ``__syncwarp`` between steps; on the host the shares of
a step run one after another. This test builds a small C shim over the
headers into ``build/`` (``_build.host_shim``) as the kernel is built (8
threads a lane) and checks, every comparison exact, with the shares of
every step forward and reversed:

- each level-split formula against the one-thread ``m16::jdouble``,
  ``jadd`` and ``jadd_mixed`` of ``csrc/mont16.cuh``, word for word: a
  doubling in place, an addition in place (its exceptional double run
  when P == Q), a mixed addition into a table entry, and the ladder's
  chain 1 (a mixed addition with P's doubling beside it, and its G digit
  of 0), on seeded points, P at infinity, Q at infinity, P == Q (one and
  two Jacobian representatives), P == -Q and values off the curve;
- the verify, lane for lane: the verdicts against the integer ECDSA
  (``vectors.expected``) on the hostile lanes of ``vectors.mixed_lanes``
  (r or s of 0, n or 2^256 - 1, Q off the curve, Q = (0, 0), the r + n
  branch, tampered digests), the ladder's edge lanes and the lanes of
  ``vectors.select_lanes``, which take each exceptional select; u1, u2
  and s^-1·R mod n against Python integers; R in affine form against
  the integer u1·G + u2·Q, and word for word against the one-thread
  formulas run in the group body's order (acc + (Q entry + G entry)).
  (The plain twin's verdicts on the same body: ``tests/
  test_torch_host_k4k5.py``, which shares no build with this file.)

The test skips, from a fixture, where g++ is absent.
"""

from __future__ import annotations

import ctypes
import shutil

import numpy as np
import pytest
import torch

from bdls_tpu_torch.crypto import vectors
from bdls_tpu_torch.crypto.marshal import ints_to_limbs
from bdls_tpu_torch.crypto.sw import _mul_add, on_curve
from bdls_tpu_torch.ops import _build, ecdsa
from bdls_tpu_torch.ops.curves import CURVES
from bdls_tpu_torch.ops.ecdsa import CURVE_IDS

SHIM = r"""
#include <string.h>

#include "mont16_group.cuh"
using namespace bdls;

static fe getw(const uint32_t* w) {
  fe a;
  for (int i = 0; i < 8; ++i) a.v[i] = w[i];
  return a;
}

static void putw(uint32_t* w, const fe& a) {
  for (int i = 0; i < 8; ++i) w[i] = a.v[i];
}

static m16::jpt getp(const uint32_t* w) {
  m16::jpt p;
  p.x = getw(w);
  p.y = getw(w + 8);
  p.z = getw(w + 16);
  return p;
}

static void putp(uint32_t* w, const m16::jpt& p) {
  putw(w, p.x);
  putw(w + 8, p.y);
  putw(w + 16, p.z);
}

// K4's group body on B lanes: the verdicts, and each lane's u1 and u2
// (plain), s^-1·R mod n and R (X, Y, Z, Montgomery form)
template <class C>
static void verify_run(const int32_t* qx, const int32_t* qy,
                       const int32_t* r, const int32_t* s, const int32_t* e,
                       const uint32_t* gtab, uint8_t* out, uint32_t* u,
                       uint32_t* sm, uint32_t* R, int B) {
  grp::m16_state* st = new grp::m16_state();
  const grp::gctx g{0, 0};
  for (int b = 0; b < B; ++b) {
    out[b] = grp::verify_lane_mont16_group<C>(g, *st, qx, qy, r, s, e, gtab,
                                              b, B) ? 1 : 0;
    putw(u + 16 * b, st->u1);
    putw(u + 16 * b + 8, st->u2);
    putw(sm + 8 * b, st->sm);
    putp(R + 24 * b, st->pt[grp::PT_ACC]);
  }
  delete st;
}

extern "C" void host_verify(int curve, const int32_t* qx, const int32_t* qy,
                            const int32_t* r, const int32_t* s,
                            const int32_t* e, const uint32_t* gtab,
                            uint8_t* out, uint32_t* u, uint32_t* sm,
                            uint32_t* R, int B, int reverse) {
  grp::host_reverse() = reverse != 0;
  if (curve == 0)
    verify_run<CurveP256>(qx, qy, r, s, e, gtab, out, u, sm, R, B);
  else
    verify_run<CurveK256>(qx, qy, r, s, e, gtab, out, u, sm, R, B);
  grp::host_reverse() = false;
}

// the group body's ladder on the one-thread formulas: the table, then a
// window at a time 4 doublings and acc + (Q entry + G entry)
template <class C>
static m16::jpt ladder(const fe& u1, const fe& u2, const fe& qx,
                       const fe& qy, const uint32_t* gtab) {
  typedef typename C::P F;
  m16::jpt tab[15], o, acc, t;
  fe one;
  load_one<F>(one);
  memset(&o, 0, sizeof o);
  o.y = one;
  tab[0].x = qx;
  tab[0].y = qy;
  tab[0].z = one;
  m16::jdouble<C>(tab[1], tab[0]);
  for (int k = 2; k < 15; ++k) m16::jadd_mixed<C>(tab[k], tab[k - 1], qx, qy);
  acc = o;
  for (int w = 0; w < 64; ++w) {
    for (int d = 0; d < 4; ++d) {
      m16::jdouble<C>(t, acc);
      acc = t;
    }
    const uint32_t dq = m16::nibble_msb(u2, w), dg = m16::nibble_msb(u1, w);
    m16::jpt sum = dq ? tab[dq - 1] : o;
    if (dg) {
      const m16::jpt pq = sum;
      m16::jadd_mixed<C>(sum, pq, getw(gtab + 16 * dg),
                         getw(gtab + 16 * dg + 8));
    }
    m16::jadd<C>(t, acc, sum);
    acc = t;
  }
  return acc;
}

extern "C" void host_ladder(int curve, const uint32_t* u, const int32_t* qx,
                            const int32_t* qy, const uint32_t* gtab,
                            uint32_t* R, int B) {
  for (int b = 0; b < B; ++b) {
    fe x, y, xm, ym;
    load_limbs16(x, qx, b, B);
    load_limbs16(y, qy, b, B);
    const fe u1 = getw(u + 16 * b), u2 = getw(u + 16 * b + 8);
    m16::jpt acc;
    if (curve == 0) {
      to_mont<P256P>(xm, x);
      to_mont<P256P>(ym, y);
      acc = ladder<CurveP256>(u1, u2, xm, ym, gtab);
    } else {
      to_mont<K256P>(xm, x);
      to_mont<K256P>(ym, y);
      acc = ladder<CurveK256>(u1, u2, xm, ym, gtab);
    }
    putp(R + 24 * b, acc);
  }
}

// an addition alone, as the group body runs one: levels 0-3, P doubled
// into PT_DBL when P == Q, level 4
template <class C>
static void run_alone(grp::m16_state& st, grp::m16_part a) {
  const grp::gctx g{0, 0};
  const grp::m16_part off = grp::m16_off();
  for (int L = 0; L < 4; ++L) {
    a.level = (uint8_t)L;
    grp::m16_run<C>(g, st, nullptr, a, off, off);
  }
  if (st.flags[a.chain] & grp::M16_SAME)
    for (int L = 0; L < grp::m16_levels<C>(grp::M16_DBL); ++L)
      grp::m16_run<C>(g, st, nullptr,
                      grp::m16_op(grp::M16_DBL, L, a.p, grp::PT_DBL,
                                  grp::BANKD),
                      off, off);
  a.level = 4;
  grp::m16_run<C>(g, st, nullptr, a, off, off);
}

// One formula, the group's and the one-thread one: kind 0 a doubling in
// place; 1 an addition P + Q in place (the exceptional double run when
// P == Q); 2 a mixed addition P + (Qx, Qy) into a table entry; 3 chain
// 1's mixed addition, P's doubling beside it (keep: a G digit of 0, the
// result P).
template <class C>
static void formula_run(int kind, const uint32_t* pw, const uint32_t* qw,
                        int keep, uint32_t* got, uint32_t* want) {
  using namespace grp;
  m16_state* st = new m16_state();
  const gctx g{0, 0};
  const m16::jpt P = getp(pw), Q = getp(qw);
  const m16_part off = m16_off();
  m16::jpt ref;
  st->pt[PT_ACC] = P;
  int out = PT_ACC;
  if (kind == 0) {
    for (int L = 0; L < m16_levels<C>(M16_DBL); ++L)
      m16_run<C>(g, *st, nullptr,
                 m16_op(M16_DBL, L, PT_ACC, PT_ACC, BANK0), off, off);
    m16::jdouble<C>(ref, P);
  } else if (kind == 1) {
    st->pt[PT_SUM] = Q;
    run_alone<C>(*st, m16_op(M16_ADD, 0, PT_ACC, PT_ACC, BANK0, 0, PT_SUM));
    m16::jadd<C>(ref, P, Q);
  } else if (kind == 2) {
    st->pt[PT_TAB] = Q;              // the table's affine Q: x, y
    out = PT_TAB + 1;
    run_alone<C>(*st, m16_op(M16_MADD, 0, PT_ACC, out, BANK0));
    m16::jadd_mixed<C>(ref, P, Q.x, Q.y);
  } else {
    st->ge[0] = Q.x;
    st->ge[1] = Q.y;
    out = PT_SUM;
    for (int L = 0; L < 5; ++L) {
      m16_part a = m16_op(M16_MADD, L, PT_ACC, PT_SUM, BANK1, 1);
      a.keep = keep != 0;
      const m16_part d = L < m16_levels<C>(M16_DBL)
          ? m16_op(M16_DBL, L, PT_ACC, PT_DBL, BANKD) : off;
      m16_run<C>(g, *st, nullptr, off, a, d);
    }
    if (keep) ref = P;
    else m16::jadd_mixed<C>(ref, P, Q.x, Q.y);
  }
  putp(got, st->pt[out]);
  putp(want, ref);
  delete st;
}

extern "C" void host_formula(int curve, int kind, const uint32_t* p,
                             const uint32_t* q, int keep, uint32_t* got,
                             uint32_t* want, int reverse) {
  grp::host_reverse() = reverse != 0;
  if (curve == 0) formula_run<CurveP256>(kind, p, q, keep, got, want);
  else formula_run<CurveK256>(kind, p, q, keep, got, want);
  grp::host_reverse() = false;
}
"""

R256 = 1 << 256


@pytest.fixture(scope="module")
def shim():
    if shutil.which("g++") is None:
        pytest.skip("g++ not found: the host build of the kernel is skipped")
    return _build.host_shim(SHIM, "host_mont16_group")


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def _u32(vals) -> np.ndarray:
    return np.array([[(v >> (32 * i)) & 0xFFFFFFFF for i in range(8)]
                     for v in vals], dtype=np.uint32)


def _ints(a: np.ndarray) -> list[int]:
    a = a.reshape(-1, 8).astype(object)
    return [sum(int(w) << (32 * i) for i, w in enumerate(row)) for row in a]


def _jac(curve: str, pt, z: int) -> list[int]:
    """Affine (x, y) (None: infinity) as Jacobian (x·z^2, y·z^3, z) in
    Montgomery form; infinity is (R, R, 0)."""
    p = CURVES[curve].fp.modulus
    if pt is None:
        return [R256 % p, R256 % p, 0]
    x, y = pt
    return [x * z * z * R256 % p, y * z ** 3 * R256 % p, z * R256 % p]


def _affine(curve: str, X: int, Y: int, Z: int):
    """Jacobian words (Montgomery form) -> affine integers (None: Z = 0)."""
    p = CURVES[curve].fp.modulus
    ri = pow(R256, -1, p)
    X, Y, Z = X * ri % p, Y * ri % p, Z * ri % p
    if Z == 0:
        return None
    zi = pow(Z, -1, p)
    return X * zi * zi % p, Y * zi ** 3 % p


def _point(curve: str, rng):
    cv = CURVES[curve]
    k = int.from_bytes(rng.bytes(32), "big") % (cv.fn.modulus - 1) + 1
    return _mul_add(cv, k, (cv.gx, cv.gy))


def _neg(curve: str, pt):
    return pt[0], (-pt[1]) % CURVES[curve].fp.modulus


def _formula_cases(curve: str, rng) -> list[tuple[str, list, list]]:
    """(label, P, Q) as Jacobian Montgomery integers."""
    p = CURVES[curve].fp.modulus

    def z():
        return int.from_bytes(rng.bytes(32), "big") % (p - 1) + 1

    a, b = _point(curve, rng), _point(curve, rng)
    junk = [int.from_bytes(rng.bytes(32), "big") % p for _ in range(6)]
    return [
        ("P + Q", _jac(curve, a, z()), _jac(curve, b, z())),
        ("P + Q, Z2 = 1", _jac(curve, a, z()), _jac(curve, b, 1)),
        ("P == Q, two representatives", _jac(curve, a, z()),
         _jac(curve, a, z())),
        ("P == Q, one representative", _jac(curve, a, 1), _jac(curve, a, 1)),
        ("P == -Q", _jac(curve, a, z()), _jac(curve, _neg(curve, a), z())),
        ("P == Q, Q affine", _jac(curve, a, z()), _jac(curve, a, 1)),
        ("P == -Q, Q affine", _jac(curve, a, z()),
         _jac(curve, _neg(curve, a), 1)),
        ("P at infinity, Q affine", _jac(curve, None, 1), _jac(curve, b, 1)),
        ("P at infinity", _jac(curve, None, 1), _jac(curve, b, z())),
        ("Q at infinity", _jac(curve, a, z()), _jac(curve, None, 1)),
        ("both at infinity", _jac(curve, None, 1), _jac(curve, None, 1)),
        ("off the curve", junk[:3], junk[3:]),
    ]


@pytest.mark.parametrize("curve", sorted(CURVES))
def test_level_formulas_match_one_thread_word_for_word(shim, curve):
    rng = np.random.default_rng(181)
    cases = _formula_cases(curve, rng)
    n = 0
    for label, P, Q in cases:
        # a mixed addition's Q is affine: its Z = 1 (infinity has no
        # affine form)
        for kind, keep in ((0, 0), (1, 0), (2, 0), (3, 0), (3, 1)):
            if kind >= 2 and Q[2] != R256 % CURVES[curve].fp.modulus:
                continue
            pw, qw = _u32(P), _u32(Q)
            for reverse in (0, 1):
                got, want = np.zeros(24, np.uint32), np.zeros(24, np.uint32)
                shim.host_formula(CURVE_IDS[curve], kind, _ptr(pw), _ptr(qw),
                                  keep, _ptr(got), _ptr(want), reverse)
                assert got.tolist() == want.tolist(), (label, kind, keep,
                                                       reverse)
                n += 1
    assert n == 2 * (12 * 2 + 5 * 3)


def _verify_lanes(curve: str) -> list[tuple]:
    rng = np.random.default_rng(183)
    return (vectors.mixed_lanes(curve, rng, n_valid=3)
            + vectors.ladder_lanes(curve, rng)
            + vectors.select_lanes(curve, rng))


def _run_verify(shim, curve, lanes, reverse):
    cols = [np.ascontiguousarray(ints_to_limbs(c).view(np.int32))
            for c in vectors.columns(lanes)]
    gtab = ecdsa.device_mont16_table(curve, torch.device("cpu")).numpy()
    B = len(lanes)
    out = np.zeros(B, np.uint8)
    u = np.zeros((B, 2, 8), np.uint32)
    sm = np.zeros((B, 8), np.uint32)
    R = np.zeros((B, 3, 8), np.uint32)
    shim.host_verify(CURVE_IDS[curve], *(_ptr(a) for a in (*cols, gtab, out,
                                                          u, sm, R)),
                     B, reverse)
    return cols, gtab, out.astype(bool).tolist(), u, sm, R


@pytest.mark.parametrize("curve", sorted(CURVES))
def test_group_verify_matches_integer_ecdsa(shim, curve):
    cv = CURVES[curve]
    n, g = cv.fn.modulus, (cv.gx, cv.gy)
    lanes = _verify_lanes(curve)
    runs = [_run_verify(shim, curve, lanes, rev) for rev in (0, 1)]
    cols, gtab, ok, u, sm, R = runs[0]
    for other in runs[1:]:
        assert other[2] == ok
        for a, b in zip(other[3:], (u, sm, R)):
            assert np.array_equal(a, b)
    assert ok == vectors.expected(curve, lanes)
    assert any(ok) and not all(ok)

    # u1, u2 and s^-1·R mod n: the reference's values, 0 where s = 0 or n
    u1s, u2s = _ints(u[:, 0]), _ints(u[:, 1])
    for (qx, qy, r, s, d, label), u1, u2, sinv_m in zip(lanes, u1s, u2s,
                                                        _ints(sm)):
        w = pow(s, -1, n) if s % n else 0
        assert sinv_m == w * R256 % n, label
        assert (u1, u2) == (int.from_bytes(d, "big") * w % n, r * w % n), \
            label

    # R in affine form: u1·G + u2·Q wherever Q is a curve point
    rw = [_ints(R[b]) for b in range(len(lanes))]
    checked = 0
    for lane, u1, u2, (X, Y, Z) in zip(lanes, u1s, u2s, rw):
        if not on_curve(curve, lane[0], lane[1]):
            continue
        assert _affine(curve, X, Y, Z) == _mul_add(cv, u1, g, u2,
                                                   lane[:2]), lane[5]
        checked += 1
    assert checked >= len(lanes) // 2

    # R word for word: the one-thread formulas in the group body's order
    ref = np.zeros_like(R)
    shim.host_ladder(CURVE_IDS[curve], _ptr(u), _ptr(cols[0]), _ptr(cols[1]),
                     _ptr(gtab), _ptr(ref), len(lanes))
    for b, lane in enumerate(lanes):
        assert np.array_equal(R[b], ref[b]), lane[5]


def _ladder_events(curve: str, u1: int, u2: int, q) -> set[str]:
    """The exceptional cases K4's ladder meets on u1·G + u2·Q, in its order
    (acc + (Q entry + G entry)), from the integer group law."""
    cv = CURVES[curve]
    g = (cv.gx, cv.gy)

    def add(a, b):
        if a is None:
            return b
        return _mul_add(cv, 1, a, 1, b) if b is not None else a

    tab = [_mul_add(cv, k, q) for k in range(1, 16)]
    acc, events = None, set()
    for w in range(64):
        acc = _mul_add(cv, 16, acc) if acc is not None else None
        dq, dg = (u2 >> (252 - 4 * w)) & 15, (u1 >> (252 - 4 * w)) & 15
        pq = tab[dq - 1] if dq else None
        ge = _mul_add(cv, dg, g) if dg else None
        if pq is not None and ge is not None:
            if pq == ge:
                events.add("chain 1 P == Q")
            elif pq == _neg(curve, ge):
                events.add("chain 1 P == -Q")
        s = add(pq, ge)
        if acc is not None and s is not None:
            if acc == s:
                events.add("chain 0 P == Q")
            elif acc == _neg(curve, s):
                events.add("chain 0 P == -Q")
        acc = add(acc, s)
    assert acc == _mul_add(cv, u1, g, u2, q)
    return events


@pytest.mark.parametrize("curve", sorted(CURVES))
def test_select_lanes_take_each_select(curve):
    rng = np.random.default_rng(185)
    got = {}
    for qx, qy, r, s, d, label in vectors.select_lanes(curve, rng):
        assert s == 1
        got[label] = _ladder_events(curve, int.from_bytes(d, "big"), r,
                                    (qx, qy))
    labels = list(got)
    assert "chain 1 P == Q" in got[labels[0]]
    assert "chain 1 P == -Q" in got[labels[1]]
    assert "chain 0 P == Q" in got[labels[2]]
    assert "chain 0 P == -Q" in got[labels[3]]
