"""The gen-1 ``mont16`` verify's plain twin (K4's) against the reference.

``bdls_tpu_torch/ops/mont.py``, ``ops/jacobian.py`` and
``ops/ecdsa.py:verify_kernel`` copy ``bdls_tpu/ops/mont.py``,
``ops/jacobian.py`` and ``ops/ecdsa.py:verify_kernel(field="mont16")``.
Held here, exactly, on the same seeded numpy inputs:

- every field function against the reference's, run eagerly, on P-256
  and secp256k1 p and n: edge values, seeded ones, zero lanes in the
  batch inverse;
- the point functions (doubling; complete and mixed addition with an
  operand at infinity, P == Q, P == -Q) against the reference's;
- ``fixed_base_table`` bit for bit, and K4's word table built from it;
- both ladders against integer scalar multiplication;
- ``verify_kernel`` against the integer ECDSA on valid, tampered and
  hostile lanes (r or s of 0, n or above; Q off the curve or (0, 0); the
  forged ``r + n`` lane; a tampered digest), both curves, both
  ``inv``/``ladder`` strategies.

The reference's whole ``verify_kernel`` runs eagerly at some 56 ms a
Montgomery product on XLA:CPU (minutes a call) and compiles in about 6
minutes, so the lane-for-lane comparison with it is the ``slow`` test at
the end.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bdls_tpu.ops import curves as jcurves
from bdls_tpu.ops import ecdsa as jecdsa
from bdls_tpu.ops import jacobian as jjac
from bdls_tpu.ops import mont as jmont
from bdls_tpu_torch.crypto import vectors
from bdls_tpu_torch.crypto.marshal import ints_to_limbs
from bdls_tpu_torch.ops import ecdsa, jacobian, mont
from bdls_tpu_torch.ops.curves import CURVES
from bdls_tpu_torch.ops.fields import ints_to_limb_array, limb_array_to_ints

torch.set_num_threads(1)

R = 1 << 256
MODULI = [(c, k) for c in sorted(CURVES) for k in ("fp", "fn")]


def _port(xs) -> torch.Tensor:
    return torch.from_numpy(ints_to_limb_array(xs).astype(np.int64))


def _ref(xs):
    return jnp.asarray(ints_to_limb_array(xs))


def _ints(a) -> list[int]:
    if isinstance(a, torch.Tensor):
        a = a.numpy()
    return limb_array_to_ints(np.asarray(a).astype(np.uint32))


@pytest.mark.parametrize("curve,kind", MODULI)
def test_field_ops_match_the_reference(curve, kind):
    ctx, jctx = getattr(CURVES[curve], kind), getattr(jcurves.CURVES[curve],
                                                       kind)
    m = ctx.modulus
    rng = np.random.default_rng(101 + MODULI.index((curve, kind)))
    red = [0, 1, 2, m - 1, m - 2] + [
        int.from_bytes(rng.bytes(32), "big") % m for _ in range(11)]
    wide = [0, 1, m - 1, m, m + 1, R - 1, R - m, 1 << 255] + [
        int.from_bytes(rng.bytes(32), "big") for _ in range(8)]
    below_2m = [v + m if v + m < R and i % 2 else v
                for i, v in enumerate(red)]
    a, b, w, t2 = _port(red), _port(red[::-1]), _port(wide), \
        _port(below_2m)
    ja, jb, jw, jt2 = _ref(red), _ref(red[::-1]), _ref(wide), \
        _ref(below_2m)
    with jax.disable_jit():
        pairs = [
            (mont.mont_mul(ctx, w, b), jmont.mont_mul(jctx, jw, jb)),
            (mont.mont_sqr(ctx, a), jmont.mont_sqr(jctx, ja)),
            (mont.to_mont(ctx, w), jmont.to_mont(jctx, jw)),
            (mont.from_mont(ctx, a), jmont.from_mont(jctx, ja)),
            (mont.mod_add(ctx, a, b), jmont.mod_add(jctx, ja, jb)),
            (mont.mod_sub(ctx, a, b), jmont.mod_sub(jctx, ja, jb)),
            (mont.reduce_once(ctx, t2), jmont.reduce_once(jctx, jt2)),
            (mont.add_const_carry(w, ctx.m_limbs)[0],
             jmont.add_const_carry(jw, jctx.m_limbs)[0]),
        ]
        flags = [
            (mont.add_const_carry(w, ctx.m_limbs)[1],
             jmont.add_const_carry(jw, jctx.m_limbs)[1]),
            (mont.geq_const(w, ctx.m_limbs), jmont.geq_const(jw, jctx.m_limbs)),
            (mont.is_zero(w), jmont.is_zero(jw)),
            (mont.eq(a, b), jmont.eq(ja, jb)),
        ]
    for ours, theirs in pairs:
        assert _ints(ours) == _ints(theirs)
    for ours, theirs in flags:
        assert ours.tolist() == np.asarray(theirs).astype(ours.numpy(
        ).dtype).tolist()
    assert _ints(mont.mont_mul(ctx, w, b)) == [
        x * y * pow(R, -1, m) % m for x, y in zip(wide, red[::-1])]


@pytest.mark.parametrize("curve", sorted(CURVES))
def test_inverses_match_the_reference_with_zero_lanes(curve):
    ctx, jctx = CURVES[curve].fn, jcurves.CURVES[curve].fn
    m = ctx.modulus
    rng = np.random.default_rng(111)
    vals = [5, 0, m - 1, 0, 1] + [int.from_bytes(rng.bytes(32), "big") % m
                                  for _ in range(6)]
    am = [v * R % m for v in vals]
    a, ja = _port(am), _ref(am)
    got, fermat = mont.batch_inv(ctx, a), mont.mont_pow_fermat(ctx, a)
    assert _ints(got) == _ints(jmont.batch_inv(jctx, ja)) == _ints(fermat) \
        == _ints(jmont.mont_pow_fermat(jctx, ja)) == [
            pow(v, -1, m) * R % m if v else 0 for v in vals]


# ------------------------------------------------------------- points

def _aff_add(curve, P, Q):
    p = curve.fp.modulus
    if P is None:
        return Q
    if Q is None:
        return P
    (x1, y1), (x2, y2) = P, Q
    if x1 == x2 and (y1 + y2) % p == 0:
        return None
    if P == Q:
        lam = (3 * x1 * x1 + curve.a) * pow(2 * y1, -1, p) % p
    else:
        lam = (y2 - y1) * pow(x2 - x1, -1, p) % p
    x3 = (lam * lam - x1 - x2) % p
    return (x3, (lam * (x1 - x3) - y1) % p)


def _aff_mul(curve, k, P):
    acc = None
    for bit in bin(k)[2:] if k else "":
        acc = _aff_add(curve, acc, acc)
        if bit == "1":
            acc = _aff_add(curve, acc, P)
    return acc


def _jac(curve, pts, zs):
    """Affine points (None = infinity) -> Montgomery Jacobian columns."""
    p = curve.fp.modulus
    cols = ([], [], [])
    for P, z in zip(pts, zs):
        if P is None:
            x, y, z = 1, 1, 0
        else:
            x, y = P[0] * z * z % p, P[1] * z * z * z % p
        for c, v in zip(cols, (x, y, z)):
            c.append(v * R % p)
    return cols


def _affine(curve, X, Y, Z):
    p = curve.fp.modulus
    out = []
    for x, y, z in zip(*(_ints(c) for c in (X, Y, Z))):
        x, y, z = (v * pow(R, -1, p) % p for v in (x, y, z))
        if z == 0:
            out.append(None)
        else:
            zi = pow(z, -1, p)
            out.append((x * zi * zi % p, y * zi * zi * zi % p))
    return out


@pytest.mark.parametrize("curve", sorted(CURVES))
def test_point_functions_match_the_reference(curve):
    cv, jcv = CURVES[curve], jcurves.CURVES[curve]
    G = (cv.gx, cv.gy)
    P = _aff_mul(cv, 7, G)
    Q = _aff_mul(cv, 11, G)
    negP = (P[0], cv.fp.modulus - P[1])
    #        generic  P == Q  P == -Q  P = inf  Q = inf  both inf
    lhs = [P, P, P, None, P, None]
    rhs = [Q, P, negP, Q, None, None]
    zl = [3, 5, 7, 1, 9, 1]
    zr = [2, 4, 6, 8, 1, 1]
    a = _jac(cv, lhs, zl)
    b = _jac(cv, rhs, zr)
    pa, pb = (jacobian.PointJ(*(_port(c) for c in t)) for t in (a, b))
    ja, jb = (jjac.PointJ(*(_ref(c) for c in t)) for t in (a, b))
    # mixed addition: affine Q in Montgomery form (not infinity)
    aff = [Q, P, negP, Q, Q, P]
    qx = [v[0] * R % cv.fp.modulus for v in aff]
    qy = [v[1] * R % cv.fp.modulus for v in aff]
    ours = [jacobian.point_double(cv, pa), jacobian.point_add(cv, pa, pb),
            jacobian.point_add_mixed(cv, pa, _port(qx), _port(qy))]
    theirs = [jjac.point_double(jcv, ja), jjac.point_add(jcv, ja, jb),
              jjac.point_add_mixed(jcv, ja, _ref(qx), _ref(qy))]
    for o, t in zip(ours, theirs):
        for c in range(3):
            assert _ints(o[c]) == _ints(t[c])
    assert _affine(cv, *ours[0]) == [_aff_add(cv, v, v) for v in lhs]
    assert _affine(cv, *ours[1]) == [_aff_add(cv, u, v)
                                     for u, v in zip(lhs, rhs)]
    assert _affine(cv, *ours[2]) == [_aff_add(cv, u, v)
                                     for u, v in zip(lhs, aff)]


@pytest.mark.parametrize("curve", sorted(CURVES))
def test_fixed_base_table_is_the_references(curve):
    xs, ys = jacobian.fixed_base_table(curve)
    jxs, jys = jjac.fixed_base_table(curve)
    assert xs.dtype == jxs.dtype and np.array_equal(xs, jxs)
    assert np.array_equal(ys, jys)
    # K4 reads the same values as 32-bit words, (16, 2, 8)
    words = ecdsa.device_mont16_table(curve, torch.device("cpu")).numpy()
    w = words.view(np.uint32).astype(np.uint64)
    for d in range(1, 16):
        for c, tab in ((0, xs), (1, ys)):
            got = sum(int(w[d, c, i]) << (32 * i) for i in range(8))
            assert got == sum(int(tab[d, i]) << (16 * i) for i in range(16))


@pytest.mark.parametrize("curve", sorted(CURVES))
def test_ladders_match_integer_scalar_multiplication(curve):
    cv = CURVES[curve]
    n, p = cv.fn.modulus, cv.fp.modulus
    rng = np.random.default_rng(113)
    Q = _aff_mul(cv, 1 + int(rng.integers(1, 1 << 30)), (cv.gx, cv.gy))
    u1s = [0, 1, 5, n - 1] + [int.from_bytes(rng.bytes(32), "big") % n]
    u2s = [3, 0, n - 5, n - 1] + [int.from_bytes(rng.bytes(32), "big") % n]
    B = len(u1s)
    qx = _port([Q[0] * R % p] * B)
    qy = _port([Q[1] * R % p] * B)
    want = [_aff_add(cv, _aff_mul(cv, a, (cv.gx, cv.gy)), _aff_mul(cv, b, Q))
            for a, b in zip(u1s, u2s)]
    for ladder in (jacobian.windowed_dual_mul, jacobian.shamir_mul):
        got = ladder(cv, _port(u1s), _port(u2s), qx, qy)
        assert _affine(cv, *got) == want


@pytest.mark.parametrize("curve", sorted(CURVES))
@pytest.mark.parametrize("inv,ladder", [("batch", "windowed"),
                                        ("fermat", "shamir")])
def test_verify_kernel_matches_integer_ecdsa(curve, inv, ladder):
    rng = np.random.default_rng(117)
    lanes = vectors.mixed_lanes(curve, rng, n_valid=2)
    cols = [torch.from_numpy(ints_to_limbs(c).view(np.int32))
            for c in vectors.columns(lanes)]
    got = ecdsa.verify_kernel(CURVES[curve], *cols, inv=inv,
                              ladder=ladder).tolist()
    assert got == vectors.expected(curve, lanes)
    with pytest.raises(ValueError):
        ecdsa.verify_kernel(CURVES[curve], *cols, inv="newton")


@pytest.mark.slow
@pytest.mark.parametrize("curve", sorted(CURVES))
def test_verify_kernel_matches_the_reference_program(curve):
    """The reference's compiled ``mont16`` program (about 6 minutes a
    curve on XLA:CPU), lane for lane, both strategies of the port."""
    rng = np.random.default_rng(119)
    lanes = vectors.mixed_lanes(curve, rng, n_valid=2)
    cols = [ints_to_limbs(c) for c in vectors.columns(lanes)]
    ref = np.asarray(jecdsa.jitted_verify(curve, "mont16")(
        *(jnp.asarray(c) for c in cols))).tolist()
    for inv, ladder in (("batch", "windowed"), ("fermat", "shamir")):
        got = ecdsa.verify_kernel(
            CURVES[curve], *(torch.from_numpy(c.view(np.int32))
                             for c in cols), inv=inv, ladder=ladder)
        assert got.tolist() == ref
    assert ref == vectors.expected(curve, lanes)
