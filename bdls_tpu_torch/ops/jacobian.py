"""Jacobian point arithmetic over the gen-1 field — the plain twin of K4's
point functions.

The port's counterpart of ``bdls_tpu/ops/jacobian.py``
(``point_double`` ``:53``, ``point_add`` ``:87``, ``point_add_mixed``
``:122``, ``shamir_mul`` ``:163``, ``fixed_base_table`` ``:198``,
``windowed_dual_mul`` ``:260``), over :mod:`bdls_tpu_torch.ops.mont`.
Coordinates are Montgomery-form ``(16, B)`` int64 limbs; infinity is
Z == 0. Every exceptional case (an operand at infinity, P == Q,
P == -Q) is resolved by a per-lane select, never by control flow, in the
reference's order. ``csrc/mont16.cuh`` is the same algorithm, a lane a
thread.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from bdls_tpu_torch.ops.curves import CURVES, Curve
from bdls_tpu_torch.ops.fields import LIMB_BITS, NLIMBS, int_to_limbs
from bdls_tpu_torch.ops.mont import bcast_const, eq, is_zero, mod_add, \
    mod_sub, mont_mul, mont_sqr, select


class PointJ(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor


def point_select(mask: torch.Tensor, p: PointJ, q: PointJ) -> PointJ:
    return PointJ(select(mask, p.x, q.x), select(mask, p.y, q.y),
                  select(mask, p.z, q.z))


def infinity_like(x: torch.Tensor) -> PointJ:
    z = torch.zeros_like(x)
    one = z.clone()
    one[0] = 1       # arbitrary affine coordinates; Z = 0 is what matters
    return PointJ(one, one, z)


def _const(limbs, like: torch.Tensor) -> torch.Tensor:
    return bcast_const(limbs, like).expand_as(like)


def point_double(curve: Curve, p: PointJ) -> PointJ:
    """dbl-2007-bl, specialised on the curve's a; right for Z = 0 (stays
    at infinity) and Y = 0 without a branch."""
    fp = curve.fp
    xx = mont_sqr(fp, p.x)
    yy = mont_sqr(fp, p.y)
    yyyy = mont_sqr(fp, yy)
    zz = mont_sqr(fp, p.z)
    # S = 2·((X + YY)^2 - XX - YYYY)
    s = mod_sub(fp, mod_sub(fp, mont_sqr(fp, mod_add(fp, p.x, yy)), xx),
                yyyy)
    s = mod_add(fp, s, s)
    # M = 3·XX + a·ZZ^2
    m = mod_add(fp, mod_add(fp, xx, xx), xx)
    if curve.a_kind == "minus3":
        # 3·(X - ZZ)·(X + ZZ) = 3·XX - 3·ZZ^2
        m = mont_mul(fp, mod_add(fp, p.x, zz), mod_sub(fp, p.x, zz))
        m = mod_add(fp, mod_add(fp, m, m), m)
    elif curve.a_kind != "zero":
        zz2 = mont_sqr(fp, zz)
        m = mod_add(fp, m, mont_mul(fp, _const(curve.a_mont, zz2), zz2))
    t = mod_sub(fp, mont_sqr(fp, m), mod_add(fp, s, s))
    y8 = mod_add(fp, yyyy, yyyy)
    y8 = mod_add(fp, y8, y8)
    y8 = mod_add(fp, y8, y8)
    y3 = mod_sub(fp, mont_mul(fp, m, mod_sub(fp, s, t)), y8)
    # Z3 = (Y + Z)^2 - YY - ZZ = 2·Y·Z
    z3 = mod_sub(fp, mod_sub(fp, mont_sqr(fp, mod_add(fp, p.y, p.z)), yy),
                 zz)
    return PointJ(t, y3, z3)


def point_add(curve: Curve, p: PointJ, q: PointJ) -> PointJ:
    """Complete Jacobian addition: add-2007-bl, then P = inf -> Q,
    Q = inf -> P, P == Q -> the double, P == -Q -> inf (H = 0 gives
    Z3 = 0)."""
    fp = curve.fp
    z1z1 = mont_sqr(fp, p.z)
    z2z2 = mont_sqr(fp, q.z)
    u1 = mont_mul(fp, p.x, z2z2)
    u2 = mont_mul(fp, q.x, z1z1)
    s1 = mont_mul(fp, p.y, mont_mul(fp, q.z, z2z2))
    s2 = mont_mul(fp, q.y, mont_mul(fp, p.z, z1z1))
    h = mod_sub(fp, u2, u1)
    i = mont_sqr(fp, mod_add(fp, h, h))
    j = mont_mul(fp, h, i)
    r = mod_sub(fp, s2, s1)
    r = mod_add(fp, r, r)
    v = mont_mul(fp, u1, i)
    x3 = mod_sub(fp, mod_sub(fp, mont_sqr(fp, r), j), mod_add(fp, v, v))
    s1j = mont_mul(fp, s1, j)
    y3 = mod_sub(fp, mont_mul(fp, r, mod_sub(fp, v, x3)),
                 mod_add(fp, s1j, s1j))
    zsum = mod_sub(fp, mod_sub(fp, mont_sqr(fp, mod_add(fp, p.z, q.z)),
                               z1z1), z2z2)
    z3 = mont_mul(fp, zsum, h)
    added = PointJ(x3, y3, z3)

    inf1 = is_zero(p.z)
    inf2 = is_zero(q.z)
    same = eq(u1, u2) & eq(s1, s2) & ~inf1 & ~inf2
    out = point_select(same, point_double(curve, p), added)
    out = point_select(inf2, p, out)
    return point_select(inf1, q, out)


def point_add_mixed(curve: Curve, p: PointJ, qx: torch.Tensor,
                    qy: torch.Tensor) -> PointJ:
    """Complete mixed addition ``p + (qx, qy, 1)`` (madd-2007-bl, then
    the selects). The affine operand cannot be infinity: callers select
    around a zero digit."""
    fp = curve.fp
    z1z1 = mont_sqr(fp, p.z)
    u2 = mont_mul(fp, qx, z1z1)
    s2 = mont_mul(fp, qy, mont_mul(fp, p.z, z1z1))
    h = mod_sub(fp, u2, p.x)
    hh = mont_sqr(fp, h)
    i4 = mod_add(fp, hh, hh)
    i4 = mod_add(fp, i4, i4)
    j = mont_mul(fp, h, i4)
    r = mod_sub(fp, s2, p.y)
    r = mod_add(fp, r, r)
    v = mont_mul(fp, p.x, i4)
    x3 = mod_sub(fp, mod_sub(fp, mont_sqr(fp, r), j), mod_add(fp, v, v))
    s1j = mont_mul(fp, p.y, j)
    y3 = mod_sub(fp, mont_mul(fp, r, mod_sub(fp, v, x3)),
                 mod_add(fp, s1j, s1j))
    z3 = mont_mul(fp, mod_add(fp, p.z, p.z), h)   # 0 when P == ±Q
    added = PointJ(x3, y3, z3)

    inf1 = is_zero(p.z)
    same = eq(u2, p.x) & eq(s2, p.y) & ~inf1
    out = point_select(same, point_double(curve, p), added)
    qx, qy = torch.broadcast_tensors(qx, qy)
    return point_select(inf1, PointJ(qx, qy, _const(fp.one_mont, qx)), out)


def scalar_bits_msb(k: torch.Tensor) -> torch.Tensor:
    """Exact limbs (16, B) -> bit planes (256, B), most significant
    first."""
    shifts = torch.arange(LIMB_BITS, device=k.device)[None, :, None]
    bits = (k[:, None, :] >> shifts) & 1
    return bits.reshape((NLIMBS * LIMB_BITS,) + k.shape[1:]).flip(0)


def nibbles_msb(k: torch.Tensor) -> torch.Tensor:
    """Exact limbs (16, B) -> 4-bit digits (64, B), most significant
    first."""
    shifts = torch.arange(0, LIMB_BITS, 4, device=k.device)[None, :, None]
    nib = (k[:, None, :] >> shifts) & 0xF
    return nib.reshape((NLIMBS * LIMB_BITS // 4,) + k.shape[1:]).flip(0)


def shamir_mul(curve: Curve, u1: torch.Tensor, u2: torch.Tensor,
               qx_m: torch.Tensor, qy_m: torch.Tensor) -> PointJ:
    """R = u1·G + u2·Q by interleaved double-and-add (Shamir's trick):
    256 steps of one double and one complete add of O, Q, G or G + Q,
    chosen by a select. u1, u2 plain; Q Montgomery affine."""
    fp = curve.fp
    one_m = _const(fp.one_mont, u1)
    g = PointJ(_const(curve.gx_mont, u1), _const(curve.gy_mont, u1), one_m)
    q = PointJ(qx_m, qy_m, one_m)
    gq = point_add(curve, g, q)
    bits_g, bits_q = scalar_bits_msb(u1), scalar_bits_msb(u2)
    acc = infinity_like(u1)
    for bg, bq in zip(bits_g, bits_q):
        acc = point_double(curve, acc)
        idx = bg * 2 + bq
        addend = point_select(idx == 3, gq, point_select(idx == 2, g, q))
        acc = point_select(idx == 0, acc, point_add(curve, acc, addend))
    return acc


@functools.lru_cache(maxsize=None)
def fixed_base_table(curve_name: str):
    """The host ``[0..15]·G`` affine table in Montgomery form (R = 2^256):
    two ``(16, 16)`` uint32 arrays (x, y) of 16-bit limbs, entry 0 a
    dummy (the ladder selects around digit 0). Bit-identical to the
    reference's, and the table K4 reads (as 32-bit words)."""
    curve = CURVES[curve_name]
    p = curve.fp.modulus

    def aff_add(P, Q):
        if P is None:
            return Q
        (x1, y1), (x2, y2) = P, Q
        if x1 == x2 and (y1 + y2) % p == 0:
            return None
        if P == Q:
            lam = (3 * x1 * x1 + curve.a) * pow(2 * y1, p - 2, p) % p
        else:
            lam = (y2 - y1) * pow(x2 - x1, p - 2, p) % p
        x3 = (lam * lam - x1 - x2) % p
        return (x3, (lam * (x1 - x3) - y1) % p)

    xs = np.zeros((16, NLIMBS), dtype=np.uint32)
    ys = np.zeros_like(xs)
    acc = None
    for d in range(1, 16):
        acc = aff_add(acc, (curve.gx, curve.gy))
        xs[d] = int_to_limbs(acc[0] * (1 << 256) % p)
        ys[d] = int_to_limbs(acc[1] * (1 << 256) % p)
    return xs, ys


def _lookup(tab: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """Per-lane gather: ``tab`` (T, 16, B) or (T, 16, 1), digit ``d``
    (B,) in [0, T) -> (16, B)."""
    tab = tab.expand(-1, -1, d.shape[0])
    idx = d[None, None, :].expand(1, tab.shape[1], -1)
    return tab.gather(0, idx)[0]


def windowed_dual_mul(curve: Curve, u1: torch.Tensor, u2: torch.Tensor,
                      qx_m: torch.Tensor, qy_m: torch.Tensor) -> PointJ:
    """R = u1·G + u2·Q with 4-bit fixed windows: a per-lane [1..15]·Q
    Jacobian table (one double, 13 mixed adds), then 64 windows of 4
    doubles, one complete add of the Q entry and one mixed add of the
    host G entry, each selected away for a zero digit."""
    fp = curve.fp
    one_m = _const(fp.one_mont, u1)
    q1 = PointJ(qx_m, qy_m, one_m)
    tab = [q1, point_double(curve, q1)]
    for _ in range(13):
        tab.append(point_add_mixed(curve, tab[-1], qx_m, qy_m))
    zero = torch.zeros_like(u1)
    # entry 0 is never used (digit 0 selects the add away)
    tab = PointJ(*(torch.stack([zero] + [getattr(t, c) for t in tab])
                   for c in "xyz"))
    gx_np, gy_np = fixed_base_table(curve.name)
    gx = torch.as_tensor(gx_np.astype(np.int64), device=u1.device)[:, :, None]
    gy = torch.as_tensor(gy_np.astype(np.int64), device=u1.device)[:, :, None]
    dg, dq = nibbles_msb(u1), nibbles_msb(u2)
    acc = infinity_like(u1)
    for w in range(dg.shape[0]):
        for _ in range(4):
            acc = point_double(curve, acc)
        qpt = PointJ(*(_lookup(getattr(tab, c), dq[w]) for c in "xyz"))
        acc = point_select(dq[w] == 0, acc, point_add(curve, acc, qpt))
        acc = point_select(dg[w] == 0, acc, point_add_mixed(
            curve, acc, _lookup(gx, dg[w]), _lookup(gy, dg[w])))
    return acc
