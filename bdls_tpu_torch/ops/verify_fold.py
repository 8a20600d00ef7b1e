"""Batched ECDSA verification: host tables and the plain PyTorch version.

The counterpart of ``bdls_tpu/ops/verify_fold.py``, in three parts:

- **Host tables** in the port's layout: the 8-bit G table [0..255]·G
  with entry 0 = (0 : 1 : 0), as ``uint32`` ``(256, 3, 8)`` — entry d,
  coordinate (x, y, z), eight little-endian 32-bit limbs of the
  canonical integer. :func:`device_g_table` uploads it in Montgomery
  form for the CUDA kernel; :func:`verify_fold` reads it as 16-bit limbs.
- :func:`tables_from_reference`, which carries the JAX package's
  radix-12 tables (``verify_fold.const_tree``) over into that layout, so
  a test can pin that both packages hold the same integers.
- :func:`verify_fold`, the plain PyTorch version of the kernel in
  ``csrc/verify.cu``, with the contract of ``verify_fold.py:860``: five
  ``(16, B)`` arrays of 16-bit limbs in, a ``(B,)`` bool verdict out,
  every screen included (r, s in [1, n); Qx, Qy < p; Q ≠ (0, 0); Q on the
  curve; R ≠ ∞; x(R) ≡ r through X == r·Z or, where r + n < p,
  X == (r + n)·Z).

R = u1·G + u2·Q comes from the generic dual ladder of ``dual_ladder``
(``verify_fold.py:806``) on both curves: 33 steps of 8 doublings, two
signed 4-bit Q-window adds from a per-lane [0..8]·Q table and one 8-bit
G-table add. The JAX package runs secp256k1 through its GLV ladder
instead; the verdict is the same.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from bdls_tpu_torch.ops import fold
from bdls_tpu_torch.ops.curves import CURVES, Curve
from bdls_tpu_torch.ops.fold import FE, fe_const, fe_zero, fold_ctx, \
    from_limbs16, is_zero_mod, norm
from bdls_tpu_torch.ops.proj import Proj, TorchField, point_add, point_dbl

_U32 = np.uint32


# --------------------------------------------------------------- tables

def _aff_add(curve: Curve, P, Q):
    """Host affine point addition (table construction only)."""
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


def _int_to_u32x8(x: int) -> np.ndarray:
    return np.array([(x >> (32 * i)) & 0xFFFFFFFF for i in range(8)],
                    dtype=_U32)


@functools.lru_cache(maxsize=None)
def g_table_8bit(curve_name: str) -> np.ndarray:
    """[0..255]·G as (256, 3, 8) uint32 canonical projective limbs;
    entry 0 = (0, 1, 0), every other entry has z = 1."""
    curve = CURVES[curve_name]
    tab = np.zeros((256, 3, 8), dtype=_U32)
    tab[0, 1] = _int_to_u32x8(1)
    acc = None
    for d in range(1, 256):
        acc = _aff_add(curve, acc, (curve.gx, curve.gy))
        tab[d, 0] = _int_to_u32x8(acc[0])
        tab[d, 1] = _int_to_u32x8(acc[1])
        tab[d, 2] = _int_to_u32x8(1)
    tab.setflags(write=False)
    return tab


def table_ints(tab: np.ndarray) -> list[list[int]]:
    """(256, 3, 8) uint32 table -> per entry the three coordinate ints."""
    w = tab.astype(object)
    return [[sum(int(w[d, c, i]) << (32 * i) for i in range(8))
             for c in range(3)] for d in range(tab.shape[0])]


def tables_from_reference(arrays: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
    """The JAX package's radix-12 tables -> the port's layout.

    ``arrays`` is ``bdls_tpu.ops.verify_fold.const_tree(curve)`` as numpy
    arrays (keys ``g:<curve>:x|y|z``, each ``(256, 23)`` limbs of 12
    bits). Returns ``{curve_name: (256, 3, 8) uint32}`` for every curve
    whose G table is present."""
    out = {}
    for name in CURVES:
        keys = [f"g:{name}:{c}" for c in ("x", "y", "z")]
        if not all(k in arrays for k in keys):
            continue
        tab = np.zeros((256, 3, 8), dtype=_U32)
        for c, k in enumerate(keys):
            limbs = np.asarray(arrays[k]).astype(object)
            for d in range(limbs.shape[0]):
                x = sum(int(v) << (12 * j) for j, v in enumerate(limbs[d]))
                tab[d, c] = _int_to_u32x8(x)
        out[name] = tab
    return out


@functools.lru_cache(maxsize=None)
def device_g_table(curve_name: str, device: torch.device) -> torch.Tensor:
    """The G table in Montgomery form (x·2^256 mod p), ``(256, 3, 8)``
    int32 bit patterns on ``device``: what the CUDA kernel reads."""
    p = CURVES[curve_name].fp.modulus
    r = 1 << 256
    ints = table_ints(g_table_8bit(curve_name))
    mont = np.stack([np.stack([_int_to_u32x8(v * r % p) for v in entry])
                     for entry in ints])
    return torch.from_numpy(mont.view(np.int32).copy()).to(device)


@functools.lru_cache(maxsize=None)
def _g_table_limbs16(curve_name: str, device: torch.device) -> torch.Tensor:
    """The G table as (256, 3, 16) int64 16-bit limbs (plain version)."""
    t = g_table_8bit(curve_name).astype(np.int64)
    lo, hi = t & 0xFFFF, t >> 16
    limbs = np.stack([lo, hi], axis=-1).reshape(256, 3, 16)
    return torch.as_tensor(limbs, device=device)


# -------------------------------------------------------- the plain ladder

def _signed_digits(u2c: torch.Tensor):
    """Canonical (16, B) scalar -> 66 signed 4-bit digits, LSB first:
    d_i = nib(u2 + 0x88…8)_i - 8 for i < 64, d_64 = the carry nibble,
    d_65 = 0. Returns (mag, neg), each (66, B)."""
    c8 = sum(8 << (4 * i) for i in range(64))
    w, carry = fold.add_const_carry(u2c, c8)
    shifts = torch.arange(0, 16, 4, device=u2c.device)[None, :, None]
    nib = ((w[:, None, :] >> shifts) & 0xF).reshape(64, -1)
    d = nib - 8
    zero = torch.zeros_like(carry)
    mag = torch.cat([d.abs(), carry[None], zero[None]])
    neg = torch.cat([d < 0, (zero != 0)[None], (zero != 0)[None]])
    return mag, neg


def _bytes(u1c: torch.Tensor) -> torch.Tensor:
    """Canonical (16, B) scalar -> 33 bytes, LSB first (byte 32 = 0)."""
    lo, hi = u1c & 0xFF, u1c >> 8
    b = torch.stack([lo, hi], dim=1).reshape(32, -1)
    return torch.cat([b, torch.zeros_like(b[:1])])


def _lookup(tab: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """Per-lane gather: tab (T, L, B), d (B,) -> (L, B)."""
    idx = d[None, None, :].expand(1, tab.shape[1], tab.shape[2])
    return tab.gather(0, idx)[0]


def dual_ladder(curve: Curve, fpc, u1c, u2c, qx: FE, qy: FE) -> Proj:
    """R = u1·G + u2·Q over canonical (16, B) scalars u1c, u2c."""
    like = qx.v
    f = TorchField(fpc, like)
    one = norm(fpc, fe_const(fpc, 1, like))
    zero = fe_zero(like)

    # per-lane [0..8]·Q in normal form, stacked (9, 18, B) per coordinate
    q1 = Proj(norm(fpc, qx), norm(fpc, qy), one)
    entries = [Proj(zero, one, zero), q1]
    acc = point_dbl(f, curve, q1)
    entries.append(Proj(*(norm(fpc, c) for c in acc)))
    for _ in range(6):
        acc = point_add(f, curve, entries[-1], q1)
        entries.append(Proj(*(norm(fpc, c) for c in acc)))
    lbq = max(c.lb for e in entries for c in e)
    tabs = [torch.stack([fold._pad_to(getattr(e, c).v, fold.L_NORM)
                         for e in entries]) for c in ("x", "y", "z")]

    mag, neg = _signed_digits(u2c)
    dg = _bytes(u1c)
    gtab = _g_table_limbs16(curve.name, like.device)

    def q_addend(i):
        pt = [FE(_lookup(t, mag[i]), lbq) for t in tabs]
        y_neg = fold.sub(fpc, zero, pt[1])
        return Proj(pt[0], fold.select(neg[i], y_neg, pt[1]), pt[2])

    acc = Proj(zero, one, zero)
    for k in range(33):
        for h in range(2):
            for _ in range(4):
                acc = point_dbl(f, curve, acc)
            acc = point_add(f, curve, acc, q_addend(65 - 2 * k - h))
        g = gtab[dg[32 - k]]                           # (B, 3, 16)
        gpt = Proj(*(FE(g[:, c].T, 1 << 16) for c in range(3)))
        acc = point_add(f, curve, acc, gpt)
        acc = Proj(*(norm(fpc, c) for c in acc))
    return acc


def verify_fold(curve: Curve, qx16, qy16, r16, s16, e16) -> torch.Tensor:
    """All inputs (16, B) 16-bit-limb tensors; returns (B,) bool."""
    fpc = fold_ctx(curve.fp.modulus)
    fnc = fold_ctx(curve.fn.modulus)
    qx16, qy16, r16, s16, e16 = (t.to(torch.int64) & 0xFFFF
                                 for t in (qx16, qy16, r16, s16, e16))
    n, p = curve.fn.modulus, curve.fp.modulus

    # --- scalar-range checks on the exact 16-limb inputs ---------------
    r_ok = ~fold.is_zero16(r16) & fold.lt_const(r16, n)
    s_ok = ~fold.is_zero16(s16) & fold.lt_const(s16, n)
    q_ok = fold.lt_const(qx16, p) & fold.lt_const(qy16, p) & \
        ~(fold.is_zero16(qx16) & fold.is_zero16(qy16))

    qx, qy = from_limbs16(qx16), from_limbs16(qy16)
    r_fe, s_fe, e_fe = (from_limbs16(a) for a in (r16, s16, e16))

    # --- u1 = e/s, u2 = r/s (mod n) ------------------------------------
    s_inv = fold.fermat_inv(fnc, s_fe)
    u1c = fold.canon(fnc, fold.mul(fnc, e_fe, s_inv))
    u2c = fold.canon(fnc, fold.mul(fnc, r_fe, s_inv))

    # --- curve membership of Q -----------------------------------------
    x3 = fold.mul(fpc, fold.sqr(fpc, qx), qx)
    rhs = fold.add(x3, fe_const(fpc, curve.b, qx.v))
    if curve.a % p:
        rhs = fold.add(rhs, fold.mul(fpc, fe_const(fpc, curve.a, qx.v), qx))
    on_curve = is_zero_mod(fpc, fold.sub(fpc, fold.sqr(fpc, qy), rhs))

    # --- R = u1·G + u2·Q ------------------------------------------------
    rp = dual_ladder(curve, fpc, u1c, u2c, qx, qy)
    not_inf = ~is_zero_mod(fpc, rp.z)

    # --- x(R) ≡ r (mod n), inversion-free: X == r·Z or (r+n)·Z ---------
    ok1 = is_zero_mod(fpc, fold.sub(fpc, rp.x, fold.mul(fpc, r_fe, rp.z)))
    rn16, carry = fold.add_const_carry(r16, n)
    rn_fits = (carry == 0) & fold.lt_const(rn16, p)
    ok2 = rn_fits & is_zero_mod(
        fpc, fold.sub(fpc, rp.x, fold.mul(fpc, from_limbs16(rn16), rp.z)))

    return r_ok & s_ok & q_ok & on_curve & not_inf & (ok1 | ok2)
