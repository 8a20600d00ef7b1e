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

R = u1·G + u2·Q comes, as in the reference (``verify_fold.py:890-895``),
from the generic dual ladder ``dual_ladder`` (``verify_fold.py:806``) on
P-256: 33 steps of 8 doublings, two signed 4-bit Q-window adds from a
per-lane [0..8]·Q table and one 8-bit G-table add; and on secp256k1 from
``dual_ladder_glv`` (``verify_fold.py:315``): the GLV halves of u2 on a
chain of 136 doublings over the [0..8]·Q table and its ψ(Q) x table,
u1·G from the positioned G byte tables on an accumulator never doubled.

The **pinned-key** side (``verify_fold.py:440-782``) is the second part
of this module: for a public key known ahead of time,
:func:`build_pinned_tables` builds positioned tables tab[j][d] =
(d·16^j)·Q on the host, and :func:`verify_fold_pinned` (the plain
version of ``csrc/pinned.cu``) consumes both scalars through positioned
tables with zero doublings. Tables are ``uint32`` ``(npos, 9, 8)``
canonical limbs; the pool the kernel reads holds them in Montgomery
form (:func:`pinned_device_tables`), ``(C, npos, 9, 8)`` int32 bit
patterns per coordinate.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from bdls_tpu_torch.ops import fold, glv, table_snapshot
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


def _ints_to_u32(vals) -> np.ndarray:
    """Python ints < 2^256 -> (N, 8) uint32, little-endian limbs."""
    buf = b"".join(int(v).to_bytes(32, "little") for v in vals)
    return np.frombuffer(buf, dtype="<u4").astype(_U32).reshape(-1, 8)


def _u32_to_ints(a: np.ndarray) -> list[int]:
    """(..., 8) uint32 (or int32 bit patterns) -> the flat list of ints."""
    raw = np.ascontiguousarray(a).view("<u4").tobytes()
    return [int.from_bytes(raw[32 * i:32 * i + 32], "little")
            for i in range(len(raw) // 32)]


def _int_to_u32x8(x: int) -> np.ndarray:
    return _ints_to_u32([x])[0]


def _multiples(curve: Curve, base, count: int) -> tuple[list, list, list]:
    """[0..count-1]·base as projective coordinate lists, entry 0 =
    (0, 1, 0) and every other entry affine (z = 1)."""
    xs, ys, zs = [0], [1], [0]
    acc = None
    for _ in range(1, count):
        acc = _aff_add(curve, acc, base)
        xs.append(acc[0])
        ys.append(acc[1])
        zs.append(1)
    return xs, ys, zs


def _stored(curve_name: str, family: str, shape: tuple, build):
    """One host table through the snapshot store
    (:mod:`bdls_tpu_torch.ops.table_snapshot`, on with
    ``BDLS_TPU_AOT_CACHE``): a hit as stored, else ``build()`` saved
    there; read-only either way."""
    got = table_snapshot.load_host_tables(curve_name, family, 1, [shape])
    if got is None:
        tab = build(curve_name)
        table_snapshot.save_host_tables(curve_name, family, [tab])
    else:
        tab = got[0]
    tab.setflags(write=False)
    return tab


def _g_table_8bit_build(curve_name: str) -> np.ndarray:
    curve = CURVES[curve_name]
    cols = _multiples(curve, (curve.gx, curve.gy), 256)
    return np.stack([_ints_to_u32(c) for c in cols], axis=1)


@functools.lru_cache(maxsize=None)
def g_table_8bit(curve_name: str) -> np.ndarray:
    """[0..255]·G as (256, 3, 8) uint32 canonical projective limbs;
    entry 0 = (0, 1, 0), every other entry has z = 1. Memoized in the
    snapshot store (family ``"g"``) when ``BDLS_TPU_AOT_CACHE`` is set."""
    return _stored(curve_name, "g", (256, 3, 8), _g_table_8bit_build)


def _g32_tables_build(curve_name: str) -> np.ndarray:
    curve = CURVES[curve_name]
    base = (curve.gx, curve.gy)
    tabs = []
    for _ in range(32):
        cols = _multiples(curve, base, 256)
        tabs.append(np.stack([_ints_to_u32(c) for c in cols], axis=1))
        for _ in range(8):                 # next position: 2^8 · base
            base = _aff_add(curve, base, base)
    return np.stack(tabs)


@functools.lru_cache(maxsize=None)
def g32_tables(curve_name: str) -> np.ndarray:
    """The 32 positioned G byte tables, tab[j][d] = (d·2^(8j))·G, as
    (32, 256, 3, 8) uint32 canonical projective limbs with entry 0 =
    (0, 1, 0): the reference's ``_g_tables_positioned_build``
    (``verify_fold.py:248``), which ``pinned_const_tree`` carries for
    both curves. A scalar's 32 bytes consume them with no doubling.
    Memoized in the snapshot store (family ``"g32"``), as
    :func:`g_table_8bit`."""
    return _stored(curve_name, "g32", (32, 256, 3, 8), _g32_tables_build)


def table_ints(tab: np.ndarray) -> list[list[int]]:
    """(256, 3, 8) uint32 table -> per entry the three coordinate ints."""
    flat = _u32_to_ints(tab)
    return [flat[3 * d:3 * d + 3] for d in range(tab.shape[0])]


def _from_radix12(limbs) -> np.ndarray:
    """(..., 23) radix-12 limbs (the JAX package's layout) -> (..., 8)
    uint32 limbs of the same integers."""
    a = np.asarray(limbs).astype(object)
    shifts = np.array([12 * j for j in range(a.shape[-1])], dtype=object)
    vals = (a << shifts).sum(axis=-1)
    return _ints_to_u32(vals.reshape(-1)).reshape(vals.shape + (8,))


def tables_from_reference(arrays: dict[str, np.ndarray],
                          kind: str = "g") -> dict[str, np.ndarray]:
    """The JAX package's radix-12 G tables -> the port's layout.

    ``arrays`` is ``bdls_tpu.ops.verify_fold.const_tree(curve)`` (or
    ``pinned_const_tree(curve)``) as numpy arrays. ``kind="g"`` reads
    the keys ``g:<curve>:x|y|z`` (each ``(256, 23)``) and returns
    ``{curve_name: (256, 3, 8) uint32}``; ``kind="g32"`` reads the
    positioned tables ``g32:<curve>:x|y|z`` (each ``(32, 256, 23)``)
    and returns ``{curve_name: (32, 256, 3, 8) uint32}``, for every
    curve whose tables are present."""
    if kind not in ("g", "g32"):
        raise ValueError(f"unknown table kind {kind!r}")
    out = {}
    for name in CURVES:
        keys = [f"{kind}:{name}:{c}" for c in ("x", "y", "z")]
        if all(k in arrays for k in keys):
            out[name] = np.stack([_from_radix12(arrays[k]) for k in keys],
                                 axis=-2)
    return out


def _mont_u32(curve_name: str, tab: np.ndarray) -> np.ndarray:
    """Canonical (..., 8) uint32 limbs -> Montgomery form x·2^256 mod p,
    as int32 bit patterns of the same shape (what the kernels read)."""
    p = CURVES[curve_name].fp.modulus
    mont = _ints_to_u32([v * (1 << 256) % p for v in _u32_to_ints(tab)])
    return mont.reshape(tab.shape).view(np.int32)


def mont_words(curve_name: str, vals) -> np.ndarray:
    """Python ints -> their Montgomery form mod p, ``(N, 8)`` int32
    words (a pool entry's encoding of each)."""
    return _mont_u32(curve_name, _ints_to_u32(vals))


@functools.lru_cache(maxsize=None)
def device_g_table(curve_name: str, device: torch.device) -> torch.Tensor:
    """The G table in Montgomery form (x·2^256 mod p), ``(256, 3, 8)``
    int32 bit patterns on ``device``: what the CUDA kernel reads."""
    return torch.from_numpy(
        _mont_u32(curve_name, g_table_8bit(curve_name))).to(device)


@functools.lru_cache(maxsize=None)
def device_g32_table(curve_name: str, device: torch.device) -> torch.Tensor:
    """The 32 positioned G tables in Montgomery form, ``(32, 256, 3, 8)``
    int32 bit patterns on ``device``: what the pinned kernel reads."""
    return torch.from_numpy(
        _mont_u32(curve_name, g32_tables(curve_name))).to(device)


def _limbs16(t: np.ndarray) -> np.ndarray:
    """(..., 8) uint32 -> (..., 16) int64 16-bit limbs."""
    t = t.astype(np.int64)
    return np.stack([t & 0xFFFF, t >> 16], axis=-1).reshape(
        t.shape[:-1] + (16,))


@functools.lru_cache(maxsize=None)
def _g_table_limbs16(curve_name: str, device: torch.device) -> torch.Tensor:
    """The G table as (256, 3, 16) int64 16-bit limbs (plain version)."""
    return torch.as_tensor(_limbs16(g_table_8bit(curve_name)), device=device)


@functools.lru_cache(maxsize=None)
def _g32_limbs16(curve_name: str, device: torch.device) -> torch.Tensor:
    """The positioned G tables as (32, 256, 3, 16) int64 16-bit limbs."""
    return torch.as_tensor(_limbs16(g32_tables(curve_name)), device=device)


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


def _lane_table(curve: Curve, f, fpc, qx: FE, qy: FE, one: FE, zero: FE):
    """Per-lane [0..8]·Q in normal form (entry 0 = infinity): the
    entries, and their coordinates stacked (9, 18, B) each with the
    limbs' bound."""
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
    return entries, tabs, lbq


def dual_ladder(curve: Curve, fpc, u1c, u2c, qx: FE, qy: FE) -> Proj:
    """R = u1·G + u2·Q over canonical (16, B) scalars u1c, u2c."""
    like = qx.v
    f = TorchField(fpc, like)
    one = norm(fpc, fe_const(fpc, 1, like))
    zero = fe_zero(like)
    _, tabs, lbq = _lane_table(curve, f, fpc, qx, qy, one, zero)

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


def dual_ladder_glv(curve: Curve, fpc, u1c, u2c, qx: FE, qy: FE) -> Proj:
    """secp256k1's R = u1·G + u2·Q with the GLV split, the schedule of the
    reference's ``dual_ladder_glv`` (``verify_fold.py:315``): u2 = k1 +
    k2·λ with halves below 2^132 (:func:`glv.decompose`), k1·Q + k2·ψ(Q)
    on one doubling chain of 17 steps (4 doublings, the halves' digits at
    position 33 - 2·step, 4 doublings, those at 32 - 2·step: 136
    doublings, not 264), ψ(Q) = (β·X : Y : Z) read from a second x table;
    u1·G on an accumulator of its own, two positioned G bytes a step
    (:func:`g32_tables`), never doubled; one complete addition joins the
    two."""
    like = qx.v
    f = TorchField(fpc, like)
    one = norm(fpc, fe_const(fpc, 1, like))
    zero = fe_zero(like)
    entries, tabs, lbq = _lane_table(curve, f, fpc, qx, qy, one, zero)
    beta = fe_const(fpc, glv.BETA, like)
    psis = [norm(fpc, fold.mul(fpc, e.x, beta)) for e in entries]
    lbp = max(c.lb for c in psis)
    psi = torch.stack([fold._pad_to(c.v, fold.L_NORM) for c in psis])

    k1m, k1n, k2m, k2n = glv.decompose(u2c)
    d1, n1 = _signed_digits_k(k1m)                  # (34, B) each
    d2, n2 = _signed_digits_k(k2m)

    def q_addend(xtab, lbx, d, neg) -> Proj:
        x = FE(_lookup(xtab, d), lbx)
        y = FE(_lookup(tabs[1], d), lbq)
        z = FE(_lookup(tabs[2], d), lbq)
        return Proj(x, fold.select(neg, fold.sub(fpc, zero, y), y), z)

    g32 = _g32_limbs16(curve.name, like.device)
    by = _bytes(u1c)

    def g_addend(j: int) -> Proj:
        g = g32[j][by[j]]                               # (B, 3, 16)
        return Proj(*(FE(g[:, c].T, 1 << 16) for c in range(3)))

    accq = Proj(zero, one, zero)
    accg = Proj(zero, one, zero)
    for st in range(17):
        for pos in (33 - 2 * st, 32 - 2 * st):
            for _ in range(4):
                accq = point_dbl(f, curve, accq)
            accq = point_add(f, curve, accq, q_addend(
                tabs[0], lbq, d1[pos], n1[pos] ^ k1n))
            accq = point_add(f, curve, accq, q_addend(
                psi, lbp, d2[pos], n2[pos] ^ k2n))
        for j in (2 * st, 2 * st + 1):
            if j < 32:
                accg = point_add(f, curve, accg, g_addend(j))
        accq = Proj(*(norm(fpc, c) for c in accq))
        accg = Proj(*(norm(fpc, c) for c in accg))
    out = point_add(f, curve, accq, accg)
    return Proj(*(norm(fpc, c) for c in out))


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

    # --- R = u1·G + u2·Q: the GLV ladder on secp256k1, as the reference
    # chooses at verify_fold.py:890-895 ----------------------------------
    ladder = dual_ladder_glv if curve.name == "secp256k1" else dual_ladder
    rp = ladder(curve, fpc, u1c, u2c, qx, qy)
    not_inf = ~is_zero_mod(fpc, rp.z)

    # --- x(R) ≡ r (mod n), inversion-free: X == r·Z or (r+n)·Z ---------
    ok1 = is_zero_mod(fpc, fold.sub(fpc, rp.x, fold.mul(fpc, r_fe, rp.z)))
    rn16, carry = fold.add_const_carry(r16, n)
    rn_fits = (carry == 0) & fold.lt_const(rn16, p)
    ok2 = rn_fits & is_zero_mod(
        fpc, fold.sub(fpc, rp.x, fold.mul(fpc, from_limbs16(rn16), rp.z)))

    return r_ok & s_ok & q_ok & on_curve & not_inf & (ok1 | ok2)


# ------------------------------------------------- pinned-key tables
#
# For a key known ahead of time the host builds POSITIONED signed-4-bit
# tables tab[j][d] = (d·16^j)·Q, as the reference's
# ``build_pinned_tables`` (``verify_fold.py:498``) does. Consuming u2
# through them needs no doubling and no per-lane table build. Entry 0 is
# infinity (x = 0, y = 1); z is made from the digit, so only x and y
# (and psi_x = β·x for secp256k1's GLV half) are stored.

PINNED_COORDS = {"secp256k1": ("x", "y", "psi_x"), "P-256": ("x", "y")}


def pinned_positions(curve_name: str) -> int:
    """Signed-4-bit digit positions of u2 the pinned ladder consumes:
    the two 132-bit GLV halves on secp256k1 (33 digits + carry), the
    whole 256-bit scalar on P-256 (64 digits + 2 carry nibbles)."""
    if curve_name == "secp256k1":
        return (glv.KMAX_BITS + 3) // 4 + 1        # 34
    return 66


def pinned_pool_bytes(curve_name: str) -> int:
    """Device bytes one pinned key occupies in the port's layout."""
    return (len(PINNED_COORDS[curve_name]) * pinned_positions(curve_name)
            * 9 * 8 * 4)


def build_pinned_tables(curve_name: str, qx: int, qy: int) -> dict:
    """Positioned tables for a fixed public key Q = (qx, qy): per
    coordinate of ``PINNED_COORDS[curve_name]`` a ``(npos, 9, 8)``
    uint32 array whose entry [j][d] holds that coordinate of
    (d·16^j)·Q, canonical, with entry 0 = infinity (x = 0, y = 1).

    Pinned lanes skip the range and curve checks of the generic verify,
    so Q is validated here exactly as the reference validates it:
    ``ValueError`` for a coordinate out of range, Q = (0, 0), or a point
    off the curve."""
    curve = CURVES[curve_name]
    p = curve.fp.modulus
    if not (0 <= qx < p and 0 <= qy < p):
        raise ValueError("public key coordinate out of range")
    if qx == 0 and qy == 0:
        raise ValueError("public key is the point at infinity")
    if (qy * qy - (qx * qx * qx + curve.a * qx + curve.b)) % p:
        raise ValueError("public key not on curve")
    npos = pinned_positions(curve_name)
    xs: list[int] = []
    ys: list[int] = []
    base = (qx, qy)
    for _ in range(npos):
        x, y, _z = _multiples(curve, base, 9)
        xs += x
        ys += y
        for _ in range(4):                 # next position: 16·base
            base = _aff_add(curve, base, base)
    tabs = {"x": xs, "y": ys}
    if curve_name == "secp256k1":
        tabs["psi_x"] = [glv.psi_host(x, 0)[0] for x in xs]
    return {nm: _ints_to_u32(v).reshape(npos, 9, 8) for nm, v in tabs.items()}


def pinned_tables_from_reference(tabs: dict) -> dict:
    """One key's output of the reference's ``build_pinned_tables``
    (radix-12, ``(npos, 9, 23)`` per coordinate) -> the port's
    ``(npos, 9, 8)`` uint32 layout."""
    return {nm: _from_radix12(v) for nm, v in tabs.items()}


def pinned_device_tables(curve_name: str, tabs: dict) -> dict:
    """Canonical pinned tables -> the pool's entries: Montgomery form,
    ``(npos, 9, 8)`` int32 bit patterns per coordinate."""
    return {nm: _mont_u32(curve_name, v) for nm, v in tabs.items()}


def check_pools(curve_name: str, pools: dict) -> int:
    """Shape and type checks of a pinned pool; returns its capacity."""
    names = PINNED_COORDS[curve_name]
    if set(pools) != set(names):
        raise ValueError(f"{curve_name} pools hold {sorted(names)}, "
                         f"got {sorted(pools)}")
    cap = pools["x"].shape[0]
    shape = (cap, pinned_positions(curve_name), 9, 8)
    for nm in names:
        t = pools[nm]
        if tuple(t.shape) != shape or t.dtype != torch.int32:
            raise ValueError(f"pool {nm!r} must be {shape} int32, got "
                             f"{tuple(t.shape)} {t.dtype}")
    if cap < 1:
        raise ValueError("empty pool")
    return cap


# ------------------------------------------------ the plain pinned ladder

def _signed_digits_k(km: torch.Tensor):
    """GLV half magnitude (9, B) 16-bit limbs < 2^132 -> 34 signed 4-bit
    digits, LSB first: d_i = nib(k + 0x88…8)_i - 8 for i < 33 and
    d_33 = the carry nibble (``_signed_digits_k``, ``verify_fold.py:272``).
    Returns (mag, neg), each (34, B)."""
    nd = (glv.KMAX_BITS + 3) // 4                  # 33
    c8 = sum(8 << (4 * i) for i in range(nd))
    c8l = torch.as_tensor([(c8 >> (16 * i)) & 0xFFFF for i in range(9)],
                          device=km.device)[:, None]
    w = glv._ripple(km + c8l)
    shifts = torch.arange(0, 16, 4, device=km.device)[None, :, None]
    nib = ((w[:, None, :] >> shifts) & 0xF).reshape(36, -1)[:nd + 1]
    low = (torch.arange(nd + 1, device=km.device) < nd)[:, None]
    d = nib - 8
    mag = torch.where(low, d.abs(), nib)
    neg = low & (d < 0)
    return mag, neg


def _mont_entry(flat: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Lane b's entry flat[idx[b]] of a (N, 8) int32 Montgomery pool as
    (16, B) int64 16-bit limbs (still in Montgomery form)."""
    w = flat[idx].to(torch.int64) & 0xFFFFFFFF             # (B, 8)
    return torch.stack([w & 0xFFFF, w >> 16], dim=-1).reshape(-1, 16).T


def pinned_ladder(curve: Curve, fpc, u1c, u2c, slot: torch.Tensor,
                  pools: dict) -> Proj:
    """R = u1·G + u2·Q with Q pinned at pool slot ``slot`` (B,): only
    position-absolute complete additions, the schedule of the
    reference's ``pinned_ladder`` (``verify_fold.py:597``).

    secp256k1: u2 splits into two 132-bit GLV halves that read the x and
    psi_x pools; 17 steps of four Q entries (x, psi_x at the high
    position, then at the low one) and two G bytes (positions 2j and
    2j + 1; past 31 the infinity entry). P-256: u2's 66 signed digits,
    33 steps of two Q entries and one G byte. A Q entry's y is negated
    where its digit's sign (XOR the half's sign) says so."""
    npos = pinned_positions(curve.name)
    like = u2c
    f = TorchField(fpc, like)
    one = norm(fpc, fe_const(fpc, 1, like))
    zero = fe_zero(like)
    rinv = fe_const(fpc, pow(1 << 256, -1, curve.fp.modulus), like)
    flat = {nm: t.reshape(-1, 8) for nm, t in pools.items()}
    slot = slot.to(torch.int64)

    def q_addend(xname: str, pos: int, d, neg) -> Proj:
        idx = (slot * npos + pos) * 9 + d
        x = fold.mul(fpc, FE(_mont_entry(flat[xname], idx), 1 << 16), rinv)
        y = fold.mul(fpc, FE(_mont_entry(flat["y"], idx), 1 << 16), rinv)
        z = FE((d != 0).to(torch.int64)[None], 2)
        return Proj(x, fold.select(neg, fold.sub(fpc, zero, y), y), z)

    g32 = _g32_limbs16(curve.name, like.device)
    by = _bytes(u1c)                                # (33, B), byte 32 = 0

    def g_addend(j: int) -> Proj:
        g = g32[min(j, 31)][by[min(j, 32)]]          # (B, 3, 16)
        return Proj(*(FE(g[:, c].T, 1 << 16) for c in range(3)))

    acc = Proj(zero, one, zero)
    if curve.name == "secp256k1":
        k1m, k1n, k2m, k2n = glv.decompose(u2c)
        d1, n1 = _signed_digits_k(k1m)
        d2, n2 = _signed_digits_k(k2m)
        for st in range(npos // 2):                  # 17
            for pos in (npos - 1 - 2 * st, npos - 2 - 2 * st):
                acc = point_add(f, curve, acc, q_addend(
                    "x", pos, d1[pos], n1[pos] ^ k1n))
                acc = point_add(f, curve, acc, q_addend(
                    "psi_x", pos, d2[pos], n2[pos] ^ k2n))
            for j in (2 * st, 2 * st + 1):
                acc = point_add(f, curve, acc, g_addend(j))
            acc = Proj(*(norm(fpc, c) for c in acc))
    else:
        mag, neg = _signed_digits(u2c)              # (66, B)
        for st in range(npos // 2):                  # 33
            for pos in (npos - 1 - 2 * st, npos - 2 - 2 * st):
                acc = point_add(f, curve, acc, q_addend(
                    "x", pos, mag[pos], neg[pos]))
            acc = point_add(f, curve, acc, g_addend(st))
            acc = Proj(*(norm(fpc, c) for c in acc))
    return acc


def verify_fold_pinned(curve: Curve, r16, s16, e16, slot: torch.Tensor,
                       pools: dict) -> torch.Tensor:
    """Pinned-key batched verify, the contract of the reference's
    ``verify_fold_pinned`` (``verify_fold.py:736``): r16, s16, e16 are
    (16, B) 16-bit limbs, ``slot`` (B,) pool slots, ``pools`` the pinned
    pool (:func:`check_pools`). Returns (B,) bool.

    The key never enters: its checks ran when it was pinned. What is
    left: r, s in [1, n); a batch inverse of s; u1 = e/s, u2 = r/s; the
    zero-doubling ladder; R ≠ ∞; x(R) ≡ r through X == r·Z or, where
    r + n < p, X == (r + n)·Z. A slot outside the pool gives False."""
    cap = check_pools(curve.name, pools)
    fpc = fold_ctx(curve.fp.modulus)
    fnc = fold_ctx(curve.fn.modulus)
    r16, s16, e16 = (t.to(torch.int64) & 0xFFFF for t in (r16, s16, e16))
    n, p = curve.fn.modulus, curve.fp.modulus
    slot = slot.to(device=r16.device, dtype=torch.int64)
    slot_ok = (slot >= 0) & (slot < cap)

    r_ok = ~fold.is_zero16(r16) & fold.lt_const(r16, n)
    s_ok = ~fold.is_zero16(s16) & fold.lt_const(s16, n)
    r_fe, s_fe, e_fe = (from_limbs16(a) for a in (r16, s16, e16))
    s_inv = fold.batch_inv(fnc, s_fe)
    u1c = fold.canon(fnc, fold.mul(fnc, e_fe, s_inv))
    u2c = fold.canon(fnc, fold.mul(fnc, r_fe, s_inv))

    rp = pinned_ladder(curve, fpc, u1c, u2c, torch.where(slot_ok, slot, 0),
                       pools)
    not_inf = ~is_zero_mod(fpc, rp.z)
    ok1 = is_zero_mod(fpc, fold.sub(fpc, rp.x, fold.mul(fpc, r_fe, rp.z)))
    rn16, carry = fold.add_const_carry(r16, n)
    rn_fits = (carry == 0) & fold.lt_const(rn16, p)
    ok2 = rn_fits & is_zero_mod(
        fpc, fold.sub(fpc, rp.x, fold.mul(fpc, from_limbs16(rn16), rp.z)))
    return r_ok & s_ok & slot_ok & not_inf & (ok1 | ok2)
