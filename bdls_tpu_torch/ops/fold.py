"""Plain PyTorch field arithmetic mod p and mod n — the CUDA kernel's twin.

The counterpart of ``bdls_tpu/ops/fold.py`` (the TPU's radix-12 fold
field). It computes the same functions (products, sums, differences,
canonical forms and inverses of integers mod m) but in a layout chosen
for PyTorch rather than for the TPU's vector unit:

- **Representation**: a field element is ``(L, B)`` int64 limbs of
  nominally 16 bits, batch last (the ``(16, B)`` wire layout of
  :mod:`bdls_tpu_torch.crypto.marshal`). Limbs are redundant: each
  :class:`FE` carries ``lb``, a Python-int exclusive bound on its limbs,
  so overflow safety is decided when the code runs on shapes, never
  per value. int64 is the carrier because torch's ``uint32`` lacks
  ``+``, ``>>`` and comparisons on the CPU.
- **Normal form**: at most 18 limbs, each below 2^17. Products of two
  normal elements take 35 columns below 18·2^34 < 2^39.
- **Multiply** = one shifted-copies gather, one product and one column
  sum, then a fold of every column at position ≥ 16 through the constant
  ``ρ_k = 2^(16k) mod m`` rows, then parallel carry passes. The value is
  kept exactly (limbs are never dropped), so no value bound is needed.
- **Subtraction** is compensated: ``a - b + C`` with C ≡ 0 (mod m) and
  every limb of C above b's limb bound.
- **Canonical form** (exact limbs in ``[0, m)``) is paid only where a
  value is compared: exact ripples, three folds of the bits above 2^256
  through ``δ = 2^256 mod m`` and two conditional subtractions of m.

This is the plain version that the tests hold against the JAX package
on the CPU and that ``chip_smoke.py`` holds the kernel against on the
card. It repeats the kernel's arithmetic with many small tensor ops and
is no yardstick of speed.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

RADIX = 16
MASK = (1 << RADIX) - 1
N16 = 16                   # limbs of a canonical 256-bit value
L_NORM = 18                # limbs of a normal-form element
LB_NORM = 1 << 17          # exclusive limb bound of the normal form
_RHO_ROWS = 32             # fold rows: positions 16 .. 47
_I64 = torch.int64


def int_to_limbs16(x: int, n: int = N16) -> np.ndarray:
    if x < 0 or x >= 1 << (RADIX * n):
        raise ValueError("out of range")
    return np.array([(x >> (RADIX * i)) & MASK for i in range(n)],
                    dtype=np.int64)


def limbs16_to_int(limbs) -> int:
    return sum(int(v) << (RADIX * i) for i, v in enumerate(limbs))


def tensor_to_ints(v: torch.Tensor) -> list[int]:
    """(L, B) limbs (any bounds) -> the B integers they hold."""
    a = v.detach().cpu().numpy()
    return [limbs16_to_int(a[:, b]) for b in range(a.shape[1])]


def _decompose_range(value: int, lo: int, hi: int, n: int) -> list[int]:
    """``value`` as n base-2^16 digits each in [lo, hi] (compensation
    constants: ≡ 0 mod m with every limb large)."""
    digits = [0] * n
    rem = value
    for i in range(n - 1, 0, -1):
        low_min = sum(lo << (RADIX * j) for j in range(i))
        d = max(lo, min(hi, (rem - low_min) >> (RADIX * i)))
        digits[i] = d
        rem -= d << (RADIX * i)
    if not lo <= rem <= hi:
        raise ValueError("decomposition failed")
    digits[0] = rem
    return digits


class FoldCtx(NamedTuple):
    """Host constants for one odd modulus 2^256/3 < m < 2^256 with
    δ = 2^256 mod m < 2^226: the four moduli of P-256 and secp256k1, and
    Ed25519's 2^255 - 19."""

    modulus: int
    m16: np.ndarray          # (16,) limbs of m
    rho: np.ndarray          # (_RHO_ROWS, 16) limbs of 2^(16·(16+k)) mod m
    delta: np.ndarray        # (16,) limbs of 2^256 mod m
    comp: np.ndarray         # (18,) limbs of k·m, each in [2^17, 2^18)
    comp_max: int
    inv_exp: int             # m - 2 (Fermat)


@functools.lru_cache(maxsize=None)
def fold_ctx(modulus: int) -> FoldCtx:
    if modulus % 2 == 0 or not (1 << 256) < 3 * modulus < (3 << 256):
        raise ValueError("modulus must be odd, in (2^256/3, 2^256)")
    if (1 << 256) % modulus >= 1 << 226:
        raise ValueError("2^256 mod m must be < 2^226")
    rho = np.stack([int_to_limbs16(pow(2, RADIX * (N16 + k), modulus))
                    for k in range(_RHO_ROWS)])
    lo, hi = LB_NORM, 2 * LB_NORM - 1
    mid = sum(((lo + hi) // 2) << (RADIX * i) for i in range(L_NORM))
    comp = None
    for k in range(max(1, mid // modulus - 4), mid // modulus + 8):
        try:
            comp = _decompose_range(k * modulus, lo, hi, L_NORM)
            break
        except ValueError:
            continue
    if comp is None:
        raise ValueError("no compensation constant found")
    return FoldCtx(
        modulus=modulus,
        m16=int_to_limbs16(modulus),
        rho=rho,
        delta=int_to_limbs16((1 << 256) % modulus),
        comp=np.array(comp, dtype=np.int64),
        comp_max=max(comp),
        inv_exp=modulus - 2,
    )


@functools.lru_cache(maxsize=None)
def _dev(modulus: int, name: str, device: torch.device) -> torch.Tensor:
    """Constant tensors of one modulus on one device, shaped to broadcast
    against ``(L, B)`` limbs."""
    ctx = fold_ctx(modulus)
    arr = {
        "m16": ctx.m16[:, None],
        "rho": ctx.rho[:, :, None],
        "delta": ctx.delta[:, None],
        "comp": ctx.comp[:, None],
    }[name]
    return torch.as_tensor(arr, dtype=_I64, device=device)


@functools.lru_cache(maxsize=None)
def _mul_idx(la: int, lb: int, device: torch.device) -> torch.Tensor:
    """SH[i, k] = b[k - i] (zero outside) as a gather index into
    ``b`` padded with ``la`` zero rows."""
    idx = (np.arange(la + lb - 1)[None, :] - np.arange(la)[:, None])
    idx = np.where((idx >= 0) & (idx < lb), idx, lb)
    return torch.as_tensor(idx, dtype=_I64, device=device)


class FE(NamedTuple):
    """A batched field element: limbs ``(L, B)`` int64 and ``lb``, an
    exclusive bound on every limb (a plain Python int)."""

    v: torch.Tensor
    lb: int


def from_limbs16(a16: torch.Tensor) -> FE:
    """(16, B) 16-bit limbs (int32 bit patterns or any integer dtype)."""
    return FE(a16.to(_I64) & MASK, 1 << RADIX)


def fe_const(ctx: FoldCtx, x: int, like: torch.Tensor) -> FE:
    col = torch.as_tensor(int_to_limbs16(x % ctx.modulus)[:, None],
                          device=like.device)
    return FE(col.expand(N16, like.shape[-1]), 1 << RADIX)


def fe_zero(like: torch.Tensor) -> FE:
    return FE(torch.zeros((1, like.shape[-1]), dtype=_I64,
                          device=like.device), 1)


def _pad_to(v: torch.Tensor, n: int) -> torch.Tensor:
    if v.shape[0] >= n:
        return v
    return torch.nn.functional.pad(v, (0, 0, 0, n - v.shape[0]))


# ------------------------------------------------------------ arithmetic

def add(x: FE, y: FE) -> FE:
    n = max(x.v.shape[0], y.v.shape[0])
    assert x.lb + y.lb < 1 << 62
    return FE(_pad_to(x.v, n) + _pad_to(y.v, n), x.lb + y.lb - 1)


def mul_small(x: FE, k: int) -> FE:
    assert (x.lb - 1) * k < 1 << 62
    return FE(x.v * k, (x.lb - 1) * k + 1)


def sub(ctx: FoldCtx, x: FE, y: FE) -> FE:
    """x - y + C, C ≡ 0 (mod m) with every limb at least y's bound."""
    if y.lb > LB_NORM or y.v.shape[0] > L_NORM:
        y = norm(ctx, y)
    if x.v.shape[0] > L_NORM:
        x = norm(ctx, x)
    comp = _dev(ctx.modulus, "comp", x.v.device)
    v = _pad_to(x.v, L_NORM) + comp - _pad_to(y.v, L_NORM)
    return FE(v, x.lb + ctx.comp_max)


def select(mask: torch.Tensor, x: FE, y: FE) -> FE:
    """Per-lane select: mask (B,) bool -> x else y."""
    n = max(x.v.shape[0], y.v.shape[0])
    return FE(torch.where(mask[None], _pad_to(x.v, n), _pad_to(y.v, n)),
              max(x.lb, y.lb))


def _carry(v: torch.Tensor, lb: int):
    """One parallel carry pass; grows the limb count by one (the value is
    kept exactly)."""
    lo = torch.nn.functional.pad(v & MASK, (0, 0, 0, 1))
    hi = torch.nn.functional.pad(v >> RADIX, (0, 0, 1, 0))
    return lo + hi, (1 << RADIX) + ((lb - 1) >> RADIX)


def _fold(ctx: FoldCtx, v: torch.Tensor, lb: int):
    """Limbs at positions ≥ 16 folded through ρ (one product, one sum)."""
    h = v.shape[0] - N16
    assert 0 < h <= _RHO_ROWS
    rho = _dev(ctx.modulus, "rho", v.device)[:h]
    contrib = (rho * v[N16:, None, :]).sum(0)
    new_lb = (lb - 1) * (1 + h * MASK) + 1
    assert new_lb < 1 << 62, new_lb
    return v[:N16] + contrib, new_lb


def _reduce(ctx: FoldCtx, v: torch.Tensor, lb: int) -> FE:
    """Carry and fold until the normal form (≤ 18 limbs, limbs < 2^17)."""
    for _ in range(8):
        while lb > LB_NORM:
            v, lb = _carry(v, lb)
        if v.shape[0] <= L_NORM:
            return FE(v, lb)
        v, lb = _fold(ctx, v, lb)
    raise AssertionError("reduce did not converge")


def norm(ctx: FoldCtx, x: FE) -> FE:
    if x.lb <= LB_NORM and x.v.shape[0] <= L_NORM:
        return x
    return _reduce(ctx, x.v, x.lb)


def mul(ctx: FoldCtx, x: FE, y: FE) -> FE:
    x, y = norm(ctx, x), norm(ctx, y)
    a, b = x.v, y.v
    la, lb_ = a.shape[0], b.shape[0]
    b_ext = torch.nn.functional.pad(b, (0, 0, 0, 1))
    sh = b_ext[_mul_idx(la, lb_, a.device)]              # (la, la+lb-1, B)
    cols = (a[:, None, :] * sh).sum(0)
    bound = min(la, lb_) * (x.lb - 1) * (y.lb - 1) + 1
    assert bound < 1 << 62
    return _reduce(ctx, cols, bound)


def sqr(ctx: FoldCtx, x: FE) -> FE:
    return mul(ctx, x, x)


# ------------------------------------------------------------- canonical

def _ripple(v: torch.Tensor, n: int) -> torch.Tensor:
    """Exact carry propagation over n output limbs (serial; canon only)."""
    v = _pad_to(v, n).clone()
    for i in range(n - 1):
        c = v[i] >> RADIX
        v[i] &= MASK
        v[i + 1] += c
    return v


def _fold_delta(ctx: FoldCtx, v: torch.Tensor) -> torch.Tensor:
    """Exact limbs -> lo + (value >> 256)·δ, exact limbs again."""
    hi = torch.zeros_like(v[0])
    for k in range(v.shape[0] - 1, N16 - 1, -1):
        hi = (hi << RADIX) + v[k]
    delta = _dev(ctx.modulus, "delta", v.device)
    return _ripple(v[:N16] + hi[None] * delta, N16 + 3)


def _sub_m_if(ctx: FoldCtx, v: torch.Tensor) -> torch.Tensor:
    """One conditional exact subtraction of m (17 exact limbs in/out)."""
    m = _pad_to(_dev(ctx.modulus, "m16", v.device), v.shape[0])
    d = v - m
    borrow = torch.zeros_like(v[0])
    out = torch.empty_like(v)
    for i in range(v.shape[0]):
        x = d[i] - borrow
        borrow = (x < 0).to(_I64)
        out[i] = x + (borrow << RADIX)
    return torch.where((borrow == 0)[None], out, v)


def canon(ctx: FoldCtx, x: FE) -> torch.Tensor:
    """FE -> exact limbs (16, B), value in [0, m).

    Convergence: a normal element is below 2^290, so the first δ-fold
    leaves < 2^256 + 2^34·2^226, the second < 2^256 + 2^231, the third
    < 2^256 + δ < 3m (m > 2^256/3 and δ < m); two conditional
    subtractions finish."""
    x = norm(ctx, x)
    v = _ripple(x.v, L_NORM + 1)
    for _ in range(3):
        v = _fold_delta(ctx, v)
    v = _sub_m_if(ctx, v)
    v = _sub_m_if(ctx, v)
    return v[:N16]


def is_zero_mod(ctx: FoldCtx, x: FE) -> torch.Tensor:
    return (canon(ctx, x) == 0).all(0)


# ------------------------------------------------------------- inversion

def fermat_inv(ctx: FoldCtx, x: FE) -> FE:
    """x^(m-2) by square-and-multiply over the public exponent, most
    significant bit first (zero lanes map to zero)."""
    x = norm(ctx, x)
    e = ctx.inv_exp
    acc = x
    for i in range(e.bit_length() - 2, -1, -1):
        acc = sqr(ctx, acc)
        if (e >> i) & 1:
            acc = mul(ctx, acc, x)
    return acc


def _scan_mul(ctx: FoldCtx, v: torch.Tensor,
              one: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix products along the batch axis (log-depth:
    lane i takes lane i - k's running product for k = 1, 2, 4 …)."""
    k = 1
    while k < v.shape[1]:
        shifted = torch.cat([one[:, :k], v[:, :-k]], dim=1)
        prod = mul(ctx, FE(v, LB_NORM), FE(shifted, LB_NORM))
        v = _pad_to(norm(ctx, prod).v, L_NORM)
        k *= 2
    return v


def batch_inv(ctx: FoldCtx, x: FE) -> FE:
    """Montgomery batch inversion along the batch axis: prefix and
    suffix products, ONE Fermat inverse of the total, two products a
    lane (the reference's ``fold.batch_inv``). Zero lanes -> zero."""
    zero = is_zero_mod(ctx, x)
    one = _pad_to(fe_const(ctx, 1, x.v).v, L_NORM)
    safe = _pad_to(select(~zero, norm(ctx, x), FE(one, 1 << RADIX)).v, L_NORM)
    pre = _scan_mul(ctx, safe, one)
    suf = _scan_mul(ctx, safe.flip(1), one).flip(1)
    inv_total = fermat_inv(ctx, FE(pre[:, -1:], LB_NORM))
    pre_ex = torch.cat([one[:, :1], pre[:, :-1]], dim=1)
    suf_ex = torch.cat([suf[:, 1:], one[:, :1]], dim=1)
    inv = mul(ctx, mul(ctx, FE(pre_ex, LB_NORM), FE(suf_ex, LB_NORM)),
              FE(inv_total.v.expand(-1, pre_ex.shape[1]), inv_total.lb))
    return select(zero, fe_zero(x.v), inv)


# ----------------------------------------------- raw 16-limb comparisons

def lt_const(a16: torch.Tensor, c: int) -> torch.Tensor:
    """(16, B) exact limbs < the constant c, per lane."""
    c16 = torch.as_tensor(int_to_limbs16(c)[:, None], device=a16.device)
    diff = a16 - c16
    nz = diff != 0
    # the most significant differing limb decides
    pos = torch.arange(1, N16 + 1, device=a16.device)[:, None]
    top = (nz * pos).amax(0)                               # 0: equal
    idx = (top - 1).clamp(min=0)
    d = diff.gather(0, idx[None])[0]
    return (top > 0) & (d < 0)


def is_zero16(a16: torch.Tensor) -> torch.Tensor:
    return (a16 == 0).all(0)


def add_const_carry(a16: torch.Tensor, c: int):
    """Exact (16, B) a + c: (limbs, carry out of bit 256)."""
    c16 = torch.as_tensor(int_to_limbs16(c)[:, None], device=a16.device)
    v = _ripple(a16 + c16, N16 + 1)
    return v[:N16], v[N16]
