"""Plain PyTorch arithmetic mod the BLS12-381 prime — K9's field twin.

The counterpart of ``bdls_tpu/ops/wideint.py`` (the TPU's radix-12
field for moduli past 256 bits), for the one modulus the port needs,
p < 2^381. It computes the same functions (products, sums, differences,
canonical forms and inverses mod p) in the layout of
:mod:`bdls_tpu_torch.ops.fold`:

- **Representation**: an element is ``(L, *batch)`` int64 limbs of
  nominally 16 bits, with ``lb``, a Python-int exclusive bound on every
  limb, so overflow safety is decided on shapes, never per value. int64
  is the carrier because torch's ``uint32`` lacks ``+``, ``>>`` and
  comparisons on the CPU.
- **Normal form**: at most 26 limbs, each below 2^17. The fold boundary
  is limb 24 (2^384): columns at or above it fold through the constant
  rows ``ρ_k = 2^(16(24+k)) mod p``, then parallel carry passes; the
  value is kept exactly (no limb is dropped).
- **Subtraction** is compensated: ``a - b + C`` with C ≡ 0 (mod p) and
  every limb of C above b's limb bound.
- **Canonical form** (the exact value in [0, p)) is paid only where a
  value is compared or leaves the field: an exact ripple and a descent
  of conditional subtractions of 2^k·p.

The kernel (``csrc/fp381.cuh``) keeps 12 × 32-bit Montgomery limbs; the
two meet in canonical 32-bit words (:func:`from_words`,
:func:`to_words`), the layout of every K9 input and output.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from bdls_tpu_torch.ops.bls_host import P

RADIX = 16
MASK = (1 << RADIX) - 1
N16 = 24                   # 16-bit limbs of a 384-bit value
L_NORM = 26                # limbs of a normal-form element
LB_NORM = 1 << 17          # exclusive limb bound of the normal form
_RHO_ROWS = 32             # fold rows: positions 24 .. 55
_VALUE_BITS = 418          # a normal value (26 limbs under 2^17) < 2^418
_CANON_LIMBS = 27          # exact limbs that hold it
_I64 = torch.int64


def int_to_limbs(x: int, n: int = N16) -> np.ndarray:
    if x < 0 or x >= 1 << (RADIX * n):
        raise ValueError("out of range")
    return np.array([(x >> (RADIX * i)) & MASK for i in range(n)],
                    dtype=np.int64)


def limbs_to_int(limbs) -> int:
    return sum(int(v) << (RADIX * i) for i, v in enumerate(limbs))


def _decompose_range(value: int, lo: int, hi: int, n: int) -> list[int]:
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


@functools.lru_cache(maxsize=None)
def _host_consts() -> dict:
    rho = np.stack([int_to_limbs(pow(2, RADIX * (N16 + k), P))
                    for k in range(_RHO_ROWS)])
    lo, hi = LB_NORM, 2 * LB_NORM - 1
    mid = sum(((lo + hi) // 2) << (RADIX * i) for i in range(L_NORM))
    comp = None
    for k in range(mid // P - 4, mid // P + 8):
        try:
            comp = _decompose_range(k * P, lo, hi, L_NORM)
            break
        except ValueError:
            continue
    assert comp is not None
    # 2^(top+1)·p > 2^418 (p > 2^380): the descent starts at 2^top·p
    top = _VALUE_BITS - P.bit_length()
    desc = np.stack([int_to_limbs(P << e, _CANON_LIMBS)
                     for e in range(top, -1, -1)])
    return {"rho": rho, "comp": np.array(comp, dtype=np.int64),
            "desc": desc}


COMP_MAX = max(int(c) for c in _host_consts()["comp"])


@functools.lru_cache(maxsize=None)
def _dev(name: str, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(_host_consts()[name], dtype=_I64, device=device)


def _bcast(c: torch.Tensor, ndim: int) -> torch.Tensor:
    """A (L,) or (rows, L) constant shaped against ``ndim``-dim limbs."""
    return c.reshape(c.shape + (1,) * (ndim - 1))


class FP(NamedTuple):
    """Batched element: limbs ``(L, *batch)`` int64 and ``lb``, an
    exclusive bound on every limb (a plain Python int)."""

    v: torch.Tensor
    lb: int


def _pad_to(v: torch.Tensor, n: int) -> torch.Tensor:
    if v.shape[0] >= n:
        return v
    return torch.cat([v, v.new_zeros((n - v.shape[0],) + v.shape[1:])])


# ---------------------------------------------------- ints and words

def from_ints(xs, device=None) -> FP:
    """Host ints (reduced mod p) -> (24, B) canonical limbs."""
    arr = np.stack([int_to_limbs(int(x) % P) for x in xs], axis=1)
    return FP(torch.as_tensor(arr, dtype=_I64, device=device), 1 << RADIX)


def to_ints(x: FP) -> list[int]:
    """The canonical values of a (L, B) element."""
    a = canon(x).cpu().numpy()
    return [limbs_to_int(a[:, b]) for b in range(a.shape[1])]


def from_words(w: torch.Tensor) -> FP:
    """(12, *batch) 32-bit words (int32 bit patterns or int64) -> the
    (24, *batch) 16-bit limbs of the same value (read mod p from here
    on)."""
    w = w.to(_I64) & 0xFFFFFFFF
    v = torch.stack([w & MASK, w >> RADIX], dim=1)
    return FP(v.reshape((N16,) + w.shape[1:]), 1 << RADIX)


def to_words(x: FP) -> torch.Tensor:
    """The canonical value as (12, *batch) int64 words in [0, 2^32)."""
    c = canon(x)
    return c[0::2] | (c[1::2] << RADIX)


# -------------------------------------------------------- arithmetic

def add(x: FP, y: FP) -> FP:
    n = max(x.v.shape[0], y.v.shape[0])
    assert x.lb + y.lb < 1 << 62
    return FP(_pad_to(x.v, n) + _pad_to(y.v, n), x.lb + y.lb - 1)


def mul_small(x: FP, k: int) -> FP:
    assert (x.lb - 1) * k < 1 << 62
    return FP(x.v * k, (x.lb - 1) * k + 1)


def sub(x: FP, y: FP) -> FP:
    """x - y + C, C ≡ 0 (mod p) with every limb at least y's bound."""
    y = norm(y)
    if x.v.shape[0] > L_NORM:
        x = norm(x)
    comp = _bcast(_dev("comp", x.v.device), x.v.dim())
    v = _pad_to(x.v, L_NORM) + comp - _pad_to(y.v, L_NORM)
    return FP(v, x.lb + COMP_MAX)


def _carry(v: torch.Tensor, lb: int):
    """One parallel carry pass; grows the limb count by one."""
    lo = _pad_to(v & MASK, v.shape[0] + 1)
    hi = torch.cat([v.new_zeros((1,) + v.shape[1:]), v >> RADIX])
    return lo + hi, (1 << RADIX) + ((lb - 1) >> RADIX)


def _fold(v: torch.Tensor, lb: int):
    """Limbs at positions ≥ 24 folded through ρ."""
    h = v.shape[0] - N16
    assert 0 < h <= _RHO_ROWS
    rho = _bcast(_dev("rho", v.device)[:h], v.dim())       # (h, 24, 1..)
    contrib = (rho * v[N16:, None]).sum(0)
    new_lb = (lb - 1) * (1 + h * MASK) + 1
    assert new_lb < 1 << 62, new_lb
    return v[:N16] + contrib, new_lb


def _reduce(v: torch.Tensor, lb: int) -> FP:
    for _ in range(8):
        while lb > LB_NORM:
            v, lb = _carry(v, lb)
        if v.shape[0] <= L_NORM:
            return FP(v, lb)
        v, lb = _fold(v, lb)
    raise AssertionError("reduce did not converge")


def norm(x: FP) -> FP:
    if x.lb <= LB_NORM and x.v.shape[0] <= L_NORM:
        return x
    return _reduce(x.v, x.lb)


def mul_cols(x: FP, y: FP) -> FP:
    """The exact product's columns, not reduced: elementwise over the
    batch dims (which must match), ``la + lb - 1`` limbs."""
    x, y = norm(x), norm(y)
    a, b = x.v, y.v
    la, lb_ = a.shape[0], b.shape[0]
    cols = a.new_zeros((la + lb_ - 1,) + tuple(a.shape[1:]))
    for i in range(la):                                # shifted rows of b
        cols[i:i + lb_] += a[i] * b
    bound = min(la, lb_) * (x.lb - 1) * (y.lb - 1) + 1
    assert bound < 1 << 62
    return FP(cols, bound)


def mul(x: FP, y: FP) -> FP:
    """Elementwise product over the batch dims (which must match)."""
    return _reduce(*mul_cols(x, y))


def sqr(x: FP) -> FP:
    return mul(x, x)


# --------------------------------------------------------- canonical

def _ripple(v: torch.Tensor, n: int) -> torch.Tensor:
    """Exact carry propagation over n output limbs (serial)."""
    v = _pad_to(v, n).clone()
    for i in range(n - 1):
        c = v[i] >> RADIX
        v[i] &= MASK
        v[i + 1] += c
    return v


def _sub_if_ge(v: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """v - c where v ≥ c, else v (exact limbs in and out)."""
    c = _bcast(c, v.dim())
    borrow = torch.zeros_like(v[0])
    out = torch.empty_like(v)
    for i in range(v.shape[0]):
        x = v[i] - c[i] - borrow
        borrow = (x < 0).to(_I64)
        out[i] = x + (borrow << RADIX)
    return torch.where((borrow == 0)[None], out, v)


def canon(x: FP) -> torch.Tensor:
    """FP -> exact limbs (24, *batch), value in [0, p). A normal element
    is below 2^418 (26 limbs under 2^17); the descent subtracts 2^k·p,
    for k from 37 down to 0, where it fits."""
    x = norm(x)
    v = _ripple(x.v, _CANON_LIMBS)
    for c in _dev("desc", v.device):
        v = _sub_if_ge(v, c)
    return v[:N16]


def is_zero(x: FP) -> torch.Tensor:
    return (canon(x) == 0).all(0)


def eq_mod(x: FP, y: FP) -> torch.Tensor:
    return is_zero(sub(x, y))


def inv(x: FP) -> FP:
    """x^(p-2) by square-and-multiply, most significant bit first (zero
    -> zero)."""
    x = norm(x)
    e = P - 2
    acc = x
    for i in range(e.bit_length() - 2, -1, -1):
        acc = sqr(acc)
        if (e >> i) & 1:
            acc = mul(acc, x)
    return acc
