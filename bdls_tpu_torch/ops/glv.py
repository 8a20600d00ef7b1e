"""GLV scalar decomposition for secp256k1 — the port's copy.

The counterpart of ``bdls_tpu/ops/glv.py``. secp256k1 has the
endomorphism ψ(x, y) = (β·x, y) = λ·P (β³ = 1 mod p, λ³ = 1 mod n), so
``k·Q`` splits into ``k1·Q + k2·ψ(Q)`` with |k1|, |k2| < 2^132. With the
lattice basis (a1, b1), (a2, b2) of (λ, n) (Guide to ECC, alg. 3.74):

    c1 = (k·g1) >> 384      c2 = (k·g2) >> 384
    k1 = k - c1·a1 - c2·a2  k2 = c1·|b1| - c2·b2

where g_i = floor(2^384·|b|/n) + 1. The constants below are the
reference's (``glv.py:36-69``); :func:`decompose_host` is its integer
oracle; :func:`decompose` is the plain PyTorch version over the port's
16-bit limbs, and ``csrc/glv.cuh`` the kernel's. All three give the same
(k1, k2) for every k < n, so the signed digits, and with them the table
entries each lane reads, are the reference's.
"""

from __future__ import annotations

import torch

# secp256k1 base field, group order, endomorphism constants (public)
P = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEFFFFFC2F
N = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141
LAMBDA = 0x5363AD4CC05C30E0A5261C028812645A122E22EA20816678DF02967C1B23BD72
BETA = 0x7AE96A2B657C07106E64479EAC3434E99CF0497512F58995C1396C28719501EE

A1 = 0x3086D221A7D46BCDE86C90E49284EB15
B1 = -0xE4437ED6010E88286F547FA90ABFE4C3     # negative
A2 = 0x114CA50F7A8E2F3F657C1108D9D44CFD8
B2 = A1

SHIFT = 384
G1C = (B2 << SHIFT) // N + 1
G2C = ((-B1) << SHIFT) // N + 1
KMAX_BITS = 132                              # |k_i| < 2^132

_RADIX = 16
_MASK = (1 << _RADIX) - 1
NLIMB_OUT = (KMAX_BITS + _RADIX - 1) // _RADIX    # 9 limbs of 16 bits
_WIDE = 18                                   # 288 bits: k1, k2 signed


def psi_host(x: int, y: int) -> tuple[int, int]:
    """ψ(x, y) = (β·x, y) on host affine coordinates; ψ(P) = λ·P."""
    return x * BETA % P, y


def decompose_host(k: int) -> tuple[int, int]:
    """The decomposition over Python ints (the test oracle)."""
    c1 = (k * G1C) >> SHIFT
    c2 = (k * G2C) >> SHIFT
    k1 = k - c1 * A1 - c2 * A2
    k2 = -c1 * B1 - c2 * B2
    assert (k1 + k2 * LAMBDA) % N == k % N
    assert abs(k1) < 1 << KMAX_BITS and abs(k2) < 1 << KMAX_BITS
    return k1, k2


def _limbs(c: int) -> list[int]:
    out = []
    while c:
        out.append(c & _MASK)
        c >>= _RADIX
    return out


def _mul_const(a: torch.Tensor, c: int, n_out: int) -> torch.Tensor:
    """Columns of a·c (a: (L, B) limbs, any sign; c >= 0), truncated to
    n_out columns and not yet carried. A column sums at most 18 products
    below 2^32, so int64 holds it."""
    cols = torch.zeros((n_out,) + a.shape[1:], dtype=torch.int64,
                       device=a.device)
    for j, cj in enumerate(_limbs(c)):
        if cj and j < n_out:
            m = min(a.shape[0], n_out - j)
            cols[j:j + m] += a[:m] * cj
    return cols


def _ripple(v: torch.Tensor) -> torch.Tensor:
    """Exact carry with floor division: limbs 0..L-2 land in
    [0, 2^16), the top limb keeps the sign of the value."""
    v = v.clone()
    for i in range(v.shape[0] - 1):
        c = v[i] >> _RADIX
        v[i] -= c << _RADIX
        v[i + 1] += c
    return v


def _mulshift(kc: torch.Tensor, g: int) -> torch.Tensor:
    """(k·g) >> 384 exactly, for canonical k ((16, B) 16-bit limbs)."""
    n = kc.shape[0] + len(_limbs(g)) + 1
    prod = _ripple(_mul_const(kc, g, n))
    return prod[SHIFT // _RADIX:]


def _signed(v: torch.Tensor):
    """Signed columns -> (|value| as NLIMB_OUT limbs, value < 0)."""
    v = _ripple(v)
    neg = v[-1] < 0
    mag = torch.where(neg[None], _ripple(-v), v)
    return mag[:NLIMB_OUT], neg


def decompose(kc16: torch.Tensor):
    """Batched GLV split of canonical scalars k < n, given as (16, B)
    16-bit limbs. Returns (k1_mag, k1_neg, k2_mag, k2_neg): magnitudes
    (9, B) int64 16-bit limbs below 2^132, signs (B,) bool."""
    k = kc16.to(torch.int64)
    c1 = _mulshift(k, G1C)
    c2 = _mulshift(k, G2C)
    kw = torch.nn.functional.pad(k, (0, 0, 0, _WIDE - k.shape[0]))
    k1 = kw - _mul_const(c1, A1, _WIDE) - _mul_const(c2, A2, _WIDE)
    k2 = _mul_const(c1, -B1, _WIDE) - _mul_const(c2, B2, _WIDE)
    k1m, k1n = _signed(k1)
    k2m, k2n = _signed(k2)
    return k1m, k1n, k2m, k2n
