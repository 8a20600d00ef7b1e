"""Fixed-width limb representation and per-modulus Montgomery context.

The port's own copy of ``bdls_tpu/ops/fields.py`` (numpy only).

TPUs have no 64-bit integer datapath and no widening 32x32 multiply, so all
big-int arithmetic here uses 16-bit limbs held in ``uint32``: a 16x16-bit
product fits exactly in 32 bits, and column accumulations stay far below
2^32 (bounded in :mod:`bdls_tpu.ops.mont`).

A 256-bit integer x is ``x = sum_i limb[i] << (16*i)`` (little-endian).
Batched device arrays are limbs-first ``(NLIMBS, B)`` so that the batch
dimension lands on TPU lanes.

Reference parity: this is the TPU-native replacement for the reference's
big-int layers — Go stdlib ``crypto/elliptic`` P-256 (used by
``bccsp/sw/ecdsa.go:41-57``) and the vendored pure-Go secp256k1
(``vendor/github.com/BDLS-bft/bdls/crypto/btcec``).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Sequence

import numpy as np

LIMB_BITS = 16
NLIMBS = 16  # 256 bits
LIMB_MASK = (1 << LIMB_BITS) - 1


def int_to_limbs(x: int, n: int = NLIMBS) -> np.ndarray:
    """Python int -> little-endian uint32 limb vector of length ``n``."""
    if x < 0 or x >= 1 << (LIMB_BITS * n):
        raise ValueError(f"integer out of range for {n} limbs")
    out = np.empty(n, dtype=np.uint32)
    for i in range(n):
        out[i] = x & LIMB_MASK
        x >>= LIMB_BITS
    return out


def limbs_to_int(limbs: Sequence[int]) -> int:
    """Little-endian limb vector -> Python int."""
    x = 0
    for i, v in enumerate(limbs):
        x += int(v) << (LIMB_BITS * i)
    return x


def ints_to_limb_array(xs: Sequence[int], n: int = NLIMBS) -> np.ndarray:
    """Batch of ints -> limbs-first ``(n, B)`` uint32 array (vectorized)."""
    buf = b"".join(x.to_bytes(LIMB_BITS * n // 8, "little") for x in xs)
    raw = np.frombuffer(buf, dtype="<u2").reshape(len(xs), n)
    return np.ascontiguousarray(raw.T).astype(np.uint32)


def limb_array_to_ints(a: np.ndarray) -> list[int]:
    """Limbs-first ``(n, B)`` array -> list of Python ints."""
    a = np.asarray(a)
    le16 = a.T.astype("<u2")  # (B, n) uint16 little-endian
    return [int.from_bytes(row.tobytes(), "little") for row in le16]


class FieldCtx(NamedTuple):
    """Static Montgomery context for a fixed odd modulus m < 2^256.

    All members are host numpy constants; they embed into XLA programs as
    literals. R = 2^256.
    """

    modulus: int            # python int, for host-side checks
    m_limbs: np.ndarray     # (NLIMBS,) uint32
    n0: np.uint32           # -m^-1 mod 2^16
    r2_limbs: np.ndarray    # R^2 mod m, for to_mont
    one_mont: np.ndarray    # R mod m  (Montgomery form of 1)
    inv_exp_bits: np.ndarray  # (256,) uint32 bits of m-2, MSB first (Fermat inverse)


@functools.lru_cache(maxsize=None)
def field_ctx(modulus: int) -> FieldCtx:
    if modulus % 2 == 0 or modulus >= 1 << 256 or modulus < 3:
        raise ValueError("modulus must be odd and < 2^256")
    r = 1 << (LIMB_BITS * NLIMBS)
    n0 = (-pow(modulus, -1, 1 << LIMB_BITS)) % (1 << LIMB_BITS)
    exp = modulus - 2
    bits = np.array([(exp >> (255 - i)) & 1 for i in range(256)], dtype=np.uint32)
    return FieldCtx(
        modulus=modulus,
        m_limbs=int_to_limbs(modulus),
        n0=np.uint32(n0),
        r2_limbs=int_to_limbs(r * r % modulus),
        one_mont=int_to_limbs(r % modulus),
        inv_exp_bits=bits,
    )
