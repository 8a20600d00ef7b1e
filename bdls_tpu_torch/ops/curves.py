"""Curve constants for the verify paths: P-256, secp256k1 and Ed25519.

The port's own copy of ``bdls_tpu/ops/curves.py`` (numpy only).

- NIST P-256: every Fabric-side signature (MSP identities, endorsements,
  block signatures) — reference ``bccsp/sw/ecdsa.go``.
- secp256k1: every BDLS consensus message — reference
  ``vendor/github.com/BDLS-bft/bdls/message.go:170-184``.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np

from bdls_tpu_torch.ops.fields import FieldCtx, field_ctx, int_to_limbs


class Curve(NamedTuple):
    name: str
    fp: FieldCtx          # base field context (mod p)
    fn: FieldCtx          # scalar field context (mod n, the group order)
    a: int
    b: int
    gx: int
    gy: int
    a_kind: str           # 'zero' | 'minus3' | 'generic' (static kernel specialization)
    a_mont: np.ndarray    # (NLIMBS,) a*R mod p
    b_mont: np.ndarray
    gx_mont: np.ndarray
    gy_mont: np.ndarray


def _mont(x: int, p: int) -> np.ndarray:
    return int_to_limbs(x * (1 << 256) % p)


@functools.lru_cache(maxsize=None)
def _make_curve(name: str, p: int, n: int, a: int, b: int, gx: int, gy: int) -> Curve:
    if a % p == 0:
        kind = "zero"
    elif (a - (p - 3)) % p == 0:
        kind = "minus3"
    else:
        kind = "generic"
    return Curve(
        name=name, fp=field_ctx(p), fn=field_ctx(n), a=a % p, b=b % p,
        gx=gx, gy=gy, a_kind=kind,
        a_mont=_mont(a % p, p), b_mont=_mont(b % p, p),
        gx_mont=_mont(gx, p), gy_mont=_mont(gy, p),
    )


P256 = _make_curve(
    "P-256",
    p=0xFFFFFFFF00000001000000000000000000000000FFFFFFFFFFFFFFFFFFFFFFFF,
    n=0xFFFFFFFF00000000FFFFFFFFFFFFFFFFBCE6FAADA7179E84F3B9CAC2FC632551,
    a=0xFFFFFFFF00000001000000000000000000000000FFFFFFFFFFFFFFFFFFFFFFFC,
    b=0x5AC635D8AA3A93E7B3EBBD55769886BC651D06B0CC53B0F63BCE3C3E27D2604B,
    gx=0x6B17D1F2E12C4247F8BCE6E563A440F277037D812DEB33A0F4A13945D898C296,
    gy=0x4FE342E2FE1A7F9B8EE7EB4A7C0F9E162BCE33576B315ECECBB6406837BF51F5,
)

SECP256K1 = _make_curve(
    "secp256k1",
    p=0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEFFFFFC2F,
    n=0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141,
    a=0,
    b=7,
    gx=0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798,
    gy=0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8,
)

CURVES = {"P-256": P256, "secp256k1": SECP256K1}


class EdwardsCurve(NamedTuple):
    """Twisted Edwards curve -x^2 + y^2 = 1 + d x^2 y^2 (a = -1).

    The unified extended-coordinate addition is complete here because
    a = -1 is a square mod p (p ≡ 1 mod 4) while d is a non-square: no
    exceptional cases and no selects in the ladder
    (:mod:`bdls_tpu_torch.ops.ed25519`).
    """

    name: str
    fp: FieldCtx          # base field context (mod 2^255-19)
    order: int            # L, the prime subgroup order; scalar
                          # reduction mod L stays on the host
    cofactor: int
    d: int
    gx: int
    gy: int
    order_limbs: np.ndarray   # (16,) uint32 16-bit limbs of L (S < L check)


@functools.lru_cache(maxsize=None)
def _make_edwards(name: str, p: int, order: int, cofactor: int, d: int,
                  gx: int, gy: int) -> EdwardsCurve:
    return EdwardsCurve(
        name=name, fp=field_ctx(p), order=order, cofactor=cofactor,
        d=d % p, gx=gx, gy=gy, order_limbs=int_to_limbs(order))


# RFC 8032 §5.1 constants: d = -121665/121666 mod p, B = (gx, gy) the
# standard base point of order L.
ED25519 = _make_edwards(
    "ed25519",
    p=(1 << 255) - 19,
    order=(1 << 252) + 27742317777372353535851937790883648493,
    cofactor=8,
    d=0x52036CEE2B6FFE738CC740797779E89800700A4D4141D8AB75EB4DCA135978A3,
    gx=0x216936D3CD6E53FEC0A4E231FDD6DC5C692CC7609525A7B2C9562D608F25D51A,
    gy=0x6666666666666666666666666666666666666666666666666666666666666658,
)

EDWARDS_CURVES = {"ed25519": ED25519}
