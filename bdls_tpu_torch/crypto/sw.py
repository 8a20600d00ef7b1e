"""The `sw` software provider — pure-Python ECDSA and Ed25519 (no OpenSSL).

The counterpart of ``bdls_tpu/crypto/sw.py``, rewritten without the
``cryptography`` package, which the machine that runs the port on the
card does not have. It serves three roles:

- the low-S policy (``LOW_S_CURVES``, ``is_low_s``, ``normalize_s``),
  copied unchanged: signatures are normalized to low-S when signed, and
  high-S signatures are rejected on the P-256 verify path
  (``bccsp/sw/ecdsa.go:27-57``);
- key generation from a seeded rng and deterministic-nonce signing, so a
  run on the card can make real signatures for its inputs;
- ``SwCSP.verify``, the provider's counted CPU fallback.

Ed25519 (curve ``"ed25519"``) is the reference's: the RFC 8032 host
oracle of :mod:`bdls_tpu_torch.ops.ed25519`, with the private seed kept
in an :class:`Ed25519KeyHandle`. Its signatures ride the same (r, s)
int pair as ECDSA: r is the RFC 8032 R encoding as a big-endian int
(it round-trips to the exact 32 bytes), s the scalar S; the request's
``digest`` field carries the whole message.

The arithmetic is textbook Jacobian double-and-add over Python ints with
Shamir's trick for ``u1·G + u2·Q``: slow (milliseconds a signature) and
not constant-time, which is fine for a fallback and for test inputs; it
is never on the kernel's path.
"""

from __future__ import annotations

import hashlib
import hmac
import os
from typing import Sequence

from bdls_tpu_torch.crypto.csp import CSP, PublicKey, VerifyRequest
from bdls_tpu_torch.ops import ed25519 as ed_ops
from bdls_tpu_torch.ops.curves import CURVES

_ORDERS = {name: cv.fn.modulus for name, cv in CURVES.items()}

# curves whose verify path enforces low-S (Fabric-side signatures);
# the consensus engine's secp256k1 path accepts both halves, matching
# Go's ecdsa.Verify used by the reference engine.
LOW_S_CURVES = frozenset({"P-256"})


def is_low_s(curve: str, s: int) -> bool:
    return s <= _ORDERS[curve] // 2


def normalize_s(curve: str, s: int) -> int:
    n = _ORDERS[curve]
    return n - s if s > n // 2 else s


# ------------------------------------------------------- integer curve math
# Jacobian (X, Y, Z) with affine (X/Z^2, Y/Z^3); None is infinity.

def _jdbl(cv, P):
    if P is None:
        return None
    p = cv.fp.modulus
    X, Y, Z = P
    if Y == 0:
        return None
    yy = Y * Y % p
    s = 4 * X * yy % p
    zz = Z * Z % p
    m = (3 * X * X + cv.a * zz * zz) % p
    x3 = (m * m - 2 * s) % p
    y3 = (m * (s - x3) - 8 * yy * yy) % p
    return (x3, y3, 2 * Y * Z % p)


def _jadd(cv, P, Q):
    if P is None:
        return Q
    if Q is None:
        return P
    p = cv.fp.modulus
    X1, Y1, Z1 = P
    X2, Y2, Z2 = Q
    z1z1 = Z1 * Z1 % p
    z2z2 = Z2 * Z2 % p
    u1 = X1 * z2z2 % p
    u2 = X2 * z1z1 % p
    s1 = Y1 * Z2 * z2z2 % p
    s2 = Y2 * Z1 * z1z1 % p
    if u1 == u2:
        return _jdbl(cv, P) if s1 == s2 else None
    h = (u2 - u1) % p
    hh = h * h % p
    hhh = h * hh % p
    r = (s2 - s1) % p
    v = u1 * hh % p
    x3 = (r * r - hhh - 2 * v) % p
    y3 = (r * (v - x3) - s1 * hhh) % p
    return (x3, y3, Z1 * Z2 * h % p)


def _affine(cv, P):
    if P is None:
        return None
    p = cv.fp.modulus
    zi = pow(P[2], -1, p)
    zi2 = zi * zi % p
    return (P[0] * zi2 % p, P[1] * zi2 * zi % p)


def _mul_add(cv, k1: int, P1, k2: int = 0, P2=None):
    """k1·P1 + k2·P2 (affine inputs, affine or None out), Shamir's trick."""
    J1 = None if P1 is None else (P1[0], P1[1], 1)
    J2 = None if P2 is None else (P2[0], P2[1], 1)
    J12 = _jadd(cv, J1, J2)
    acc = None
    for i in range(max(k1.bit_length(), k2.bit_length()) - 1, -1, -1):
        acc = _jdbl(cv, acc)
        b1, b2 = (k1 >> i) & 1, (k2 >> i) & 1
        if b1 and b2:
            acc = _jadd(cv, acc, J12)
        elif b1:
            acc = _jadd(cv, acc, J1)
        elif b2:
            acc = _jadd(cv, acc, J2)
    return _affine(cv, acc)


def on_curve(curve: str, x: int, y: int) -> bool:
    cv = CURVES[curve]
    p = cv.fp.modulus
    return (0 <= x < p and 0 <= y < p and (x, y) != (0, 0)
            and (y * y - x * x * x - cv.a * x - cv.b) % p == 0)


def ecdsa_verify(curve: str, x: int, y: int, digest: bytes, r: int,
                 s: int) -> bool:
    """Plain ECDSA verify (no low-S policy): the digest's 32 bytes are
    the 256-bit integer e, as OpenSSL takes a SHA-256 prehash."""
    cv = CURVES[curve]
    n = cv.fn.modulus
    if len(digest) != 32 or not (0 < r < n and 0 < s < n):
        return False
    if not on_curve(curve, x, y):
        return False
    e = int.from_bytes(digest, "big")
    w = pow(s, -1, n)
    R = _mul_add(cv, e * w % n, (cv.gx, cv.gy), r * w % n, (x, y))
    return R is not None and R[0] % n == r


# --------------------------------------------------------------- provider

class KeyHandle:
    """Private-key handle kept inside the provider (the reference never
    exports private scalars either — file keystore, bccsp/sw/fileks.go)."""

    def __init__(self, curve: str, d: int):
        cv = CURVES[curve]
        if not 0 < d < cv.fn.modulus:
            raise ValueError("private scalar out of range")
        self.curve = curve
        self._d = d
        self._pub = _mul_add(cv, d, (cv.gx, cv.gy))

    def public_key(self) -> PublicKey:
        return PublicKey(self.curve, *self._pub)


class Ed25519KeyHandle:
    """Ed25519 seed held inside the provider (signs RFC 8032 style)."""

    def __init__(self, seed: bytes):
        self._seed = seed
        self.curve = "ed25519"
        self._pub = ed_ops.public_point(seed)

    def public_key(self) -> PublicKey:
        return PublicKey("ed25519", *self._pub)


def _nonce(d: int, digest: bytes, n: int):
    """Deterministic nonces: HMAC-SHA256 keyed by the private scalar over
    the digest and a counter (RFC 6979 in spirit; any unpredictable
    k < n gives a valid signature)."""
    key = d.to_bytes(32, "big")
    ctr = 0
    while True:
        k = int.from_bytes(hmac.new(
            key, digest + ctr.to_bytes(4, "big"), hashlib.sha256).digest(),
            "big") % n
        if k:
            yield k
        ctr += 1


class SwCSP(CSP):
    def key_gen(self, curve: str, rng=None):
        """A fresh key. ``rng`` (a ``numpy.random.Generator``) makes it
        reproducible; without one the scalar (or Ed25519 seed) comes
        from ``os.urandom``."""
        if curve == "ed25519":
            return Ed25519KeyHandle(
                rng.bytes(32) if rng is not None else os.urandom(32))
        n = _ORDERS[curve]
        raw = rng.bytes(40) if rng is not None else os.urandom(40)
        return KeyHandle(curve, int.from_bytes(raw, "big") % (n - 1) + 1)

    def key_from_scalar(self, curve: str, d: int):
        if curve == "ed25519":
            # deterministic fixture keys: the scalar is the RFC seed
            return Ed25519KeyHandle(d.to_bytes(32, "little"))
        return KeyHandle(curve, d)

    def key_import(self, curve: str, x: int, y: int) -> PublicKey:
        if curve == "ed25519":
            if not (0 <= x < ed_ops.P and 0 <= y < ed_ops.P
                    and ed_ops.on_curve(x, y)):
                raise ValueError("point not on edwards25519")
            return PublicKey(curve, x, y)
        if not on_curve(curve, x, y):
            raise ValueError(f"point not on {curve}")
        return PublicKey(curve, x, y)

    def hash(self, data: bytes, algo: str = "sha256") -> bytes:
        return hashlib.new(algo, data).digest()

    def sign(self, key_handle, digest: bytes) -> tuple[int, int]:
        if isinstance(key_handle, Ed25519KeyHandle):
            sig = ed_ops.sign(key_handle._seed, digest)
            return (int.from_bytes(sig[:32], "big"),
                    int.from_bytes(sig[32:], "little"))
        cv = CURVES[key_handle.curve]
        n = cv.fn.modulus
        if len(digest) != 32:
            raise ValueError("sign takes a 32-byte digest")
        e = int.from_bytes(digest, "big")
        d = key_handle._d
        for k in _nonce(d, digest, n):
            r = _mul_add(cv, k, (cv.gx, cv.gy))[0] % n
            if r == 0:
                continue
            s = pow(k, -1, n) * (e + r * d) % n
            if s:
                return r, normalize_s(key_handle.curve, s)
        raise AssertionError("unreachable")

    def verify(self, req: VerifyRequest) -> bool:
        curve = req.key.curve
        if curve == "ed25519":
            if not 0 <= req.r < (1 << 256):
                return False
            return ed_ops.verify_affine(
                req.key.x, req.key.y, req.r.to_bytes(32, "big"), req.s,
                req.digest)
        if curve in LOW_S_CURVES and not is_low_s(curve, req.s):
            return False
        return ecdsa_verify(curve, req.key.x, req.key.y, req.digest,
                            req.r, req.s)

    def verify_batch(self, reqs: Sequence[VerifyRequest]) -> list[bool]:
        # an endorsement storm or gossip fan-in repeats the same few
        # envelopes hundreds of times per batch — verify each distinct
        # (key, sig, digest) lane once and fan its verdict out
        memo: dict[tuple, bool] = {}
        out = []
        for r in reqs:
            k = (r.key.curve, r.key.x, r.key.y, r.r, r.s, r.digest)
            v = memo.get(k)
            if v is None:
                v = memo[k] = self.verify(r)
            out.append(v)
        return out
