"""Crypto service provider (CSP) interface — the plugin boundary.

The port's own copy of ``bdls_tpu/crypto/csp.py``.

Re-states the reference's BCCSP SPI (``bccsp/bccsp.go:90-134``): KeyGen,
KeyImport, Hash, Sign, **Verify** — plus the one TPU-first addition,
``verify_batch``, which is the whole point: every call site above this
boundary (MSP identities, policy evaluation, consensus proof checks,
committer validation) stays unchanged when the provider is swapped,
exactly the property the reference guarantees via ``msp/identities.go:190``.
"""

from __future__ import annotations

import abc
import functools
import hashlib
from dataclasses import dataclass
from typing import Optional, Sequence

# The vote-class lane bound, shared by the two tiers that must agree on
# it: batches at/below this many lanes are "vote-shaped" — the TpuCSP
# dispatcher serves them from its latency tier
# (``tpu_provider.DEFAULT_LATENCY_MAX_LANES``) and the verifyd
# coalescer routes them to its vote lane
# (``coalescer.DEFAULT_VOTE_LANE_MAX``). Hoisted here (the one module
# both sides already depend on) so the defaults cannot drift apart.
DEFAULT_VOTE_CLASS_MAX_LANES = 256


@dataclass(frozen=True)
class PublicKey:
    """An ECDSA public key: curve name + affine coordinates."""

    curve: str  # "P-256" | "secp256k1"
    x: int
    y: int

    def ski(self) -> bytes:
        """Subject key identifier (sha256 of the uncompressed point),
        like the reference's SKI (bccsp/sw/keys.go)."""
        return _ski(self.x, self.y)


@functools.lru_cache(maxsize=4096)
def _ski(x: int, y: int) -> bytes:
    """sha256(0x04 || x || y), kept for the last 4096 points: a batch
    names few keys many times (a block's endorsers, a round's
    consenters), each request with a ``PublicKey`` of its own."""
    raw = b"\x04" + x.to_bytes(32, "big") + y.to_bytes(32, "big")
    return hashlib.sha256(raw).digest()


@dataclass(frozen=True)
class VerifyRequest:
    """One signature-verification work item."""

    key: PublicKey
    digest: bytes  # 32 bytes
    r: int
    s: int

    def ski(self) -> bytes:
        """The key's subject key identifier (``PublicKey.ski``)."""
        return self.key.ski()


class WireVerifyRequest:
    """A verify work item backed by its fixed-width wire encoding.

    Wire-facing call sites (the consensus verifier, the ``verifyd``
    sidecar ingress, ``RemoteCSP``) already hold every field as a
    32-byte big-endian string; carrying those bytes (instead of eagerly
    converting to Python ints) lets the provider's marshal stage pack a
    whole batch through one ``np.frombuffer``
    (:func:`bdls_tpu_torch.crypto.marshal.marshal_requests` fast path) with
    zero re-copy and zero big-int work. The int views (``key``, ``r``,
    ``s``) are computed lazily — only the CPU fallback, the low-S
    policy screen, and the pinned-key cache ever need them.

    Construct via :func:`bdls_tpu_torch.crypto.marshal.from_wire_fields`,
    which applies the one shared wire screen (oversized field =
    invalid lane) so call sites cannot drift.
    """

    __slots__ = ("curve", "_qx", "_qy", "_r", "_s", "_e",
                 "_key", "_ri", "_si")

    def __init__(self, curve: str, qx: bytes, qy: bytes, r: bytes,
                 s: bytes, digest32: bytes):
        if not all(len(b) == 32 for b in (qx, qy, r, s, digest32)):
            raise ValueError("WireVerifyRequest fields must be 32 bytes")
        self.curve = curve
        self._qx, self._qy, self._r, self._s = qx, qy, r, s
        self._e = digest32
        self._key: Optional[PublicKey] = None
        self._ri: Optional[int] = None
        self._si: Optional[int] = None

    def wire32(self) -> tuple[bytes, bytes, bytes, bytes, bytes]:
        """The five fixed-width columns ``(qx, qy, r, s, e)`` the limb
        packer takes."""
        return self._qx, self._qy, self._r, self._s, self._e

    def ski(self) -> bytes:
        """Subject key identifier straight from the wire bytes (same
        value as ``PublicKey.ski()``, no int round-trip)."""
        return hashlib.sha256(b"\x04" + self._qx + self._qy).digest()

    @property
    def key(self) -> PublicKey:
        if self._key is None:
            self._key = PublicKey(
                self.curve,
                int.from_bytes(self._qx, "big"),
                int.from_bytes(self._qy, "big"),
            )
        return self._key

    @property
    def digest(self) -> bytes:
        return self._e

    @property
    def r(self) -> int:
        if self._ri is None:
            self._ri = int.from_bytes(self._r, "big")
        return self._ri

    @property
    def s(self) -> int:
        if self._si is None:
            self._si = int.from_bytes(self._s, "big")
        return self._si


class CSP(abc.ABC):
    """The provider SPI. Signing/hash always stay host-side; Verify may be
    offloaded (the reference's pkcs11 provider is the architectural
    precedent for out-of-process verify — bccsp/pkcs11/pkcs11.go:283)."""

    @abc.abstractmethod
    def key_gen(self, curve: str): ...

    @abc.abstractmethod
    def key_import(self, curve: str, x: int, y: int) -> PublicKey: ...

    @abc.abstractmethod
    def hash(self, data: bytes, algo: str = "sha256") -> bytes: ...

    @abc.abstractmethod
    def sign(self, key_handle, digest: bytes) -> tuple[int, int]: ...

    @abc.abstractmethod
    def verify(self, req: VerifyRequest) -> bool: ...

    @abc.abstractmethod
    def verify_batch(self, reqs: Sequence[VerifyRequest]) -> list[bool]: ...

    def verify_block(self, req):
        """Whole-block endorsement verification: hash every lane's raw
        message, verify the signatures, and evaluate the per-tx N-of-M
        policies, returning per-tx int32 flags (``blocklane.TXFLAG_*``)
        instead of per-lane bits.

        The default rides this provider's own ``verify_batch`` through
        the host reference path (hash via ``hashlib``, Python policy
        tally); ``TorchCSP`` overrides it with the fused
        hash→verify→policy kernel. Non-abstract so every provider has
        the capability."""
        from bdls_tpu_torch.crypto import blocklane

        return blocklane.verify_block_host(self.verify_batch, req)
