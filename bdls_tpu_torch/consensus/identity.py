"""Consensus identities, the signing digest and a signed envelope.

The port's own copy of what the batch-verify seam needs from
``bdls_tpu/consensus/identity.py`` (``:29-44``), with hashlib only:

- identity = 64 bytes, big-endian X‖Y of the secp256k1 public key
  (``vendor/.../bdls/message.go:73-93``);
- signing digest = blake2b-256 over ``"BDLS_CONSENSUS_SIGNATURE" ‖
  version (le32) ‖ X ‖ Y ‖ len(payload) (le32) ‖ payload``
  (``message.go:97-138``);
- :class:`SignedEnvelope`, a plain dataclass with the six fields of the
  wire message ``wire.proto:SignedEnvelope``, which is all the verifier
  reads (the machine that runs the port has no protobuf);
- :func:`sign_payload`, signing with the port's pure-Python ``sw``
  provider, for tests and ``chip_smoke.py``.
"""

from __future__ import annotations

import hashlib
import struct
from dataclasses import dataclass

from bdls_tpu_torch.crypto.sw import KeyHandle, SwCSP

PROTOCOL_VERSION = 1
SIGNATURE_PREFIX = b"BDLS_CONSENSUS_SIGNATURE"
AXIS = 32


def envelope_digest(version: int, pub_x: bytes, pub_y: bytes,
                    payload: bytes) -> bytes:
    h = hashlib.blake2b(digest_size=32)
    h.update(SIGNATURE_PREFIX)
    h.update(struct.pack("<I", version))
    h.update(pub_x)
    h.update(pub_y)
    h.update(struct.pack("<I", len(payload)))
    h.update(payload)
    return h.digest()


def identity_of(pub_x: bytes, pub_y: bytes) -> bytes:
    return pub_x + pub_y


@dataclass
class SignedEnvelope:
    """The wire message's fields: ``payload`` is the serialized consensus
    message, kept verbatim for the re-hash; the others are big-endian
    byte strings (32 bytes when well formed)."""

    version: int = PROTOCOL_VERSION
    payload: bytes = b""
    pub_x: bytes = b""
    pub_y: bytes = b""
    sig_r: bytes = b""
    sig_s: bytes = b""


def identity_of_key(key: KeyHandle) -> bytes:
    pub = key.public_key()
    return identity_of(pub.x.to_bytes(AXIS, "big"),
                       pub.y.to_bytes(AXIS, "big"))


def sign_payload(key: KeyHandle, payload: bytes) -> SignedEnvelope:
    """A secp256k1 envelope signed by ``key`` (a ``sw`` key handle)."""
    if key.curve != "secp256k1":
        raise ValueError("consensus identities are secp256k1 keys")
    pub = key.public_key()
    x, y = pub.x.to_bytes(AXIS, "big"), pub.y.to_bytes(AXIS, "big")
    r, s = SwCSP().sign(key, envelope_digest(PROTOCOL_VERSION, x, y, payload))
    return SignedEnvelope(PROTOCOL_VERSION, payload, x, y,
                          r.to_bytes(AXIS, "big"), s.to_bytes(AXIS, "big"))
