"""Length-framed digests — the one place the framing discipline lives.

Every security-critical digest in the framework (endorsement digests,
cluster auth transcripts, member certs, signed seeks) hashes a sequence
of variable-length components. Concatenating them unframed lets bytes
shift across component boundaries without changing the digest — a
forgery that works against an unframed ``endorsement_digest``. This
helper makes the framed form the default: each part is preceded by its
4-byte little-endian length.

The port's copy of ``bdls_tpu/crypto/framing.py``.
"""

from __future__ import annotations

import hashlib
from typing import Iterable


def framed_preimage(prefix: bytes, parts: Iterable[bytes]) -> bytes:
    """The exact byte string :func:`framed_digest` hashes:
    ``prefix ‖ (len(p) ‖ p for p in parts)``. Exposed for pipelines
    that hash *in-kernel* (the fused block-verify program ships raw
    framed messages to the device SHA-256 stage) — by construction
    ``sha256(framed_preimage(...)) == framed_digest(...)``."""
    out = bytearray(prefix)
    for part in parts:
        out += len(part).to_bytes(4, "little")
        out += part
    return bytes(out)


def framed_digest(prefix: bytes, parts: Iterable[bytes],
                  algo: str = "sha256") -> bytes:
    """Hash ``prefix ‖ (len(p) ‖ p for p in parts)`` with 32-byte output."""
    if algo == "sha256":
        h = hashlib.sha256()
    elif algo == "blake2b":
        h = hashlib.blake2b(digest_size=32)
    else:
        raise ValueError(f"unsupported digest algo {algo!r}")
    h.update(prefix)
    for part in parts:
        h.update(len(part).to_bytes(4, "little"))
        h.update(part)
    return h.digest()
