"""Vectorized host-side marshaling: VerifyRequests -> limb arrays.

The port's own copy of ``bdls_tpu/crypto/marshal.py``: the five limb
columns of the two ECDSA curves and the six of Ed25519
(:func:`marshal_ed25519`).

The pre-pipelined provider built five Python lists of big ints per
batch and converted them limb-by-limb (`ints_to_limb_array` over
`int.to_bytes` per value) — O(batch) Python big-int work on the flush
thread, which at 2048-lane buckets dominated host prep. Here the whole
batch is packed through numpy:

- every field value is rendered once as a fixed 32-byte big-endian
  string (digests already *are* 32-byte strings and skip even that);
- one ``b"".join`` + ``np.frombuffer`` reinterprets the concatenated
  buffer as ``(B, 16)`` big-endian 16-bit words;
- a reversed view + transpose lands the limbs-first ``(NLIMBS, B)``
  uint32 layout the kernels take (:mod:`bdls_tpu_torch.ops.fields`).

Padding to a bucket size replicates lane 0 (same policy as the old
per-list ``col.extend([col[0]] * pad)``) as one numpy broadcast.

Wire-facing callers (``consensus/verifier.py``) hold the 32-byte
big-endian encodings already — :func:`bytes32_to_limbs` packs those
with zero Python big-int operations.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from bdls_tpu_torch.ops.fields import NLIMBS

_WIDTH = 32  # bytes per 256-bit value

# packed into lanes that are screened invalid: a harmless in-range value
# (the lane's verdict is forced False regardless of kernel output)
FILLER32 = (b"\0" * 31) + b"\x01"


def bytes32_to_limbs(chunks: Sequence[bytes]) -> np.ndarray:
    """Fixed 32-byte big-endian strings -> limbs-first ``(16, B)`` uint32.

    Every chunk must be exactly 32 bytes (callers pad/screen wire input
    first — oversized fields are invalid lanes, undersized are
    left-zero-padded by the caller via ``rjust``).
    """
    buf = b"".join(chunks)
    if len(buf) != _WIDTH * len(chunks):
        raise ValueError("bytes32_to_limbs requires exactly 32-byte chunks")
    # big-endian 16-bit words, most significant first; limb order is
    # little-endian, so reverse the word axis before going limbs-first
    words = np.frombuffer(buf, dtype=">u2").reshape(len(chunks), NLIMBS)
    return np.ascontiguousarray(words[:, ::-1].T).astype(np.uint32)


def ints_to_limbs(vals: Sequence[int]) -> np.ndarray:
    """Python ints < 2^256 -> limbs-first ``(16, B)`` uint32.

    One ``to_bytes`` per value (C-level, no Python limb loops), then a
    single bulk reinterpretation — the numpy path of the old
    ``ints_to_limb_array`` with the big-endian encoding the rest of the
    host stack (wire fields, digests) already uses.
    """
    return bytes32_to_limbs([v.to_bytes(_WIDTH, "big") for v in vals])


def from_wire_fields(curve: str, qx: bytes, qy: bytes, sig_r: bytes,
                     sig_s: bytes, digest: bytes):
    """THE wire -> (pub, digest, r, s) extraction: one screened lane.

    Every wire-facing verify path — :class:`TpuBatchVerifier` and
    :class:`CspBatchVerifier` (consensus/verifier.py), the ``verifyd``
    sidecar ingress, and the ``RemoteCSP`` client — goes through this
    helper, so the adversarial-input screen cannot drift between the
    in-process and remote paths. Rules:

    - any field longer than 32 bytes overflows the 256-bit limb
      encoding: the lane is invalid (returns ``None``; callers force
      the verdict False without touching a kernel);
    - shorter fields left-zero-extend (big-endian), digests use their
      low 32 bytes exactly like the dispatcher's >=2^256 digest screen.

    Returns a byte-backed
    :class:`~bdls_tpu_torch.crypto.csp.WireVerifyRequest` (zero big-int work
    here or in the limb packer), or ``None`` for an invalid lane.
    """
    from bdls_tpu_torch.crypto.csp import WireVerifyRequest

    fields = (qx, qy, sig_r, sig_s)
    if any(len(f) > _WIDTH for f in fields):
        return None
    if len(digest) > _WIDTH and any(digest[:-_WIDTH]):
        # digest integer >= 2^256: never a valid 256-bit e
        return None
    return WireVerifyRequest(
        curve,
        *(f.rjust(_WIDTH, b"\0") for f in fields),
        digest[-_WIDTH:].rjust(_WIDTH, b"\0"),
    )


def pack_wire_requests(reqs: Sequence, size: int) -> tuple[np.ndarray, ...]:
    """Screened wire lanes -> the five padded ``(16, size)`` limb
    arrays. ``None`` entries (lanes :func:`from_wire_fields` rejected)
    pack :data:`FILLER32` — callers force those verdicts False."""
    cols: tuple[list, ...] = ([], [], [], [], [])
    for req in reqs:
        w = (FILLER32,) * 5 if req is None else req.wire32()
        for col, val in zip(cols, w):
            col.append(val)
    return pad_lanes(tuple(bytes32_to_limbs(c) for c in cols), size)


def marshal_ed25519(reqs: Sequence) -> tuple[np.ndarray, ...]:
    """Ed25519 batch -> the SIX ``(16, B)`` limb arrays
    ``(ax, ay, rx, ry, s, k)`` the Edwards kernel takes.

    EdDSA's challenge scalar depends on SHA-512 of the message, so the
    expansion from the 5-column wire lane (qx/qy = affine A, sig_r =
    the RFC 8032 R encoding carried verbatim, sig_s = S, digest = M)
    to the kernel's 6 columns is host work: decompress R and hash the
    challenge per lane, then bulk-pack like every other curve.
    Undecodable lanes become all-zero coords, which the kernel's
    on-curve check rejects."""
    from bdls_tpu_torch.ops import ed25519 as ed_ops

    rows = []
    for r in reqs:
        if r is None:
            rows.append((0, 0, 0, 0, 0, 0))
        elif hasattr(r, "wire32"):
            qx, qy, rr, ss, e = r.wire32()
            rows.append(ed_ops.ed25519_lane(
                int.from_bytes(qx, "big"), int.from_bytes(qy, "big"),
                rr, int.from_bytes(ss, "big"), e))
        else:
            rows.append(ed_ops.ed25519_lane(
                r.key.x, r.key.y, r.r.to_bytes(_WIDTH, "big"), r.s,
                r.digest))
    return tuple(ed_ops.lanes_to_limbs(rows))


def _req_curve(req) -> str:
    return req.curve if hasattr(req, "curve") else req.key.curve


def marshal_requests(reqs: Sequence) -> tuple[np.ndarray, ...]:
    """A batch of :class:`~bdls_tpu_torch.crypto.csp.VerifyRequest` -> the five
    ``(16, B)`` limb arrays ``(qx, qy, r, s, e)`` the verify kernels
    take (six for ed25519 — :func:`marshal_ed25519`; batches are
    single-curve by the time they reach a marshal). Digests pass
    through without any int conversion at all.

    Wire-backed requests (:class:`~bdls_tpu_torch.crypto.csp.WireVerifyRequest`,
    the sidecar/verifier ingress path) skip even the ``to_bytes``
    rendering: their 32-byte encodings feed ``frombuffer`` directly."""
    if reqs and _req_curve(reqs[0]) == "ed25519":
        return marshal_ed25519(reqs)
    if reqs and all(hasattr(r, "wire32") for r in reqs):
        cols = list(zip(*(r.wire32() for r in reqs)))
        return tuple(bytes32_to_limbs(list(c)) for c in cols)
    qx = ints_to_limbs([r.key.x for r in reqs])
    qy = ints_to_limbs([r.key.y for r in reqs])
    rr = ints_to_limbs([r.r for r in reqs])
    ss = ints_to_limbs([r.s for r in reqs])
    # digest as a 256-bit integer: short digests left-zero-extend, and a
    # longer one only reaches here with all-zero leading bytes (the
    # dispatcher screens digests whose integer value is >= 2^256)
    ee = bytes32_to_limbs([r.digest[-_WIDTH:].rjust(_WIDTH, b"\0")
                           for r in reqs])
    return qx, qy, rr, ss, ee


def pad_lanes(arrs: Sequence[np.ndarray], size: int) -> tuple[np.ndarray, ...]:
    """Pad each ``(16, n)`` array to ``(16, size)`` lanes by replicating
    lane 0 (keeps padded lanes validly-shaped work, like the old list
    ``extend``). No copy when already at size."""
    out = []
    for a in arrs:
        n = a.shape[1]
        if n == size:
            out.append(a)
            continue
        pad = np.broadcast_to(a[:, :1], (a.shape[0], size - n))
        out.append(np.concatenate([a, pad], axis=1))
    return tuple(out)
