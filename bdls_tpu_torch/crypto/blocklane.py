"""Block-lane request types and the host reference path.

The port's own copy of ``bdls_tpu/crypto/blocklane.py``. One
:class:`BlockVerifyRequest` carries a whole block's endorsement lanes as
raw wire bytes (unhashed messages, 32-byte big-endian key and signature
fields) plus per-tx N-of-M policy descriptors over a small org universe:
the unit of work the fused block program
(:mod:`bdls_tpu_torch.ops.block_verify`) takes in one launch.

:func:`verify_block_host` is the reference semantics that program is
held against: hash on the host (``hashlib``), one ``verify_batch`` call,
a Python policy tally. It is also the lane-at-a-time path and the
answer for a request beyond the largest bucket.

Flags: the block lane decides only the endorsement-signature half of
validation, so its verdicts are ``TXFLAG_VALID`` and
``TXFLAG_POLICY_FAILURE``, numerically equal to the committer's
``TxFlag.VALID`` and ``ENDORSEMENT_POLICY_FAILURE``.

Every function reads a request, lane and policy by attribute only, so
the reference package's request types work here unchanged.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np

from bdls_tpu_torch.crypto.csp import PublicKey, VerifyRequest

_WIDTH = 32

TXFLAG_VALID = 0
TXFLAG_POLICY_FAILURE = 2


@dataclass(frozen=True)
class BlockLane:
    """One endorsement signature lane: the raw signed message plus the
    wire-encoded key/signature fields and its (tx row, org index)
    coordinates in the request's bitmap."""

    msg: bytes
    qx: bytes
    qy: bytes
    r: bytes
    s: bytes
    tx: int
    org: int


@dataclass(frozen=True)
class BlockPolicy:
    """N-of-M policy for one tx row: ``required`` distinct orgs out of
    ``orgs`` (indices into the request's org universe; empty = every
    org counts) must contribute a valid endorsement."""

    required: int = 1
    orgs: tuple = ()


@dataclass
class BlockVerifyRequest:
    """A whole block's endorsement lanes + per-tx policies. ``norgs``
    is the org-universe size O of the bitmap (lane ``org`` and policy
    ``orgs`` index into it)."""

    curve: str
    lanes: list = field(default_factory=list)
    policies: list = field(default_factory=list)
    norgs: int = 1

    @property
    def ntx(self) -> int:
        return len(self.policies)


def lane_screened(lane: BlockLane) -> bool:
    """The wire screen (``marshal.from_wire_fields`` rule): any key or
    signature field longer than 32 bytes overflows the 256-bit limb
    encoding, so the lane is invalid and counts toward no policy."""
    return all(len(f) <= _WIDTH
               for f in (lane.qx, lane.qy, lane.r, lane.s))


def policy_org_masks(policies: Sequence[BlockPolicy],
                     norgs: int) -> np.ndarray:
    """(T, O) uint8 mask: ``mask[t, o]`` = 1 iff org o counts toward
    policy t (empty ``orgs`` = all count). Out-of-universe indices are
    dropped: the committer's sentinel ``orgs=(norgs,)`` leaves a row
    empty, so that policy fails."""
    m = np.zeros((len(policies), norgs), dtype=np.uint8)
    for t, p in enumerate(policies):
        if p.orgs:
            for o in p.orgs:
                if 0 <= int(o) < norgs:
                    m[t, int(o)] = 1
        else:
            m[t, :] = 1
    return m


def tally_flags(hit: np.ndarray, policies: Sequence[BlockPolicy],
                norgs: int) -> np.ndarray:
    """Per-tx verdicts from the (T, O) valid-org hit bitmap: count
    distinct in-mask orgs, compare against required."""
    mask = policy_org_masks(policies, norgs).astype(bool)
    cnt = (hit.astype(bool) & mask).sum(axis=1)
    reqd = np.array([int(p.required) for p in policies], dtype=np.int64)
    return np.where(cnt >= reqd, TXFLAG_VALID,
                    TXFLAG_POLICY_FAILURE).astype(np.int32)


def verify_block_host(verify_batch, req: BlockVerifyRequest,
                      digest_memo: Optional[dict] = None) -> np.ndarray:
    """The reference path: hash every lane's message on the host, one
    ``verify_batch`` call over the whole block, Python policy tally.
    Returns per-tx int32 flags (TXFLAG_*).

    ``digest_memo`` (bytes -> digest) hashes each distinct message once,
    however many lanes repeat it."""
    memo = digest_memo if digest_memo is not None else {}
    reqs: list[VerifyRequest] = []
    meta: list[tuple[int, int]] = []
    for ln in req.lanes:
        if not lane_screened(ln):
            continue
        d = memo.get(ln.msg)
        if d is None:
            d = memo[ln.msg] = hashlib.sha256(ln.msg).digest()
        reqs.append(VerifyRequest(
            key=PublicKey(req.curve,
                          int.from_bytes(ln.qx, "big"),
                          int.from_bytes(ln.qy, "big")),
            digest=d,
            r=int.from_bytes(ln.r, "big"),
            s=int.from_bytes(ln.s, "big"),
        ))
        meta.append((ln.tx, ln.org))
    ok = verify_batch(reqs) if reqs else []
    T = req.ntx
    hit = np.zeros((T, req.norgs), dtype=bool)
    for (t, o), v in zip(meta, ok):
        if v and 0 <= t < T and 0 <= o < req.norgs:
            hit[t, o] = True
    return tally_flags(hit, req.policies, req.norgs)
