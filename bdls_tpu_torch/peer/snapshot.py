"""Peer ledger snapshots: export at a height, bootstrap a new peer from
the snapshot without replaying the chain.

Reference parity: ``core/ledger/kvledger/snapshot/`` — a snapshot
captures the committed state (with versions) plus the block-chain
anchor (last block) at a height; a new peer joins from it
("join-from-snapshot", ``kvledger`` CreateFromSnapshot) and continues
committing from height H+1. History before the snapshot point is not
carried (matching the reference: pre-snapshot history queries are
unavailable on a snapshot-bootstrapped peer).

Format: one file, 4-byte length-framed JSON records — a header record
{channel, height, last_block_hex} followed by one record per state key
{k, v_hex, ver} and a final {"commit": 1} marker (torn/partial files are
rejected outright: a snapshot is transferred atomically, unlike a WAL).

The port's copy of ``bdls_tpu/peer/snapshot.py``, whole: the same
records in the same frames, so a snapshot either package writes loads
in the other. A peer started from one commits from its anchor on,
through K7 on ``TorchCSP``.
"""

from __future__ import annotations

import json
from typing import Optional

from bdls_tpu_torch.ordering import fabric_codec as pb
from bdls_tpu_torch.ordering.block import header_hash
from bdls_tpu_torch.ordering.ledger import LedgerError, MemoryLedger, _LedgerBase
from bdls_tpu_torch.utils.frames import TornFrame, encode_frame, iter_frames


class SnapshotError(Exception):
    pass


def _write_rec(fh, obj: dict) -> None:
    fh.write(encode_frame(json.dumps(obj).encode()))


def _read_recs(path: str):
    with open(path, "rb") as fh:
        raw = fh.read()
    try:
        for _, payload in iter_frames(raw, torn="raise"):
            yield json.loads(payload)
    except TornFrame as exc:
        raise SnapshotError(f"truncated snapshot file: {exc}")


def export_snapshot(peer, path: str) -> dict:
    """Write a snapshot of a peer's current committed state + chain
    anchor. Returns the header metadata."""
    last = peer.block_store.last_block()
    header = {
        "channel": peer.channel_id,
        "height": peer.block_store.height(),
        "last_block": last.SerializeToString().hex(),
        "last_hash": header_hash(last.header).hex(),
    }
    with open(path, "wb") as fh:
        _write_rec(fh, header)
        state = peer.state
        for key in state.keys():
            _write_rec(fh, {
                "k": key,
                "v": state.get(key).hex(),
                "ver": list(state.version(key)),
            })
        _write_rec(fh, {"commit": 1})
    return header


class SnapshotLedger(_LedgerBase):
    """A block store anchored at a snapshot: holds blocks from the
    snapshot height onward; earlier blocks are unavailable (by design —
    the snapshot replaced them)."""

    def __init__(self, anchor: pb.Block):
        self._base = anchor.header.number
        self._blocks: list[pb.Block] = [anchor]

    def append(self, block: pb.Block) -> None:
        if block.header.number != self.height():
            raise LedgerError(
                f"append out of order: {block.header.number} != {self.height()}"
            )
        self._blocks.append(block)

    def get(self, number: int) -> pb.Block:
        if number < self._base:
            raise LedgerError(
                f"block {number} predates the snapshot (base {self._base})"
            )
        try:
            return self._blocks[number - self._base]
        except IndexError:
            raise LedgerError(f"no such block {number}")

    def height(self) -> int:
        return self._base + len(self._blocks)

    def iterator(self, start: int = 0):
        for n in range(max(start, self._base), self.height()):
            yield self.get(n)


def load_snapshot(path: str) -> tuple[dict, pb.Block, list[dict]]:
    """Parse + integrity-check a snapshot file."""
    recs = list(_read_recs(path))
    if len(recs) < 2 or not recs or "channel" not in recs[0]:
        raise SnapshotError("missing snapshot header")
    if recs[-1] != {"commit": 1}:
        raise SnapshotError("snapshot missing commit marker (partial file)")
    header = recs[0]
    anchor = pb.Block()
    anchor.ParseFromString(bytes.fromhex(header["last_block"]))
    if header_hash(anchor.header).hex() != header["last_hash"]:
        raise SnapshotError("snapshot anchor hash mismatch")
    if anchor.header.number != header["height"] - 1:
        raise SnapshotError("snapshot height/anchor disagree")
    return header, anchor, recs[1:-1]


def bootstrap_from_snapshot(path: str, csp, org: str, signing_key,
                            orderer_sources=(), policy=None, *, msp):
    """Create a PeerNode from a snapshot (kvledger CreateFromSnapshot):
    state preloaded with versions, block store anchored at the snapshot
    block, delivery resuming at height H."""
    from bdls_tpu_torch.models.peer import PeerNode

    header, anchor, state_recs = load_snapshot(path)
    store = SnapshotLedger(anchor)
    peer = PeerNode(
        channel_id=header["channel"],
        csp=csp,
        org=org,
        signing_key=signing_key,
        genesis=anchor,          # ignored: store already has the anchor
        orderer_sources=list(orderer_sources),
        policy=policy,
        block_store=store,
        msp=msp,
    )
    for rec in state_recs:
        ws = pb.WriteSet()
        w = ws.writes.add()
        w.key = rec["k"]
        w.value = bytes.fromhex(rec["v"])
        peer.state.apply(ws, tuple(rec["ver"]))
    if peer.deliverer is not None:
        peer.deliverer.next_number = store.height()
    return peer
