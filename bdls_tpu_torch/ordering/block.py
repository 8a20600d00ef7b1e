"""Canonical block & envelope hashing and construction helpers.

Reference parity: ``protoutil/blockutils.go`` (block header hash as the
chain link) and the BDLS plugin's hash-chained block creator
(``orderer/consensus/bdls/blockcreator.go:25-46``). Header hashing uses an
explicit canonical byte layout (number‖prev‖data_hash) rather than
serialized protobuf, so the chain link never depends on codec details.

The port's copy of ``bdls_tpu/ordering/block.py``.
"""

from __future__ import annotations

import hashlib
import struct
from typing import Optional, Sequence

from bdls_tpu_torch.ordering import fabric_codec as pb


def header_hash(header: pb.BlockHeader) -> bytes:
    buf = struct.pack("<Q", header.number) + header.previous_hash + header.data_hash
    return hashlib.sha256(buf).digest()


def data_hash(txs: Sequence[bytes]) -> bytes:
    h = hashlib.sha256()
    for tx in txs:
        h.update(hashlib.sha256(tx).digest())
    return h.digest()


def tx_digest(env: pb.TxEnvelope) -> bytes:
    """The signed digest of an envelope: sha256(canonical header ‖ payload)."""
    hdr = env.header
    buf = (
        struct.pack("<iq", hdr.type, hdr.timestamp_unix_ms)
        + hdr.channel_id.encode()
        + b"\x00"
        + hdr.tx_id.encode()
        + b"\x00"
        + hdr.creator_x
        + hdr.creator_y
        + hdr.creator_org.encode()
        + b"\x00"
        + env.payload
    )
    return hashlib.sha256(buf).digest()


def make_block(number: int, previous_hash: bytes, txs: Sequence[bytes]) -> pb.Block:
    blk = pb.Block()
    blk.header.number = number
    blk.header.previous_hash = previous_hash
    blk.header.data_hash = data_hash(txs)
    for tx in txs:
        blk.data.transactions.append(tx)
    # metadata slots: [0] signatures, [1] last config, [2] consensus proof
    for _ in range(3):
        blk.metadata.entries.append(b"")
    return blk


def genesis_block(channel_id: str, config_payload: bytes = b"") -> pb.Block:
    """Deterministic genesis: block 0 with a single config tx."""
    env = pb.TxEnvelope()
    env.header.type = pb.TxType.TX_CONFIG
    env.header.channel_id = channel_id
    env.header.tx_id = f"genesis-{channel_id}"
    env.payload = config_payload
    return make_block(0, b"\x00" * 32, [env.SerializeToString()])


class BlockCreator:
    """Hash-chain state: builds the next block from a batch
    (reference blockcreator.go)."""

    def __init__(self, last_header: pb.BlockHeader):
        self.number = last_header.number
        self.prev_hash = header_hash(last_header)

    def create_next(self, txs: Sequence[bytes]) -> pb.Block:
        return make_block(self.number + 1, self.prev_hash, txs)

    def advance(self, committed: pb.Block) -> None:
        """Re-anchor on a committed block (ours or a peer's winning one)."""
        self.number = committed.header.number
        self.prev_hash = header_hash(committed.header)


def validate_chain_link(block: pb.Block, last_header: pb.BlockHeader) -> Optional[str]:
    """Structural validation of a proposed block against our chain tip.
    Returns an error string or None (used as the engine's StateValidate —
    a real implementation of what the reference hardcodes to true,
    chain.go:338)."""
    if block.header.number != last_header.number + 1:
        return f"number {block.header.number} != {last_header.number + 1}"
    want_prev = header_hash(last_header)
    if block.header.previous_hash != want_prev:
        return "previous_hash mismatch"
    if block.header.data_hash != data_hash(block.data.transactions):
        return "data_hash mismatch"
    if not block.data.transactions:
        return "empty block"
    return None
