"""Append-only block ledgers (reference:
``common/ledger/blockledger/fileledger/``).

``FileLedger``: one directory per channel, blocks appended to a single
segment file as ``[u32 length][serialized Block]`` records; the offset
index is rebuilt by a scan on open (crash-safe: a torn tail record is
truncated). The ledger is also the checkpoint — on restart the chain
resumes from the last committed block, mirroring the reference's recovery
story.

``MemoryLedger``: same interface for tests.

The port's copy of ``bdls_tpu/ordering/ledger.py``.
"""

from __future__ import annotations

import os
import struct
import threading
from typing import Iterator, Optional

from bdls_tpu_torch.ordering import fabric_codec as pb


class LedgerError(Exception):
    pass


class _LedgerBase:
    def append(self, block: pb.Block) -> None:
        raise NotImplementedError

    def get(self, number: int) -> pb.Block:
        raise NotImplementedError

    def height(self) -> int:
        """Number of blocks (next block number)."""
        raise NotImplementedError

    def last_block(self) -> Optional[pb.Block]:
        h = self.height()
        return self.get(h - 1) if h else None

    def iterator(self, start: int = 0) -> Iterator[pb.Block]:
        for n in range(start, self.height()):
            yield self.get(n)


class MemoryLedger(_LedgerBase):
    def __init__(self):
        self._blocks: list[pb.Block] = []
        self._lock = threading.Lock()

    def append(self, block: pb.Block) -> None:
        with self._lock:
            if block.header.number != len(self._blocks):
                raise LedgerError(
                    f"append out of order: {block.header.number} != {len(self._blocks)}"
                )
            self._blocks.append(block)

    def get(self, number: int) -> pb.Block:
        try:
            return self._blocks[number]
        except IndexError:
            raise LedgerError(f"no such block {number}")

    def height(self) -> int:
        return len(self._blocks)


class FileLedger(_LedgerBase):
    _MAGIC = b"BDL1"

    def __init__(self, directory: str):
        self.dir = directory
        os.makedirs(directory, exist_ok=True)
        self.path = os.path.join(directory, "blocks.seg")
        self._lock = threading.Lock()
        self._offsets: list[int] = []
        self._scan()
        self._fh = open(self.path, "ab")

    def _scan(self) -> None:
        """Rebuild the offset index; truncate a torn tail record."""
        self._offsets = []
        if not os.path.exists(self.path):
            with open(self.path, "wb") as fh:
                fh.write(self._MAGIC)
            return
        with open(self.path, "rb+") as fh:
            magic = fh.read(4)
            if magic != self._MAGIC:
                raise LedgerError(f"bad ledger magic in {self.path}")
            off = 4
            size = os.path.getsize(self.path)
            while off + 4 <= size:
                fh.seek(off)
                (length,) = struct.unpack("<I", fh.read(4))
                if off + 4 + length > size:
                    break  # torn write
                self._offsets.append(off)
                off += 4 + length
            if off < size:
                fh.truncate(off)

    def append(self, block: pb.Block) -> None:
        with self._lock:
            if block.header.number != len(self._offsets):
                raise LedgerError(
                    f"append out of order: {block.header.number} != {len(self._offsets)}"
                )
            raw = block.SerializeToString()
            self._fh.seek(0, os.SEEK_END)
            off = self._fh.tell()
            self._fh.write(struct.pack("<I", len(raw)) + raw)
            self._fh.flush()
            os.fsync(self._fh.fileno())
            self._offsets.append(off)

    def get(self, number: int) -> pb.Block:
        with self._lock:
            if number < 0 or number >= len(self._offsets):
                raise LedgerError(f"no such block {number}")
            off = self._offsets[number]
        with open(self.path, "rb") as fh:
            fh.seek(off)
            (length,) = struct.unpack("<I", fh.read(4))
            blk = pb.Block()
            blk.ParseFromString(fh.read(length))
            return blk

    def height(self) -> int:
        with self._lock:
            return len(self._offsets)

    def close(self) -> None:
        self._fh.close()


class LedgerFactory:
    """One ledger per channel under a base directory (reference:
    fileledger factory in orderer/common/server/util.go)."""

    def __init__(self, base_dir: Optional[str] = None):
        self.base_dir = base_dir
        self._ledgers: dict[str, _LedgerBase] = {}
        self._lock = threading.Lock()

    def get_or_create(self, channel_id: str) -> _LedgerBase:
        with self._lock:
            if channel_id not in self._ledgers:
                if self.base_dir is None:
                    self._ledgers[channel_id] = MemoryLedger()
                else:
                    self._ledgers[channel_id] = FileLedger(
                        os.path.join(self.base_dir, channel_id)
                    )
            return self._ledgers[channel_id]

    def channel_ids(self) -> list[str]:
        """In-memory channels plus everything persisted under base_dir
        (ledger directories and join-block files) — a restarted factory
        must enumerate channels it has not opened yet."""
        names = set()
        with self._lock:
            names.update(self._ledgers)
        if self.base_dir and os.path.isdir(self.base_dir):
            for entry in os.listdir(self.base_dir):
                path = os.path.join(self.base_dir, entry)
                if os.path.isdir(path):
                    names.add(entry)
                elif entry.endswith(".joinblock"):
                    names.add(entry[:-len(".joinblock")])
        return sorted(names)
