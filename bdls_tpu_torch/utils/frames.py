"""Length-framed record files — the one shared framing implementation.

Every durable log in the framework (block ledger, KV state log, raft
WAL, snapshots) stores ``[u32 little-endian length][payload]`` records.
This module is the single copy of the frame walk so torn-tail policy
fixes (or a future checksum) land in one place.

Two policies:
- ``iter_frames(raw, torn="stop")`` yields payloads up to the first
  incomplete frame and reports where the valid prefix ends (WAL/state-log
  recovery: truncate and continue).
- ``iter_frames(raw, torn="raise")`` raises on any incomplete tail
  (snapshots: transferred atomically, a torn file is rejected).

The port's copy of ``bdls_tpu/utils/frames.py``.
"""

from __future__ import annotations

import struct
from typing import Iterator


class TornFrame(Exception):
    pass


def encode_frame(payload: bytes) -> bytes:
    return struct.pack("<I", len(payload)) + payload


def iter_frames(raw: bytes, start: int = 0,
                torn: str = "stop") -> Iterator[tuple[int, bytes]]:
    """Yield ``(end_offset, payload)`` per complete frame. ``end_offset``
    is the offset just past the frame — the caller's truncation point."""
    off = start
    while off + 4 <= len(raw):
        (n,) = struct.unpack_from("<I", raw, off)
        if off + 4 + n > len(raw):
            if torn == "raise":
                raise TornFrame(f"incomplete frame at {off}")
            return
        payload = raw[off + 4 : off + 4 + n]
        off += 4 + n
        yield off, payload
    if off != len(raw) and torn == "raise":
        raise TornFrame(f"trailing bytes at {off}")
