"""Length-prefixed Frame codec for the verifyd socket tier.

The port's copy of ``bdls_tpu/sidecar/wire.py`` over the hand-written
codec (:mod:`bdls_tpu_torch.sidecar.verifyd_codec`) in place of
protobuf: every frame is its 4-byte little-endian length followed by
the encoded ``Frame``, with a hard size cap so a malformed or hostile
length prefix can never balloon a read. Its bytes are the reference's,
so either side's client talks to either side's daemon.
"""

from __future__ import annotations

import socket
import struct

from bdls_tpu_torch.sidecar import verifyd_codec as codec

# generous: an 8192-lane batch is ~1.4 MB of lane fields
MAX_FRAME = 32 * 1024 * 1024


class WireError(Exception):
    """Framing violation or closed stream."""


class OversizedFrame(WireError):
    """A frame whose declared length exceeds :data:`MAX_FRAME`.

    The payload has already been drained from the stream when this is
    raised, so the connection is still framed: the server can answer
    with an explicit error frame and close cleanly instead of killing
    the connection mid-stream with no explanation.
    """

    def __init__(self, length: int):
        super().__init__(f"oversized frame {length}")
        self.length = length


_DRAIN_CHUNK = 1 << 20


def encode_frame(frame: codec.Frame) -> bytes:
    raw = codec.encode(frame)
    if len(raw) > MAX_FRAME:
        raise WireError(f"frame too large ({len(raw)} bytes)")
    return struct.pack("<I", len(raw)) + raw


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise WireError("connection closed")
        buf += chunk
    return bytes(buf)


def recv_frame(sock: socket.socket) -> codec.Frame:
    """Blocking read of one frame from a connected socket (a body that
    does not decode raises :class:`verifyd_codec.DecodeError`)."""
    (length,) = struct.unpack("<I", _recv_exact(sock, 4))
    if length > MAX_FRAME:
        # drain the payload so the stream stays framed for the caller
        left = length
        while left:
            step = min(left, _DRAIN_CHUNK)
            _recv_exact(sock, step)
            left -= step
        raise OversizedFrame(length)
    return codec.decode(_recv_exact(sock, length))


async def read_frame(reader) -> codec.Frame:
    """Read one frame from an ``asyncio.StreamReader`` (daemon ingress).
    Raises :class:`WireError` on EOF or a framing violation."""
    import asyncio

    try:
        header = await reader.readexactly(4)
    except (asyncio.IncompleteReadError, ConnectionError) as exc:
        raise WireError("connection closed") from exc
    (length,) = struct.unpack("<I", header)
    if length > MAX_FRAME:
        left = length
        try:
            while left:
                step = min(left, _DRAIN_CHUNK)
                await reader.readexactly(step)
                left -= step
        except (asyncio.IncompleteReadError, ConnectionError) as exc:
            raise WireError("connection closed") from exc
        raise OversizedFrame(length)
    try:
        raw = await reader.readexactly(length)
    except (asyncio.IncompleteReadError, ConnectionError) as exc:
        raise WireError("connection closed") from exc
    return codec.decode(raw)
