"""Proto3 wire primitives for the port's hand-written codecs.

The machine that runs the port on the card has no protobuf, so the
port's messages (``sidecar/verifyd_codec.py``, ``consensus/wire_codec.py``)
are encoded and decoded by hand on these pieces:

- :func:`varint` and :func:`read_varint`: base-128 integers, at most 10
  bytes, bits above 64 dropped (as protobuf's parser drops them);
- :func:`read_tag`: a field key, at most 5 bytes and below 2^32, field
  number 1 or more;
- :func:`skip`: the end of one field's value, unknown fields and groups
  included, groups nested at most :data:`MAX_DEPTH` deep counting the
  messages around them (protobuf's default recursion limit).

Input that protobuf's parser refuses raises :class:`DecodeError`.
"""

from __future__ import annotations


class DecodeError(ValueError):
    """Bytes that are not a valid encoding of the message."""


WT_VARINT, WT_I64, WT_LEN, WT_SGROUP, WT_EGROUP, WT_I32 = 0, 1, 2, 3, 4, 5
# messages and groups nested inside one another, the outermost message
# at depth 0
MAX_DEPTH = 100
U32 = (1 << 32) - 1
U64 = (1 << 64) - 1

SMALL = [bytes((i,)) for i in range(128)]


def varint(n: int) -> bytes:
    if n < 0x80:
        return SMALL[n]
    out = bytearray()
    while n >= 0x80:
        out.append((n & 0x7F) | 0x80)
        n >>= 7
    out.append(n)
    return bytes(out)


def read_varint(buf: bytes, pos: int, end: int) -> tuple[int, int]:
    result = shift = 0
    for i in range(pos, min(end, pos + 10)):
        b = buf[i]
        result |= (b & 0x7F) << shift
        if b < 0x80:
            return result & U64, i + 1
        shift += 7
    if end - pos < 10:
        raise DecodeError("truncated varint")
    raise DecodeError("varint longer than 10 bytes")


def read_tag(buf: bytes, pos: int, end: int) -> tuple[int, int]:
    """A field key: its varint may take 5 bytes at most and stay below
    2^32, and its field number must not be 0."""
    result = shift = 0
    for i in range(pos, min(end, pos + 5)):
        b = buf[i]
        result |= (b & 0x7F) << shift
        if b < 0x80:
            if result > U32:
                raise DecodeError("field key above 32 bits")
            if result < 8:
                raise DecodeError("field number 0")
            return result, i + 1
        shift += 7
    if end - pos < 5:
        raise DecodeError("truncated field key")
    raise DecodeError("field key longer than 5 bytes")


def skip(buf: bytes, pos: int, end: int, num: int, wt: int,
         depth: int = 0) -> int:
    """Position after one field's value; ``depth`` is the nesting of the
    message that holds the field."""
    if wt == WT_VARINT:
        return read_varint(buf, pos, end)[1]
    if wt == WT_I64 or wt == WT_I32:
        stop = pos + (8 if wt == WT_I64 else 4)
    elif wt == WT_LEN:
        n, pos = read_varint(buf, pos, end)
        stop = pos + n
    elif wt == WT_SGROUP:
        depth += 1
        if depth > MAX_DEPTH:
            raise DecodeError("groups nested too deep")
        while True:
            if pos >= end:
                raise DecodeError("truncated group")
            key, pos = read_tag(buf, pos, end)
            if key & 7 == WT_EGROUP:
                if key >> 3 != num:
                    raise DecodeError("mismatched end group")
                return pos
            pos = skip(buf, pos, end, key >> 3, key & 7, depth)
    else:
        raise DecodeError(f"wire type {wt}")
    if stop > end:
        raise DecodeError("truncated field")
    return stop
