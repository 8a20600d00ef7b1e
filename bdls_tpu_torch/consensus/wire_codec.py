"""The consensus wire format, encoded and decoded without protobuf.

The counterpart of ``bdls_tpu/consensus/wire_pb2.py`` (the schema
``bdls_tpu/consensus/wire.proto``): ``MsgType``, ``ConsensusMessage``
and, for ``SignedEnvelope``, the port's one envelope class
:class:`bdls_tpu_torch.consensus.identity.SignedEnvelope`. The codec is
written by hand on the primitives of :mod:`bdls_tpu_torch.utils.proto3`,
because the machine that runs the port on the card has no protobuf.

:func:`encode` writes the bytes protobuf's ``SerializeToString`` writes,
and :func:`decode_envelope` / :func:`decode_message` accept and refuse
what ``ParseFromString`` accepts and refuses (:class:`DecodeError`):

- fields in field-number order; 0 and empty bytes are left out (proto3's
  implicit presence), except ``lock_release``, a message field: it is
  written when set, even empty, and ``None`` means absent (protobuf's
  ``HasField``);
- ``type`` is an open enum, an int32 on the wire: a value the schema
  does not name is kept, and a negative one travels as ten bytes;
  ``version`` is a uint32, ``height`` and ``round`` uint64s;
- a scalar or bytes field seen twice keeps the last value, ``proof``
  appends, and ``lock_release`` seen twice merges the second into the
  first;
- unknown fields, and known ones under another wire type, are kept as
  their raw bytes, in the order read, on the message's
  ``unknown_fields``, and written back after the known fields, so a
  re-serialized proof keeps its bytes.

``unknown_fields`` is a plain attribute, not a dataclass field: two
messages that differ only there compare equal, as
``SignedEnvelope.__dataclass_fields__`` stays the wire message's six
fields.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import IntEnum
from typing import Optional

from bdls_tpu_torch.consensus.identity import SignedEnvelope
from bdls_tpu_torch.utils.proto3 import (SMALL, U32, U64, WT_LEN,
                                         WT_VARINT, DecodeError, read_tag,
                                         read_varint, skip, varint)

__all__ = ["DecodeError", "MsgType", "ConsensusMessage", "SignedEnvelope",
           "encode", "decode_envelope", "decode_message", "copy_envelope"]


class MsgType(IntEnum):
    NOP = 0
    ROUND_CHANGE = 1
    LOCK = 2
    SELECT = 3
    COMMIT = 4
    LOCK_RELEASE = 5
    DECIDE = 6
    RESYNC = 7

    @classmethod
    def Name(cls, number: int) -> str:
        """The value's name, as protobuf's ``EnumTypeWrapper.Name``:
        ``ValueError`` for a number the schema does not name."""
        try:
            return cls(number).name
        except ValueError:
            raise ValueError(f"MsgType has no value {number}") from None


@dataclass
class ConsensusMessage:
    type: int = 0
    height: int = 0
    round: int = 0
    state: bytes = b""
    proof: list = field(default_factory=list)
    lock_release: Optional[SignedEnvelope] = None
    vote_sig: bytes = b""
    commit_cert: bytes = b""

    # raw unknown fields (see the module docstring)
    unknown_fields = b""


def copy_envelope(env: SignedEnvelope) -> SignedEnvelope:
    """A copy with the unknown fields (protobuf's ``CopyFrom``)."""
    out = SignedEnvelope(env.version, env.payload, env.pub_x, env.pub_y,
                         env.sig_r, env.sig_s)
    if env.unknown_fields:
        out.unknown_fields = env.unknown_fields
    return out


# ---- encode ---------------------------------------------------------------

def _bytes(name: str, v) -> bytes:
    if type(v) is bytes:
        return v
    if isinstance(v, str) or not isinstance(v, (bytearray, memoryview)):
        raise TypeError(f"{name}: {type(v).__name__} for bytes")
    return bytes(v)


def _uint(name: str, v, top: int) -> int:
    if not isinstance(v, int) or isinstance(v, bool):
        raise TypeError(f"{name}: {type(v).__name__} for an integer")
    if not 0 <= v <= top:
        raise ValueError(f"{name}: {v} out of range")
    return v


def _env_parts(env: SignedEnvelope, parts: list) -> None:
    v = env.version
    if v:
        parts += (b"\x08", varint(_uint("version", v, U32)))
    for tag, name in ((b"\x12", "payload"), (b"\x1a", "pub_x"),
                      (b"\x22", "pub_y"), (b"\x2a", "sig_r"),
                      (b"\x32", "sig_s")):
        b = getattr(env, name)
        if b:
            b = _bytes(name, b)
            n = len(b)
            parts += (tag, SMALL[n] if n < 0x80 else varint(n), b)
    unknown = getattr(env, "unknown_fields", b"")
    if unknown:
        parts.append(unknown)


def _encode_envelope(env: SignedEnvelope) -> bytes:
    parts: list = []
    _env_parts(env, parts)
    return b"".join(parts)


def _encode_message(m: ConsensusMessage) -> bytes:
    parts: list = []
    t = m.type
    if t:
        if not isinstance(t, int) or not -(1 << 31) <= t < (1 << 31):
            raise ValueError(f"type: {t!r} is not an int32")
        parts += (b"\x08", varint(t if t > 0 else t + (1 << 64)))
    if m.height:
        parts += (b"\x10", varint(_uint("height", m.height, U64)))
    if m.round:
        parts += (b"\x18", varint(_uint("round", m.round, U64)))
    if m.state:
        b = _bytes("state", m.state)
        parts += (b"\x22", varint(len(b)), b)
    for p in m.proof:
        b = _encode_envelope(p)
        parts += (b"\x2a", varint(len(b)), b)
    if m.lock_release is not None:
        b = _encode_envelope(m.lock_release)
        parts += (b"\x32", varint(len(b)), b)
    if m.vote_sig:
        b = _bytes("vote_sig", m.vote_sig)
        parts += (b"\x3a", varint(len(b)), b)
    if m.commit_cert:
        b = _bytes("commit_cert", m.commit_cert)
        parts += (b"\x42", varint(len(b)), b)
    if m.unknown_fields:
        parts.append(m.unknown_fields)
    return b"".join(parts)


def encode(msg) -> bytes:
    """The proto3 bytes of a :class:`SignedEnvelope` or a
    :class:`ConsensusMessage`, as ``SerializeToString`` writes them."""
    if isinstance(msg, ConsensusMessage):
        return _encode_message(msg)
    if isinstance(msg, SignedEnvelope):
        return _encode_envelope(msg)
    raise TypeError(f"not a consensus wire message: {type(msg).__name__}")


# ---- decode ---------------------------------------------------------------

_MSG_BYTES = {0x22: "state", 0x3a: "vote_sig", 0x42: "commit_cert"}


def _length(buf: bytes, pos: int, end: int) -> tuple[int, int]:
    """(start, stop) of the length-delimited value whose length varint
    starts at ``pos``."""
    n = buf[pos] if pos < end else 0x80
    if n < 0x80:
        pos += 1
    else:
        n, pos = read_varint(buf, pos, end)
    stop = pos + n
    if stop > end:
        raise DecodeError("truncated field")
    return pos, stop


def _unknown(buf: bytes, pos: int, end: int, depth: int) -> int:
    """Position after the field whose key starts at ``pos`` (a field the
    message does not know, or a known one under another wire type)."""
    key = buf[pos]
    if key < 0x80:
        if key < 8:
            raise DecodeError("field number 0")
        pos += 1
    else:
        key, pos = read_tag(buf, pos, end)
    return skip(buf, pos, end, key >> 3, key & 7, depth)


def _envelope(buf: bytes, pos: int, end: int, depth: int,
              base: Optional[SignedEnvelope] = None) -> SignedEnvelope:
    """Parse the envelope in ``buf[pos:end]``, merged onto ``base`` (a
    field read twice keeps the last value). The key and length reads are
    inlined: this loop runs for every envelope of every frame, some
    1.7 million times in two heights of a 128-validator network."""
    if base is None:
        ver, fields, unknown = 0, [b"", b"", b"", b"", b""], []
    else:
        ver = base.version
        fields = [base.payload, base.pub_x, base.pub_y, base.sig_r,
                  base.sig_s]
        unknown = [base.unknown_fields] if base.unknown_fields else []
    while pos < end:
        key = buf[pos]
        if key < 0x80:
            if key < 8:
                raise DecodeError("field number 0")
            p = pos + 1
        else:
            key, p = read_tag(buf, pos, end)
        num, wt = key >> 3, key & 7
        if wt == WT_LEN and 2 <= num <= 6:
            n = buf[p] if p < end else 0x80
            if n < 0x80:
                p += 1
            else:
                n, p = read_varint(buf, p, end)
            stop = p + n
            if stop > end:
                raise DecodeError("truncated field")
            fields[num - 2] = buf[p:stop]
            pos = stop
        elif num == 1 and wt == WT_VARINT:
            ver, pos = read_varint(buf, p, end)
            ver &= U32
        else:
            stop = skip(buf, p, end, num, wt, depth)
            unknown.append(buf[pos:stop])
            pos = stop
    env = SignedEnvelope(ver, *fields)
    if unknown:
        env.unknown_fields = b"".join(unknown)
    return env


def _message_field(m: ConsensusMessage, buf: bytes, num: int, wt: int,
                   pos: int, end: int):
    """Read known field ``num`` under wire type ``wt`` at ``pos`` (after
    its key); the position after it, or None when the wire type is not
    the field's."""
    if wt == WT_VARINT and 1 <= num <= 3:
        v, pos = read_varint(buf, pos, end)
        if num == 1:  # int32 enum: the low 32 bits, signed
            v &= U32
            m.type = v - (1 << 32) if v >> 31 else v
        elif num == 2:
            m.height = v
        else:
            m.round = v
        return pos
    if wt == WT_LEN and 4 <= num <= 8:
        start, stop = _length(buf, pos, end)
        if num == 5:
            m.proof.append(_envelope(buf, start, stop, 1))
        elif num == 6:
            m.lock_release = _envelope(buf, start, stop, 1, m.lock_release)
        else:
            setattr(m, _MSG_BYTES[num << 3 | WT_LEN], buf[start:stop])
        return stop
    return None


def _message_into(m: ConsensusMessage, buf: bytes, pos: int,
                  end: int) -> None:
    unknown = []
    while pos < end:
        key = buf[pos]
        if 8 <= key < 0x80:
            nxt = _message_field(m, buf, key >> 3, key & 7, pos + 1, end)
        else:
            k, p = read_tag(buf, pos, end) if key >= 0x80 else (key, pos)
            nxt = _message_field(m, buf, k >> 3, k & 7, p, end)
        if nxt is None:
            start = pos
            pos = _unknown(buf, pos, end, 0)
            unknown.append(buf[start:pos])
        else:
            pos = nxt
    if unknown:
        m.unknown_fields = m.unknown_fields + b"".join(unknown)


def _buffer(data) -> bytes:
    if type(data) is bytes:
        return data
    if isinstance(data, str):
        raise TypeError("decode takes bytes, not str")
    return bytes(data)


def decode_envelope(data) -> SignedEnvelope:
    """Parse a ``SignedEnvelope``; :class:`DecodeError` where protobuf
    would refuse the bytes."""
    buf = _buffer(data)
    return _envelope(buf, 0, len(buf), 0)


def decode_message(data) -> ConsensusMessage:
    """Parse a ``ConsensusMessage``; :class:`DecodeError` where protobuf
    would refuse the bytes."""
    buf = _buffer(data)
    m = ConsensusMessage()
    _message_into(m, buf, 0, len(buf))
    return m
