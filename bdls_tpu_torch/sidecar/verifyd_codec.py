"""The ``verifyd`` frame schema, encoded and decoded without protobuf.

The counterpart of ``bdls_tpu/sidecar/verifyd_pb2.py``: plain
dataclasses for the 17 messages of ``bdls_tpu/sidecar/verifyd.proto``,
with the proto's field names and numbers, and a proto3 wire codec
written by hand, so the daemon and its client run where no protobuf is
installed. :func:`encode` gives the bytes protobuf's
``SerializeToString`` gives, byte for byte, and :func:`decode` parses
whatever protobuf emits:

- fields in field-number order, each behind its varint tag;
- implicit presence: 0, ``""``, ``b""`` and a double whose bit pattern
  is 0 are left out (so ``-0.0`` is written); the member of a oneof is
  written even when it is empty;
- doubles as fixed64 little-endian, every integer as a varint;
- ``repeated uint32`` packed on encode, packed or not on decode;
- ``string`` fields must be valid UTF-8 (:class:`DecodeError`);
- a scalar seen twice keeps the last value, a repeated field appends, a
  message field seen twice merges, the last oneof member wins; unknown
  fields (and known ones under another wire type) are skipped; input
  that ends inside a field raises :class:`DecodeError`.

``Frame`` carries its oneof as ``kind`` (the member's name, or ``None``)
and ``msg``; ``frame.verify`` and the other member names read ``msg``
when that member is set and ``None`` otherwise.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Optional

from bdls_tpu_torch.utils.proto3 import (  # noqa: F401 (DecodeError)
    SMALL as _SMALL, WT_I64 as _WT_I64, WT_LEN as _WT_LEN,
    WT_VARINT as _WT_VARINT, DecodeError, read_varint as _read_varint,
    skip as _skip, varint as _varint)

# field kinds
STRING, BYTES, UINT32, UINT64, BOOL, DOUBLE, MESSAGE = (
    "string", "bytes", "uint32", "uint64", "bool", "double", "message")

_WIRE_TYPE = {STRING: _WT_LEN, BYTES: _WT_LEN, UINT32: _WT_VARINT,
              UINT64: _WT_VARINT, BOOL: _WT_VARINT, DOUBLE: _WT_I64,
              MESSAGE: _WT_LEN}
_MAX = {UINT32: (1 << 32) - 1, UINT64: (1 << 64) - 1}
_D = struct.Struct("<d")
_ZERO8 = bytes(8)


class _Field:
    __slots__ = ("num", "name", "kind", "repeated", "sub", "tag", "wt")

    def __init__(self, num, name, kind, repeated=False, sub=None):
        self.num, self.name, self.kind = num, name, kind
        self.repeated, self.sub = repeated, sub
        # repeated fields all travel length-delimited (uint32 packed)
        self.wt = _WT_LEN if repeated else _WIRE_TYPE[kind]
        self.tag = _varint(num << 3 | self.wt)


def _schema(cls, *fields) -> None:
    cls._FIELDS = tuple(_Field(*f) for f in fields)
    cls._BY_NUM = {f.num: f for f in cls._FIELDS}


# ---- the messages (verifyd.proto order) -----------------------------------

@dataclass(slots=True)
class VerifyLane:
    curve: str = ""
    pub_x: bytes = b""
    pub_y: bytes = b""
    digest: bytes = b""
    sig_r: bytes = b""
    sig_s: bytes = b""


_schema(VerifyLane, (1, "curve", STRING), (2, "pub_x", BYTES),
        (3, "pub_y", BYTES), (4, "digest", BYTES), (5, "sig_r", BYTES),
        (6, "sig_s", BYTES))


@dataclass(slots=True)
class VerifyBatchRequest:
    seq: int = 0
    tenant: str = ""
    traceparent: str = ""
    deadline_ms: float = 0.0
    lanes: list = field(default_factory=list)
    lane_hint: int = 0


_schema(VerifyBatchRequest, (1, "seq", UINT64), (2, "tenant", STRING),
        (3, "traceparent", STRING), (4, "deadline_ms", DOUBLE),
        (5, "lanes", MESSAGE, True, VerifyLane), (6, "lane_hint", UINT32))


@dataclass(slots=True)
class VerifyBatchResponse:
    seq: int = 0
    n: int = 0
    verdicts: bytes = b""
    error: str = ""
    retry_after_ms: float = 0.0
    shed: bool = False


_schema(VerifyBatchResponse, (1, "seq", UINT64), (2, "n", UINT32),
        (3, "verdicts", BYTES), (4, "error", STRING),
        (5, "retry_after_ms", DOUBLE), (6, "shed", BOOL))


@dataclass(slots=True)
class WarmKeysRequest:
    tenant: str = ""
    curve: str = ""
    pubs: list = field(default_factory=list)


_schema(WarmKeysRequest, (1, "tenant", STRING), (2, "curve", STRING),
        (3, "pubs", BYTES, True))


@dataclass(slots=True)
class WarmKeysResponse:
    accepted: int = 0
    error: str = ""


_schema(WarmKeysResponse, (1, "accepted", UINT32), (2, "error", STRING))


@dataclass(slots=True)
class StatsRequest:
    pass


_schema(StatsRequest)


@dataclass(slots=True)
class StatsResponse:
    json: str = ""


_schema(StatsResponse, (1, "json", STRING))


@dataclass(slots=True)
class CertCommitteeRequest:
    tenant: str = ""
    committee: str = ""
    quorum: int = 0
    pks: list = field(default_factory=list)


_schema(CertCommitteeRequest, (1, "tenant", STRING),
        (2, "committee", STRING), (3, "quorum", UINT32),
        (4, "pks", BYTES, True))


@dataclass(slots=True)
class CertCommitteeResponse:
    registered: int = 0
    error: str = ""


_schema(CertCommitteeResponse, (1, "registered", UINT32),
        (2, "error", STRING))


@dataclass(slots=True)
class CertBatchRequest:
    seq: int = 0
    tenant: str = ""
    committee: str = ""
    certs: list = field(default_factory=list)


_schema(CertBatchRequest, (1, "seq", UINT64), (2, "tenant", STRING),
        (3, "committee", STRING), (4, "certs", BYTES, True))


@dataclass(slots=True)
class WarmStateRequest:
    tenant: str = ""


_schema(WarmStateRequest, (1, "tenant", STRING))


@dataclass(slots=True)
class WarmStateResponse:
    warmed: list = field(default_factory=list)
    snapshot_path: str = ""
    error: str = ""


_schema(WarmStateResponse, (1, "warmed", MESSAGE, True, WarmKeysRequest),
        (2, "snapshot_path", STRING), (3, "error", STRING))


@dataclass(slots=True)
class BlockLaneMsg:
    msg: bytes = b""
    pub_x: bytes = b""
    pub_y: bytes = b""
    sig_r: bytes = b""
    sig_s: bytes = b""
    tx: int = 0
    org: int = 0


_schema(BlockLaneMsg, (1, "msg", BYTES), (2, "pub_x", BYTES),
        (3, "pub_y", BYTES), (4, "sig_r", BYTES), (5, "sig_s", BYTES),
        (6, "tx", UINT32), (7, "org", UINT32))


@dataclass(slots=True)
class BlockPolicyMsg:
    required: int = 0
    orgs: list = field(default_factory=list)


_schema(BlockPolicyMsg, (1, "required", UINT32),
        (2, "orgs", UINT32, True))


@dataclass(slots=True)
class VerifyBlockRequest:
    seq: int = 0
    tenant: str = ""
    traceparent: str = ""
    deadline_ms: float = 0.0
    curve: str = ""
    norgs: int = 0
    lanes: list = field(default_factory=list)
    policies: list = field(default_factory=list)


_schema(VerifyBlockRequest, (1, "seq", UINT64), (2, "tenant", STRING),
        (3, "traceparent", STRING), (4, "deadline_ms", DOUBLE),
        (5, "curve", STRING), (6, "norgs", UINT32),
        (7, "lanes", MESSAGE, True, BlockLaneMsg),
        (8, "policies", MESSAGE, True, BlockPolicyMsg))


@dataclass(slots=True)
class VerifyBlockResponse:
    seq: int = 0
    ntx: int = 0
    flags: bytes = b""
    error: str = ""
    retry_after_ms: float = 0.0
    shed: bool = False


_schema(VerifyBlockResponse, (1, "seq", UINT64), (2, "ntx", UINT32),
        (3, "flags", BYTES), (4, "error", STRING),
        (5, "retry_after_ms", DOUBLE), (6, "shed", BOOL))


# the Frame oneof ``kind``: member name -> message class, field number =
# position + 1
MEMBERS = (
    ("verify", VerifyBatchRequest),
    ("verdict", VerifyBatchResponse),
    ("warm", WarmKeysRequest),
    ("warm_resp", WarmKeysResponse),
    ("stats_req", StatsRequest),
    ("stats_resp", StatsResponse),
    ("cert_committee", CertCommitteeRequest),
    ("cert_committee_resp", CertCommitteeResponse),
    ("cert", CertBatchRequest),
    ("warm_state_req", WarmStateRequest),
    ("warm_state_resp", WarmStateResponse),
    ("verify_block", VerifyBlockRequest),
    ("block_verdict", VerifyBlockResponse),
)
_MEMBER_CLASS = dict(MEMBERS)
_MEMBER_NUM = {name: i + 1 for i, (name, _) in enumerate(MEMBERS)}
_MEMBER_TAG = {name: _varint(num << 3 | _WT_LEN)
               for name, num in _MEMBER_NUM.items()}


class Frame:
    """One frame: ``kind`` names the oneof member set (``None``: none),
    ``msg`` holds it. ``Frame(verify=req)`` sets a member;
    ``Frame(kind="stats_req")`` sets an empty one."""

    __slots__ = ("kind", "msg")

    def __init__(self, kind: Optional[str] = None, msg=None, **member):
        if member:
            if kind is not None or msg is not None or len(member) != 1:
                raise TypeError("Frame takes one member")
            ((kind, msg),) = member.items()
        if kind is not None:
            cls = _MEMBER_CLASS.get(kind)
            if cls is None:
                raise ValueError(f"Frame has no member {kind!r}")
            if msg is None:
                msg = cls()
            elif type(msg) is not cls:
                raise TypeError(f"Frame.{kind} takes a {cls.__name__}")
        elif msg is not None:
            raise TypeError("a Frame message needs its kind")
        self.kind = kind
        self.msg = msg

    def __eq__(self, other) -> bool:
        return (isinstance(other, Frame) and self.kind == other.kind
                and self.msg == other.msg)

    def __repr__(self) -> str:
        if self.kind is None:
            return "Frame()"
        return f"Frame({self.kind}={self.msg!r})"


def _member(name: str):
    return property(lambda self: self.msg if self.kind == name else None,
                    doc=f"The {name} member, or None when another is set.")


for _name, _ in MEMBERS:
    setattr(Frame, _name, _member(_name))

MESSAGES = tuple(cls for _, cls in MEMBERS) + (VerifyLane, BlockLaneMsg,
                                               BlockPolicyMsg, Frame)


# ---- encode ---------------------------------------------------------------

def _uint(v, f: _Field) -> int:
    if not isinstance(v, int):
        raise TypeError(f"{f.name}: {type(v).__name__} for {f.kind}")
    if not 0 <= v <= _MAX[f.kind]:
        raise ValueError(f"{f.name}: {v} out of {f.kind} range")
    return int(v)


def _blob(v, f: _Field) -> bytes:
    if f.kind == STRING:
        if not isinstance(v, str):
            raise TypeError(f"{f.name}: {type(v).__name__} for string")
        return v.encode("utf-8")
    if isinstance(v, str):
        raise TypeError(f"{f.name}: str for bytes")
    return bytes(v)


def _encode_parts(msg, parts: list) -> None:
    for f in msg._FIELDS:
        v = getattr(msg, f.name)
        kind = f.kind
        if not v and kind is not DOUBLE:  # implicit presence (-0.0 is kept)
            continue
        tag = f.tag
        if kind is BYTES and not f.repeated:
            b = v if type(v) is bytes else _blob(v, f)
            n = len(b)
            parts += (tag, _SMALL[n] if n < 0x80 else _varint(n), b)
        elif f.repeated:
            if kind is MESSAGE:
                for item in v:
                    data = encode(item)
                    parts += (tag, _varint(len(data)), data)
            elif kind is UINT32:  # packed
                body = b"".join(_varint(_uint(x, f)) for x in v)
                parts += (tag, _varint(len(body)), body)
            else:
                for item in v:
                    b = _blob(item, f)
                    parts += (tag, _varint(len(b)), b)
        elif kind is STRING:
            b = _blob(v, f)
            parts += (tag, _varint(len(b)), b)
        elif kind is DOUBLE:
            b = _D.pack(v)
            if b != _ZERO8:
                parts += (tag, b)
        elif kind is BOOL:
            parts += (tag, b"\x01")
        else:
            parts += (tag, _varint(_uint(v, f)))


def encode(msg) -> bytes:
    """The proto3 bytes of a message or a :class:`Frame`, as protobuf's
    ``SerializeToString`` writes them."""
    if isinstance(msg, Frame):
        if msg.kind is None:
            return b""
        data = encode(msg.msg)
        return b"".join((_MEMBER_TAG[msg.kind], _varint(len(data)), data))
    parts: list = []
    _encode_parts(msg, parts)
    return b"".join(parts)


# ---- decode ---------------------------------------------------------------

def _decode_into(msg, buf: bytes, pos: int, end: int) -> None:
    by_num = msg._BY_NUM
    while pos < end:
        key = buf[pos]
        if key < 0x80:
            pos += 1
        else:
            key, pos = _read_varint(buf, pos, end)
        num, wt = key >> 3, key & 7
        if num == 0:
            raise DecodeError("field number 0")
        f = by_num.get(num)
        if f is None or (wt != f.wt and not (
                f.repeated and f.kind is UINT32 and wt == _WT_VARINT)):
            # unknown, or a known field under another wire type
            pos = _skip(buf, pos, end, num, wt)
            continue
        kind = f.kind
        if wt == _WT_LEN:
            n = buf[pos] if pos < end else 0x80
            if n < 0x80:
                pos += 1
            else:
                n, pos = _read_varint(buf, pos, end)
            stop = pos + n
            if stop > end:
                raise DecodeError(f"{f.name}: truncated")
            if kind is BYTES:
                v = buf[pos:stop]
            elif kind is STRING:
                try:
                    v = buf[pos:stop].decode("utf-8")
                except UnicodeDecodeError as exc:
                    raise DecodeError(f"{f.name}: invalid UTF-8") from exc
            elif kind is MESSAGE:  # repeated: only Frame holds a single one
                v = f.sub()
                _decode_into(v, buf, pos, stop)
            else:  # packed uint32
                out = getattr(msg, f.name)
                while pos < stop:
                    x, pos = _read_varint(buf, pos, stop)
                    out.append(x & 0xFFFFFFFF)
                continue
            pos = stop
        elif wt == _WT_I64:
            if pos + 8 > end:
                raise DecodeError(f"{f.name}: truncated")
            v = _D.unpack_from(buf, pos)[0]
            pos += 8
        else:
            x, pos = _read_varint(buf, pos, end)
            v = (x != 0 if kind is BOOL
                 else x & 0xFFFFFFFF if kind is UINT32 else x)
        if f.repeated:
            getattr(msg, f.name).append(v)
        else:
            setattr(msg, f.name, v)


def _decode_frame(buf: bytes) -> Frame:
    frame = Frame()
    pos, end = 0, len(buf)
    while pos < end:
        key, pos = _read_varint(buf, pos, end)
        num, wt = key >> 3, key & 7
        if num == 0:
            raise DecodeError("field number 0")
        if wt != _WT_LEN or not 1 <= num <= len(MEMBERS):
            pos = _skip(buf, pos, end, num, wt)
            continue
        n, pos = _read_varint(buf, pos, end)
        stop = pos + n
        if stop > end:
            raise DecodeError("Frame: truncated")
        name, cls = MEMBERS[num - 1]
        if frame.kind != name:
            # a new member replaces the one set; the same one again merges
            frame.kind, frame.msg = name, cls()
        _decode_into(frame.msg, buf, pos, stop)
        pos = stop
    return frame


def decode(data, cls=Frame):
    """Parse proto3 bytes into ``cls`` (default :class:`Frame`); raises
    :class:`DecodeError` on bytes protobuf would refuse."""
    buf = data if type(data) is bytes else bytes(data)
    if cls is Frame:
        return _decode_frame(buf)
    msg = cls()
    _decode_into(msg, buf, 0, len(buf))
    return msg
