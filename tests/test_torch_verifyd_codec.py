"""The port's hand-written ``verifyd`` frame codec against protobuf.

``bdls_tpu_torch/sidecar/verifyd_codec.py`` must write the bytes that
the reference's ``verifyd_pb2`` (protobuf) writes, byte for byte, and
each side must parse the other's bytes to the same fields. For each of
the 17 message types: the defaults, seeded random messages and the
edge cases (-0.0, inf and NaN doubles, 2^64 - 1 and 2^32 - 1, empty and
long ``bytes``, non-ASCII strings, ``orgs`` empty and long); every
oneof member empty; an 8192-lane frame. Then the decoder's rules, each
held against what protobuf does with the same bytes: unpacked ``orgs``,
unknown fields of every wire type, a known field under another wire
type, a scalar twice, a repeated field split, two oneof members, one
member twice, bad UTF-8, every truncation of an encoding, and seeded
byte mutations of valid encodings. Last, ``wire``'s framing (and its
drain of an oversized payload) against the reference's ``wire``.
"""

from __future__ import annotations

import asyncio
import math
import random
import socket
import struct

import pytest
from google.protobuf.message import DecodeError as PbDecodeError

from bdls_tpu.sidecar import verifyd_pb2 as pb
from bdls_tpu.sidecar import wire as jwire
from bdls_tpu_torch.sidecar import verifyd_codec as C
from bdls_tpu_torch.sidecar import wire

CLASSES = {cls.__name__: cls for cls in C.MESSAGES}
MEMBER_NAMES = [name for name, _ in C.MEMBERS]


# ---- the two sides under one view -------------------------------------------

def to_pb(msg):
    """The protobuf message holding the same fields as a port message."""
    if isinstance(msg, C.Frame):
        out = pb.Frame()
        if msg.kind is not None:
            sub = getattr(out, msg.kind)
            sub.SetInParent()
            sub.MergeFrom(to_pb(msg.msg))
        return out
    out = getattr(pb, type(msg).__name__)()
    for f in msg._FIELDS:
        v = getattr(msg, f.name)
        if f.repeated and f.kind == C.MESSAGE:
            for item in v:
                getattr(out, f.name).add().MergeFrom(to_pb(item))
        elif f.repeated:
            getattr(out, f.name).extend(v)
        else:
            setattr(out, f.name, v)
    return out


def _scalar(kind, v):
    # doubles by bit pattern, so -0.0 and NaN compare exactly
    return struct.pack("<d", v) if kind == C.DOUBLE else v


def view_port(msg):
    if isinstance(msg, C.Frame):
        return ("Frame", msg.kind,
                None if msg.kind is None else view_port(msg.msg))
    out = {}
    for f in msg._FIELDS:
        v = getattr(msg, f.name)
        if f.repeated and f.kind == C.MESSAGE:
            out[f.name] = [view_port(x) for x in v]
        elif f.repeated:
            out[f.name] = [bytes(x) if f.kind == C.BYTES else x for x in v]
        else:
            out[f.name] = (bytes(v) if f.kind == C.BYTES
                           else _scalar(f.kind, v))
    return out


def view_pb(msg, cls):
    if cls is C.Frame:
        kind = msg.WhichOneof("kind")
        return ("Frame", kind, None if kind is None else view_pb(
            getattr(msg, kind), C.MEMBERS[MEMBER_NAMES.index(kind)][1]))
    out = {}
    for f in cls._FIELDS:
        v = getattr(msg, f.name)
        if f.repeated and f.kind == C.MESSAGE:
            out[f.name] = [view_pb(x, f.sub) for x in v]
        elif f.repeated:
            out[f.name] = list(v)
        else:
            out[f.name] = _scalar(f.kind, v)
    return out


def pb_parse(cls, raw):
    """(ok, view) of protobuf's parse of ``raw``."""
    msg = getattr(pb, cls.__name__)()
    try:
        msg.ParseFromString(raw)
    except PbDecodeError:
        return False, None
    return True, view_pb(msg, cls)


def port_parse(cls, raw):
    try:
        return True, view_port(C.decode(raw, cls))
    except C.DecodeError:
        return False, None


def assert_same_bytes_and_fields(msg):
    cls = type(msg)
    ours = C.encode(msg)
    theirs = to_pb(msg).SerializeToString()
    assert ours == theirs, (msg, ours.hex(), theirs.hex())
    # each side parses the other's bytes to the same fields
    assert port_parse(cls, theirs) == (True, view_port(msg))
    assert pb_parse(cls, ours) == (True, view_port(msg))


# ---- seeded messages ----------------------------------------------------------

STRINGS = ["", "P-256", "secp256k1", "ed25519", "tenant-ü", "通道-7",
           "emoji 🛰", "\x00nul", "x" * 300]
BYTES_LENS = [0, 1, 31, 32, 33, 64, 200, 1153]
UINT32S = [0, 1, 127, 128, 300, 16383, 16384, (1 << 31), (1 << 32) - 1]
UINT64S = [0, 1, 127, 128, (1 << 32), (1 << 63), (1 << 64) - 1]
DOUBLES = [0.0, -0.0, 1.0, -1.5, 5000.0, 1e-310, 2.0 ** 1023,
           math.inf, -math.inf, math.nan]


def rand_value(f, rng: random.Random):
    kind = f.kind
    if kind == C.STRING:
        return rng.choice(STRINGS)
    if kind == C.BYTES:
        return rng.randbytes(rng.choice(BYTES_LENS))
    if kind == C.UINT32:
        return rng.choice(UINT32S + [rng.randrange(1 << 32)])
    if kind == C.UINT64:
        return rng.choice(UINT64S + [rng.randrange(1 << 64)])
    if kind == C.BOOL:
        return rng.random() < 0.5
    if kind == C.DOUBLE:
        return rng.choice(DOUBLES + [rng.uniform(-1e6, 1e6)])
    return rand_msg(f.sub, rng)


def rand_msg(cls, rng: random.Random):
    if cls is C.Frame:
        kind = rng.choice(MEMBER_NAMES + [None])
        if kind is None:
            return C.Frame()
        return C.Frame(kind, rand_msg(C.MEMBERS[MEMBER_NAMES.index(kind)][1],
                                      rng))
    vals = {}
    for f in cls._FIELDS:
        if rng.random() < 0.25:
            continue  # the default
        if f.repeated:
            n = rng.choice([0, 1, 2, 5] + ([40] if f.kind == C.UINT32
                                           else []))
            vals[f.name] = [rand_value(f, rng) for _ in range(n)]
        else:
            vals[f.name] = rand_value(f, rng)
    return cls(**vals)


@pytest.mark.parametrize("name", sorted(CLASSES))
def test_defaults_encode_to_nothing(name):
    cls = CLASSES[name]
    assert C.encode(cls()) == b""
    assert_same_bytes_and_fields(cls())


@pytest.mark.parametrize("name", sorted(CLASSES))
def test_seeded_messages_match_protobuf(name):
    cls = CLASSES[name]
    rng = random.Random(f"verifyd-codec-{name}")
    for _ in range(60):
        assert_same_bytes_and_fields(rand_msg(cls, rng))


@pytest.mark.parametrize("kind", MEMBER_NAMES)
def test_empty_oneof_member_is_written(kind):
    frame = C.Frame(kind=kind)
    raw = C.encode(frame)
    assert raw == bytes(((MEMBER_NAMES.index(kind) + 1) << 3 | 2, 0))
    assert_same_bytes_and_fields(frame)
    back = C.decode(raw)
    assert back.kind == kind and getattr(back, kind) == frame.msg
    for other in MEMBER_NAMES:
        if other != kind:
            assert getattr(back, other) is None


EDGE_CASES = {
    "deadline -0.0 is written": (
        C.Frame(verify=C.VerifyBatchRequest(deadline_ms=-0.0)),
        "0a09210000000000000080"),
    "deadline 0.0 is not": (
        C.Frame(verify=C.VerifyBatchRequest(deadline_ms=0.0)), "0a00"),
    "seq 2^64 - 1, a 10-byte varint": (
        C.Frame(verify=C.VerifyBatchRequest(seq=(1 << 64) - 1)),
        "0a0b08ffffffffffffffffff01"),
    "stats request": (C.Frame(kind="stats_req"), "2a00"),
    "orgs packed": (C.BlockPolicyMsg(required=2, orgs=[1, 2, 300]),
                    "080212040102ac02"),
    "lane_hint 2^32 - 1": (
        C.VerifyBatchRequest(lane_hint=(1 << 32) - 1), "30ffffffff0f"),
    "retry inf, shed": (
        C.VerifyBatchResponse(retry_after_ms=math.inf, shed=True),
        "29000000000000f07f3001"),
    "retry NaN": (C.VerifyBlockResponse(retry_after_ms=math.nan),
                  "29000000000000f87f"),
    "non-ASCII tenant": (C.WarmStateRequest(tenant="tenant-ü"),
                         "0a097465" + "6e616e742dc3bc"),
    "empty bytes in a repeated field are written": (
        C.WarmKeysRequest(pubs=[b"", b"\x01"]), "1a001a0101"),
    "empty orgs": (C.BlockPolicyMsg(required=1, orgs=[]), "0801"),
}


@pytest.mark.parametrize("case", sorted(EDGE_CASES))
def test_edge_cases(case):
    msg, want = EDGE_CASES[case]
    assert C.encode(msg).hex() == want
    assert_same_bytes_and_fields(msg)


def test_long_repeated_and_wide_fields():
    rng = random.Random(7)
    assert_same_bytes_and_fields(C.BlockPolicyMsg(
        required=3, orgs=[rng.randrange(1 << 32) for _ in range(2000)]))
    assert_same_bytes_and_fields(C.CertCommitteeRequest(
        tenant="t", committee="c", quorum=85,
        pks=[rng.randbytes(1153) for _ in range(128)]))
    assert_same_bytes_and_fields(C.StatsResponse(json="{}" * 40000))


def test_8192_lane_frame():
    rng = random.Random(8192)
    lanes = [C.VerifyLane(curve=rng.choice(["P-256", "secp256k1"]),
                          pub_x=rng.randbytes(32), pub_y=rng.randbytes(32),
                          digest=rng.randbytes(32), sig_r=rng.randbytes(32),
                          sig_s=rng.randbytes(rng.choice([32, 33])))
             for _ in range(8192)]
    frame = C.Frame(verify=C.VerifyBatchRequest(
        seq=12, tenant="firehose", traceparent="00-" + "a" * 32 + "-"
        + "b" * 16 + "-01", deadline_ms=5000.0, lanes=lanes, lane_hint=0))
    raw = C.encode(frame)
    assert raw == to_pb(frame).SerializeToString()
    assert len(raw) > 1 << 20
    assert C.decode(raw) == frame


# ---- the decoder's rules, against protobuf on the same bytes ----------------

def both(cls, raw):
    got, want = port_parse(cls, raw), pb_parse(cls, raw)
    assert got == want, (cls.__name__, raw.hex(), got, want)
    return got


def test_unpacked_and_split_orgs():
    assert C.decode(bytes.fromhex("0802100110021003"),
                    C.BlockPolicyMsg).orgs == [1, 2, 3]
    both(C.BlockPolicyMsg, bytes.fromhex("0802100110021003"))
    # packed and unpacked runs append in order
    ok, view = both(C.BlockPolicyMsg, bytes.fromhex("12020102100312020405"))
    assert ok and view["orgs"] == [1, 2, 3, 4, 5]
    # a varint over 32 bits keeps its low 32, as protobuf does
    both(C.BlockPolicyMsg, bytes.fromhex("10ffffffffff01"))


@pytest.mark.parametrize("unknown", [
    "c00101",                  # field 24, varint
    "c9010102030405060708",    # field 25, fixed64
    "d20103616263",            # field 26, length-delimited
    "dd0101020304",            # field 27, fixed32
    "e301e801" "05" "e401",    # field 28, a group holding a varint
])
def test_unknown_fields_are_skipped(unknown):
    body = bytes.fromhex("0a05502d323536" + unknown + "2201ff")
    ok, view = both(C.VerifyLane, body)
    assert ok and view["curve"] == "P-256" and view["digest"] == b"\xff"
    frame = bytes.fromhex(unknown) + bytes.fromhex("2a00")
    assert both(C.Frame, frame)[1][1] == "stats_req"


@pytest.mark.parametrize("raw", [
    "0801",        # curve (a string) as a varint
    "1101020304050607082203616263",  # pub_x as fixed64, then digest
    "0d01020304",  # curve as fixed32
    "0a0b",        # a Frame member as a varint
])
def test_known_field_under_another_wire_type_is_skipped(raw):
    cls = C.Frame if raw == "0a0b" else C.VerifyLane
    both(cls, bytes.fromhex(raw))


def test_last_value_wins_repeated_appends_oneof_last_member():
    # seq twice: the last value
    ok, view = both(C.VerifyBatchRequest, bytes.fromhex("08010802"))
    assert view["seq"] == 2
    # a repeated message field split by another field appends
    ok, view = both(C.VerifyBatchRequest,
                    bytes.fromhex("2a020a00" "0801" "2a03120101"))
    assert len(view["lanes"]) == 2 and view["lanes"][1]["pub_x"] == b"\x01"
    # two oneof members: the last one wins
    ok, view = both(C.Frame, bytes.fromhex("0a020801" "2a00"))
    assert view[1] == "stats_req"
    # the same member twice merges: scalars from the second, lanes appended
    ok, view = both(C.Frame, bytes.fromhex("0a060801" "2a020a00"
                                           "0a0512017a" "2a00"))
    assert view[1] == "verify"
    assert view[2]["seq"] == 1 and view[2]["tenant"] == "z"
    assert len(view[2]["lanes"]) == 2


@pytest.mark.parametrize("cls,raw", [
    (C.VerifyLane, "0a02fffe"),
    (C.VerifyBatchRequest, "1201c0"),
    (C.StatsResponse, "0a03eda080"),   # a UTF-16 surrogate
    (C.Frame, "3a0412020a80"),         # cert_committee.committee, nested
])
def test_bad_utf8_raises_on_both_sides(cls, raw):
    with pytest.raises(C.DecodeError):
        C.decode(bytes.fromhex(raw), cls)
    assert pb_parse(cls, bytes.fromhex(raw)) == (False, None)


@pytest.mark.parametrize("name", sorted(CLASSES))
def test_every_truncation_parses_as_protobuf_does(name):
    cls = CLASSES[name]
    rng = random.Random(f"truncate-{name}")
    for _ in range(4):
        raw = C.encode(rand_msg(cls, rng))
        for cut in range(len(raw)):
            both(cls, raw[:cut])
    with pytest.raises(C.DecodeError):
        C.decode(bytes.fromhex("0a0b08ff"))  # a member cut short


@pytest.mark.parametrize("name", ["Frame", "VerifyBatchRequest",
                                  "VerifyBlockRequest", "WarmStateResponse",
                                  "BlockPolicyMsg"])
def test_mutated_encodings_parse_as_protobuf_does(name):
    cls = CLASSES[name]
    rng = random.Random(f"mutate-{name}")
    for _ in range(150):
        raw = bytearray(C.encode(rand_msg(cls, rng)) or b"\x08\x01")
        for _ in range(rng.choice([1, 2, 4])):
            i = rng.randrange(len(raw))
            raw[i] = rng.choice([rng.randrange(256), raw[i] ^ 0x80,
                                 raw[i] ^ 0x07, 0x00, 0xff])
        both(cls, bytes(raw))


def test_frame_api():
    req = C.VerifyBatchRequest(seq=3)
    frame = C.Frame(verify=req)
    assert frame.kind == "verify" and frame.verify is req
    assert frame.verdict is None and frame.msg is req
    assert C.Frame().kind is None and C.encode(C.Frame()) == b""
    with pytest.raises(ValueError):
        C.Frame(kind="nope")
    with pytest.raises(TypeError):
        C.Frame(verify=C.VerifyBatchResponse())
    with pytest.raises(ValueError):
        C.encode(C.VerifyBatchRequest(lane_hint=1 << 32))
    with pytest.raises(ValueError):
        C.encode(C.VerifyBatchRequest(seq=-1))
    with pytest.raises(TypeError):
        C.encode(C.VerifyLane(curve=b"P-256"))


# ---- wire: the framing, against the reference's -----------------------------

def _sample_frame():
    rng = random.Random(11)
    return C.Frame(verify=C.VerifyBatchRequest(
        seq=9, tenant="t", lane_hint=85, deadline_ms=-0.0,
        lanes=[C.VerifyLane("secp256k1", rng.randbytes(32), rng.randbytes(32),
                            rng.randbytes(32), rng.randbytes(32),
                            rng.randbytes(32)) for _ in range(5)]))


def test_encode_frame_equals_the_reference():
    frame = _sample_frame()
    ours = wire.encode_frame(frame)
    assert ours == jwire.encode_frame(to_pb(frame))
    assert wire.MAX_FRAME == jwire.MAX_FRAME
    assert struct.unpack("<I", ours[:4])[0] == len(ours) - 4


def _oversized_then(frame_bytes: bytes) -> bytes:
    length = wire.MAX_FRAME + 1
    return struct.pack("<I", length) + b"\x00" * length + frame_bytes


@pytest.mark.parametrize("side", ["port", "reference"])
def test_recv_frame_drains_an_oversized_payload(side):
    mod = wire if side == "port" else jwire
    frame = _sample_frame()
    a, b = socket.socketpair()
    try:
        data = _oversized_then(wire.encode_frame(frame))
        import threading

        t = threading.Thread(target=a.sendall, args=(data,))
        t.start()
        with pytest.raises(mod.OversizedFrame) as exc:
            mod.recv_frame(b)
        assert exc.value.length == wire.MAX_FRAME + 1
        got = mod.recv_frame(b)  # the stream is still framed
        t.join()
        if side == "port":
            assert got == frame
        else:
            assert got.SerializeToString() == C.encode(frame)
        a.close()
        with pytest.raises(mod.WireError):
            mod.recv_frame(b)
    finally:
        a.close()
        b.close()


def test_read_frame_async_drain_and_eof():
    frame = _sample_frame()

    async def run():
        reader = asyncio.StreamReader(limit=1 << 26)
        reader.feed_data(_oversized_then(wire.encode_frame(frame)))
        reader.feed_data(wire.encode_frame(C.Frame(kind="stats_req")))
        reader.feed_data(b"\x05\x00")
        reader.feed_eof()
        with pytest.raises(wire.OversizedFrame):
            await wire.read_frame(reader)
        assert await wire.read_frame(reader) == frame
        assert (await wire.read_frame(reader)).kind == "stats_req"
        with pytest.raises(wire.WireError):
            await wire.read_frame(reader)

    asyncio.run(run())
