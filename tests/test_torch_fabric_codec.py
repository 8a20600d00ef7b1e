"""The port's hand-written ordering codec against protobuf.

``bdls_tpu_torch/ordering/fabric_codec.py`` must write the bytes that
the reference's ``fabric_pb2`` (protobuf) writes, byte for byte, and
accept and refuse what it accepts and refuses. Hypothesis builds random
messages of each of the 17 types and applies the same field operations
to both sides (the two share the message surface), then holds the
serializations equal and each side's parse of the other's bytes equal.
Named cases cover each trouble spot: invalid UTF-8 in a ``string``,
empty submessages that were touched against ones only read, -0.0 and
NaN doubles, ``uint64`` up to 2^64 - 1, enum values the schema does not
name, unknown fields kept and written back (through ``CopyFrom`` too),
and the ``add()``/``CopyFrom`` surface the ordering and peer layers
call. Garbage, truncated and mutated inputs are refused exactly when
protobuf refuses them, and what both accept re-serializes to the same
bytes. Every comparison is exact.
"""

from __future__ import annotations

import math
import random
import struct

import pytest
from google.protobuf.message import DecodeError as PbDecodeError
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from bdls_tpu.ordering import fabric_pb2 as pb
from bdls_tpu_torch.ordering import fabric_codec as C

NAMES = [cls.__name__ for cls in C.MESSAGES]
SETTINGS = settings(max_examples=60, deadline=None,
                    suppress_health_check=[HealthCheck.too_slow])


# ---- random messages, applied to both sides ---------------------------------

def _scalar_strategy(kind):
    if kind == C.ENUM:
        return st.one_of(st.sampled_from([0, 1]),
                         st.integers(-(1 << 31), (1 << 31) - 1))
    if kind == C.INT64:
        return st.integers(-(1 << 63), (1 << 63) - 1)
    if kind == C.UINT32:
        return st.integers(0, (1 << 32) - 1)
    if kind == C.UINT64:
        return st.integers(0, (1 << 64) - 1)
    if kind == C.BOOL:
        return st.booleans()
    if kind == C.DOUBLE:
        return st.floats(allow_nan=False)
    if kind == C.STRING:
        return st.text(max_size=12)
    return st.binary(max_size=40)


def spec_strategy(cls, depth=0):
    """A list of (field, value) operations: a scalar value, a list for a
    repeated field, a sub-spec (or None: SetInParent) for a message."""
    items = []
    for f in cls.FIELDS:
        if f.kind == C.MESSAGE:
            sub = spec_strategy(f.cls, depth + 1)
            if f.repeated:
                val = st.lists(sub, max_size=3)
            else:
                val = st.one_of(st.none(), sub)
        elif f.repeated:
            val = st.lists(_scalar_strategy(f.kind), max_size=4)
        else:
            val = _scalar_strategy(f.kind)
        items.append(st.one_of(st.just(None), st.tuples(st.just(f.name),
                                                           val)))
    return st.lists(st.one_of(*items), max_size=len(cls.FIELDS) + 2).map(
        lambda ops: [op for op in ops if op is not None])


def apply(msg, spec):
    """Apply ``spec`` to ``msg`` (a port or a protobuf message)."""
    fields = {f.name: f for f in C.MESSAGES[
        NAMES.index(type(msg).__name__)].FIELDS}
    for name, val in spec:
        f = fields[name]
        if f.kind == C.MESSAGE and f.repeated:
            for sub in val:
                apply(getattr(msg, name).add(), sub)
        elif f.kind == C.MESSAGE:
            child = getattr(msg, name)
            if val is None or not val:
                child.SetInParent()
            else:
                apply(child, val)
        elif f.repeated:
            getattr(msg, name).extend(val)
        else:
            setattr(msg, name, val)


def pair(name, spec):
    a, b = getattr(C, name)(), getattr(pb, name)()
    apply(a, spec)
    apply(b, spec)
    return a, b


def parse_both(name, data):
    """(port result, protobuf result): the re-serialized bytes, or
    ``"refused"``."""
    out = []
    for mod, err in ((C, C.DecodeError), (pb, PbDecodeError)):
        m = getattr(mod, name)()
        try:
            m.ParseFromString(data)
        except (err, ValueError) as exc:
            if mod is pb:
                assert isinstance(exc, PbDecodeError), exc
            out.append("refused")
            continue
        out.append(m.SerializeToString())
    return tuple(out)


@st.composite
def message_spec(draw):
    name = draw(st.sampled_from(NAMES))
    return name, draw(spec_strategy(getattr(C, name)))


@SETTINGS
@given(message_spec())
def test_round_trip_byte_for_byte(case):
    name, spec = case
    a, b = pair(name, spec)
    data = b.SerializeToString()
    assert a.SerializeToString() == data
    assert a.ByteSize() == b.ByteSize()
    back = getattr(C, name).FromString(data)
    assert back == a
    assert back.SerializeToString() == data
    assert getattr(pb, name).FromString(a.SerializeToString()) == b


@SETTINGS
@given(message_spec(), st.binary(max_size=30))
def test_unknown_fields_kept_and_written_back(case, tail):
    name, spec = case
    _, b = pair(name, spec)
    # a well-formed unknown field (number 15, bytes) and garbage after it
    unk = b"\x7a" + bytes([len(tail)]) + tail
    data = b.SerializeToString() + unk
    got = parse_both(name, data)
    assert got[0] == got[1] != "refused"
    m = getattr(C, name)()
    m.CopyFrom(getattr(C, name).FromString(data))
    assert m.SerializeToString() == got[1]


@SETTINGS
@given(st.sampled_from(NAMES), st.binary(max_size=64))
def test_garbage_refused_exactly_when_protobuf_refuses(name, data):
    got = parse_both(name, data)
    assert got[0] == got[1]


@SETTINGS
@given(message_spec(), st.data())
def test_truncated_and_mutated_encodings(case, data):
    name, spec = case
    _, b = pair(name, spec)
    enc = b.SerializeToString()
    if not enc:
        return
    cut = data.draw(st.integers(0, len(enc) - 1))
    got = parse_both(name, enc[:cut])
    assert got[0] == got[1]
    i = data.draw(st.integers(0, len(enc) - 1))
    v = data.draw(st.integers(0, 255))
    mutated = enc[:i] + bytes([v]) + enc[i + 1:]
    got = parse_both(name, mutated)
    assert got[0] == got[1]


def test_every_truncation_of_a_block():
    blk = pb.Block()
    blk.header.number = 7
    blk.header.previous_hash = b"\x01" * 32
    blk.data.transactions.extend([b"\x0a\x02\x08\x01", b"", b"x" * 300])
    blk.metadata.entries.extend([b"", b"\x05", b""])
    enc = blk.SerializeToString()
    for cut in range(len(enc) + 1):
        got = parse_both("Block", enc[:cut])
        assert got[0] == got[1], cut


# ---- the trouble spots ------------------------------------------------------

@pytest.mark.parametrize("bad", ["fffe", "eda080", "c0af", "f4908080", "80",
                                 "e282", "edbfbf"])
def test_invalid_utf8_string_refused(bad):
    raw = bytes.fromhex(bad)
    hdr = b"\x1a" + bytes([len(raw)]) + raw   # TxHeader.tx_id
    env = b"\x0a" + bytes([len(hdr)]) + hdr   # TxEnvelope.header
    assert parse_both("TxEnvelope", env) == ("refused", "refused")
    assert parse_both("TxHeader", hdr) == ("refused", "refused")
    # the same bytes in a ``bytes`` field are fine
    ok = b"\x22" + bytes([len(raw)]) + raw    # TxHeader.creator_x
    assert parse_both("TxHeader", ok)[0] == ok


def test_touched_empty_submessage_is_written():
    for mod in (C, pb):
        b = mod.Block()
        b.metadata.SetInParent()
        assert b.SerializeToString() == b"\x1a\x00"
        b = mod.Block()
        b.header.number = 0
        assert b.SerializeToString() == b"\x0a\x00"
        assert b.HasField("header") and not b.HasField("data")
        b = mod.Block()
        _ = b.header.number
        _ = b.data.transactions
        assert b.SerializeToString() == b""
        assert not b.HasField("header")
        assert mod.EndorsedAction().SerializeToString() == b""
        e = mod.EndorsedAction()
        e.read_set.reads.add()
        assert e.SerializeToString() == b"\x22\x02\x0a\x00"
        b = mod.Block()
        b.data.transactions.append(b"")
        assert b.SerializeToString() == b"\x12\x02\x0a\x00"
        b = mod.Block()
        b.header.CopyFrom(mod.BlockHeader())
        assert b.SerializeToString() == b"\x0a\x00"
        b.ClearField("header")
        assert b.SerializeToString() == b""
    # presence survives a parse and a copy
    m = C.Block.FromString(b"\x0a\x00\x1a\x00")
    assert m.HasField("header") and m.HasField("metadata")
    c = C.Block()
    c.CopyFrom(m)
    assert c.SerializeToString() == b"\x0a\x00\x1a\x00"
    assert c != C.Block() and pb.Block.FromString(b"\x0a\x00") != pb.Block()


@pytest.mark.parametrize("v", [0.0, -0.0, 1.5, -2.25, math.inf, -math.inf,
                               math.nan, 5e-324, 1.7976931348623157e308])
def test_double_is_little_endian_fixed64(v):
    a, b = C.ChannelConfig(), pb.ChannelConfig()
    a.batch_timeout_s = v
    b.batch_timeout_s = v
    a.consensus_latency_s = 3          # an int is taken as a double
    b.consensus_latency_s = 3
    assert a.SerializeToString() == b.SerializeToString()
    assert struct.pack("<d", v) in a.SerializeToString() or \
        struct.pack("<d", v) == b"\x00" * 8
    back = C.ChannelConfig.FromString(b.SerializeToString())
    assert struct.pack("<d", back.batch_timeout_s) == \
        struct.pack("<d", pb.ChannelConfig.FromString(
            b.SerializeToString()).batch_timeout_s)


@pytest.mark.parametrize("field,v", [
    ("number", (1 << 64) - 1), ("number", 1 << 63), ("number", 1)])
def test_uint64_full_range(field, v):
    a, b = C.BlockHeader(), pb.BlockHeader()
    setattr(a, field, v)
    setattr(b, field, v)
    assert a.SerializeToString() == b.SerializeToString()
    assert C.BlockHeader.FromString(b.SerializeToString()).number == v
    for bad in (-1, 1 << 64):
        with pytest.raises(ValueError):
            setattr(C.BlockHeader(), field, bad)
        with pytest.raises(ValueError):
            setattr(pb.BlockHeader(), field, bad)


@pytest.mark.parametrize("v", [2, 7, -1, -(1 << 31), (1 << 31) - 1])
def test_enum_values_the_schema_does_not_name(v):
    a, b = C.TxHeader(), pb.TxHeader()
    a.type = v
    b.type = v
    assert a.SerializeToString() == b.SerializeToString()
    assert C.TxHeader.FromString(b.SerializeToString()).type == \
        pb.TxHeader.FromString(b.SerializeToString()).type == v
    for bad in (1 << 31, -(1 << 31) - 1):
        with pytest.raises(ValueError):
            C.TxHeader().type = bad
        with pytest.raises(ValueError):
            pb.TxHeader().type = bad
    assert C.TxType.TX_CONFIG == pb.TxType.TX_CONFIG == C.TX_CONFIG
    assert C.TxType.Name(1) == pb.TxType.Name(1)
    with pytest.raises(ValueError):
        C.TxType.Name(v if v not in (0, 1) else 9)


@pytest.mark.parametrize("raw", [
    "18ffffffffff01",              # uint32 from a wider varint
    "18ffffffffffffffffff01",      # ten-byte varint
    "1a0105",                      # a varint field under wire type 2
    "0d01020304",                  # a bytes field under wire type 5
    "600163080164",                # unknown varint, then a group
    "09" + "00" * 8,               # bytes field under wire type 1
    "0a0161" + "0a0162",           # a field seen twice
])
def test_consenter_decoder_rules(raw):
    got = parse_both("Consenter", bytes.fromhex(raw))
    assert got[0] == got[1]


@pytest.mark.parametrize("raw", [
    "0a020801" + "0a021001",       # a submessage seen twice merges
    "0a03f80101",                  # an unknown field inside a submessage
    "1206" + "0a0178" + "0a00",    # repeated bytes split across fields
    "0c",                          # a stray end-group
    "0f",                          # wire type 7
    "00",                          # field number 0
    "0a05" + "0801",               # a length past the end
    "0aff",                        # a truncated length
    "0a8080808010",                # a length above 2^32
    "fa" * 6,                      # a key longer than five bytes
])
def test_block_decoder_rules(raw):
    got = parse_both("Block", bytes.fromhex(raw))
    assert got[0] == got[1]


def test_assignment_checks_match_protobuf():
    cases = [
        ("TxEnvelope", "payload", "x"), ("TxEnvelope", "payload",
                                         bytearray(b"x")),
        ("TxHeader", "tx_id", 3), ("TxHeader", "timestamp_unix_ms", 1.5),
        ("TxHeader", "timestamp_unix_ms", 1 << 63), ("KVWrite", "is_delete",
                                                     "y"),
        ("Consenter", "port", 1 << 32), ("ChannelConfig", "batch_timeout_s",
                                         "1"),
    ]
    for name, field, v in cases:
        errs = []
        for mod in (C, pb):
            try:
                setattr(getattr(mod, name)(), field, v)
                errs.append(None)
            except (TypeError, ValueError) as exc:
                errs.append(type(exc))
        assert errs[0] == errs[1], (name, field, v, errs)
    for mod in (C, pb):
        h = mod.TxHeader()
        h.tx_id = b"ab"                  # UTF-8 bytes into a string
        assert h.tx_id == "ab"
        w = mod.KVWrite()
        w.is_delete = 2
        assert w.is_delete is True
        with pytest.raises(AttributeError):
            mod.Block().header = mod.BlockHeader()
        with pytest.raises(AttributeError):
            mod.BlockData().transactions = [b""]
        with pytest.raises(ValueError):
            mod.TxHeader().HasField("tx_id")


def test_surface_the_ordering_and_peer_layers_call():
    """The calls of ``chain.py``, ``committer.py:apply_private_writes``,
    ``endorser.py`` and ``models/peer.py``, made on both sides."""
    outs = []
    for mod in (C, pb):
        blk = mod.Block()
        blk.header.number = 3
        blk.header.previous_hash = b"p" * 32
        for tx in (b"a", b"bb"):
            blk.data.transactions.append(tx)
        for _ in range(3):
            blk.metadata.entries.append(b"")
        blk.metadata.entries[2] = b"proof"
        proposed = mod.Block()
        proposed.CopyFrom(blk)
        proposed.metadata.entries[2] = b""
        blk.metadata.entries[0] = bytes([0, 2])
        act = mod.EndorsedAction()
        act.proposal_hash = b"h" * 32
        act.contract = "cc"
        rd = act.read_set.reads.add()
        rd.key = "k"
        rd.exists = True
        rd.version_block, rd.version_tx = (2, 5)
        w = act.write_set.writes.add()
        w.key, w.value = "k", b"v"
        w2 = act.write_set.writes.add()
        w2.collection, w2.key, w2.value_hash = "c", "pk", b"\x11" * 32
        e = act.endorsements.add()
        e.org, e.sig_r = "org1", b"\x01"
        other = mod.EndorsedAction()
        other.endorsements.add().org = "org2"
        act.endorsements.extend(other.endorsements)
        public = mod.WriteSet()
        public.writes.add().CopyFrom(w)
        hw = public.writes.add()
        hw.key = "_pvthash/cc/c/pk"
        hw.value = w2.value_hash
        env = mod.TxEnvelope()
        env.header.type = mod.TxType.TX_NORMAL
        env.header.channel_id = "ch"
        env.header.tx_id = "t1"
        env.payload = act.SerializeToString()
        outs.append([blk.SerializeToString(), proposed.SerializeToString(),
                     act.SerializeToString(), public.SerializeToString(),
                     env.SerializeToString(), len(act.endorsements),
                     list(blk.data.transactions),
                     bytes(act.proposal_hash), blk.metadata.entries[0]])
    assert outs[0] == outs[1]


def test_seeded_blocks_of_transactions_parse_alike():
    rng = random.Random(19)
    for _ in range(20):
        blk = pb.Block()
        blk.header.number = rng.randrange(1 << 40)
        blk.header.data_hash = rng.randbytes(32)
        for _ in range(rng.randrange(0, 30)):
            env = pb.TxEnvelope()
            env.header.tx_id = f"tx{rng.randrange(1000)}"
            env.header.timestamp_unix_ms = rng.randrange(-(1 << 40), 1 << 40)
            env.payload = rng.randbytes(rng.randrange(0, 200))
            blk.data.transactions.append(env.SerializeToString())
        blk.metadata.entries.extend([rng.randbytes(rng.randrange(3))
                                     for _ in range(3)])
        data = blk.SerializeToString()
        m = C.Block.FromString(data)
        assert m.SerializeToString() == data
        assert list(m.data.transactions) == list(blk.data.transactions)
        for raw in m.data.transactions:
            assert C.TxEnvelope.FromString(raw).SerializeToString() == raw
