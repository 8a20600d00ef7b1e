"""The port's consensus wire codec against protobuf's ``wire_pb2``.

``bdls_tpu_torch.consensus.wire_codec`` writes ``SignedEnvelope`` and
``ConsensusMessage`` by hand, because the machine that runs the port on
the card has no protobuf. Held here, exactly, against the reference's
generated ``bdls_tpu/consensus/wire_pb2.py``:

- every field, and its default left out, encodes to ``wire_pb2``'s bytes
  and decodes back equal on both sides;
- ``lock_release`` present but empty differs on the wire from absent;
- proofs nested three deep (a <lock-release> carrying a <lock> carrying
  <roundchange>s), ``uint64`` and ``int32`` extremes, enum values the
  schema does not name, unknown fields kept and written back, fields
  seen twice, wire types that do not match, groups, tag lengths;
- byte mutations of real frames: the port refuses exactly where
  ``ParseFromString`` raises, and otherwise decodes to what it decodes
  and writes back its bytes.
"""

from __future__ import annotations

import random

import pytest

from bdls_tpu.consensus import wire_pb2
from bdls_tpu_torch.consensus import wire_codec as W
from bdls_tpu_torch.consensus.identity import SignedEnvelope, Signer
from bdls_tpu_torch.utils.proto3 import varint

U64 = (1 << 64) - 1


# ---- conversions between the two representations ---------------------------

def pb_env(e: SignedEnvelope) -> wire_pb2.SignedEnvelope:
    out = wire_pb2.SignedEnvelope()
    out.ParseFromString(W.encode(e))
    return out


def assert_env_equal(pb, env: SignedEnvelope) -> None:
    assert (pb.version, pb.payload, pb.pub_x, pb.pub_y, pb.sig_r,
            pb.sig_s) == (env.version, env.payload, env.pub_x, env.pub_y,
                          env.sig_r, env.sig_s)
    assert pb.SerializeToString() == W.encode(env)


def assert_msg_equal(pb, m: W.ConsensusMessage) -> None:
    assert (pb.type, pb.height, pb.round, pb.state, pb.vote_sig,
            pb.commit_cert) == (m.type, m.height, m.round, m.state,
                                m.vote_sig, m.commit_cert)
    assert len(pb.proof) == len(m.proof)
    for a, b in zip(pb.proof, m.proof):
        assert_env_equal(a, b)
    assert pb.HasField("lock_release") == (m.lock_release is not None)
    if m.lock_release is not None:
        assert_env_equal(pb.lock_release, m.lock_release)
    assert pb.SerializeToString() == W.encode(m)


def both(raw: bytes, cls):
    """Parse with both; (pb or exception, port or exception)."""
    pb = cls()
    try:
        pb.ParseFromString(raw)
    except Exception as exc:  # noqa: BLE001 - protobuf's DecodeError
        pb = exc
    try:
        port = (W.decode_message if cls is wire_pb2.ConsensusMessage
                else W.decode_envelope)(raw)
    except W.DecodeError as exc:
        port = exc
    return pb, port


def assert_same_parse(raw: bytes, cls) -> bool:
    """Both refuse, or both accept with equal fields and bytes; True
    when accepted."""
    pb, port = both(raw, cls)
    assert isinstance(pb, Exception) == isinstance(port, Exception), (
        raw.hex(), pb, port)
    if isinstance(pb, Exception):
        return False
    if cls is wire_pb2.ConsensusMessage:
        assert_msg_equal(pb, port)
    else:
        assert_env_equal(pb, port)
    return True


@pytest.fixture(scope="module")
def signers():
    return [Signer.from_scalar(0x7000 + i) for i in range(4)]


# ---- fields ---------------------------------------------------------------

ENVELOPES = [
    SignedEnvelope(0),
    SignedEnvelope(1, b"p", b"x" * 32, b"y" * 32, b"r" * 32, b"s" * 32),
    SignedEnvelope(0xFFFFFFFF, b"", b"", b"", b"", b"\0"),
    SignedEnvelope(2, b"\0" * 300, b"\1", b"", b"\xff" * 33, b""),
    SignedEnvelope(128, bytes(range(256)) * 70, b"", b"y", b"", b"s"),
]


@pytest.mark.parametrize("i", range(len(ENVELOPES)))
def test_envelope_fields_encode_as_wire_pb2(i):
    env = ENVELOPES[i]
    pb = wire_pb2.SignedEnvelope(
        version=env.version, payload=env.payload, pub_x=env.pub_x,
        pub_y=env.pub_y, sig_r=env.sig_r, sig_s=env.sig_s)
    assert W.encode(env) == pb.SerializeToString()
    assert W.decode_envelope(pb.SerializeToString()) == env
    assert_same_parse(pb.SerializeToString(), wire_pb2.SignedEnvelope)


def _pb_msg(m: W.ConsensusMessage) -> wire_pb2.ConsensusMessage:
    pb = wire_pb2.ConsensusMessage()
    pb.type = m.type
    pb.height = m.height
    pb.round = m.round
    pb.state = m.state
    for p in m.proof:
        pb.proof.add().CopyFrom(pb_env(p))
    if m.lock_release is not None:
        pb.lock_release.CopyFrom(pb_env(m.lock_release))
    pb.vote_sig = m.vote_sig
    pb.commit_cert = m.commit_cert
    return pb


MESSAGES = [
    W.ConsensusMessage(),
    W.ConsensusMessage(type=W.MsgType.ROUND_CHANGE, height=1, state=b"s"),
    W.ConsensusMessage(type=W.MsgType.RESYNC, height=U64, round=U64),
    W.ConsensusMessage(type=W.MsgType.DECIDE, height=1 << 63, round=127,
                       state=b"b" * 200, proof=ENVELOPES[:3],
                       vote_sig=b"v" * 96, commit_cert=b"c" * 1200),
    W.ConsensusMessage(type=W.MsgType.LOCK_RELEASE,
                       lock_release=ENVELOPES[1]),
    W.ConsensusMessage(type=99, height=5),              # unknown enum value
    W.ConsensusMessage(type=-1),                        # negative int32
    W.ConsensusMessage(type=(1 << 31) - 1),
    W.ConsensusMessage(type=-(1 << 31), round=1),
]


@pytest.mark.parametrize("i", range(len(MESSAGES)))
def test_message_fields_encode_as_wire_pb2(i):
    m = MESSAGES[i]
    pb = _pb_msg(m)
    raw = pb.SerializeToString()
    assert W.encode(m) == raw
    assert W.decode_message(raw) == m
    assert_same_parse(raw, wire_pb2.ConsensusMessage)


def test_out_of_range_values_are_refused_on_encode():
    for m in (W.ConsensusMessage(height=U64 + 1),
              W.ConsensusMessage(round=-1),
              W.ConsensusMessage(type=1 << 31)):
        with pytest.raises(ValueError):
            W.encode(m)
    with pytest.raises(ValueError):
        W.encode(SignedEnvelope(1 << 32))
    with pytest.raises(TypeError):
        W.encode(SignedEnvelope(1, "text"))


def test_msgtype_names_match_wire_pb2():
    for v in range(8):
        assert W.MsgType.Name(v) == wire_pb2.MsgType.Name(v)
    for v in (8, 99, -1):
        with pytest.raises(ValueError):
            wire_pb2.MsgType.Name(v)
        with pytest.raises(ValueError):
            W.MsgType.Name(v)


# ---- lock_release presence ------------------------------------------------

def test_empty_lock_release_differs_from_absent():
    absent, empty = W.ConsensusMessage(), W.ConsensusMessage(
        lock_release=SignedEnvelope(0))
    pb_absent = wire_pb2.ConsensusMessage()
    pb_empty = wire_pb2.ConsensusMessage()
    pb_empty.lock_release.CopyFrom(wire_pb2.SignedEnvelope())
    assert W.encode(absent) == pb_absent.SerializeToString() == b""
    assert W.encode(empty) == pb_empty.SerializeToString() == b"\x32\x00"
    assert W.decode_message(b"").lock_release is None
    got = W.decode_message(b"\x32\x00").lock_release
    assert got == SignedEnvelope(0) and not got.payload
    # merged on decode: the second occurrence's fields land on the first
    e1 = W.encode(SignedEnvelope(1, b"ab"))
    e2 = W.encode(SignedEnvelope(0, b"", b"x"))
    raw = (b"\x32" + bytes([len(e1)]) + e1 + b"\x32" + bytes([len(e2)])
           + e2)
    assert W.decode_message(raw).lock_release == SignedEnvelope(
        1, b"ab", b"x")
    assert assert_same_parse(raw, wire_pb2.ConsensusMessage)


def test_the_engine_reads_presence_as_the_reference_does(signers):
    """``_on_lock_release`` hands ``m.lock_release`` to the verifier: an
    empty one is present, and its empty payload is ErrMessageIsEmpty,
    as the reference's ``HasField`` branch gives."""
    from bdls_tpu_torch.consensus import errors as E
    from bdls_tpu_torch.consensus import (Config, Consensus,
                                          CpuBatchVerifier)
    from bdls_tpu_torch.consensus.engine import Stage

    node = Consensus(Config(
        epoch=0.0, signer=signers[0],
        participants=[s.identity for s in signers],
        state_compare=lambda a, b: (a > b) - (a < b),
        state_validate=lambda s, h: True, verifier=CpuBatchVerifier()))
    node.current_round.stage = Stage.LOCK_RELEASE
    for lr in (None, SignedEnvelope(0)):
        m = W.ConsensusMessage(type=W.MsgType.LOCK_RELEASE, height=1,
                               lock_release=lr)
        env = signers[1].sign_payload(W.encode(m))
        with pytest.raises(E.ErrMessageIsEmpty):
            node.receive_message(W.encode(env), 0.0)


# ---- nesting, unknown fields, odd encodings --------------------------------

def test_nested_proofs_three_deep(signers):
    rcs = [s.sign_payload(W.encode(W.ConsensusMessage(
        type=W.MsgType.ROUND_CHANGE, height=U64, round=U64 - 1,
        state=b"st"))) for s in signers[:3]]
    lock = signers[0].sign_payload(W.encode(W.ConsensusMessage(
        type=W.MsgType.LOCK, height=U64, round=U64 - 1, state=b"st",
        proof=rcs)))
    release = signers[1].sign_payload(W.encode(W.ConsensusMessage(
        type=W.MsgType.LOCK_RELEASE, height=U64, lock_release=lock)))
    raw = W.encode(release)
    pb = wire_pb2.SignedEnvelope()
    pb.ParseFromString(raw)
    assert_env_equal(pb, W.decode_envelope(raw))
    m = wire_pb2.ConsensusMessage()
    m.ParseFromString(pb.payload)
    assert_msg_equal(m, W.decode_message(pb.payload))
    inner = wire_pb2.ConsensusMessage()
    inner.ParseFromString(m.lock_release.payload)
    assert_msg_equal(inner, W.decode_message(m.lock_release.payload))
    assert [p.SerializeToString() for p in inner.proof] == [
        W.encode(p) for p in rcs]
    assert inner.height == U64 and inner.round == U64 - 1


ODD = [
    # (bytes, message class) -- unknown fields, kept and written back
    (bytes([0x48, 0x05, 0x08, 0x01, 0x10, 0x02]), "msg"),
    (bytes([0x08, 0x01, 0x3a, 0x01, 0x61]), "env"),
    (bytes([0x2a, 0x05, 0x08, 0x01, 0x3a, 0x01, 0x61]), "msg"),
    (bytes([0x4d, 1, 2, 3, 4, 0x49]) + bytes(range(8)), "msg"),
    (bytes([0x4b, 0x5b, 0x5c, 0x4c, 0x10, 0x07]), "msg"),   # groups
    (bytes([0x2a, 0x02, 0x4b, 0x4c]), "msg"),                # group in proof
    (bytes([0x2b, 0x08, 0x01, 0x2c]), "msg"),    # proof under a group
    (bytes([0x0b, 0x0c]), "msg"),
    # known fields under another wire type: unknown to the parser
    (bytes([0x12, 0x01, 0x41, 0x08, 0x01]), "msg"),
    (bytes([0x0a, 0x00, 0x15, 1, 2, 3, 4]), "env"),
    # a field seen twice: the last value
    (bytes([0x10, 0x05, 0x10, 0x06, 0x22, 0x01, 0x61, 0x22, 0x00]), "msg"),
    (bytes([0x08, 0x02, 0x08, 0x00, 0x12, 0x01, 0x61]), "env"),
    # explicit defaults, non-minimal varints and tags
    (bytes([0x10, 0x00, 0x22, 0x00, 0x08, 0x00]), "msg"),
    (bytes([0x88, 0x00, 0x05, 0x10, 0x85, 0x00]), "msg"),
    (bytes([0xc8, 0x80, 0x80, 0x80, 0x00, 0x05]), "msg"),
    (bytes([0x88, 0x80, 0x80, 0x80, 0x00, 0x05]), "msg"),
    (bytes([0x48, 0x85, 0x00]), "msg"),
    (bytes([0xf8, 0xff, 0xff, 0xff, 0x0f, 0x01]), "msg"),
    # enum values: 2^32 + 1 keeps 1, 2^31 is negative, 10-byte varints
    (bytes([0x08, 0x81, 0x80, 0x80, 0x80, 0x10]), "msg"),
    (bytes([0x08, 0x80, 0x80, 0x80, 0x80, 0x08]), "msg"),
    (bytes([0x08]) + bytes([0xff] * 9 + [0x01]), "msg"),
    (bytes([0x10]) + bytes([0xff] * 9 + [0x7f]), "msg"),
    (bytes([0x48]) + bytes([0x80] * 9 + [0x02]), "msg"),
    (bytes([0x08]) + bytes([0xff] * 9 + [0x01]), "env"),
    # refused by protobuf
    (bytes([0x00, 0x01]), "msg"),
    (bytes([0x4e, 0x01]), "msg"),
    (bytes([0x4f, 0x01]), "env"),
    (bytes([0x4c]), "msg"),
    (bytes([0x4b]), "msg"),
    (bytes([0x4b, 0x5b, 0x4c, 0x5c]), "msg"),
    (bytes([0x4b, 0x00, 0x4c]), "msg"),
    (bytes([0x4d, 1, 2, 3]), "msg"),
    (bytes([0x4a, 0x05, 0x01]), "msg"),
    (bytes([0x2a, 0x02, 0x08]), "msg"),
    (bytes([0x2a, 0x01, 0x4c]), "msg"),
    (bytes([0x12, 0x80, 0x80, 0x80, 0x80, 0x10]), "msg"),
    (bytes([0x88, 0x80, 0x80, 0x80, 0x80, 0x00, 0x05]), "msg"),
    (bytes([0xc8, 0x80, 0x80, 0x80, 0x10, 0x05]), "msg"),
    (bytes([0xf8, 0xff, 0xff, 0xff, 0x1f, 0x01]), "msg"),
    (bytes([0x10]) + bytes([0xff] * 10 + [0x01]), "msg"),
    (bytes([0x48]) + bytes([0x80] * 10), "msg"),
    (bytes([0x10, 0x80]), "env"),
    (bytes([0x12, 0x05, 0x61]), "env"),
]


@pytest.mark.parametrize("i", range(len(ODD)))
def test_odd_encodings_parse_as_wire_pb2(i):
    raw, kind = ODD[i]
    cls = (wire_pb2.ConsensusMessage if kind == "msg"
           else wire_pb2.SignedEnvelope)
    assert_same_parse(raw, cls)


@pytest.mark.parametrize("depth", [99, 100, 101])
def test_group_depth_limit(depth):
    top = bytes([0x4b]) * depth + bytes([0x4c]) * depth
    assert_same_parse(top, wire_pb2.ConsensusMessage)
    assert_same_parse(top, wire_pb2.SignedEnvelope)
    n = len(top)
    nested = bytes([0x2a, (n & 0x7f) | 0x80, n >> 7]) + top
    assert_same_parse(nested, wire_pb2.ConsensusMessage)


def test_unknown_fields_survive_a_resync(signers):
    """``_on_resync`` re-serializes parsed proofs: an unknown field in a
    proof envelope comes back byte for byte, as from ``wire_pb2``."""
    env = signers[2].sign_payload(b"\x08\x01")
    # field 15 = 42 and field 16 a fixed32 in the envelope, field 19 = 7
    # in the message
    raw_env = W.encode(env) + bytes([0x78, 0x2a, 0x85, 0x01, 1, 2, 3, 4])
    raw = (b"\x08\x07\x2a" + varint(len(raw_env)) + raw_env
           + bytes([0x98, 0x01, 0x07]))
    pb = wire_pb2.ConsensusMessage()
    pb.ParseFromString(raw)
    m = W.decode_message(raw)
    assert W.encode(m.proof[0]) == pb.proof[0].SerializeToString() == raw_env
    assert W.encode(W.copy_envelope(m.proof[0])) == raw_env
    assert W.encode(m) == pb.SerializeToString()


# ---- byte mutations of real frames ------------------------------------------

@pytest.fixture(scope="module")
def frames(signers):
    """Every frame a 4-node network posts deciding two heights, and the
    consensus messages inside them."""
    from bdls_tpu_torch.consensus import (Config, Consensus,
                                          CpuBatchVerifier)
    from bdls_tpu_torch.consensus.ipc import VirtualNetwork

    net = VirtualNetwork(seed=3, latency=0.01)
    out = []
    post = net.post
    net.post = lambda s, d, data: (out.append(data), post(s, d, data))
    for s in signers:
        net.add_node(Consensus(Config(
            epoch=0.0, signer=s, participants=[x.identity for x in signers],
            state_compare=lambda a, b: (a > b) - (a < b),
            state_validate=lambda s_, h_: True, latency=0.05,
            verifier=CpuBatchVerifier())))
    net.connect_all()
    t = 0.0
    while min(net.heights()) < 2:
        for node in net.nodes:
            node.propose(b"h%d" % (node.latest_height + 1))
        t += 0.5
        net.run_until(t)
    uniq = list(dict.fromkeys(out))
    payloads = list(dict.fromkeys(W.decode_envelope(f).payload
                                  for f in uniq))
    kinds = {W.decode_message(p).type for p in payloads}
    assert {W.MsgType.ROUND_CHANGE, W.MsgType.LOCK, W.MsgType.COMMIT,
            W.MsgType.DECIDE} <= kinds
    return uniq, payloads


def _mutants(raw: bytes, rng: random.Random, n: int):
    for _ in range(n):
        op = rng.randrange(5)
        i = rng.randrange(len(raw))
        if op == 0:      # flip a bit
            yield raw[:i] + bytes([raw[i] ^ (1 << rng.randrange(8))]) \
                + raw[i + 1:]
        elif op == 1:    # overwrite a byte
            yield raw[:i] + bytes([rng.randrange(256)]) + raw[i + 1:]
        elif op == 2:    # truncate
            yield raw[:i]
        elif op == 3:    # delete a byte
            yield raw[:i] + raw[i + 1:]
        else:            # insert a byte
            yield raw[:i] + bytes([rng.randrange(256)]) + raw[i:]


def test_real_frames_decode_as_wire_pb2(frames):
    uniq, payloads = frames
    for raw in uniq:
        assert assert_same_parse(raw, wire_pb2.SignedEnvelope)
    for p in payloads:
        assert assert_same_parse(p, wire_pb2.ConsensusMessage)


def test_mutated_frames_refused_exactly_where_wire_pb2_refuses(frames):
    uniq, payloads = frames
    rng = random.Random(18)
    counts = {"accepted": 0, "refused": 0}
    for cls, pool in ((wire_pb2.SignedEnvelope, uniq),
                      (wire_pb2.ConsensusMessage, payloads)):
        for raw in pool:
            for bad in _mutants(raw, rng, 200):
                ok = assert_same_parse(bad, cls)
                counts["accepted" if ok else "refused"] += 1
    # both outcomes are exercised
    assert counts["accepted"] > 100 and counts["refused"] > 100, counts
