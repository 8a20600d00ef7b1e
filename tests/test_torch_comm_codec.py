"""The port's cluster and Raft codecs against protobuf.

``bdls_tpu_torch/comm/comm_codec.py`` and
``bdls_tpu_torch/ordering/raft_codec.py`` must write the bytes that the
reference's ``comm_pb2`` and ``raft_pb2`` write, byte for byte, and read
back what they read. Hypothesis builds random messages of each of the 9
types (``ClusterFrame``'s ``oneof`` members set in any order, enum
values the schema does not name) and applies the same operations to
both sides; each side parses the other's bytes, unknown fields kept.
Named cases hold the ``oneof`` rules and the nested enum of the
table-driven runtime (``utils/proto3_message.py``) against protobuf's:
``WhichOneof``, a member set clears the others, ``HasField`` and
``ClearField`` on members and on the group, a member present as soon as
any of its fields is assigned (``auth_resp.ok = False`` is ``12 00``),
``CopyFrom`` and ``SetInParent`` into a member, parsing (the last member
wins, the same member merges) and ``RaftMessage.VOTE_REQ``. Every
comparison is exact.
"""

from __future__ import annotations

import pytest
from google.protobuf.message import DecodeError as PbDecodeError
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from bdls_tpu.comm import comm_pb2
from bdls_tpu.ordering import raft_pb2
from bdls_tpu_torch.comm import comm_codec
from bdls_tpu_torch.ordering import raft_codec
from bdls_tpu_torch.utils import proto3_message as R

PAIRS = {cls.__name__: (cls, getattr(comm_pb2, cls.__name__))
         for cls in comm_codec.MESSAGES}
PAIRS.update({cls.__name__: (cls, getattr(raft_pb2, cls.__name__))
              for cls in raft_codec.MESSAGES})
NAMES = sorted(PAIRS)
SETTINGS = settings(max_examples=60, deadline=None,
                    suppress_health_check=[HealthCheck.too_slow])


def _scalar_strategy(kind):
    if kind == R.ENUM:
        return st.one_of(st.sampled_from([0, 1, 2, 3]),
                         st.integers(-(1 << 31), (1 << 31) - 1))
    if kind == R.INT64:
        return st.integers(-(1 << 63), (1 << 63) - 1)
    if kind == R.UINT32:
        return st.integers(0, (1 << 32) - 1)
    if kind == R.UINT64:
        return st.integers(0, (1 << 64) - 1)
    if kind == R.BOOL:
        return st.booleans()
    if kind == R.STRING:
        return st.text(max_size=12)
    return st.binary(max_size=40)


def spec_strategy(cls):
    """(field, value) operations: a scalar, a list of sub-specs for a
    repeated message, a sub-spec (or None: SetInParent) for a message."""
    items = []
    for f in cls.FIELDS:
        if f.kind == R.MESSAGE:
            sub = spec_strategy(f.cls)
            val = (st.lists(sub, max_size=3) if f.repeated
                   else st.one_of(st.none(), sub))
        else:
            val = _scalar_strategy(f.kind)
        items.append(st.tuples(st.just(f.name), val))
    return st.lists(st.one_of(*items), max_size=len(cls.FIELDS) + 2)


def apply(msg, spec):
    fields = {f.name: f for f in PAIRS[type(msg).__name__][0].FIELDS}
    for name, val in spec:
        f = fields[name]
        if f.kind == R.MESSAGE and f.repeated:
            for sub in val:
                apply(getattr(msg, name).add(), sub)
        elif f.kind == R.MESSAGE:
            child = getattr(msg, name)
            if not val:
                child.SetInParent()
            else:
                apply(child, val)
        else:
            setattr(msg, name, val)


@st.composite
def message_spec(draw):
    name = draw(st.sampled_from(NAMES))
    return name, draw(spec_strategy(PAIRS[name][0]))


def pair(name, spec):
    port_cls, pb_cls = PAIRS[name]
    a, b = port_cls(), pb_cls()
    apply(a, spec)
    apply(b, spec)
    return a, b


def fields_of(msg) -> list:
    """Every field's value as plain Python, the oneof member first."""
    out = []
    if type(msg).__name__ == "ClusterFrame":
        out.append(msg.WhichOneof("kind"))
    for f in PAIRS[type(msg).__name__][0].FIELDS:
        v = getattr(msg, f.name)
        if f.kind == R.MESSAGE and f.repeated:
            out.append([fields_of(m) for m in v])
        elif f.kind == R.MESSAGE:
            out.append((msg.HasField(f.name), fields_of(v)))
        else:
            out.append(v)
    return out


@SETTINGS
@given(message_spec())
def test_round_trip_byte_for_byte(case):
    name, spec = case
    a, b = pair(name, spec)
    data = b.SerializeToString()
    assert a.SerializeToString() == data
    assert a.ByteSize() == b.ByteSize()
    assert fields_of(a) == fields_of(b)
    back = PAIRS[name][0].FromString(data)
    assert back == a and fields_of(back) == fields_of(b)


UNKNOWN = (b"\xf8\x07\x05",              # field 127, varint 5
           b"\xfa\x07\x03abc",           # field 127, 3 bytes
           b"\x9d\x06\x01\x02\x03\x04")  # field 99, fixed32


@SETTINGS
@given(message_spec(), st.sampled_from(UNKNOWN))
def test_each_side_reads_the_others_bytes_unknown_fields_kept(case, extra):
    name, spec = case
    a, b = pair(name, spec)
    port_cls, pb_cls = PAIRS[name]
    ref_bytes = b.SerializeToString() + extra
    mine = port_cls.FromString(ref_bytes)
    assert fields_of(mine) == fields_of(pb_cls.FromString(ref_bytes))
    assert mine.SerializeToString() == \
        pb_cls.FromString(ref_bytes).SerializeToString()
    port_bytes = a.SerializeToString() + extra
    theirs = pb_cls.FromString(port_bytes)
    assert fields_of(theirs) == fields_of(port_cls.FromString(port_bytes))
    assert theirs.SerializeToString() == \
        port_cls.FromString(port_bytes).SerializeToString()


@SETTINGS
@given(st.sampled_from(NAMES), st.binary(max_size=48))
def test_garbage_is_refused_alike(name, data):
    out = []
    for cls, err in ((PAIRS[name][0], R.DecodeError),
                     (PAIRS[name][1], PbDecodeError)):
        m = cls()
        try:
            m.ParseFromString(data)
        except err:
            out.append("refused")
            continue
        out.append(m.SerializeToString())
    assert out[0] == out[1]


# ---- the oneof rules and the nested enum, case by case ----------------------

def _try(fn):
    try:
        return fn()
    except Exception as exc:  # noqa: BLE001 — the class is compared
        return type(exc).__name__


def _frame_state(f) -> tuple:
    return (f.WhichOneof("kind"), f.HasField("kind"),
            [f.HasField(m) for m in ("auth", "auth_resp", "step",
                                     "pull_req", "pull_resp",
                                     "auth_challenge")],
            f.SerializeToString())


def case_auth_resp_ok_false(m):
    f = m.ClusterFrame()
    f.auth_resp.ok = False
    return _frame_state(f)


def case_auth_resp_rejection(m):
    f = m.ClusterFrame()
    f.auth_resp.ok = False
    f.auth_resp.error = "challenge nonce mismatch"
    return _frame_state(f)


def case_setting_a_member_clears_the_others(m):
    f = m.ClusterFrame()
    f.step.channel = "ch"
    f.step.payload = b"p"
    first = _frame_state(f)
    f.pull_req.start = 3
    return first, _frame_state(f), f.step.channel


def case_reading_a_member_does_not_set_it(m):
    f = m.ClusterFrame()
    return f.auth.from_id, f.step.channel, _frame_state(f)


def case_a_stub_read_before_stays_linked(m):
    f = m.ClusterFrame()
    stub = f.auth
    f.step.channel = "x"
    stub.from_id = b"1"
    return _frame_state(f)


def case_a_member_cut_loose_stays_loose(m):
    f = m.ClusterFrame()
    f.step.channel = "x"
    old = f.step
    f.auth.version = 1
    old.channel = "y"
    return old.channel, _frame_state(f)


def case_clear_field_on_a_member(m):
    f = m.ClusterFrame()
    f.step.channel = "x"
    f.ClearField("auth")
    kept = _frame_state(f)
    f.ClearField("step")
    return kept, _frame_state(f)


def case_clear_field_on_the_group(m):
    f = m.ClusterFrame()
    f.pull_resp.number = 9
    f.ClearField("kind")
    empty = _frame_state(f)
    f.ClearField("kind")
    return empty, _frame_state(f)


def case_copy_from_into_a_member(m):
    req = m.AuthRequest()
    req.version = 3
    req.timestamp_unix_ms = -5
    req.from_id = b"\x01" * 64
    req.eph_pub = b"\x04" + b"\x02" * 64
    f = m.ClusterFrame()
    f.step.channel = "x"
    f.auth.CopyFrom(req)
    return _frame_state(f), f.auth.version


def case_copy_from_an_empty_message(m):
    f = m.ClusterFrame()
    f.auth_challenge.CopyFrom(m.AuthChallenge())
    return _frame_state(f)


def case_set_in_parent(m):
    f = m.ClusterFrame()
    f.step.channel = "x"
    f.pull_req.SetInParent()
    return _frame_state(f)


def case_parsing_the_last_member_wins(m):
    step = m.ClusterFrame()
    step.step.channel = "a"
    auth = m.ClusterFrame()
    auth.auth.version = 2
    step2 = m.ClusterFrame()
    step2.step.payload = b"z"
    f = m.ClusterFrame.FromString(step.SerializeToString()
                                  + auth.SerializeToString()
                                  + step2.SerializeToString())
    return _frame_state(f), f.step.channel, f.step.payload


def case_parsing_the_same_member_merges(m):
    a, b = m.ClusterFrame(), m.ClusterFrame()
    a.step.channel = "a"
    b.step.payload = b"z"
    f = m.ClusterFrame.FromString(a.SerializeToString()
                                  + b.SerializeToString())
    return _frame_state(f), f.step.channel, f.step.payload


def case_merge_from_another_member(m):
    a, b = m.ClusterFrame(), m.ClusterFrame()
    a.step.channel = "a"
    b.pull_req.end = 4
    a.MergeFrom(b)
    return _frame_state(a)


def case_unknown_group_and_field(m):
    f = m.ClusterFrame()
    return (_try(lambda: f.WhichOneof("nokind")),
            _try(lambda: f.HasField("nothing")),
            _try(lambda: f.ClearField("nothing")))


def case_nested_enum(m):
    rm = m.RaftMessage
    return ([int(rm.VOTE_REQ), int(rm.VOTE_RESP), int(rm.APPEND_REQ),
             int(rm.APPEND_RESP)],
            [rm.Type.Name(i) for i in range(4)],
            rm.Type.Value("APPEND_RESP"), list(rm.Type.keys()),
            list(rm.Type.values()), _try(lambda: rm.Type.Name(9)),
            _try(lambda: rm.Type.Value("NOPE")))


def case_open_enum_and_the_from_field(m):
    msg = m.RaftMessage()
    msg.type = m.RaftMessage.APPEND_RESP
    setattr(msg, "from", b"\x07" * 64)
    msg.entries.add(term=2, index=5, data=b"blk")
    other = m.RaftMessage()
    other.type = 7
    back = m.RaftMessage.FromString(other.SerializeToString())
    return (msg.SerializeToString(), other.SerializeToString(), back.type,
            getattr(m.RaftMessage.FromString(msg.SerializeToString()),
                    "from"))


CASES = {name[5:]: fn for name, fn in dict(globals()).items()
         if name.startswith("case_")}


class _Ref:
    """The reference's modules under the port's names."""
    ClusterFrame = comm_pb2.ClusterFrame
    AuthRequest = comm_pb2.AuthRequest
    AuthChallenge = comm_pb2.AuthChallenge
    RaftMessage = raft_pb2.RaftMessage


class _Port:
    ClusterFrame = comm_codec.ClusterFrame
    AuthRequest = comm_codec.AuthRequest
    AuthChallenge = comm_codec.AuthChallenge
    RaftMessage = raft_codec.RaftMessage


@pytest.mark.parametrize("name", sorted(CASES))
def test_oneof_and_enum_rules_match_protobuf(name):
    assert CASES[name](_Port) == CASES[name](_Ref)


def test_auth_rejection_is_the_reference_bytes():
    f = comm_codec.ClusterFrame()
    f.auth_resp.ok = False
    assert f.SerializeToString() == b"\x12\x00"
