"""The port's peer side (``bdls_tpu_torch/peer``, ``crypto/msp.py``)
against the JAX package, on the CPU.

One set of blocks, built once as bytes, goes through the reference's
``Committer`` over its ``SwCSP`` and through the port's over the port's
``SwCSP``, each on a ``FileLedger`` and a file-backed ``KVState``. The
blocks hold phase 6j's hostile transactions (an endorsement signature
flipped, an endorser the MSP does not know, a duplicate tx id, an
undecodable payload), MVCC conflicts, a reserved ``_pvthash/`` write, a
bad creator signature, a creator outside the MSP, an under-endorsed
transaction and a delete. Held equal: the flags, the KV state with its
versions and history, range and composite queries, the ledger's and the
state log's file bytes, recovery from torn tails, and
``rebuild_state_from_blocks``. The port's validator gives the same flags
with the block lane on and off, and through ``TorchCSP(device="cpu")``
(one ``tpu_block_blocks_total``, the plain K7). Then the deliberate
difference: a ``verify_block`` that raises fails the port's
``validate_block``, where the reference's falls back quietly. Also the
MSP, lifecycle and private-data pieces the committer uses, the
endorser's action bytes, and ``TxFlag``'s values pinned to the block
lane's. Every comparison is exact.
"""

from __future__ import annotations

import hashlib
import os

import pytest
import torch

from bdls_tpu.crypto import msp as JM
from bdls_tpu.crypto.sw import SwCSP as JSwCSP
from bdls_tpu.ordering import fabric_pb2 as jpb
from bdls_tpu.ordering.ledger import FileLedger as JFileLedger
from bdls_tpu.peer import committer as JC
from bdls_tpu.peer import lifecycle as JL
from bdls_tpu.peer import privdata as JP
from bdls_tpu.peer import validator as JV
from bdls_tpu.peer.endorser import Endorser as JEndorser
from bdls_tpu.peer.endorser import Proposal as JProposal
from bdls_tpu_torch.crypto import blocklane as bl
from bdls_tpu_torch.crypto import msp as M
from bdls_tpu_torch.crypto.sw import KeyHandle, SwCSP
from bdls_tpu_torch.crypto.torch_provider import TorchCSP
from bdls_tpu_torch.ordering import fabric_codec as pb
from bdls_tpu_torch.ordering.block import genesis_block, header_hash, \
    make_block, tx_digest
from bdls_tpu_torch.ordering.ledger import FileLedger
from bdls_tpu_torch.peer import committer as C
from bdls_tpu_torch.peer import lifecycle as L
from bdls_tpu_torch.peer import privdata as P
from bdls_tpu_torch.peer import validator as V
from bdls_tpu_torch.peer.endorser import Endorser, Proposal, sign_proposal

torch.set_num_threads(1)

SW, JSW = SwCSP(), JSwCSP()
ORG1, ORG2, ORG3, CLIENT, ROGUE, OUTSIDER = (0xEE01, 0xEE02, 0xEE03,
                                             0xC0FE, 0xBAD2, 0xD00D)
CHANNEL = "peerchan"


class DeterministicJSwCSP(JSwCSP):
    """The reference's provider with the port's deterministic nonce."""

    def sign(self, key_handle, digest):
        d = key_handle._sk.private_numbers().private_value
        return SW.sign(KeyHandle(key_handle.curve, d), digest)


# ---- one set of blocks, as bytes --------------------------------------------

def _key(scalar):
    return SW.key_from_scalar("P-256", scalar)


def action(writes, reads=(), endorsers=(("org1", ORG1), ("org2", ORG2)),
           contract="kvput", flip=False, collection=None) -> pb.EndorsedAction:
    a = pb.EndorsedAction()
    a.proposal_hash = hashlib.sha256(repr((writes, reads)).encode()).digest()
    a.contract = contract
    for key, exists, ver in reads:
        rd = a.read_set.reads.add()
        rd.key, rd.exists = key, exists
        rd.version_block, rd.version_tx = ver
    for key, value in writes:
        w = a.write_set.writes.add()
        w.key = key
        if value is None:
            w.is_delete = True
        else:
            w.value = value
    if collection is not None:
        w = a.write_set.writes.add()
        w.collection, w.key = collection
        w.value_hash = hashlib.sha256(b"secret").digest()
    digest = V.endorsement_digest(a)
    for org, scalar in endorsers:
        k = _key(scalar)
        r, s = SW.sign(k, digest)
        e = a.endorsements.add()
        pub = k.public_key()
        e.endorser_x = pub.x.to_bytes(32, "big")
        e.endorser_y = pub.y.to_bytes(32, "big")
        e.org = org
        e.sig_r = r.to_bytes(32, "big")
        e.sig_s = s.to_bytes(32, "big")
    if flip:
        e = a.endorsements[1]
        e.sig_s = e.sig_s[:-1] + bytes([e.sig_s[-1] ^ 1])
    return a


def envelope(tx_id, payload, creator=CLIENT, org="org1",
             bad_sig=False) -> bytes:
    env = pb.TxEnvelope()
    env.header.type = pb.TxType.TX_NORMAL
    env.header.channel_id = CHANNEL
    env.header.tx_id = tx_id
    env.header.timestamp_unix_ms = 1700000000000
    k = _key(creator)
    pub = k.public_key()
    env.header.creator_x = pub.x.to_bytes(32, "big")
    env.header.creator_y = pub.y.to_bytes(32, "big")
    env.header.creator_org = org
    env.payload = payload
    r, s = SW.sign(k, tx_digest(env))
    if bad_sig:
        r ^= 1
    env.sig_r = r.to_bytes(32, "big")
    env.sig_s = s.to_bytes(32, "big")
    return env.SerializeToString()


def put(tx_id, key, value, **kw) -> bytes:
    return envelope(tx_id, action([(key, value)], **kw).SerializeToString())


# (block number -> [(envelope bytes, expected flag)])
FLAG = V.TxFlag
BLOCKS_SPEC = {
    1: [
        (put("t0", "a", b"1"), FLAG.VALID),
        (put("t1", "b", b"1"), FLAG.VALID),
        (put("t2", "c", b"1", flip=True), FLAG.ENDORSEMENT_POLICY_FAILURE),
        (put("t3", "d", b"1", endorsers=(("org1", ORG1), ("org2", ROGUE))),
         FLAG.ENDORSEMENT_POLICY_FAILURE),
        (put("t1", "e", b"1"), FLAG.DUPLICATE_TXID),
        (envelope("t5", b"\x0a\xff\xff\xff\xff\x0f"), FLAG.BAD_PAYLOAD),
        (put("t6", "_pvthash/kvput/c/k", b"x"), FLAG.NAMESPACE_VIOLATION),
        (put("t7", "a", b"2", reads=(("a", False, (0, 0)),)),
         FLAG.MVCC_READ_CONFLICT),
        (envelope("t8", action([("f", b"1")]).SerializeToString(),
                  bad_sig=True), FLAG.BAD_CREATOR_SIGNATURE),
        (envelope("t9", action([("g", b"1")]).SerializeToString(),
                  creator=OUTSIDER), FLAG.CREATOR_NOT_MEMBER),
    ],
    2: [
        (put("u0", "a", b"3", reads=(("a", True, (1, 0)),)), FLAG.VALID),
        (envelope("u1", action([("b", None)]).SerializeToString()),
         FLAG.VALID),
        (put("u2", "b", b"9", reads=(("b", True, (1, 1)),)),
         FLAG.MVCC_READ_CONFLICT),
        (put("t0", "h", b"1"), FLAG.VALID),   # a tx id of block 1
        (put("u4", "i", b"1", endorsers=(("org1", ORG1),)),
         FLAG.ENDORSEMENT_POLICY_FAILURE),
        (put("u5", "comp\x00x\x00", b"c"), FLAG.VALID),
        (put("u6", "j", b"1", collection=("secret", "k")),
         FLAG.NAMESPACE_VIOLATION),
    ],
}


def block_bytes() -> list[bytes]:
    blocks = [genesis_block(CHANNEL)]
    for n in sorted(BLOCKS_SPEC):
        prev = blocks[-1].header
        blocks.append(make_block(n, header_hash(prev),
                                 [raw for raw, _ in BLOCKS_SPEC[n]]))
    return [b.SerializeToString() for b in blocks]


def expected(n: int) -> list[int]:
    return [int(f) for _, f in BLOCKS_SPEC[n]]


def _msp(side):
    if side == "port":
        msp, csp, ident = M.LocalMSP(SW), SW, M.Identity
    else:
        msp, csp, ident = JM.LocalMSP(JSW), JSW, JM.Identity
    for org, scalar in (("org1", ORG1), ("org2", ORG2), ("org3", ORG3),
                        ("org1", CLIENT)):
        msp.register(ident(org=org, key=csp.key_from_scalar(
            "P-256", scalar).public_key()))
    return msp


def commit_all(side, tmp_path, csp=None):
    """Commit the blocks through one side's Committer on files under
    ``tmp_path/side``: (committer, flags by block, ledger, state)."""
    root = tmp_path / side
    root.mkdir()
    if side == "port":
        mod, fl, parse = C, FileLedger, pb.Block.FromString
        csp = csp or SW
    else:
        mod, fl, parse = JC, JFileLedger, jpb.Block.FromString
        csp = csp or JSW
    ledger = fl(str(root / "ledger"))
    state = mod.KVState(str(root / "state.log"))
    raw = block_bytes()
    ledger.append(parse(raw[0]))
    com = mod.Committer(ledger, state, csp,
                        (V if side == "port" else JV).EndorsementPolicy(
                            required=2), msp=_msp(side))
    flags = {n: [int(f) for f in com.commit_block(parse(raw[n]))]
             for n in sorted(BLOCKS_SPEC)}
    return com, flags, ledger, state


def state_view(state):
    return {k: (state.get(k), state.version(k), state.history(k))
            for k in state.keys()}


def test_committer_matches_reference_flags_state_and_files(tmp_path):
    _, jflags, jledger, jstate = commit_all("reference", tmp_path)
    com, flags, ledger, state = commit_all("port", tmp_path)
    assert flags == jflags == {n: expected(n) for n in BLOCKS_SPEC}
    assert state_view(state) == state_view(jstate)
    assert state.get("a") == b"3" and state.get("b") is None
    assert state.history("b") == [((1, 1), b"1"), ((2, 1), None)]
    assert state.range_query("a", "z") == jstate.range_query("a", "z")
    assert state.range_query(limit=2) == jstate.range_query(limit=2)
    assert state.partial_composite_query("comp") == \
        jstate.partial_composite_query("comp") == [("comp\x00x\x00", b"c")]
    assert com.stats == {"blocks": 2, "valid_txs": 6, "invalid_txs": 11}
    jledger.close()
    ledger.close()
    jstate.close()
    state.close()
    for name in ("ledger/blocks.seg", "state.log"):
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "reference" / name).read_bytes()


def test_recovery_from_torn_tails_matches_reference(tmp_path):
    for side in ("reference", "port"):
        _, _, ledger, state = commit_all(side, tmp_path)
        ledger.close()
        state.close()
        # a torn ledger record and a half-written state flush
        with open(tmp_path / side / "ledger" / "blocks.seg", "ab") as fh:
            fh.write(b"\x40\x00\x00\x00partial")
        rec = b'{"k": "z", "v": "00", "ver": [3, 0]}'
        with open(tmp_path / side / "state.log", "ab") as fh:
            fh.write(len(rec).to_bytes(4, "little") + rec + b"\x05\x00")
    views = {}
    for side, mod, fl in (("reference", JC, JFileLedger),
                          ("port", C, FileLedger)):
        ledger = fl(str(tmp_path / side / "ledger"))
        state = mod.KVState(str(tmp_path / side / "state.log"))
        views[side] = (ledger.height(),
                       [ledger.get(i).SerializeToString() for i in range(3)],
                       state_view(state))
        ledger.close()
        state.close()
    assert views["port"] == views["reference"]
    assert views["port"][0] == 3
    for name in ("ledger/blocks.seg", "state.log"):
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "reference" / name).read_bytes()


def test_rebuild_state_from_blocks_matches_reference(tmp_path):
    _, _, jledger, jstate = commit_all("reference", tmp_path)
    _, _, ledger, state = commit_all("port", tmp_path)
    rebuilt = C.rebuild_state_from_blocks(ledger)
    jrebuilt = JC.rebuild_state_from_blocks(jledger)
    assert state_view(rebuilt) == state_view(jrebuilt) == state_view(state)
    assert state_view(state) == state_view(jstate)


@pytest.mark.parametrize("lane", ["on", "off"])
def test_validator_strategies_give_the_reference_flags(lane, monkeypatch):
    monkeypatch.setenv("BDLS_TPU_BLOCK_LANE", lane)
    raw = block_bytes()
    port = V.TxValidator(SW, V.EndorsementPolicy(required=2),
                         msp=_msp("port"))
    ref = JV.TxValidator(JSW, JV.EndorsementPolicy(required=2),
                         msp=_msp("reference"))
    for n in BLOCKS_SPEC:
        got = [int(f) for f in port.validate_block(pb.Block.FromString(
            raw[n]))]
        want = [int(f) for f in ref.validate_block(jpb.Block.FromString(
            raw[n]))]
        # the committer adds MVCC flags after validation
        assert got == want
        assert [g for g, e in zip(got, expected(n))
                if e != FLAG.MVCC_READ_CONFLICT] == \
            [e for e in expected(n) if e != FLAG.MVCC_READ_CONFLICT]


def test_fused_path_through_torch_csp_on_the_cpu():
    """A small block through the port's committer on
    ``TorchCSP(device="cpu")``: the plain K7 answers in one fused block
    call, with the reference's flags."""
    raw = [BLOCKS_SPEC[1][i][0] for i in (0, 2, 3)]
    gen = genesis_block(CHANNEL)
    blk = make_block(1, header_hash(gen.header), raw)
    csp = TorchCSP(device="cpu", key_cache_size=0)
    try:
        flags = V.TxValidator(csp, V.EndorsementPolicy(required=2),
                              msp=_msp("port")).validate_block(blk)
        assert csp._c_block_blocks.value() == 1
        assert csp._c_block_fallbacks.value() == 0
        assert csp.stats["runs"] == "plain"
    finally:
        csp.close()
    want = JV.TxValidator(JSW, JV.EndorsementPolicy(required=2),
                          msp=_msp("reference")).validate_block(
        jpb.Block.FromString(blk.SerializeToString()))
    assert [int(f) for f in flags] == [int(f) for f in want] == [0, 2, 2]


class _BrokenBlockLane:
    """A provider whose block lane fails, as a failed launch does."""

    def __init__(self, inner):
        self.inner = inner
        self.calls = 0

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def verify_block(self, req):
        self.calls += 1
        raise RuntimeError("block launch failed")


def test_a_failing_block_lane_fails_validation_unlike_the_reference():
    raw = block_bytes()
    port = _BrokenBlockLane(SW)
    with pytest.raises(RuntimeError, match="block launch failed"):
        V.TxValidator(port, V.EndorsementPolicy(required=2),
                      msp=_msp("port")).validate_block(
            pb.Block.FromString(raw[1]))
    assert port.calls == 1
    ref = _BrokenBlockLane(JSW)
    flags = JV.TxValidator(ref, JV.EndorsementPolicy(required=2),
                           msp=_msp("reference")).validate_block(
        jpb.Block.FromString(raw[1]))
    assert ref.calls == 1
    assert [int(f) for f, e in zip(flags, expected(1))
            if e != FLAG.MVCC_READ_CONFLICT] == \
        [e for e in expected(1) if e != FLAG.MVCC_READ_CONFLICT]


def test_a_failing_block_lane_fails_the_commit(tmp_path):
    """The committer appends nothing when validation raises."""
    with pytest.raises(RuntimeError):
        commit_all("port", tmp_path, csp=_BrokenBlockLane(SW))
    ledger = FileLedger(str(tmp_path / "port" / "ledger"))
    assert ledger.height() == 1
    ledger.close()


def test_txflag_values_pinned_to_the_block_lane():
    assert int(V.TxFlag.VALID) == bl.TXFLAG_VALID
    assert int(V.TxFlag.ENDORSEMENT_POLICY_FAILURE) == \
        bl.TXFLAG_POLICY_FAILURE
    assert {f.name: int(f) for f in V.TxFlag} == \
        {f.name: int(f) for f in JV.TxFlag}
    assert V.RESERVED_STATE_PREFIXES == JV.RESERVED_STATE_PREFIXES


def test_endorsement_digest_and_preimage_match_reference():
    for n in BLOCKS_SPEC:
        for raw, _ in BLOCKS_SPEC[n]:
            env = pb.TxEnvelope.FromString(raw)
            try:
                a = pb.EndorsedAction.FromString(env.payload)
            except pb.DecodeError:
                continue
            ja = jpb.EndorsedAction.FromString(env.payload)
            assert V.endorsement_preimage(a) == JV.endorsement_preimage(ja)
            assert V.endorsement_digest(a) == JV.endorsement_digest(ja)
            assert hashlib.sha256(V.endorsement_preimage(a)).digest() == \
                V.endorsement_digest(a)


def test_endorser_builds_the_reference_action():
    """The same proposal through both endorsers (the reference signing
    with the port's nonce) gives the same action bytes, reads and
    private writes included."""
    outs = []
    for side in ("reference", "port"):
        if side == "port":
            csp, kv, end, prop_cls = SW, C.KVState(), Endorser, Proposal
        else:
            csp, kv, end, prop_cls = (DeterministicJSwCSP(), JC.KVState(),
                                      JEndorser, JProposal)
        kv.apply(_writes(side, [("seen", b"7")]), (3, 1))

        def contract(read, args):
            return [("seen", (read("seen") or b"") + b"!"),
                    ("@coll/p", b"private"), ("gone", None)]

        e = end(csp, csp.key_from_scalar("P-256", ORG1), "org1", kv,
                contracts={"cc": contract})
        prop = prop_cls(CHANNEL, "cc", [b"x", b"y"], b"", b"", "org1")
        pub = csp.key_from_scalar("P-256", CLIENT)
        prop.creator_x = pub.public_key().x.to_bytes(32, "big")
        prop.creator_y = pub.public_key().y.to_bytes(32, "big")
        r, s = csp.sign(pub, prop.digest())
        prop.sig_r, prop.sig_s = r.to_bytes(32, "big"), s.to_bytes(32, "big")
        act = e.process_proposal(prop)
        outs.append((act.SerializeToString(), e.stats,
                     {k: v for k, v in e.transient.items()}))
    assert outs[0] == outs[1]
    # the port's signing helper signs what the reference verifies
    prop = sign_proposal(SW, _key(CLIENT), Proposal(CHANNEL, "cc", [b"x"],
                                                    b"", b"", "org1"))
    from bdls_tpu.crypto.csp import VerifyRequest as JReq

    assert JSW.verify(JReq(
        key=JSW.key_import("P-256", int.from_bytes(prop.creator_x, "big"),
                           int.from_bytes(prop.creator_y, "big")),
        digest=prop.digest(), r=int.from_bytes(prop.sig_r, "big"),
        s=int.from_bytes(prop.sig_s, "big")))


def _writes(side, pairs):
    ws = (pb if side == "port" else jpb).WriteSet()
    for k, v in pairs:
        w = ws.writes.add()
        w.key, w.value = k, v
    return ws


def test_msp_matches_reference():
    key = SW.key_from_scalar("P-256", ORG1).public_key()
    jkey = JSW.key_from_scalar("P-256", ORG1).public_key()
    for curve_key, jcurve_key in ((key, jkey),):
        ident = M.Identity(org="org1", key=curve_key)
        jident = JM.Identity(org="org1", key=jcurve_key)
        assert ident.serialize() == jident.serialize()
        assert M.Identity.deserialize(jident.serialize()).serialize() == \
            jident.serialize()
    k1 = SW.key_from_scalar("secp256k1", 5).public_key()
    jk1 = JSW.key_from_scalar("secp256k1", 5).public_key()
    assert M.Identity("o", k1).serialize() == JM.Identity("o", jk1)\
        .serialize()
    cert = M.MemberCert("org1", key, "admin", 99.5)
    jcert = JM.MemberCert("org1", jkey, "admin", 99.5)
    assert cert.tbs_digest() == jcert.tbs_digest()
    root = _key(0x1234)
    msp = M.LocalMSP(SW)
    msp.register_org_root("org1", root.public_key())
    issued = M.issue_cert(SW, root, "org1", key, role="admin",
                          not_after_unix=10.0)
    ident = msp.enroll(issued)
    assert ident.role == "admin" and msp.orgs() == ["org1"]
    with pytest.raises(M.ErrIdentityExpired):
        msp.validate(ident, now=11.0)
    assert msp.expiring_soon(5.0, now=6.0) == [ident]
    with pytest.raises(M.ErrNoOrgRoot):
        msp.enroll(M.MemberCert("org9", key, "member", 0.0))
    bad = M.MemberCert("org1", key, "member", 0.0, issued.sig_r, issued.sig_s)
    with pytest.raises(M.ErrBadCertSignature):
        msp.enroll(bad)
    msp.revoke("org1", key)
    with pytest.raises(M.ErrIdentityRevoked):
        msp.validate(M.Identity("org1", key), now=1.0)
    with pytest.raises(M.ErrUnknownOrg):
        msp.validate(M.Identity("org7", key))
    with pytest.raises(M.ErrIdentityNotRegistered):
        msp.validate(M.Identity("org1", _key(77).public_key()))
    # verify_signed_data: a non-member drops out, the rest one batch
    member = _key(ORG2)
    msp2 = _msp("port")
    items = []
    for k, org in ((member, "org2"), (_key(ROGUE), "org2")):
        data = b"signed data"
        r, s = SW.sign(k, hashlib.sha256(data).digest())
        items.append(M.SignedData(data, M.Identity(org, k.public_key()),
                                  r, s))
    items.append(M.SignedData(b"other", items[0].identity, items[0].r,
                              items[0].s))
    assert msp2.verify_signed_data(items) == [True, False, False]


def test_lifecycle_and_privdata_match_reference(tmp_path):
    d = L.ChaincodeDefinition("cc", "1.0", 2, required=2,
                              orgs=("org2", "org1"),
                              collections=(("c", ("org1",)),))
    jd = JL.ChaincodeDefinition("cc", "1.0", 2, required=2,
                                orgs=("org2", "org1"),
                                collections=(("c", ("org1",)),))
    assert d.to_bytes() == jd.to_bytes()
    assert L.ChaincodeDefinition.from_bytes(jd.to_bytes()) == \
        L.ChaincodeDefinition("cc", "1.0", 2, required=2,
                              orgs=("org1", "org2"),
                              collections=(("c", ("org1",)),))
    assert L.approval_key("cc", 2, "org1") == JL.approval_key("cc", 2,
                                                               "org1")
    for key in ("_lifecycle/approvals/cc/2/org1", "_lifecycle/approvals/x",
                "other", "_lifecycle/approvals/a/b/x/org"):
        assert L.parse_approval_key(key) == JL.parse_approval_key(key)

    def reader(key):
        return None

    d1 = L.ChaincodeDefinition("cc", "1.0", 1, orgs=("org1",))
    for args in ([b"approve", d1.to_bytes(), b"org1"],
                 [b"commit", L.ChaincodeDefinition("cc", "1", 1).to_bytes()]):
        assert L.lifecycle_contract(reader, args) == \
            JL.lifecycle_contract(reader, args)
    with pytest.raises(L.LifecycleError):
        L.lifecycle_contract(reader, [b"commit", d.to_bytes()])
    for key in ("@c/k", "@c/", "@/k", "plain", "@c/a/b"):
        assert P.parse_private_key(key) == JP.parse_private_key(key)
    writes = [("a", b"1"), ("@c/k", b"v"), ("b", None)]
    assert P.split_private_writes(writes) == JP.split_private_writes(writes)
    files = {}
    for side, mod in (("port", P), ("reference", JP)):
        path = str(tmp_path / f"{side}.pvt")
        st = mod.PvtStore(path)
        st.put("cc", "c", "k", b"v1", (1, 0))
        st.record_missing(2, 0, "cc", "c", "m", mod.value_hash(b"late"))
        assert not st.resolve_missing(2, 0, "cc", "c", "m", b"wrong")
        assert st.resolve_missing(2, 0, "cc", "c", "m", b"late")
        st.put("cc", "c", "k", None, (3, 0))
        st.close()
        back = mod.PvtStore(path)
        files[side] = (open(path, "rb").read(), back.get("cc", "c", "m"),
                       back.get("cc", "c", "k"), back.missing_snapshot())
        back.close()
    assert files["port"] == files["reference"]
    assert os.path.getsize(tmp_path / "port.pvt") > 0
