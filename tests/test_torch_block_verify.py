"""The port's block lane vs the JAX package, on the CPU.

- ``blocklane``: the flag values (pinned to the committer's ``TxFlag``),
  the wire screen, ``policy_org_masks`` with the out-of-universe
  sentinel, ``tally_flags`` and ``verify_block_host`` (with
  ``digest_memo``) equal the reference module's;
- ``plan_buckets`` and ``pack_block_request`` are bit-identical to the
  reference's, key for key and dtype for dtype: on the reference's
  standing fixture, with screened lanes, with lanes out of the org
  universe and on a hostile block;
- the plain ``block_kernel``, through ``launch_block`` on the
  reference's own packed dict, equals the reference's fused program
  (``launch_block(..., field="fold")`` on XLA:CPU): the flags and every
  lane of ``valid``, filler included. One program, compiled once for
  the module (about 40 s here);
- secp256k1 through the port equals the port's host oracle;
- the committer entry point with the port inside: the reference
  ``TxValidator(TorchCSP(device="cpu", key_cache_size=0), policy)`` gives
  the flags of ``TxValidator(SwCSP(), policy)``, with the block lane on
  and off, and with it on the fused path ran (one
  ``tpu_block_blocks_total``), not the validator's silent fallback;
- ``TorchCSP.verify_block``: the low-S screen, an overlong wire field,
  an oversize request (one counted fallback, the host oracle's flags), a
  launch that raises (raised, no fallback counted), and the
  reference's instrument and span names.

Flags and verdicts are integers and booleans: comparisons are exact.
"""

from __future__ import annotations

import hashlib
from dataclasses import replace

import numpy as np
import pytest
import torch

from bdls_tpu.crypto import blocklane as jbl
from bdls_tpu.crypto.sw import SwCSP as JSwCSP
from bdls_tpu.ops import block_verify as jbv
from bdls_tpu.ops.curves import CURVES as JCURVES
from bdls_tpu.ordering import fabric_pb2 as pb
from bdls_tpu.ordering.block import genesis_block, header_hash, make_block, \
    tx_digest
from bdls_tpu.peer.validator import EndorsementPolicy, TxFlag, TxValidator, \
    endorsement_digest
from bdls_tpu_torch.crypto import blocklane as bl
from bdls_tpu_torch.crypto import vectors
from bdls_tpu_torch.crypto.sw import SwCSP
from bdls_tpu_torch.crypto.torch_provider import TorchCSP, \
    block_lane_screen
from bdls_tpu_torch.ops import block_verify as bv
from bdls_tpu_torch.ops.curves import CURVES
from bdls_tpu_torch.utils import tracing
from bdls_tpu_torch.utils.metrics import MetricsProvider

torch.set_num_threads(1)

JSW = JSwCSP()
CLIENT = JSW.key_from_scalar("P-256", 0xAB01)
ENDORSERS = {
    "org1": JSW.key_from_scalar("P-256", 0xEB01),
    "org2": JSW.key_from_scalar("P-256", 0xEB02),
    "org3": JSW.key_from_scalar("P-256", 0xEB03),
}


def _lane(kh, msg, tx, org, *, tamper=False):
    digest = JSW.hash(msg)
    r, s = JSW.sign(kh, digest)
    pub = kh.public_key()
    return jbl.BlockLane(
        msg=msg,
        qx=pub.x.to_bytes(32, "big"), qy=pub.y.to_bytes(32, "big"),
        r=bytes(32) if tamper else r.to_bytes(32, "big"),
        s=s.to_bytes(32, "big"), tx=tx, org=org)


def _mixed_request(curve="P-256"):
    """4 txs x 3 orgs with one tampered lane (tx 1 / org 2) and one
    unsatisfiable policy (tx 3, the sentinel)."""
    keys = [JSW.key_from_scalar(curve, 0xB10C + o) for o in range(3)]
    lanes = []
    for t in range(4):
        msg = b"blk|tx%02d|" % t + bytes(16)
        for o in range(3):
            lanes.append(_lane(keys[o], msg, t, o,
                               tamper=(t == 1 and o == 2)))
    policies = [jbl.BlockPolicy(required=2, orgs=()),
                jbl.BlockPolicy(required=3, orgs=()),
                jbl.BlockPolicy(required=2, orgs=(0, 1)),
                jbl.BlockPolicy(required=1, orgs=(3,))]
    want = [jbl.TXFLAG_VALID, jbl.TXFLAG_POLICY_FAILURE,
            jbl.TXFLAG_VALID, jbl.TXFLAG_POLICY_FAILURE]
    return jbl.BlockVerifyRequest(curve, lanes, policies, norgs=3), want


def _hostile_request():
    """The standing fixture plus, at the smallest buckets (32 lanes, 8
    txs, 4 blocks, 4 orgs): a tx endorsed twice by one org, a high-S
    twin, a 33-byte field, r = n, Q off the curve, s = 0, a lane out of
    the org universe, a lane past the last tx, and messages across the
    padding boundaries."""
    req, _ = _mixed_request()
    keys = [JSW.key_from_scalar("P-256", 0xB10C + o) for o in range(3)]
    n, p = JCURVES["P-256"].fn.modulus, JCURVES["P-256"].fp.modulus
    lanes = list(req.lanes)
    for t, ln in zip(range(4, 8), (0, 55, 120, 200)):
        msg = bytes((t * 31 + j) % 256 for j in range(ln))
        lanes += [_lane(keys[0], msg, t, 0), _lane(keys[t % 3], msg, t,
                                                   t % 3 if t != 4 else 0)]
    a, b = lanes[12], lanes[13]                  # tx 4, org 0 twice
    c, d = lanes[14], lanes[15]                  # tx 5
    lanes[14] = replace(c, s=(n - int.from_bytes(c.s, "big")).to_bytes(
        32, "big"))                              # high-S twin
    lanes[16] = replace(lanes[16], r=b"\0" + lanes[16].r)   # overlong
    lanes[17] = replace(lanes[17], r=n.to_bytes(32, "big"))
    lanes[18] = replace(lanes[18], qy=((int.from_bytes(
        lanes[18].qy, "big") + 1) % p).to_bytes(32, "big"))
    lanes[19] = replace(lanes[19], s=bytes(32))
    lanes += [replace(a, org=5), replace(d, tx=9), replace(a, tx=-1)]
    policies = list(req.policies) + [jbl.BlockPolicy(required=2)] * 4
    return jbl.BlockVerifyRequest("P-256", lanes, policies, norgs=3)


def _assert_packed_equal(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k]
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and g.shape == w.shape, k
            assert np.array_equal(g, w), k
        else:
            assert g == w, k


# ---- blocklane -------------------------------------------------------------

def test_txflag_values_match_reference_and_validator():
    assert bl.TXFLAG_VALID == jbl.TXFLAG_VALID == int(TxFlag.VALID) == 0
    assert bl.TXFLAG_POLICY_FAILURE == jbl.TXFLAG_POLICY_FAILURE == \
        int(TxFlag.ENDORSEMENT_POLICY_FAILURE) == 2


def test_screen_masks_and_tally_match_reference():
    req, _ = _mixed_request()
    good = req.lanes[0]
    for bad in (replace(good, r=b"\0" + good.r), replace(good, qx=bytes(33)),
                replace(good, s=b""), good):
        assert bl.lane_screened(bad) == jbl.lane_screened(bad)
    pols = [jbl.BlockPolicy(required=1, orgs=()),
            jbl.BlockPolicy(required=1, orgs=(1,)),
            jbl.BlockPolicy(required=1, orgs=(0, 7)),
            jbl.BlockPolicy(required=1, orgs=(3,)),   # sentinel: empty
            jbl.BlockPolicy(required=0, orgs=(3,)),
            jbl.BlockPolicy(required=2, orgs=(0, 2, -1))]
    m = bl.policy_org_masks(pols, 3)
    assert m.dtype == np.uint8
    assert np.array_equal(m, jbl.policy_org_masks(pols, 3))
    assert m[3].tolist() == [0, 0, 0]
    rng = np.random.default_rng(6)
    for _ in range(20):
        hit = rng.integers(0, 2, size=(len(pols), 3)).astype(bool)
        got = bl.tally_flags(hit, pols, 3)
        assert got.dtype == np.int32
        assert np.array_equal(got, jbl.tally_flags(hit, pols, 3))


def test_verify_block_host_matches_reference_with_memo():
    req, want = _mixed_request()
    memo, jmemo = {}, {}
    got = bl.verify_block_host(SwCSP().verify_batch, req, digest_memo=memo)
    ref = jbl.verify_block_host(JSW.verify_batch, req, digest_memo=jmemo)
    assert got.dtype == np.int32
    assert got.tolist() == ref.tolist() == want
    assert memo == jmemo and len(memo) == 4
    assert memo[req.lanes[0].msg] == hashlib.sha256(req.lanes[0].msg).digest()
    # the port's own request types, through the port's default CSP hook
    port_req = bl.BlockVerifyRequest(
        req.curve, [bl.BlockLane(**ln.__dict__) for ln in req.lanes],
        [bl.BlockPolicy(p.required, p.orgs) for p in req.policies],
        norgs=req.norgs)
    assert SwCSP().verify_block(port_req).tolist() == want


# ---- buckets and packing ---------------------------------------------------

def test_plan_buckets_match_reference():
    for shape in [(0, 0, 0, 0), (1, 1, 1, 1), (9, 8, 2, 4), (2000, 1000, 16, 4),
                  (8192, 2048, 16, 32), (33, 129, 5, 17)]:
        assert bv.plan_buckets(*shape) == jbv.plan_buckets(*shape)
    for shape in [(8193, 1, 1, 1), (1, 2049, 1, 1), (1, 1, 17, 1),
                  (1, 1, 1, 33)]:
        for mod in (bv, jbv):
            with pytest.raises(ValueError, match="largest bucket"):
                mod.plan_buckets(*shape)


@pytest.mark.parametrize("case", ["mixed", "screened", "out_of_universe",
                                  "hostile", "hostile_low_s", "vectors"])
def test_pack_block_request_bit_identical(case):
    kw = {}
    if case == "mixed":
        req, _ = _mixed_request()
    elif case == "screened":
        req, _ = _mixed_request()
        kw = {"lane_ok": lambda ln: ln.tx != 0}
    elif case == "out_of_universe":
        req, _ = _mixed_request()
        ln = req.lanes[0]
        req.lanes += [replace(ln, org=3), replace(ln, org=-1),
                      replace(ln, tx=4), replace(ln, tx=-2)]
    elif case.startswith("hostile"):
        req = _hostile_request()
        if case == "hostile_low_s":
            kw = {"lane_ok": block_lane_screen("P-256")}
    else:
        req = vectors.block_request("P-256", np.random.default_rng(7), 26,
                                    msg_len=(0, 300), hostile=True)
    got = bv.pack_block_request(req, **kw)
    _assert_packed_equal(got, jbv.pack_block_request(req, **kw))
    assert (got["lane_tx"][len(req.lanes):] == -1).all()
    assert (got["required"][req.ntx:] == 1).all()
    assert (got["org_mask"][req.ntx:] == 0).all()


# ---- the fused program ------------------------------------------------------

@pytest.fixture(scope="module")
def hostile_packed():
    """The reference's packed dict for the hostile request, with the
    provider's low-S screen, and the reference program's (flags,
    valid) on it (one XLA:CPU compile)."""
    packed = jbv.pack_block_request(_hostile_request(),
                                    lane_ok=block_lane_screen("P-256"))
    flags, valid = jbv.launch_block(JCURVES["P-256"], packed, field="fold")
    return packed, np.asarray(flags), np.asarray(valid)


def test_plain_block_kernel_matches_reference_program(hostile_packed):
    packed, jflags, jvalid = hostile_packed
    assert packed["words"].shape == (4, 16, 32)
    assert packed["org_mask"].shape == (8, 4)
    flags, valid = bv.launch_block(CURVES["P-256"], packed, device="cpu")
    assert flags.dtype == torch.int32 and valid.dtype == torch.bool
    assert valid.tolist() == jvalid.tolist()          # filler included
    assert flags.tolist() == jflags.tolist()
    # the flags are the host oracle's (SwCSP applies the low-S policy)
    req = _hostile_request()
    host = bl.verify_block_host(SwCSP().verify_batch, req)
    assert flags.tolist()[:req.ntx] == host.tolist()
    assert host.tolist() == [0, 2, 0, 2, 2, 2, 2, 2]


def test_secp256k1_block_matches_host_oracle():
    req = vectors.block_request("secp256k1", np.random.default_rng(8), 26,
                                msg_len=(0, 130), hostile=True)
    packed = bv.pack_block_request(req)
    flags, valid = bv.launch_block(CURVES["secp256k1"], packed, device="cpu")
    host = bl.verify_block_host(SwCSP().verify_batch, req)
    assert flags.tolist()[:req.ntx] == host.tolist()
    assert 0 < int(valid.sum()) < len(req.lanes)
    assert bv.verify_block_fused(req, device="cpu").tolist() == host.tolist()


# ---- the committer entry point with the port inside -------------------------

def _endorsed_tx(i, orgs=("org1", "org2"), tamper=False):
    action = pb.EndorsedAction()
    action.proposal_hash = bytes([i % 256]) * 32
    w = action.write_set.writes.add()
    w.key, w.value = f"k{i}", b"v%d" % i
    digest = endorsement_digest(action)
    for org in orgs:
        kh = ENDORSERS[org]
        r, s = JSW.sign(kh, digest)
        if tamper:
            r ^= 1
        e = action.endorsements.add()
        pub = kh.public_key()
        e.endorser_x = pub.x.to_bytes(32, "big")
        e.endorser_y = pub.y.to_bytes(32, "big")
        e.org = org
        e.sig_r = r.to_bytes(32, "big")
        e.sig_s = s.to_bytes(32, "big")
    env = pb.TxEnvelope()
    env.header.type = pb.TxType.TX_NORMAL
    env.header.channel_id = "blockchan"
    env.header.tx_id = f"btx-{i}"
    pub = CLIENT.public_key()
    env.header.creator_x = pub.x.to_bytes(32, "big")
    env.header.creator_y = pub.y.to_bytes(32, "big")
    env.header.creator_org = "org1"
    env.payload = action.SerializeToString()
    r, s = JSW.sign(CLIENT, tx_digest(env))
    env.sig_r = r.to_bytes(32, "big")
    env.sig_s = s.to_bytes(32, "big")
    return env


def _block(txs):
    prev = header_hash(genesis_block("blockchan").header)
    return make_block(1, prev, [t.SerializeToString() for t in txs])


@pytest.fixture(scope="module")
def committer_block():
    return _block([
        _endorsed_tx(0),
        _endorsed_tx(1, tamper=True),
        _endorsed_tx(2, orgs=("org1",)),
        _endorsed_tx(3, orgs=("org1", "org2", "org3")),
    ])


@pytest.mark.parametrize("mode", ["on", "off"])
@pytest.mark.parametrize("policy", [
    EndorsementPolicy(required=2),
    EndorsementPolicy(required=1, orgs=frozenset({"org3"})),
], ids=["2-of-any", "org3-only"])
def test_validator_with_torch_csp_equals_sw(monkeypatch, committer_block,
                                            mode, policy):
    monkeypatch.setenv("BDLS_TPU_BLOCK_LANE", mode)
    want = TxValidator(JSwCSP(), policy).validate_block(committer_block)
    csp = TorchCSP(device="cpu", key_cache_size=0)
    try:
        got = TxValidator(csp, policy).validate_block(committer_block)
    finally:
        csp.close()
    assert got == want
    if policy.orgs:
        assert got == [TxFlag.ENDORSEMENT_POLICY_FAILURE] * 3 + [TxFlag.VALID]
    else:
        assert got == [TxFlag.VALID, TxFlag.ENDORSEMENT_POLICY_FAILURE,
                       TxFlag.ENDORSEMENT_POLICY_FAILURE, TxFlag.VALID]
    # with the lane on, the fused path ran (no swallowed exception)
    assert csp._c_block_blocks.value() == (1 if mode == "on" else 0)
    assert csp._c_block_lanes.value() == (8 if mode == "on" else 0)
    assert csp._c_block_fallbacks.value() == 0


# ---- TorchCSP.verify_block ----------------------------------------------------

def _small_request(curve, seed, ntx=2, msg_len=(0, 100)):
    return vectors.block_request(curve, np.random.default_rng(seed), ntx,
                                 msg_len=msg_len)


@pytest.mark.parametrize("curve", sorted(CURVES))
def test_low_s_screen_and_overlong_field(curve):
    req = _small_request(curve, 9, ntx=3)
    n = CURVES[curve].fn.modulus
    ln = req.lanes[0]                              # tx 0
    req.lanes[0] = replace(ln, s=(n - int.from_bytes(ln.s, "big"))
                           .to_bytes(32, "big"))
    req.lanes[2] = replace(req.lanes[2], qy=b"\0" + req.lanes[2].qy)  # tx 1
    csp = TorchCSP(device="cpu", key_cache_size=0)
    try:
        got = csp.verify_block(req)
    finally:
        csp.close()
    host = bl.verify_block_host(SwCSP().verify_batch, req)
    assert got.dtype == np.int32
    assert got.tolist() == host.tolist()
    # P-256 rejects the high-S twin; secp256k1 accepts it
    assert got.tolist() == ([2, 2, 0] if curve == "P-256" else [0, 2, 0])
    assert csp._c_block_fallbacks.value() == 0


def test_oversize_request_takes_the_counted_host_path():
    req = _small_request("P-256", 10, ntx=2)
    ln = req.lanes[2]
    long_msg = bytes(1016)                         # 17 SHA-256 blocks
    r, s = JSW.sign(JSW.key_from_scalar("P-256", 0xEB01),
                    hashlib.sha256(long_msg).digest())
    pub = JSW.key_from_scalar("P-256", 0xEB01).public_key()
    req.lanes[2] = replace(ln, msg=long_msg, qx=pub.x.to_bytes(32, "big"),
                           qy=pub.y.to_bytes(32, "big"),
                           r=r.to_bytes(32, "big"), s=s.to_bytes(32, "big"))
    with pytest.raises(ValueError, match="largest bucket"):
        bv.request_buckets(req)
    metrics = MetricsProvider()
    tracer = tracing.Tracer(metrics=metrics)
    csp = TorchCSP(device="cpu", key_cache_size=0, metrics=metrics,
                   tracer=tracer, buckets=(8,))
    try:
        got = csp.verify_block(req)
    finally:
        csp.close()
    assert got.tolist() == bl.verify_block_host(SwCSP().verify_batch,
                                                req).tolist() == [0, 0]
    assert metrics.find("tpu_block_fallbacks_total").value() == 1
    assert metrics.find("tpu_block_blocks_total").value() == 1
    assert metrics.find("tpu_verify_batches_total").value() == 1
    span = [s for t in tracer.completed() for s in t["spans"]
            if s["name"] == "tpu.verify_block"][0]
    assert span["attrs"]["fused"] is False
    assert span["attrs"]["outcome"] == "fallback"


def test_failed_launch_raises_and_counts_no_fallback(monkeypatch):
    def broken(curve, packed, *, device=None):
        raise RuntimeError("launch refused")

    req = _small_request("P-256", 11, ntx=1)
    csp = TorchCSP(device="cpu", key_cache_size=0)
    monkeypatch.setattr(bv, "launch_block", broken)
    try:
        with pytest.raises(RuntimeError, match="launch refused"):
            csp.verify_block(req)
    finally:
        csp.close()
    assert csp._c_block_fallbacks.value() == 0
    assert csp.stats["batches"] == 0


def test_instruments_and_span_keep_reference_names():
    metrics = MetricsProvider()
    tracer = tracing.Tracer(metrics=metrics)
    req = _small_request("P-256", 12, ntx=2)
    csp = TorchCSP(device="cpu", key_cache_size=0, metrics=metrics,
                   tracer=tracer)
    try:
        got = csp.verify_block(req)
    finally:
        csp.close()
    assert got.tolist() == [0, 0]
    for name in ("tpu_block_rtt_seconds", "tpu_block_blocks_total",
                 "tpu_block_lanes_total", "tpu_block_fallbacks_total"):
        assert metrics.find(name) is not None, name
    assert metrics.find("tpu_block_blocks_total").value() == 1
    assert metrics.find("tpu_block_lanes_total").value() == 4
    assert metrics.find("tpu_block_fallbacks_total").value() == 0
    assert metrics.find("tpu_block_rtt_seconds").snapshot()["count"] == 1
    span = [s for t in tracer.completed() for s in t["spans"]
            if s["name"] == "tpu.verify_block"][0]
    assert span["attrs"] == {"lanes": 4, "txs": 2, "orgs": 4, "fused": True}
