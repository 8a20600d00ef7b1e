"""The transaction flow on the port against the JAX package, on the CPU:
gateway → endorsing peers → BDLS chains → delivery → committer → kv
state (the reference's ``tests/test_gateway.py`` assembly).

The port's assembly is :mod:`bdls_tpu_torch.models.txflow`; the
reference's is built here the same way, from the same seeds, scalars
and tx ids, with its chains signing by the port's deterministic nonce
(as ``tests/test_torch_engine_framelog.py`` does) and its P-256 provider
too, so that the two flows exchange the same bytes. Four validators,
10-tx blocks, the port's ``SwCSP`` and ``CpuBatchVerifier()``. A
workload with phase 6j's hostile transactions
(``tests/_txflow_workload.py``) commits, in both
packages, the same envelopes, orderer ledgers, peer ledgers (flags in
metadata slot 0), KV states with their history, and commit statuses.
Then the reference's gateway tests on the port: a submit commits, an
evaluate changes nothing, a stateful contract reads committed state, a
single-org endorsement fails at commit; and the peer's delivery client
rotating away from a censoring source, draw for draw as the
reference's. Every comparison is exact.
"""

from __future__ import annotations

import hashlib
from typing import Optional

import pytest

from bdls_tpu.consensus import Signer as JSigner
from bdls_tpu.consensus import wire_pb2
from bdls_tpu.consensus.ipc import VirtualNetwork as JNetwork
from bdls_tpu.consensus.verifier import CpuBatchVerifier as JCpu
from bdls_tpu.crypto.msp import Identity as JIdentity
from bdls_tpu.crypto.msp import LocalMSP as JLocalMSP
from bdls_tpu.crypto.sw import SwCSP as JSwCSP
from bdls_tpu.models.peer import Gateway as JGateway
from bdls_tpu.models.peer import PeerNode as JPeerNode
from bdls_tpu.ordering import fabric_pb2 as jpb
from bdls_tpu.ordering.block import genesis_block as jgenesis
from bdls_tpu.ordering.block import tx_digest as jtx_digest
from bdls_tpu.ordering.blockcutter import BatchConfig as JBatchConfig
from bdls_tpu.ordering.chain import Chain as JChain
from bdls_tpu.ordering.ledger import MemoryLedger as JMemoryLedger
from bdls_tpu.peer.deliverclient import BFTDeliverer as JBFTDeliverer
from bdls_tpu.peer.endorser import Endorser as JEndorser
from bdls_tpu.peer.validator import EndorsementPolicy as JPolicy
from bdls_tpu_torch.consensus import CpuBatchVerifier
from bdls_tpu_torch.consensus.identity import sign_payload
from bdls_tpu_torch.crypto.sw import KeyHandle, SwCSP
from bdls_tpu_torch.models import txflow as F
from bdls_tpu_torch.models.peer import PeerNode
from bdls_tpu_torch.ordering import fabric_codec as pb
from bdls_tpu_torch.peer.deliverclient import BFTDeliverer
from bdls_tpu_torch.peer.validator import EndorsementPolicy, TxFlag

import _txflow_workload as W

SW = SwCSP()


class DeterministicSigner(JSigner):
    """The reference's consensus signer with the port's nonce."""

    def sign_payload(self, payload: bytes) -> wire_pb2.SignedEnvelope:
        d = self.private_key.private_numbers().private_value
        env = sign_payload(KeyHandle("secp256k1", d), payload)
        out = wire_pb2.SignedEnvelope()
        out.version, out.payload = env.version, env.payload
        out.pub_x, out.pub_y = env.pub_x, env.pub_y
        out.sig_r, out.sig_s = env.sig_r, env.sig_s
        return out


class DeterministicJSwCSP(JSwCSP):
    """The reference's provider with the port's deterministic nonce."""

    def sign(self, key_handle, digest):
        d = key_handle._sk.private_numbers().private_value
        return SW.sign(KeyHandle(key_handle.curve, d), digest)


class JChainSource:
    """The reference side's block source: a copy a block, as
    ``txflow.ChainSource`` hands out."""

    def __init__(self, chain):
        self.chain = chain

    def height(self) -> int:
        return self.chain.ledger.height()

    def get_block(self, n: int) -> Optional[jpb.Block]:
        try:
            blk = self.chain.ledger.get(n)
        except Exception:
            return None
        return jpb.Block.FromString(blk.SerializeToString())


def reference_stack(validators=4, max_message_count=10, batch_timeout=0.2):
    """``txflow.build_stack`` built from the reference's classes."""
    csp = DeterministicJSwCSP()
    signers = [DeterministicSigner.from_scalar(F.SIGNER_BASE + i)
               for i in range(validators)]
    participants = [s.identity for s in signers]
    net = JNetwork(seed=2, latency=0.01)
    genesis = jgenesis(F.CHANNEL)
    chains = []
    for s in signers:
        ledger = JMemoryLedger()
        ledger.append(genesis)
        chain = JChain(
            channel_id=F.CHANNEL, signer=s, participants=participants,
            ledger=ledger,
            batch_config=JBatchConfig(max_message_count=max_message_count,
                                      batch_timeout=batch_timeout),
            verifier=JCpu(), latency=0.05)
        net.add_node(chain)
        chains.append(chain)
    net.connect_all()
    sources = [JChainSource(c) for c in chains]
    msp = JLocalMSP(csp)
    for org, scalar in F.ORG_SCALARS:
        msp.register(JIdentity(
            org=org, key=csp.key_from_scalar("P-256", scalar).public_key()))
    client = csp.key_from_scalar("P-256", F.CLIENT_SCALAR)
    msp.register(JIdentity(org=F.CLIENT_ORG, key=client.public_key()))
    peers = []
    for org, scalar in F.ORG_SCALARS[:2]:
        peer = JPeerNode(
            channel_id=F.CHANNEL, csp=csp, org=org,
            signing_key=csp.key_from_scalar("P-256", scalar),
            genesis=genesis, orderer_sources=sources,
            policy=JPolicy(required=2), msp=msp)
        peer.endorser.register_contract("kvput", F.kv_put_contract)
        peer.endorser.register_contract("incr", F.kv_increment_contract)
        peers.append(peer)
    gateway = JGateway(csp, client, F.CLIENT_ORG, peers,
                       broadcast=lambda env: chains[0].submit(env, net.now),
                       required_orgs=2)
    return F.Stack(net, chains, peers, gateway, msp, genesis, csp)


def reference_hostile(stack, kind, args, tx_id) -> bytes:
    """``_txflow_workload.hostile_envelope`` from the reference's classes."""
    gw = stack.gateway

    def signed(payload):
        env = jpb.TxEnvelope()
        env.header.type = jpb.TxType.TX_NORMAL
        env.header.channel_id = F.CHANNEL
        env.header.tx_id = tx_id
        pub = gw.client_key.public_key()
        env.header.creator_x = pub.x.to_bytes(32, "big")
        env.header.creator_y = pub.y.to_bytes(32, "big")
        env.header.creator_org = gw.client_org
        env.payload = payload
        r, s = gw.csp.sign(gw.client_key, jtx_digest(env))
        env.sig_r, env.sig_s = r.to_bytes(32, "big"), s.to_bytes(32, "big")
        return env.SerializeToString()

    if kind == "bad_payload":
        return signed(W.BAD_PAYLOAD)
    prop = gw._proposal(F.CHANNEL, "kvput", args)
    action = stack.peers[0].endorser.process_proposal(prop)
    if kind == "unknown_endorser":
        JEndorser(stack.csp, stack.csp.key_from_scalar("P-256",
                                                       W.ROGUE_SCALAR),
                  stack.peers[1].org, stack.peers[1].state).endorse(action)
    else:
        action.endorsements.extend(
            stack.peers[1].endorser.process_proposal(prop).endorsements)
        if kind == "flipped_endorsement":
            e = action.endorsements[1]
            e.sig_s = e.sig_s[:-1] + bytes([e.sig_s[-1] ^ 1])
    return signed(action.SerializeToString())


def submit_reference(stack, txs) -> list[bytes]:
    sent = []
    real = stack.gateway.broadcast
    stack.gateway.broadcast = lambda env: (sent.append(env), real(env))
    for tx in txs:
        if tx.kind is None:
            stack.gateway.submit(F.CHANNEL, "kvput", tx.args, tx_id=tx.tx_id)
        else:
            env = reference_hostile(stack, tx.kind, tx.args, tx.tx_id)
            stack.gateway.broadcast(env)
    stack.gateway.broadcast = real
    return sent


def view(stack, nblocks):
    """Everything the two flows must agree on."""
    return {
        "orderers": [[c.ledger.get(i).SerializeToString()
                      for i in range(c.height())] for c in stack.chains],
        "peers": [[p.block_store.get(i).SerializeToString()
                   for i in range(p.height())] for p in stack.peers],
        "flags": [[list(p.block_store.get(i).metadata.entries[0])
                   for i in range(1, nblocks + 1)] for p in stack.peers],
        "state": [{k: (p.state.get(k), p.state.version(k),
                       p.state.history(k)) for k in p.state.keys()}
                  for p in stack.peers],
        "stats": [p.committer.stats for p in stack.peers],
    }


def test_gateway_flow_matches_reference_end_to_end():
    txs = W.plan(40, 10, hostile_every=5, offset=2)
    stack = F.build_stack(SW, CpuBatchVerifier(), validators=4,
                          max_message_count=10, batch_timeout=0.2)
    sub = W.submit_plan(stack, txs)
    assert F.drive_until(stack, 5, 60.0)
    jstack = reference_stack()
    sent = submit_reference(jstack, txs)
    assert [hashlib.sha256(e).digest() for e in sent] == sub.order
    assert F.drive_until(jstack, 5, 60.0)
    assert jstack.net.now == stack.net.now
    got, want = view(stack, 4), view(jstack, 4)
    assert got == want
    flags = [f for blk in got["flags"][0] for f in blk]
    expected = [int(sub.expected[h]) for h in sub.order]
    assert flags == expected
    assert expected.count(int(TxFlag.VALID)) == 32
    assert {k: v[0] for k, v in got["state"][0].items()} == sub.writes
    hostile = [sub.kinds[h] for h in sub.order if h in sub.kinds]
    assert sorted(set(hostile)) == sorted(W.HOSTILE_KINDS)
    for tx in txs[:3]:
        assert stack.gateway.commit_status(tx.tx_id, timeout=0.0,
                                           poll=lambda: None) == \
            jstack.gateway.commit_status(tx.tx_id, timeout=0.0,
                                         poll=lambda: None)


# ---- the reference's gateway tests, on the port -----------------------------

def port_stack():
    return F.build_stack(SW, CpuBatchVerifier())


def test_gateway_submit_commits_to_kv_state():
    st = port_stack()
    tx_id = st.gateway.submit(F.CHANNEL, "kvput",
                              [b"color", b"blue", b"size", b"42"])
    F.drive(st.net, st.peers, 20.0)
    assert st.gateway.commit_status(tx_id, timeout=0.0,
                                    poll=lambda: None) == TxFlag.VALID
    for p in st.peers:
        assert p.state.get("color") == b"blue"
        assert p.state.get("size") == b"42"
    assert st.peers[0].tx_status("no such tx") is None


def test_gateway_evaluate_is_side_effect_free():
    st = port_stack()
    ws = st.gateway.evaluate(F.CHANNEL, "kvput", [b"ghost", b"1"])
    assert ws.writes[0].key == "ghost"
    F.drive(st.net, st.peers, 3.0)
    assert st.peers[0].state.get("ghost") is None
    assert all(c.height() == 1 for c in st.chains)


def test_gateway_stateful_contract_reads_committed_state():
    st = port_stack()
    for _ in range(2):
        t = st.gateway.submit(F.CHANNEL, "incr", [b"counter"])
        F.drive(st.net, st.peers, 20.0)
        assert st.gateway.commit_status(t, timeout=0.0,
                                        poll=lambda: None) == TxFlag.VALID
    for p in st.peers:
        assert p.state.get("counter") == b"2"
        assert [v for _, v in p.state.history("counter")] == [b"1", b"2"]


def test_insufficient_endorsements_rejected_at_commit():
    st = port_stack()
    st.gateway.required_orgs = 1
    tx_id = st.gateway.submit(F.CHANNEL, "kvput", [b"bad", b"1"])
    F.drive(st.net, st.peers, 20.0)
    assert st.gateway.commit_status(tx_id, timeout=0.0, poll=lambda: None) \
        == TxFlag.ENDORSEMENT_POLICY_FAILURE
    for p in st.peers:
        assert p.state.get("bad") is None


def test_peer_needs_an_msp_unless_built_without_membership():
    st = port_stack()
    args = dict(channel_id=F.CHANNEL, csp=SW, org="org1",
                signing_key=SW.key_from_scalar("P-256", 0xEE01),
                genesis=st.genesis, orderer_sources=[])
    with pytest.raises(ValueError, match="requires an MSP"):
        PeerNode(**args, msp=None)
    peer = PeerNode.without_membership(**args)
    assert peer.msp is None and peer.deliverer is None and peer.poll() == 0
    assert peer.get_block(0).SerializeToString() == \
        st.genesis.SerializeToString()
    assert peer.get_block(5) is None


class _Source:
    """A block source that holds ``have`` blocks and serves ``serve``
    of them (a censoring orderer serves fewer than it has)."""

    def __init__(self, mod, have, serve, fail=False):
        self.mod, self.have, self.serve, self.fail = mod, have, serve, fail

    def height(self) -> int:
        if self.fail:
            raise ConnectionError("down")
        return self.have

    def get_block(self, n: int):
        if n >= self.serve:
            return None
        blk = self.mod.Block()
        blk.header.number = n
        return blk


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_deliverer_rotates_from_censoring_sources_like_the_reference(seed):
    runs = []
    for mod, cls in ((pb, BFTDeliverer), (jpb, JBFTDeliverer)):
        got = []
        srcs = [_Source(mod, 9, 3), _Source(mod, 9, 9, fail=True),
                _Source(mod, 9, 5), _Source(mod, 9, 9)]
        d = cls(srcs, on_block=lambda b: got.append(b.header.number),
                start_height=1, censorship_threshold=2, seed=seed)
        trace = [d._current]
        for _ in range(4):
            trace.append((d.poll(), d._current, d.next_number))
        runs.append((got, trace, vars(d.stats)))
    assert runs[0] == runs[1]
    assert runs[0][0] == list(range(1, 9))
    with pytest.raises(ValueError):
        BFTDeliverer([], on_block=print)
