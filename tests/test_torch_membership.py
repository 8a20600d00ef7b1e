"""The port's membership and delivery-leader election
(``bdls_tpu_torch/peer/membership.py``) against the JAX package's
``bdls_tpu/peer/membership.py``, on the CPU.

- The reference's five scenarios (``tests/test_membership.py``: a mesh
  discovered from one bootstrap address, a late joiner, the leader's
  death and the failover, a forged and a non-member alive message,
  only peers with an orderer source leading) run in both packages with
  the same keys, the same block bytes and the same seeds, each on its
  own ``SwCSP``. After every tick the two agree on each node's view
  (its identities), ``is_leader``, ``stats`` and height.
- The alive digest is the reference's, byte for byte: an alive message
  the reference signs (its random nonce) is admitted by a port node on
  ``TorchCSP(device="cpu")`` (K1's plain twin), one the port signs (its
  deterministic nonce) by a reference node; a tampered one and one from
  a key outside the MSP are refused by both.
"""

from __future__ import annotations

import pytest
import torch

from bdls_tpu.crypto.msp import Identity as JIdentity
from bdls_tpu.crypto.msp import LocalMSP as JLocalMSP
from bdls_tpu.crypto.sw import SwCSP as JSwCSP
from bdls_tpu.models.peer import PeerNode as JPeerNode
from bdls_tpu.ordering import fabric_pb2 as jpb
from bdls_tpu.peer import gossip as JG
from bdls_tpu.peer import membership as JMem
from bdls_tpu.peer.validator import EndorsementPolicy as JPolicy
from bdls_tpu_torch.crypto.msp import Identity, LocalMSP
from bdls_tpu_torch.crypto.sw import SwCSP
from bdls_tpu_torch.crypto.torch_provider import TorchCSP
from bdls_tpu_torch.models.peer import PeerNode
from bdls_tpu_torch.ordering import fabric_codec as pb
from bdls_tpu_torch.peer import gossip as G
from bdls_tpu_torch.peer import membership as Mem
from bdls_tpu_torch.peer.validator import EndorsementPolicy

from test_gossip import ListSource, make_chain

torch.set_num_threads(1)

SIDES = {
    "reference": (JSwCSP(), JLocalMSP, JIdentity, JPeerNode, JPolicy, JG,
                  JMem, jpb),
    "port": (SwCSP(), LocalMSP, Identity, PeerNode, EndorsementPolicy, G,
             Mem, pb),
}
# the fixtures' creator and endorser (tests/test_validator_security.py)
FIXTURE_SCALARS = (0xD001, 0xD002)
RAW = {k: [b.SerializeToString() for b in make_chain(k)] for k in (2, 3, 4)}


def build_net(side, n=4, k=3, sources=None, reveal=None, base=0xF100,
              endpoint="peer{}:7051"):
    """The reference test's ``build_net``: ``n`` peers of org1 with keys
    ``base + i``, one MSP, the orderer source on the peers in
    ``sources`` (all by default), alive every 0.5 s, dead after 3 s,
    leading after 1 s."""
    csp, msp_cls, ident_cls, peer_cls, pol_cls, gmod, mmod, mpb = SIDES[side]
    blocks = [mpb.Block.FromString(b) for b in RAW[k]]
    source = ListSource(blocks)
    if reveal is not None:
        source.limit = reveal
    msp = msp_cls(csp)
    keys = [csp.key_from_scalar("P-256", base + i) for i in range(n)]
    for scalar in FIXTURE_SCALARS:
        msp.register(ident_cls(org="org1", key=csp.key_from_scalar(
            "P-256", scalar).public_key()))
    for key in keys:
        msp.register(ident_cls(org="org1", key=key.public_key()))
    registry, nodes = {}, []
    for i, key in enumerate(keys):
        peer = peer_cls(
            channel_id="sec", csp=csp, org="org1", signing_key=key,
            genesis=blocks[0],
            orderer_sources=[source] if sources is None or i in sources
            else [],
            policy=pol_cls(required=1), msp=msp)
        nodes.append(mmod.DiscoveryNode(
            gmod.GossipNode(peer, fanout=2, seed=i),
            endpoint=endpoint.format(i), registry=registry, signing_key=key,
            org="org1", alive_interval=0.5, dead_after=3.0, lead_after=1.0))
    return source, nodes


def state(nodes, now):
    return [(sorted(n.view), n.is_leader(now), dict(n.stats),
             n.peer.height()) for n in nodes]


class Trace:
    """Ticks nodes as the reference test's ``drive`` does and keeps the
    state of every node after every tick."""

    def __init__(self):
        self.ticks = []

    def drive(self, nodes, everyone, t0, seconds, step=0.25):
        now = t0
        for _ in range(int(seconds / step)):
            now += step
            for node in nodes:
                node.tick(now)
            self.ticks.append(state(everyone, now))
        return now


def sc_bootstrap(side, tr):
    source, nodes = build_net(side)
    for node in nodes[1:]:
        node.bootstrap("peer0:7051", 0.0)
    now = tr.drive(nodes, nodes, 0.0, 6.0)
    assert all(len(n.view) == 3 for n in nodes)
    assert sum(n.is_leader(now) for n in nodes) == 1
    assert all(n.peer.height() == source.height() for n in nodes)


def sc_late_joiner(side, tr):
    source, nodes = build_net(side)
    for node in nodes[1:3]:
        node.bootstrap("peer0:7051", 0.0)
    now = tr.drive(nodes[:3], nodes, 0.0, 4.0)
    nodes[3].bootstrap("peer2:7051", now)
    tr.drive(nodes, nodes, now, 6.0)
    assert len(nodes[3].view) == 3
    assert nodes[3].peer.height() == source.height()


def sc_leader_death(side, tr):
    source, nodes = build_net(side, k=4, reveal=3)
    for node in nodes[1:]:
        node.bootstrap("peer0:7051", 0.0)
    now = tr.drive(nodes, nodes, 0.0, 6.0)
    dead = [n for n in nodes if n.is_leader(now)][0]
    dead.gossip.online = False
    alive = [n for n in nodes if n is not dead]
    now = tr.drive(alive, nodes, now, 8.0)
    assert all(dead.identity not in n.view for n in alive)
    new = [n for n in alive if n.is_leader(now)]
    assert len(new) == 1 and new[0] is not dead
    source.limit = len(source.blocks)
    tr.drive(alive, nodes, now, 6.0)
    assert all(n.peer.height() == source.height() for n in alive)


def sc_forged_alive(side, tr):
    csp, mmod = SIDES[side][0], SIDES[side][6]
    _, nodes = build_net(side, n=3)
    target = nodes[0]
    rogue = csp.key_from_scalar("P-256", 0xBAD001)
    pub = rogue.public_key()
    msg = mmod.AliveMsg("org1", pub.x, pub.y, "rogue:7051", 1)
    r, s = csp.sign(rogue, msg.tbs_digest())
    target.receive_alive([mmod.AliveMsg("org1", pub.x, pub.y, "rogue:7051",
                                        1, r, s)], nodes[1], 1.0)
    tr.ticks.append(state(nodes, 1.0))
    pub = csp.key_from_scalar("P-256", 0xF101).public_key()
    target.receive_alive([mmod.AliveMsg("org1", pub.x, pub.y, "peer1:7051",
                                        99, 1, 1)], nodes[1], 1.0)
    tr.ticks.append(state(nodes, 1.0))
    assert target.view == {} and target.stats["alive_rejected"] == 2


def sc_only_sources_lead(side, tr):
    source, nodes = build_net(side, n=3, k=2, sources={2}, base=0xF200,
                              endpoint="p{}")
    for node in nodes[:2]:
        node.bootstrap("p2", 0.0)
    now = tr.drive(nodes, nodes, 0.0, 5.0)
    assert [n.is_leader(now) for n in nodes] == [False, False, True]
    assert all(n.peer.height() == source.height() for n in nodes)


SCENARIOS = {"bootstrap": sc_bootstrap, "late_joiner": sc_late_joiner,
             "leader_death": sc_leader_death,
             "forged_alive": sc_forged_alive,
             "only_sources_lead": sc_only_sources_lead}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_membership_matches_reference_at_every_tick(name):
    traces = {}
    for side in ("reference", "port"):
        tr = Trace()
        SCENARIOS[name](side, tr)
        traces[side] = tr.ticks
    assert traces["port"] == traces["reference"]
    assert traces["port"]


def _alive(side, scalar, endpoint, seq, flip=0):
    csp, mmod = SIDES[side][0], SIDES[side][6]
    key = csp.key_from_scalar("P-256", scalar)
    pub = key.public_key()
    msg = mmod.AliveMsg("org1", pub.x, pub.y, endpoint, seq)
    r, s = csp.sign(key, msg.tbs_digest())
    return mmod.AliveMsg("org1", pub.x, pub.y, endpoint, seq, r, s ^ flip)


def _as(side, msg):
    return SIDES[side][6].AliveMsg(msg.org, msg.key_x, msg.key_y,
                                   msg.endpoint, msg.seq, msg.sig_r,
                                   msg.sig_s)


def test_alive_messages_cross_between_the_packages():
    port_msg = _alive("port", 0xF101, "peer1:7051", 5)
    ref_msg = _alive("reference", 0xF102, "peer2:7051", 6)
    assert port_msg.tbs_digest() == _as("reference", port_msg).tbs_digest()
    cases = {
        "port-signed": (port_msg, True),
        "reference-signed": (ref_msg, True),
        "tampered": (_alive("port", 0xF103, "peer3:7051", 7, flip=1), False),
        "outsider": (_alive("port", 0xBAD003, "rogue:7051", 1), False),
    }
    for side in ("reference", "port"):
        _, nodes = build_net(side)
        for what, (msg, want) in cases.items():
            target = nodes[0]
            before = target.stats["alive_rejected"]
            target.receive_alive([_as(side, msg)], nodes[1], 1.0)
            got = target.view.get(msg.ident(), (None,))[0]
            assert (got is not None) == want, (side, what)
            assert target.stats["alive_rejected"] - before == int(not want)
    # the reference's signature and a tampered one, decided by K1's
    # plain twin on a fresh port node
    _, nodes = build_net("port")
    csp = TorchCSP(device="cpu", key_cache_size=0)
    try:
        nodes[0].csp = csp
        nodes[0].receive_alive([_as("port", ref_msg),
                                _as("port", cases["tampered"][0])],
                               nodes[1], 1.0)
        assert list(nodes[0].view) == [ref_msg.ident()]
        assert nodes[0].stats["alive_rejected"] == 1
    finally:
        csp.close()
