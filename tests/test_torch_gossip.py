"""The port's gossip (``bdls_tpu_torch/peer/gossip.py``) against the JAX
package's ``bdls_tpu/peer/gossip.py``, on the CPU.

The reference's four scenarios (``tests/test_gossip.py``: push to
gossip-only peers, a partitioned peer healing by state transfer,
anti-entropy, stale and duplicate pushes) run in both packages on the
same block bytes (made once by the reference's fixtures), the same line
topology and the same seeds, each package's peers on its own
``SwCSP``. After every step the heights, the out-of-order buffers, the
``stats`` and the gossip layer's tracing spans agree, and at the end the
ledgers and KV states, byte for byte. Then the first scenario over one
block with the port's last peer on ``TorchCSP(device="cpu")``: it
commits what it is pushed through K7's plain twin, with the same
ledger.
"""

from __future__ import annotations

import pytest
import torch

from bdls_tpu.crypto.msp import Identity as JIdentity
from bdls_tpu.crypto.msp import LocalMSP as JLocalMSP
from bdls_tpu.crypto.sw import SwCSP as JSwCSP
from bdls_tpu.models.peer import PeerNode as JPeerNode
from bdls_tpu.peer import gossip as JG
from bdls_tpu.peer.validator import EndorsementPolicy as JPolicy
from bdls_tpu_torch.crypto.msp import Identity, LocalMSP
from bdls_tpu_torch.crypto.sw import SwCSP
from bdls_tpu_torch.crypto.torch_provider import TorchCSP
from bdls_tpu_torch.models.peer import PeerNode
from bdls_tpu_torch.ordering import fabric_codec as pb
from bdls_tpu_torch.peer import gossip as G
from bdls_tpu_torch.peer.validator import EndorsementPolicy

from test_gossip import ListSource, make_chain
from test_validator_security import CREATOR, ENDORSER

torch.set_num_threads(1)

SIDES = {
    "reference": (JSwCSP, JLocalMSP, JIdentity, JPeerNode, JPolicy, JG),
    "port": (SwCSP, LocalMSP, Identity, PeerNode, EndorsementPolicy, G),
}


def build(side, raw_blocks, fanout=2, card_last=False):
    """The reference test's ``build``: three peers of org1-3, only the
    first with the orderer source, on a line g0 - g1 - g2."""
    csp_cls, msp_cls, ident_cls, peer_cls, pol_cls, mod = SIDES[side]
    csp = csp_cls()
    if side == "port":
        blocks = [pb.Block.FromString(b) for b in raw_blocks]
    else:
        from bdls_tpu.ordering import fabric_pb2 as jpb

        blocks = [jpb.Block.FromString(b) for b in raw_blocks]
    source = ListSource(blocks)
    msp = msp_cls(csp)
    for handle in (CREATOR, ENDORSER):
        pub = handle.public_key()
        msp.register(ident_cls(org="org1", key=type(pub)(pub.curve, pub.x,
                                                           pub.y))
                     if side == "reference" else
                     ident_cls(org="org1", key=csp.key_from_scalar(
                         "P-256", SCALARS[handle]).public_key()))
    peers, csps = [], []
    for i, org in enumerate(("org1", "org2", "org3")):
        pcsp = (TorchCSP(device="cpu", key_cache_size=0)
                if card_last and i == 2 else csp)
        csps.append(pcsp)
        peers.append(peer_cls(
            channel_id="sec", csp=pcsp, org=org,
            signing_key=pcsp.key_from_scalar("P-256", 0xD100 + i),
            genesis=blocks[0],
            orderer_sources=[source] if i == 0 else [],
            policy=pol_cls(required=1), msp=msp))
    nodes = [mod.GossipNode(p, fanout=fanout, seed=i)
             for i, p in enumerate(peers)]
    nodes[0].connect(nodes[1])
    nodes[1].connect(nodes[2])
    return source, nodes, csps


SCALARS = {CREATOR: 0xD001, ENDORSER: 0xD002}


def sc_converge_via_push(source, g):
    yield lambda: g[0].poll_and_push()


def sc_partition_heals(source, g):
    def cut():
        source.limit = 3
        g[2].online = False
    yield cut
    yield lambda: g[0].poll_and_push()

    def heal():
        g[2].online = True
        source.limit = 4
    yield heal
    yield lambda: g[0].poll_and_push()


def sc_anti_entropy(source, g):
    def off():
        g[2].online = False
    yield off
    yield lambda: g[0].poll_and_push()

    def on():
        g[2].online = True
    yield on
    yield lambda: g[2].anti_entropy()


def sc_stale_and_duplicate(source, g):
    yield lambda: g[0].poll_and_push()
    yield lambda: g[2].receive_block(g[1], g[1].peer.get_block(1))
    yield lambda: g[1].receive_announcement(g[0], 1)


SCENARIOS = {"converge_via_push": (sc_converge_via_push, 3),
             "partition_heals": (sc_partition_heals, 3),
             "anti_entropy": (sc_anti_entropy, 2),
             "stale_and_duplicate": (sc_stale_and_duplicate, 2)}


def snapshot(nodes):
    return [(g.height(), sorted(g._buffer), dict(g.stats), g.online,
             len(g.neighbors)) for g in nodes]


def run(side, scenario, raw, card_last=False):
    source, nodes, csps = build(side, raw, card_last=card_last)
    try:
        steps = [snapshot(nodes)]
        for step in scenario(source, nodes):
            step()
            steps.append(snapshot(nodes))
        ledgers = [[g.peer.get_block(i).SerializeToString()
                    for i in range(g.height())] for g in nodes]
        states = [[(key, g.peer.state.get(key), g.peer.state.version(key))
                   for key in g.peer.state.keys()] for g in nodes]
    finally:
        for c in csps:
            getattr(c, "close", lambda: None)()
    return steps, ledgers, states


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_gossip_matches_reference(name, monkeypatch):
    scenario, k = SCENARIOS[name]
    raw = [b.SerializeToString() for b in make_chain(k)]
    got = {}
    for side in ("reference", "port"):
        mod = SIDES[side][-1]
        spans = []
        real = mod.tracing.GLOBAL.span

        def span(span_name, *a, _real=real, _spans=spans, **kw):
            if span_name.startswith("gossip."):
                _spans.append(span_name)
            return _real(span_name, *a, **kw)

        monkeypatch.setattr(mod.tracing.GLOBAL, "span", span)
        got[side] = run(side, scenario, raw) + (spans,)
    assert got["port"] == got["reference"]
    steps, ledgers, _, spans = got["port"]
    assert steps[-1][0][0] == k + 1 and "gossip.receive_block" in spans
    if name == "partition_heals":
        assert steps[-1][2][2]["transferred"] >= 2


def test_a_peer_on_the_plain_twins_commits_what_it_is_pushed():
    raw = [b.SerializeToString() for b in make_chain(1)]
    sw = run("port", sc_converge_via_push, raw)
    card = run("port", sc_converge_via_push, raw, card_last=True)
    assert card == sw and sw[0][-1][2][0] == 2


def test_connect_mesh_matches_reference():
    raw = [b.SerializeToString() for b in make_chain(1)]
    degrees = {}
    for side in ("reference", "port"):
        _, nodes, _ = build(side, raw)
        for g in nodes:
            g.neighbors.clear()
        SIDES[side][-1].connect_mesh(nodes)
        degrees[side] = [sorted(nodes.index(n) for n in g.neighbors)
                         for g in nodes]
    assert degrees["port"] == degrees["reference"] == [[1, 2], [0, 2],
                                                        [0, 1]]
