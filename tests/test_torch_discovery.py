"""The port's discovery service (``bdls_tpu_torch/peer/discovery.py``)
against the JAX package's ``bdls_tpu/peer/discovery.py``, on the CPU:
the same peers, orderers and endorsement descriptors (layouts and peers
by org) for the reference test's topology and a table of policies, the
same ``DiscoveryError`` texts, and the same descriptor cache: a hit
within the TTL, a miss after it and after a height update, with the
clock (``time.monotonic``, as both read it) stepped the same way."""

from __future__ import annotations

import dataclasses
import time

import pytest

from bdls_tpu.crypto.msp import LocalMSP as JLocalMSP
from bdls_tpu.crypto.sw import SwCSP as JSwCSP
from bdls_tpu.peer import discovery as JD
from bdls_tpu.peer.validator import EndorsementPolicy as JPolicy
from bdls_tpu_torch.crypto.msp import LocalMSP
from bdls_tpu_torch.crypto.sw import SwCSP
from bdls_tpu_torch.peer import discovery as D
from bdls_tpu_torch.peer.validator import EndorsementPolicy

SIDES = {"reference": (JD, JPolicy, JLocalMSP, JSwCSP),
         "port": (D, EndorsementPolicy, LocalMSP, SwCSP)}
ORGS3 = frozenset({"org1", "org2", "org3"})
POLICIES = {
    "kvput": (2, ORGS3), "": (1, frozenset()), "all3": (3, ORGS3),
    "pair": (2, frozenset({"org1", "org3"})), "one": (1, ORGS3),
    "stranger": (1, frozenset({"org9"})), "hard": (4, ORGS3),
}


def make_service(side, ttl=100.0):
    mod, pol, msp_cls, csp_cls = SIDES[side]
    svc = mod.DiscoveryService(msp_cls(csp_cls()), cache_ttl=ttl)
    svc.register_channel(mod.ChannelTopology(
        channel_id="dchan",
        peers=[mod.PeerRecord("org1", "p1:7051", 5),
               mod.PeerRecord("org1", "p1b:7051", 5),
               mod.PeerRecord("org2", "p2:7051", 5),
               mod.PeerRecord("org3", "p3:7051", 4)],
        orderers=[mod.OrdererRecord("o1:7050", "aa"),
                  mod.OrdererRecord("o2:7050", "bb")],
        policies={name: pol(required=n, orgs=orgs)
                  for name, (n, orgs) in POLICIES.items()}))
    return svc


def plain(desc):
    return (desc.contract, desc.layouts,
            {org: [dataclasses.astuple(p) for p in peers]
             for org, peers in desc.peers_by_org.items()})


def outcome(svc, channel, contract):
    try:
        return ("ok", plain(svc.endorsement_descriptor(channel, contract)))
    except Exception as exc:  # noqa: BLE001 — the error is the outcome
        return (type(exc).__name__, str(exc))


@pytest.mark.parametrize("contract", sorted(POLICIES) + ["unknown"])
def test_descriptors_match_reference(contract):
    got = {side: outcome(make_service(side), "dchan", contract)
           for side in SIDES}
    assert got["port"] == got["reference"]
    assert (got["port"][0] == "ok") == (contract not in ("hard",
                                                         "stranger"))


def test_topology_queries_match_reference():
    got = {}
    for side in SIDES:
        svc = make_service(side)
        got[side] = ([dataclasses.astuple(p) for p in svc.peers("dchan")],
                     [dataclasses.astuple(o) for o in svc.orderers("dchan")],
                     outcome(svc, "nochan", "kvput"))
        with pytest.raises(SIDES[side][0].DiscoveryError,
                           match="unknown channel nochan"):
            svc.peers("nochan")
    assert got["port"] == got["reference"]


def test_cache_ttl_and_invalidation_match_reference(monkeypatch):
    clock = [1000.0]
    monkeypatch.setattr(time, "monotonic", lambda: clock[0])
    seen = {}
    for side in SIDES:
        clock[0] = 1000.0
        svc = make_service(side, ttl=5.0)
        d1 = svc.endorsement_descriptor("dchan", "kvput")
        clock[0] += 4.9
        hit = svc.endorsement_descriptor("dchan", "kvput") is d1
        clock[0] += 0.2
        d2 = svc.endorsement_descriptor("dchan", "kvput")
        expired = d2 is not d1
        svc.update_peer_height("dchan", "p3:7051", 9)
        d3 = svc.endorsement_descriptor("dchan", "kvput")
        svc.update_peer_height("nochan", "p3:7051", 10)     # ignored
        seen[side] = (hit, expired, d3 is not d2, plain(d3),
                      sorted(k[2] for k in svc._cache))
    assert seen["port"] == seen["reference"]
    assert seen["port"][:3] == (True, True, True)
    assert seen["port"][3][2]["org3"][0][2] == 9
