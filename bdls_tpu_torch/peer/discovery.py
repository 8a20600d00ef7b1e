"""Service discovery: channel topology, endorsement descriptors, config.

Reference parity: ``discovery/`` — clients ask a peer "who can endorse
for contract X on channel Y", "which peers/orderers exist", "what is the
channel config". Results are computed from the registered membership and
cached with a bounded-TTL auth cache (``discovery/authcache.go``).

The port's copy of ``bdls_tpu/peer/discovery.py``, whole, over the
port's ``EndorsementPolicy``; the cache reads ``time.monotonic()`` as
the reference does.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Optional, Sequence

from bdls_tpu_torch.crypto.msp import LocalMSP
from bdls_tpu_torch.peer.validator import EndorsementPolicy


class DiscoveryError(Exception):
    pass


@dataclass(frozen=True)
class PeerRecord:
    org: str
    endpoint: str
    ledger_height: int = 0


@dataclass(frozen=True)
class OrdererRecord:
    endpoint: str
    identity_hex: str


@dataclass
class EndorsementDescriptor:
    """Layouts: sets of orgs whose joint endorsement satisfies the policy
    (reference discovery/endorsement descriptor)."""

    contract: str
    layouts: list[dict[str, int]]
    peers_by_org: dict[str, list[PeerRecord]]


@dataclass
class ChannelTopology:
    channel_id: str
    peers: list[PeerRecord] = field(default_factory=list)
    orderers: list[OrdererRecord] = field(default_factory=list)
    policies: dict[str, EndorsementPolicy] = field(default_factory=dict)


class DiscoveryService:
    def __init__(self, msp: LocalMSP, cache_ttl: float = 5.0):
        self.msp = msp
        self.cache_ttl = cache_ttl
        self._channels: dict[str, ChannelTopology] = {}
        self._cache: dict[tuple, tuple[float, object]] = {}

    # ---- registration (fed by gossip/membership in the reference) --------
    def register_channel(self, topology: ChannelTopology) -> None:
        self._channels[topology.channel_id] = topology

    def update_peer_height(self, channel_id: str, endpoint: str, height: int) -> None:
        topo = self._channels.get(channel_id)
        if topo is None:
            return
        topo.peers = [
            PeerRecord(p.org, p.endpoint, height if p.endpoint == endpoint else p.ledger_height)
            for p in topo.peers
        ]
        self._invalidate(channel_id)

    # ---- queries ---------------------------------------------------------
    def peers(self, channel_id: str) -> list[PeerRecord]:
        return list(self._topo(channel_id).peers)

    def orderers(self, channel_id: str) -> list[OrdererRecord]:
        return list(self._topo(channel_id).orderers)

    def endorsement_descriptor(
        self, channel_id: str, contract: str
    ) -> EndorsementDescriptor:
        """Compute org layouts satisfying the contract's endorsement
        policy (cached)."""
        key = ("desc", channel_id, contract)
        hit = self._cache.get(key)
        now = time.monotonic()
        if hit is not None and now - hit[0] < self.cache_ttl:
            return hit[1]  # type: ignore[return-value]
        topo = self._topo(channel_id)
        policy = topo.policies.get(contract) or topo.policies.get("") or \
            EndorsementPolicy()
        orgs = sorted({p.org for p in topo.peers})
        eligible = [o for o in orgs if not policy.orgs or o in policy.orgs]
        if len(eligible) < policy.required:
            raise DiscoveryError(
                f"not enough orgs for {contract!r}: need {policy.required}, "
                f"have {eligible}"
            )
        # layouts: every minimal combination of `required` eligible orgs
        from itertools import combinations

        layouts = [
            {org: 1 for org in combo}
            for combo in combinations(eligible, policy.required)
        ]
        desc = EndorsementDescriptor(
            contract=contract,
            layouts=layouts,
            peers_by_org={
                org: [p for p in topo.peers if p.org == org] for org in eligible
            },
        )
        self._cache[key] = (now, desc)
        return desc

    def _topo(self, channel_id: str) -> ChannelTopology:
        topo = self._channels.get(channel_id)
        if topo is None:
            raise DiscoveryError(f"unknown channel {channel_id}")
        return topo

    def _invalidate(self, channel_id: str) -> None:
        for key in [k for k in self._cache if k[1] == channel_id]:
            del self._cache[key]
