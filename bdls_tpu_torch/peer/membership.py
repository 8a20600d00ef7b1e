"""Gossip membership, peer discovery, and delivery-leader election.

Reference parity:
- ``gossip/discovery/discovery_impl.go`` — peers emit signed *alive*
  messages; membership spreads epidemically (each round a peer sends its
  whole alive view to a fanout sample); unknown members learned from a
  view are dialed, so one bootstrap address suffices to discover the
  mesh; members whose alive messages stop refreshing expire and are
  evicted from the view.
- ``gossip/election/election.go`` — of the alive peers eligible to pull
  from the ordering service, the one with the smallest identity becomes
  the delivery leader after a stabilization delay; everyone else relies
  on gossip dissemination. When the leader dies its alive entry expires
  everywhere and the next-smallest eligible member takes over. (The
  reference reaches the same fixed point through proposal/declaration
  messages; the min-alive-id rule is its convergence invariant.)

Trust model: an alive message is only admitted to the view if (a) its
signature verifies against the embedded key and (b) that (org, key) is a
valid member of the channel MSP — the reference's signed-gossip-identity
requirement (``gossip/api/MessageCryptoService``). Without the MSP gate
any process could inflate the view or steal leadership.

Transport: in-process endpoints like :mod:`bdls_tpu_torch.peer.gossip` — a
``registry`` maps endpoint names to nodes (the DNS/dial seam); the wire
equivalent rides the cluster transport.

The port's copy of ``bdls_tpu/peer/membership.py``, whole: the same
alive digest, so an alive message either package signs is admitted by
the other. Each alive message is one ``csp.verify``, as in the
reference: on ``TorchCSP`` a launch of K1, or of K2 once the key is
pinned. The port's providers sign with a deterministic nonce, so its
alive signatures differ from the reference's.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Optional

from bdls_tpu_torch.crypto.csp import PublicKey, VerifyRequest
from bdls_tpu_torch.crypto.framing import framed_digest
from bdls_tpu_torch.crypto.msp import Identity
from bdls_tpu_torch.peer.gossip import GossipNode


@dataclass(frozen=True)
class AliveMsg:
    """Signed liveness claim: (org, key, endpoint, seq) — the reference's
    AliveMessage with its incarnation/seqNum pair."""

    org: str
    key_x: int
    key_y: int
    endpoint: str
    seq: int
    sig_r: int = 0
    sig_s: int = 0

    def ident(self) -> bytes:
        return self.key_x.to_bytes(32, "big") + self.key_y.to_bytes(32, "big")

    def tbs_digest(self) -> bytes:
        return framed_digest(b"BDLS_TPU_GOSSIP_ALIVE", (
            self.org.encode(),
            self.key_x.to_bytes(32, "big"),
            self.key_y.to_bytes(32, "big"),
            self.endpoint.encode(),
            struct.pack("<Q", self.seq),
        ))


class DiscoveryNode:
    """Membership + election endpoint wrapped around one GossipNode."""

    def __init__(
        self,
        gossip: GossipNode,
        endpoint: str,
        registry: dict[str, "DiscoveryNode"],
        signing_key,
        org: str,
        *,
        alive_interval: float = 1.0,
        dead_after: float = 5.0,
        lead_after: float = 2.0,
    ):
        self.gossip = gossip
        self.peer = gossip.peer
        self.csp = self.peer.csp
        self.msp = self.peer.msp
        assert self.msp is not None, "discovery requires a channel MSP"
        self.endpoint = endpoint
        self.registry = registry
        self.registry[endpoint] = self
        self.signing_key = signing_key
        self.org = org
        self.alive_interval = alive_interval
        self.dead_after = dead_after
        self.lead_after = lead_after

        pub = signing_key.public_key()
        self.identity = pub.x.to_bytes(32, "big") + pub.y.to_bytes(32, "big")
        self._seq = 0
        self._next_alive = 0.0
        # ident -> (AliveMsg, last_refresh_local_time)
        self.view: dict[bytes, tuple[AliveMsg, float]] = {}
        # tombstones: highest seq ever seen per ident, surviving expiry —
        # without this, relayed copies of a dead peer's last alive
        # message re-admit it in an expire/re-admit cycle (the
        # reference's dead-membership list serves the same purpose,
        # discovery_impl.go deadLastTS)
        self._last_seq: dict[bytes, int] = {}
        self._leader_since: Optional[float] = None
        self.stats = {"alive_sent": 0, "alive_accepted": 0,
                      "alive_rejected": 0, "dials": 0, "expired": 0}

    # ---- alive emission --------------------------------------------------
    def _own_alive(self) -> AliveMsg:
        self._seq += 1
        pub = self.signing_key.public_key()
        msg = AliveMsg(org=self.org, key_x=pub.x, key_y=pub.y,
                       endpoint=self.endpoint, seq=self._seq)
        r, s = self.csp.sign(self.signing_key, msg.tbs_digest())
        return AliveMsg(org=msg.org, key_x=msg.key_x, key_y=msg.key_y,
                        endpoint=msg.endpoint, seq=msg.seq,
                        sig_r=r, sig_s=s)

    def bootstrap(self, endpoint: str, now: float) -> None:
        """Introduce this node to one existing member; the rest of the
        mesh is learned from its view (discovery_impl's bootstrap peers)."""
        other = self.registry.get(endpoint)
        if other is None or other is self:
            return
        self.gossip.connect(other.gossip)
        own = self._own_alive()
        other.receive_alive([own], self, now)
        self.receive_alive(
            [m for m, _ in other.view.values()] + [other._own_alive()],
            other, now)

    # ---- alive reception -------------------------------------------------
    def _admit(self, msg: AliveMsg, now: float) -> bool:
        if msg.ident() == self.identity:
            return False
        try:
            key = PublicKey("P-256", msg.key_x, msg.key_y)
        except Exception:
            return False
        if not self.csp.verify(VerifyRequest(
                key=key, digest=msg.tbs_digest(),
                r=msg.sig_r, s=msg.sig_s)):
            self.stats["alive_rejected"] += 1
            return False
        try:
            self.msp.validate(Identity(org=msg.org, key=key), now=None)
        except Exception:
            self.stats["alive_rejected"] += 1
            return False
        ident = msg.ident()
        if self._last_seq.get(ident, -1) >= msg.seq:
            # stale or re-gossiped duplicate: deliberately does NOT
            # refresh liveness — otherwise relayed copies of a dead
            # peer's last alive message would keep it alive (or
            # re-admit it after expiry) forever
            return False
        self._last_seq[ident] = msg.seq
        self.view[ident] = (msg, now)
        self.stats["alive_accepted"] += 1
        return True

    def receive_alive(self, msgs: list[AliveMsg], src: "DiscoveryNode",
                      now: float) -> None:
        if not self.gossip.online:
            return
        for msg in msgs:
            fresh = self._admit(msg, now)
            if fresh:
                self._maybe_dial(msg, now)

    def _maybe_dial(self, msg: AliveMsg, now: float) -> None:
        """Connect the gossip layer to a newly learned member."""
        node = self.registry.get(msg.endpoint)
        if node is None or node is self:
            return
        if node.gossip not in self.gossip.neighbors:
            self.gossip.connect(node.gossip)
            self.stats["dials"] += 1

    # ---- periodic round --------------------------------------------------
    def tick(self, now: float) -> None:
        if not self.gossip.online:
            self._leader_since = None
            return
        # expiry sweep (discovery_impl's aliveness expiration)
        for ident, (msg, seen) in list(self.view.items()):
            if now - seen > self.dead_after:
                del self.view[ident]
                self.stats["expired"] += 1
                node = self.registry.get(msg.endpoint)
                if node is not None and node.gossip in self.gossip.neighbors:
                    self.gossip.neighbors.remove(node.gossip)

        if now >= self._next_alive:
            self._next_alive = now + self.alive_interval
            batch = [m for m, _ in self.view.values()] + [self._own_alive()]
            self.stats["alive_sent"] += 1
            for n in self.gossip._sample():
                target = self._discovery_of(n)
                if target is not None:
                    target.receive_alive(batch, self, now)

        # election: smallest alive eligible identity (self included)
        if self._am_candidate_leader():
            if self._leader_since is None:
                self._leader_since = now
        else:
            self._leader_since = None

        if self.is_leader(now):
            self.gossip.poll_and_push()
        else:
            self.gossip.anti_entropy()

    def _discovery_of(self, gossip_node: GossipNode) -> Optional["DiscoveryNode"]:
        for node in self.registry.values():
            if node.gossip is gossip_node:
                return node
        return None

    # ---- election --------------------------------------------------------
    def _eligible(self, ident: bytes, msg: Optional[AliveMsg]) -> bool:
        """Only peers with an ordering-service connection can lead."""
        if ident == self.identity:
            return self.peer.deliverer is not None
        if msg is None:
            return False
        node = self.registry.get(msg.endpoint)
        return node is not None and node.peer.deliverer is not None

    def _am_candidate_leader(self) -> bool:
        if not self._eligible(self.identity, None):
            return False
        alive = [i for i, (m, _) in self.view.items()
                 if self._eligible(i, m)]
        return all(self.identity <= i for i in alive)

    def is_leader(self, now: float) -> bool:
        """Leader once the candidacy has been stable for lead_after (the
        reference's leadershipDeclaration stabilization delay)."""
        return (self._leader_since is not None
                and now - self._leader_since >= self.lead_after)
