"""Push-based block dissemination + state transfer between peers.

Reference parity: ``gossip/state/state.go`` (1-815) — the peer gossip
layer's state-transfer machinery: committed blocks are pushed to a fanout
of neighbors, out-of-order arrivals park in a payloads buffer, and a peer
that detects it is behind pulls the missing range from the announcing
neighbor (anti-entropy). The reference's leader election (only elected
peers pull from the ordering service, ``gossip/election``) maps to the
assembly choice of which peers get orderer sources: gossip-only peers
(no sources) still converge via push + state transfer.

In-process transport: GossipNodes hold direct references; ``online``
models partitions. The wire equivalent rides the same cluster transport
as ordering (comm/cluster.py pull protocol).

The port's copy of ``bdls_tpu/peer/gossip.py``, whole, over the port's
``PeerNode`` and ``ordering/fabric_codec``: a block a peer commits goes
through its committer, K7 on ``TorchCSP``.
"""

from __future__ import annotations

import random
from typing import Optional

from bdls_tpu_torch.models.peer import PeerNode
from bdls_tpu_torch.ordering import fabric_codec as pb
from bdls_tpu_torch.utils import tracing


class GossipNode:
    """One peer's gossip endpoint."""

    def __init__(self, peer: PeerNode, fanout: int = 2, seed: int = 0,
                 buffer_limit: int = 64):
        self.peer = peer
        self.fanout = fanout
        self.neighbors: list["GossipNode"] = []
        self.online = True
        self.buffer_limit = buffer_limit
        self._buffer: dict[int, pb.Block] = {}  # out-of-order payloads
        self._rng = random.Random(seed)
        self.stats = {"pushed": 0, "received": 0, "transferred": 0,
                      "buffered": 0, "announced": 0}

    # ---- topology --------------------------------------------------------
    def connect(self, other: "GossipNode") -> None:
        if other is not self and other not in self.neighbors:
            self.neighbors.append(other)
        if self not in other.neighbors:
            other.neighbors.append(self)

    def height(self) -> int:
        return self.peer.height()

    # ---- orderer-side ingestion -----------------------------------------
    def poll_and_push(self) -> int:
        """Pull from the orderer (when this peer has sources) and push any
        new blocks out — the elected-leader role in the reference."""
        before = self.height()
        pulled = self.peer.poll()
        if pulled:
            self._push_range(before, self.height())
        return pulled

    # ---- gossip protocol -------------------------------------------------
    def _sample(self) -> list["GossipNode"]:
        eligible = [n for n in self.neighbors if n.online]
        if len(eligible) <= self.fanout:
            return eligible
        return self._rng.sample(eligible, self.fanout)

    def _push_range(self, start: int, stop: int) -> None:
        """Push committed blocks [start, stop) to a neighbor fanout."""
        if not self.online:
            return
        targets = self._sample()
        for num in range(start, stop):
            blk = self.peer.get_block(num)
            if blk is None:
                continue
            for t in targets:
                self.stats["pushed"] += 1
                t.receive_block(self, blk)

    def receive_block(self, src: "GossipNode", blk: pb.Block) -> None:
        """A pushed block: commit in order, park out-of-order arrivals and
        state-transfer the gap from the pusher.

        The span adopts the pusher's context (in-process gossip calls are
        synchronous, so the contextvar carries the envelope's trace)."""
        if not self.online or not src.online:
            return
        with tracing.GLOBAL.span(
            "gossip.receive_block", attrs={"block": blk.header.number}
        ):
            self.stats["received"] += 1
            number = blk.header.number
            mine = self.height()
            if number < mine:
                return  # already have it
            if number > mine:
                if len(self._buffer) < self.buffer_limit:
                    self._buffer[number] = blk
                    self.stats["buffered"] += 1
                self._transfer_from(src, mine, number)
            else:
                self._commit(blk)
            self._drain_buffer()

    def receive_announcement(self, src: "GossipNode", src_height: int) -> None:
        """A height announcement: pull the gap if behind (anti-entropy)."""
        if not self.online or not src.online:
            return
        if src_height > self.height():
            self._transfer_from(src, self.height(), src_height)
            self._drain_buffer()

    def anti_entropy(self) -> None:
        """Compare heights with a random neighbor and catch up — the
        reference's periodic anti-entropy round (state.go antiEntropy)."""
        if not self.online:
            return
        eligible = [n for n in self.neighbors if n.online]
        if not eligible:
            return
        n = self._rng.choice(eligible)
        self.receive_announcement(n, n.height())

    # ---- internals -------------------------------------------------------
    def _transfer_from(self, src: "GossipNode", start: int, stop: int) -> None:
        """State transfer: pull [start, stop) directly from a peer known
        to have them (state.go StateRequest/StateResponse)."""
        for num in range(start, stop):
            if self.height() != num:
                break
            blk = src.peer.get_block(num)
            if blk is None:
                break
            self.stats["transferred"] += 1
            self._commit(blk)

    def _drain_buffer(self) -> None:
        while self.height() in self._buffer:
            self._commit(self._buffer.pop(self.height()))

    def _commit(self, blk: pb.Block) -> None:
        before = self.height()
        if blk.header.number != before:
            return
        self.peer.committer.commit_block(blk)
        # epidemic propagation: newly committed blocks are pushed onward
        self._push_range(before, self.height())
        # drop stale buffer entries
        for k in [k for k in self._buffer if k < self.height()]:
            del self._buffer[k]


def connect_mesh(nodes: list[GossipNode]) -> None:
    for i, a in enumerate(nodes):
        for b in nodes[i + 1:]:
            a.connect(b)
