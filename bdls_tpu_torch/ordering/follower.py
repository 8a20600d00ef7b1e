"""Follower (onboarding) chain: replicate a channel this node does not
(yet) consent on.

Reference parity: ``orderer/common/follower/follower_chain.go:130-345`` —
a node joining a channel whose consenter set excludes it runs a retry
loop pulling blocks from existing members, watching each config block;
when a config adds the node to the consenter set (its "join block"), the
follower halts and the registrar switches it to a full consensus chain
(``multichannel/registrar.go SwitchFollowerToChain``).

Transport-agnostic like the peer's deliver client: sources expose
``height()``/``get_block(n)`` — in-process registrar handles, gRPC
deliver stubs, or the cluster pull protocol.

The port's copy of ``bdls_tpu/ordering/follower.py``, over the port's
codec, ledger and ``peer/deliverclient.BFTDeliverer``.
"""

from __future__ import annotations

from typing import Optional, Sequence

from bdls_tpu_torch.ordering import fabric_codec as pb
from bdls_tpu_torch.ordering.block import validate_chain_link
from bdls_tpu_torch.ordering.ledger import _LedgerBase
from bdls_tpu_torch.peer.deliverclient import BFTDeliverer, BlockSource


class FollowerChain:
    """Replicates one channel until this node becomes a consenter."""

    def __init__(self, channel_id: str, identity: bytes, ledger: _LedgerBase,
                 join_block: Optional[pb.Block] = None):
        self.channel_id = channel_id
        self.identity = identity
        self.ledger = ledger
        # a non-genesis "join block" (reference: osnadmin join with a
        # later config block): replication must reproduce it bit-exact
        # at its height, or the channel is poisoned
        self.join_block = join_block
        self.error: Optional[str] = None
        self._fails = 0
        self._deliverer: Optional[BFTDeliverer] = None
        self._sources: list[BlockSource] = []
        # re-join over a pre-populated ledger: the bit-exact invariant
        # must hold for what is ALREADY stored at the join height
        if join_block is not None and \
                ledger.height() > join_block.header.number:
            stored = ledger.get(join_block.header.number)
            if stored.SerializeToString() != join_block.SerializeToString():
                self.error = (
                    f"stored block {join_block.header.number} differs "
                    f"from the join block")
        # set when a committed config block names us a consenter — the
        # registrar reads it and performs the switch
        self.activation_config: Optional[pb.ChannelConfig] = None
        # most recent config seen in replicated blocks (whether or not it
        # names us) — the registrar mirrors it into the read policy
        self.latest_seen_config: Optional[pb.ChannelConfig] = None

    def add_source(self, source: BlockSource) -> None:
        self._sources.append(source)
        self._deliverer = BFTDeliverer(
            list(self._sources),
            on_block=self._commit,
            start_height=self.ledger.height(),
        )

    def height(self) -> int:
        return self.ledger.height()

    def poll(self) -> int:
        """One retry-loop iteration: pull whatever is available
        (follower_chain.go:290-345's pull loop, minus the sleeps — the
        caller owns pacing)."""
        if self._deliverer is None or self.activation_config is not None \
                or self.error is not None:
            return 0
        try:
            pulled = self._deliverer.poll()
        except ValueError as exc:
            # a bad block from ONE source must not halt onboarding (a
            # single byzantine orderer could poison every joiner
            # otherwise): rotate to the next source and retry; only
            # persistent disagreement across sources poisons the channel
            self._fails += 1
            if hasattr(self._deliverer, "_rotate"):
                self._deliverer._rotate()
            if self._fails >= max(3, 2 * len(self._sources)):
                self.error = str(exc)
            return 0
        self._fails = 0
        return pulled

    # ---- internals -------------------------------------------------------
    def _commit(self, block: pb.Block) -> None:
        last = self.ledger.last_block()
        if last is not None:
            err = validate_chain_link(block, last.header)
            if err is not None:
                raise ValueError(f"follower {self.channel_id}: {err}")
        if self.join_block is not None and \
                block.header.number == self.join_block.header.number:
            if block.SerializeToString() != \
                    self.join_block.SerializeToString():
                raise ValueError(
                    f"follower {self.channel_id}: replicated block "
                    f"{block.header.number} differs from the join block")
        self.ledger.append(block)
        self._scan_for_join(block)

    def _scan_for_join(self, block: pb.Block) -> None:
        """Does this block's config name us a consenter? Then it is our
        join block (follower_chain.go:246-289)."""
        for raw in block.data.transactions:
            env = pb.TxEnvelope()
            try:
                env.ParseFromString(raw)
            except Exception:
                continue
            if env.header.type != pb.TxType.TX_CONFIG:
                continue
            cfg = pb.ChannelConfig()
            try:
                cfg.ParseFromString(env.payload)
            except Exception:
                continue
            self.latest_seen_config = cfg
            if self.identity in [c.identity for c in cfg.consenters]:
                self.activation_config = cfg


def latest_config(ledger: _LedgerBase) -> Optional[pb.ChannelConfig]:
    """Walk a ledger for its most recent committed channel config
    (reference cluster.LastConfigBlock; used on restart to decide
    follower-vs-consenter)."""
    latest: Optional[pb.ChannelConfig] = None
    for n in range(ledger.height()):
        block = ledger.get(n)
        for raw in block.data.transactions:
            env = pb.TxEnvelope()
            try:
                env.ParseFromString(raw)
            except Exception:
                continue
            if env.header.type != pb.TxType.TX_CONFIG:
                continue
            cfg = pb.ChannelConfig()
            try:
                cfg.ParseFromString(env.payload)
            except Exception:
                continue
            if cfg.consenters:
                latest = cfg
    return latest
