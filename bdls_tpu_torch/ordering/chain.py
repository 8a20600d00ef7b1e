"""Per-channel ordering chain: submit → cut → BDLS consensus → ledger.

The port's copy of ``bdls_tpu/ordering/chain.py``, on the port's engine
(:mod:`bdls_tpu_torch.consensus`). Two differences: consensus proofs are
written and read through :mod:`bdls_tpu_torch.consensus.wire_codec`, and
a chain built without a ``verifier`` verifies its votes on the card (the
engine's default), which raises where there is none: on the CPU pass
``CpuBatchVerifier()``. On the card, the chains of one network share one
``CspBatchVerifier(TorchCSP(), consenters=participants)``.

The reference's equivalent is the BDLS plugin chain
(``orderer/consensus/bdls/chain.go:713-863``): a goroutine event loop
around submitC/applyC with hardcoded keys and a localhost TCP mesh. This
implementation removes those shims and keeps the whole chain **tick-driven
and deterministic** like the consensus engine itself: ``submit()`` feeds
transactions, ``update(now)`` advances timers/consensus and applies decided
blocks. Real deployments drive ``update`` from a 20 ms ticker thread
(reference chain.go:689-701); tests drive it with virtual time.

Proposal model: each node cuts its own batches and proposes the head batch
as the next block; BDLS picks one winner per height. Losing batches are
re-anchored (new number/prev_hash) and re-proposed at the next height,
with transactions already committed by the winning block filtered out.
The engine's ``StateValidate`` is a real chain-link validation — the
reference hardcodes it to true (chain.go:338).
"""

from __future__ import annotations

import hashlib
from collections import deque
from dataclasses import dataclass
from typing import Callable, Optional

from bdls_tpu_torch.consensus import Config as EngineConfig, Consensus, Signer
from bdls_tpu_torch.consensus import wire_codec
from bdls_tpu_torch.consensus.verifier import BatchVerifier
from bdls_tpu_torch.ordering import fabric_codec as pb
from bdls_tpu_torch.ordering.block import BlockCreator, data_hash, validate_chain_link
from bdls_tpu_torch.ordering.blockcutter import BatchConfig, BlockCutter
from bdls_tpu_torch.ordering.ledger import _LedgerBase


def _compare_states(a: bytes, b: bytes) -> int:
    """Total order over proposed blocks for BDLS state selection."""
    return (a > b) - (a < b)


# transport frame tags: one byte prefix multiplexing the cluster stream,
# mirroring the reference's two cluster-gRPC request kinds
# (ConsensusRequest / SubmitRequest — orderer/consensus/bdls/egress.go:53-88)
FRAME_CONSENSUS = b"\x00"
FRAME_SUBMIT = b"\x01"


class _ConsensusPeer:
    """Wraps a transport peer so engine traffic carries the consensus tag."""

    def __init__(self, peer):
        self._peer = peer

    def remote_addr(self) -> str:
        return self._peer.remote_addr()

    def identity(self):
        return self._peer.identity()

    def send(self, data: bytes) -> None:
        self._peer.send(FRAME_CONSENSUS + data)


@dataclass
class ChainMetrics:
    """Per-channel consensus metrics (reference bdls/metrics.go)."""

    committed_block_number: int = 0
    is_leader: bool = False
    leader_id: int = 0
    normal_proposals_received: int = 0
    config_proposals_received: int = 0
    proposal_failures: int = 0
    cluster_size: int = 0


class Chain:
    """One channel's ordering pipeline. Implements the engine-facing
    receive_message/update surface so it can sit directly on a transport
    (VirtualNetwork in tests, the cluster gRPC/TCP comm in deployment)."""

    def __init__(
        self,
        channel_id: str,
        signer: Signer,
        participants: list[bytes],
        ledger: _LedgerBase,
        batch_config: Optional[BatchConfig] = None,
        verifier: Optional[BatchVerifier] = None,
        latency: float = 0.05,
        epoch: float = 0.0,
        on_commit: Optional[Callable[[pb.Block], None]] = None,
    ):
        assert ledger.height() > 0, "ledger must contain the genesis block"
        self.channel_id = channel_id
        self.ledger = ledger
        self.batch_config = batch_config or BatchConfig()
        self.cutter = BlockCutter(self.batch_config)
        self.on_commit = on_commit
        self.metrics = ChainMetrics(cluster_size=len(participants))

        last = ledger.last_block()
        self.creator = BlockCreator(last.header)
        self._last_header = last.header

        self.pending_batches: deque[list[bytes]] = deque()
        self.batch_deadline: Optional[float] = None
        self._proposed_for_height: Optional[int] = None
        self.submit_filter: Optional[Callable[[bytes], None]] = None
        self._raw_peers: list = []
        # tx dedup across submit/relay/commit (bounded: pending + recent)
        self._seen_tx: set[bytes] = set()
        self._committed_window: deque[bytes] = deque(maxlen=100_000)
        # catch-up: decided-ahead states held back until the gap is pulled
        self._holdback: dict[int, bytes] = {}

        self._engine_cfg = EngineConfig(
            epoch=epoch,
            signer=signer,
            participants=participants,
            current_height=last.header.number,
            state_compare=_compare_states,
            state_validate=self._validate_state,
            verifier=verifier,
            latency=latency,
        )
        self.engine = Consensus(self._engine_cfg)

    # ---- engine callbacks ----------------------------------------------
    def _validate_state(self, state: bytes, height: int) -> bool:
        """Engine StateValidate. The block number embedded in the state
        MUST equal the consensus height carrying it — otherwise a
        byzantine round leader could get an honest 2t+1 quorum to commit
        a block whose number doesn't match the decided height, desyncing
        engine height from ledger tip. Beyond the binding: full chain-link
        validation applies at the next expected height (the one this node
        votes on); for heights further ahead — seen in <decide> proofs
        while lagging — structural integrity only, since the 2t+1 commit
        quorum carries the trust and the pulled-block path re-validates
        links before committing. (The reference dodges all of this by
        hardcoding StateValidate=true, chain.go:338.)"""
        try:
            blk = pb.Block()
            blk.ParseFromString(state)
        except Exception:
            return False
        if blk.header.number != height:
            return False
        if not blk.data.transactions:
            return False
        if blk.header.data_hash != data_hash(blk.data.transactions):
            return False
        if blk.header.number == self._last_header.number + 1:
            return validate_chain_link(blk, self._last_header) is None
        return blk.header.number > self._last_header.number

    # ---- transport surface ---------------------------------------------
    def receive_message(self, data: bytes, now: float) -> None:
        """Cluster-stream ingress: demultiplex consensus vs relayed-submit
        frames (reference ingress.go:44-73 OnConsensus/OnSubmit)."""
        if not data:
            return
        tag, rest = data[:1], data[1:]
        if tag == FRAME_CONSENSUS:
            self.engine.receive_message(rest, now)
        elif tag == FRAME_SUBMIT:
            # defense in depth: relayed submits from peers re-run the
            # channel's msgprocessor filters (a byzantine consenter must
            # not inject unfiltered transactions)
            if self.submit_filter is not None:
                try:
                    self.submit_filter(rest)
                except Exception:
                    return
            self.submit(rest, now, relay=False)
        # unknown tags are dropped

    def join(self, peer) -> bool:
        if self.engine.join(_ConsensusPeer(peer)):
            self._raw_peers.append(peer)
            return True
        return False

    @property
    def identity(self) -> bytes:
        return self.engine.identity

    @property
    def participants(self) -> list[bytes]:
        return self.engine.participants

    def reconfigure(self, participants: list[bytes], now: float) -> None:
        """Apply a committed consenter-set change: rebuild the BDLS engine
        with the new participant set at the current ledger tip, re-joining
        the existing transport peers. The SmartBFT-style restart-on-config
        (the reference recreates the consensus instance when a config
        block changes the consenter mapping) — safe here because config
        blocks commit at a height boundary, so the fresh engine starts
        exactly where the old one decided."""
        if list(participants) == list(self.engine.participants):
            return
        from dataclasses import replace

        new_cfg = replace(
            self._engine_cfg,
            participants=list(participants),
            current_height=self.ledger.last_block().header.number,
        )
        new_engine = Consensus(new_cfg)  # may raise; adopt only on success
        self._engine_cfg = new_cfg
        self.engine = new_engine
        for peer in self._raw_peers:
            self.engine.join(_ConsensusPeer(peer))
        self.metrics.cluster_size = len(participants)
        self._proposed_for_height = None

    # ---- ingress --------------------------------------------------------
    def submit(self, env_bytes: bytes, now: float, relay: bool = True) -> None:
        """Order a validated transaction (reference chain.go Order/submit).
        Caller runs the msgprocessor filters first.

        The tx is relayed once to all consenters so every node can propose
        it — the reference's intended production path (egress.go
        SendTransaction → SubmitRequest), which its live agent-tcp code
        never wired up, leaving liveness dependent on every node
        generating its own traffic."""
        # parse BEFORE registering/relaying: a malformed envelope must be
        # dropped here, not raise out of receive_message (which would tear
        # down the cluster connection) nor poison the dedup set
        env = pb.TxEnvelope()
        try:
            env.ParseFromString(env_bytes)
        except Exception:
            return
        tx_hash = hashlib.sha256(env_bytes).digest()
        if tx_hash in self._seen_tx or tx_hash in self._committed_window:
            return
        self._seen_tx.add(tx_hash)
        if relay:
            frame = FRAME_SUBMIT + env_bytes
            for peer in self._raw_peers:
                try:
                    peer.send(frame)
                except Exception:
                    pass
        if env.header.type == pb.TxType.TX_CONFIG:
            self._submit_config(env_bytes, now)
            return
        self.metrics.normal_proposals_received += 1
        batches, pending = self.cutter.ordered(env_bytes)
        for batch in batches:
            self.pending_batches.append(batch)
        if pending and self.batch_deadline is None:
            self.batch_deadline = now + self.batch_config.batch_timeout
        if not pending:
            self.batch_deadline = None
        self._maybe_propose(now)

    def _submit_config(self, env_bytes: bytes, now: float) -> None:
        """Config txs are isolated in their own single-tx block
        (reference assembler.go:88-118). The FIFO batch queue plus
        one-proposal-per-height gives the reference's pipeline pause for
        free: nothing later is proposed until the config block commits."""
        self.metrics.config_proposals_received += 1
        leftover = self.cutter.cut()
        if leftover:
            self.pending_batches.append(leftover)
        self.pending_batches.append([env_bytes])
        self.batch_deadline = None
        self._maybe_propose(now)

    # ---- the tick -------------------------------------------------------
    def update(self, now: float) -> None:
        """Advance timers, the consensus engine, and apply decisions."""
        if self.batch_deadline is not None and now >= self.batch_deadline:
            self.batch_deadline = None
            batch = self.cutter.cut()
            if batch:
                self.pending_batches.append(batch)
        self.engine.update(now)
        self._apply_decided(now)
        self._maybe_propose(now)
        self._update_leader_metrics()

    def _maybe_propose(self, now: float) -> None:
        if not self.pending_batches:
            return
        next_height = self.ledger.height()  # next block number
        if self._proposed_for_height == next_height:
            return
        block = self.creator.create_next(self.pending_batches[0])
        assert block.header.number == next_height
        self.engine.propose(block.SerializeToString())
        self._proposed_for_height = next_height
        self._apply_decided(now)

    def _apply_decided(self, now: float) -> None:
        """Write newly decided blocks to the ledger
        (reference chain.go:532-556 writeBlock)."""
        h, rnd, state = self.engine.current_state()
        my_height = self.ledger.height() - 1  # last block number
        if h <= my_height or state is None:
            return
        blk = pb.Block()
        blk.ParseFromString(state)
        if blk.header.number != my_height + 1:
            # decided ahead of us — hold back and let the block puller
            # close the gap (reference: "this node was forced to catch up",
            # chain.go:532-539 + cluster BlockPuller)
            if blk.header.number > my_height + 1:
                proof = self.engine.current_proof()
                self._holdback[blk.header.number] = (
                    state,
                    wire_codec.encode(proof) if proof is not None else b"",
                )
            return
        # attach the consensus proof to metadata slot 2
        proof = self.engine.current_proof()
        if proof is not None:
            blk.metadata.entries[2] = wire_codec.encode(proof)
        self.ledger.append(blk)
        self._last_header = blk.header
        self.creator.advance(blk)
        self.metrics.committed_block_number = blk.header.number
        self._proposed_for_height = None
        self._reconcile_pending(blk)
        if self.on_commit is not None:
            self.on_commit(blk)

    def _reconcile_pending(self, committed: pb.Block) -> None:
        """Drop committed txs from local pending batches; keep the rest for
        re-proposal at the new height (in-flight accounting, reference
        chain.go:512-530)."""
        committed_hashes = {
            hashlib.sha256(tx).digest() for tx in committed.data.transactions
        }
        self._committed_window.extend(committed_hashes)
        self._seen_tx -= committed_hashes
        new_batches: deque[list[bytes]] = deque()
        for batch in self.pending_batches:
            kept = [
                tx
                for tx in batch
                if hashlib.sha256(tx).digest() not in committed_hashes
            ]
            if kept:
                new_batches.append(kept)
        self.pending_batches = new_batches
        # also purge committed txs from the uncut pending buffer
        if self.cutter.pending:
            kept = [
                tx
                for tx in self.cutter.pending
                if hashlib.sha256(tx).digest() not in committed_hashes
            ]
            if len(kept) != len(self.cutter.pending):
                self.cutter.pending = kept
                self.cutter.pending_bytes = sum(len(t) for t in kept)
                if not kept:
                    self.batch_deadline = None

    def _update_leader_metrics(self) -> None:
        rnd = (
            self.engine.current_round.number
            if self.engine.current_round is not None
            else 0
        )
        leader = self.engine.round_leader(rnd)
        self.metrics.is_leader = leader == self.engine.identity
        try:
            self.metrics.leader_id = self.engine.participants.index(leader)
        except ValueError:
            self.metrics.leader_id = -1

    # ---- catch-up (block puller client side) ----------------------------
    def gap(self) -> Optional[tuple[int, int]]:
        """(start, end) of missing block numbers if this node decided
        ahead of its ledger, else None."""
        if not self._holdback:
            return None
        tip = self.ledger.height() - 1
        lowest_held = min(self._holdback)
        if lowest_held <= tip + 1:
            return None
        return (tip + 1, lowest_held - 1)

    def receive_pulled_block(self, block_bytes: bytes, now: float) -> bool:
        """Accept one pulled historical block; validates the chain link and
        the embedded consensus proof signature before committing."""
        blk = pb.Block()
        try:
            blk.ParseFromString(block_bytes)
        except Exception:
            return False
        if blk.header.number != self.ledger.height():
            return False
        if validate_chain_link(blk, self._last_header) is not None:
            return False
        if not self._verify_block_proof(blk):
            return False
        self.ledger.append(blk)
        self._last_header = blk.header
        self.creator.advance(blk)
        self.metrics.committed_block_number = blk.header.number
        self._reconcile_pending(blk)
        if self.on_commit is not None:
            self.on_commit(blk)
        self._drain_holdback(now)
        return True

    def _drain_holdback(self, now: float) -> None:
        while True:
            want = self.ledger.height()
            held = self._holdback.pop(want, None)
            if held is None:
                # prune anything at or below the tip
                for k in [k for k in self._holdback if k < want]:
                    del self._holdback[k]
                return
            state, proof_bytes = held
            blk = pb.Block()
            blk.ParseFromString(state)
            if validate_chain_link(blk, self._last_header) is not None:
                # decided state does not extend what we just pulled — the
                # pulled history was forged or we diverged; drop and re-pull
                self._holdback.clear()
                return
            if proof_bytes:
                blk.metadata.entries[2] = proof_bytes
            self.ledger.append(blk)
            self._last_header = blk.header
            self.creator.advance(blk)
            self.metrics.committed_block_number = blk.header.number
            self._proposed_for_height = None
            self._reconcile_pending(blk)
            if self.on_commit is not None:
                self.on_commit(blk)

    def _verify_block_proof(self, blk: pb.Block) -> bool:
        """Full quorum check of the block's embedded <decide> proof:
        leader-signed decide + 2t+1 distinct valid <commit> proofs on the
        block content (metadata slot 2 cleared, as proposed). A single
        compromised consenter cannot forge a catch-up block."""
        if len(blk.metadata.entries) < 3 or not blk.metadata.entries[2]:
            return False
        try:
            env = wire_codec.decode_envelope(blk.metadata.entries[2])
        except Exception:
            return False
        proposed = pb.Block()
        proposed.CopyFrom(blk)
        proposed.metadata.entries[2] = b""
        return self.engine.verify_historical_decide(
            env, proposed.SerializeToString()
        )

    # ---- introspection --------------------------------------------------
    def height(self) -> int:
        return self.ledger.height()
