"""Multichannel registrar: one ordering chain per channel.

Reference parity: ``orderer/common/multichannel/registrar.go`` (chain
bookkeeping, broadcast routing, channel creation) plus the channel
participation API surface (``orderer/common/channelparticipation/``:
join/remove/list consumed by osnadmin). Channels are created by joining a
genesis block whose first transaction carries a ``ChannelConfig``
(consenter set, batch knobs, writer policy) — the clean replacement for
the reference's configtx bundles, with no system channel (the reference
also forbids one — orderer/common/server/main.go:115-126).

The port's copy of ``bdls_tpu/ordering/registrar.py``. Its BDLS chains
verify on the card unless the registrar is given a ``verifier``
(``ordering/chain.py``), and ``_warm_consenter_keys`` pins a channel's
consenter keys through ``TorchCSP.warm_keys``.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Callable, Iterator, Optional

from bdls_tpu_torch.consensus import Signer
from bdls_tpu_torch.consensus.verifier import BatchVerifier
from bdls_tpu_torch.crypto.csp import CSP
from bdls_tpu_torch.ordering import fabric_codec as pb
from bdls_tpu_torch.ordering.block import genesis_block
from bdls_tpu_torch.ordering.blockcutter import BatchConfig
from bdls_tpu_torch.ordering.chain import Chain
from bdls_tpu_torch.ordering.follower import FollowerChain, latest_config
from bdls_tpu_torch.ordering.ledger import LedgerFactory
from bdls_tpu_torch.ordering.msgprocessor import (
    ChannelPolicy,
    FilterError,
    StandardChannelProcessor,
)
from bdls_tpu_torch.utils.flog import GLOBAL as LOGS

_LOG = LOGS.get_logger("registrar")


class RegistrarError(Exception):
    pass


class ErrUnknownChannel(RegistrarError):
    pass


class ErrChannelExists(RegistrarError):
    pass


class ErrNotConsenter(RegistrarError):
    pass


class ErrIncompatibleCapabilities(RegistrarError):
    pass


# The capability level this node implements (reference
# common/capabilities/channel.go: nodes refuse channels whose config
# demands capabilities they lack). Level 2 added the raft consensus
# type; configs with capability_level 0 mean level 1.
SUPPORTED_CAPABILITY_LEVEL = 2
# feature -> minimum capability level that must be declared on-channel
FEATURE_LEVELS = {"consensus_type:raft": 2}


def check_capabilities(cfg: pb.ChannelConfig) -> None:
    """Raise unless this node supports the channel's declared level AND
    the config's features are covered by that level."""
    level = cfg.capability_level or 1
    if level > SUPPORTED_CAPABILITY_LEVEL:
        raise ErrIncompatibleCapabilities(
            f"channel {cfg.channel_id} requires capability level {level}; "
            f"this node implements {SUPPORTED_CAPABILITY_LEVEL}"
        )
    if cfg.consensus_type == "raft" and \
            level < FEATURE_LEVELS["consensus_type:raft"]:
        raise ErrIncompatibleCapabilities(
            f"channel {cfg.channel_id}: consensus_type 'raft' requires "
            f"capability level {FEATURE_LEVELS['consensus_type:raft']}, "
            f"config declares {level}"
        )


def make_channel_config(
    channel_id: str,
    consenters: list[bytes],
    max_message_count: int = 500,
    preferred_max_bytes: int = 2 * 1024 * 1024,
    absolute_max_bytes: int = 10 * 1024 * 1024,
    batch_timeout_s: float = 2.0,
    writer_orgs: tuple[str, ...] = (),
    consensus_latency_s: float = 0.05,
    reader_orgs: tuple[str, ...] = (),
    consensus_type: str = "",
    capability_level: int = 0,
) -> pb.ChannelConfig:
    cfg = pb.ChannelConfig()
    cfg.channel_id = channel_id
    for ident in consenters:
        c = cfg.consenters.add()
        c.identity = ident
    cfg.max_message_count = max_message_count
    cfg.preferred_max_bytes = preferred_max_bytes
    cfg.absolute_max_bytes = absolute_max_bytes
    cfg.batch_timeout_s = batch_timeout_s
    cfg.writer_orgs.extend(writer_orgs)
    cfg.consensus_latency_s = consensus_latency_s
    cfg.reader_orgs.extend(reader_orgs)
    cfg.consensus_type = consensus_type
    if consensus_type == "raft" and capability_level == 0:
        capability_level = FEATURE_LEVELS["consensus_type:raft"]
    cfg.capability_level = capability_level
    return cfg


def _latest_capability_level(ledger) -> int:
    """The newest committed nonzero capability_level, scanning from the
    tip (0 = no capability-bearing config committed)."""
    for n in range(ledger.height() - 1, -1, -1):
        block = ledger.get(n)
        for raw in block.data.transactions:
            env = pb.TxEnvelope()
            try:
                env.ParseFromString(raw)
            except Exception:
                continue
            if env.header.type != pb.TxType.TX_CONFIG and n != 0:
                continue
            cfg = pb.ChannelConfig()
            try:
                cfg.ParseFromString(env.payload)
            except Exception:
                continue
            if cfg.capability_level:
                return cfg.capability_level
    return 0


def config_from_genesis(block: pb.Block) -> pb.ChannelConfig:
    env = pb.TxEnvelope()
    env.ParseFromString(block.data.transactions[0])
    cfg = pb.ChannelConfig()
    cfg.ParseFromString(env.payload)
    return cfg


def make_genesis(cfg: pb.ChannelConfig) -> pb.Block:
    return genesis_block(cfg.channel_id, cfg.SerializeToString())


@dataclass
class ChannelInfo:
    name: str
    height: int
    status: str  # "active" | "onboarding" | "failed"
    consensus_relation: str  # "consenter" | "follower"
    error: Optional[str] = None


class Registrar:
    """Owns every channel's chain + processor on this ordering node."""

    def __init__(
        self,
        signer: Signer,
        ledger_factory: LedgerFactory,
        csp: CSP,
        verifier: Optional[BatchVerifier] = None,
        epoch: float = 0.0,
        on_chain_created: Optional[Callable[[str, Chain], None]] = None,
    ):
        self.signer = signer
        self.ledger_factory = ledger_factory
        self.csp = csp
        self.verifier = verifier
        self.epoch = epoch
        self.on_chain_created = on_chain_created
        self._lock = threading.RLock()
        self.chains: dict[str, Chain] = {}
        self.processors: dict[str, StandardChannelProcessor] = {}
        self.followers: dict[str, FollowerChain] = {}
        self._evicted: set[str] = set()

    # ---- startup --------------------------------------------------------
    def initialize(self) -> None:
        """Resume every channel already present in the ledger factory
        (restart path: the ledger is the checkpoint, SURVEY.md §5.4).
        The LATEST committed config decides consenter-vs-follower."""
        for channel_id in self.ledger_factory.channel_ids():
            ledger = self.ledger_factory.get_or_create(channel_id)
            if channel_id in self.chains or channel_id in self.followers:
                continue
            if ledger.height() == 0:
                # a join-block channel restarted before any block was
                # replicated: the persisted join block alone defines the
                # channel — without this, the restart orphans it
                join_block = self._load_join_block(channel_id)
                if join_block is None:
                    continue
                cfg = config_from_genesis(join_block)
                self.followers[channel_id] = FollowerChain(
                    channel_id, self.signer.identity, ledger,
                    join_block=join_block,
                )
                self.processors[channel_id] = self._make_processor(
                    channel_id, cfg
                )
                continue
            cfg = latest_config(ledger) or config_from_genesis(ledger.get(0))
            # capability-only config updates carry no consenter set, so
            # latest_config skips them; without this scan a node demoted
            # by a level raise would re-activate as a consenter after a
            # restart, diverging from the running cluster
            level = _latest_capability_level(ledger)
            if level:
                cfg.capability_level = level
            try:
                check_capabilities(cfg)
            except ErrIncompatibleCapabilities as exc:
                # a restarting node below the channel's level must not
                # consent; replicate as a follower and surface the error
                _LOG.error("%s", exc)
                self.followers[channel_id] = FollowerChain(
                    channel_id, self.signer.identity, ledger
                )
                self.processors[channel_id] = self._make_processor(
                    channel_id, cfg
                )
                continue
            if self.signer.identity in [c.identity for c in cfg.consenters]:
                self._activate(channel_id, cfg)
            else:
                self.followers[channel_id] = FollowerChain(
                    channel_id, self.signer.identity, ledger,
                    join_block=self._load_join_block(channel_id),
                )
                # followers still enforce the channel's read policy on
                # their Deliver surface
                self.processors[channel_id] = self._make_processor(
                    channel_id, cfg
                )

    # ---- channel participation API (osnadmin surface) -------------------
    def join_channel(self, genesis: pb.Block) -> ChannelInfo:
        """Join with a genesis block (block 0, channel creation) OR a
        later config "join block" (the reference's osnadmin join with a
        config block from a running channel): the latter onboards as a
        follower that replicates history from members, verifies the
        join block bit-exact at its height, and auto-promotes if the
        join block names this node a consenter."""
        if not genesis.data.transactions:
            raise RegistrarError("join block carries no transactions")
        join_block = genesis if genesis.header.number > 0 else None
        if join_block is not None:
            env = pb.TxEnvelope()
            try:
                env.ParseFromString(genesis.data.transactions[0])
            except Exception as exc:
                raise RegistrarError(f"join block undecodable: {exc}")
            if env.header.type != pb.TxType.TX_CONFIG:
                raise RegistrarError(
                    "a non-genesis join block must be a CONFIG block")
        try:
            cfg = config_from_genesis(genesis)
        except Exception as exc:
            raise RegistrarError(f"join block config undecodable: {exc}")
        if not cfg.channel_id:
            raise RegistrarError("join block has no channel id")
        check_capabilities(cfg)
        channel_id = cfg.channel_id
        with self._lock:
            if channel_id in self.chains or channel_id in self.followers:
                raise ErrChannelExists(channel_id)
            ledger = self.ledger_factory.get_or_create(channel_id)
            if join_block is None and ledger.height() == 0:
                ledger.append(genesis)
            if join_block is not None:
                self._save_join_block(channel_id, join_block)
            if join_block is None and self.signer.identity in [
                    c.identity for c in cfg.consenters]:
                self._activate(channel_id, cfg)
            else:
                # onboarding: replicate as a follower until a config block
                # adds us to the consenter set (follower_chain.go:130-345)
                self.followers[channel_id] = FollowerChain(
                    channel_id, self.signer.identity, ledger,
                    join_block=join_block,
                )
                self.processors[channel_id] = self._make_processor(
                    channel_id, cfg
                )
            return self.channel_info(channel_id)

    def add_follower_source(self, channel_id: str, source) -> None:
        """Give an onboarding channel a block source to replicate from."""
        with self._lock:
            follower = self.followers.get(channel_id)
            if follower is None:
                raise ErrUnknownChannel(channel_id)
            follower.add_source(source)

    def poll_followers(self) -> int:
        """Advance every follower one pull iteration; switch any whose
        join block arrived (SwitchFollowerToChain).

        The pull itself runs outside the registrar lock — follower block
        sources can be remote and slow, and must not stall broadcast/
        deliver on other channels."""
        with self._lock:
            snapshot = list(self.followers.items())
        pulled = 0
        for channel_id, follower in snapshot:
            pulled += follower.poll()
        with self._lock:
            for channel_id, follower in snapshot:
                if self.followers.get(channel_id) is not follower:
                    continue  # removed concurrently
                cfg = follower.activation_config
                if cfg is not None:
                    del self.followers[channel_id]
                    self._activate(channel_id, cfg)
                elif follower.latest_seen_config is not None:
                    # mirror replicated config updates into the follower's
                    # read-policy surface
                    proc = self.processors.get(channel_id)
                    seen = follower.latest_seen_config
                    if proc is not None and (seen.writer_orgs or seen.reader_orgs):
                        proc.policy = ChannelPolicy(
                            writer_orgs=frozenset(seen.writer_orgs)
                            or proc.policy.writer_orgs,
                            reader_orgs=frozenset(seen.reader_orgs)
                            or proc.policy.reader_orgs,
                        )
        return pulled

    def remove_channel(self, channel_id: str) -> None:
        with self._lock:
            if channel_id in self.followers:
                del self.followers[channel_id]
                self.processors.pop(channel_id, None)
                return
            if channel_id not in self.chains:
                raise ErrUnknownChannel(channel_id)
            del self.chains[channel_id]
            del self.processors[channel_id]

    # ---- join-block persistence (reference: filerepo join blocks) ----
    def _join_block_path(self, channel_id: str):
        base = self.ledger_factory.base_dir
        if not base:
            return None
        return f"{base}/{channel_id}.joinblock"

    def _save_join_block(self, channel_id: str, block: pb.Block) -> None:
        path = self._join_block_path(channel_id)
        if path:
            with open(path, "wb") as fh:
                fh.write(block.SerializeToString())

    def _load_join_block(self, channel_id: str):
        path = self._join_block_path(channel_id)
        if path:
            try:
                with open(path, "rb") as fh:
                    blk = pb.Block()
                    blk.ParseFromString(fh.read())
                    return blk
            except FileNotFoundError:
                return None
        return None

    def list_channels(self) -> list[ChannelInfo]:
        with self._lock:
            names = sorted(set(self.chains) | set(self.followers))
            return [self.channel_info(c) for c in names]

    def channel_info(self, channel_id: str) -> ChannelInfo:
        follower = self.followers.get(channel_id)
        if follower is not None:
            return ChannelInfo(
                name=channel_id,
                height=follower.height(),
                status="failed" if follower.error else "onboarding",
                consensus_relation="follower",
                error=follower.error,
            )
        chain = self.chains.get(channel_id)
        if chain is None:
            raise ErrUnknownChannel(channel_id)
        return ChannelInfo(
            name=channel_id,
            height=chain.height(),
            status="active",
            consensus_relation="consenter",
        )

    def _activate(self, channel_id: str, cfg: pb.ChannelConfig) -> None:
        ledger = self.ledger_factory.get_or_create(channel_id)
        batch_config = BatchConfig(
            max_message_count=cfg.max_message_count or 500,
            preferred_max_bytes=cfg.preferred_max_bytes or 2 * 1024 * 1024,
            absolute_max_bytes=cfg.absolute_max_bytes or 10 * 1024 * 1024,
            batch_timeout=cfg.batch_timeout_s or 2.0,
        )
        # consensus-engine registry (reference main.go:624-628:
        # consenters["etcdraft"] / consenters["BFT"])
        if (cfg.consensus_type or "bdls") == "raft":
            from bdls_tpu_torch.ordering.raft import RaftChain

            wal_path = None
            if self.ledger_factory.base_dir:
                wal_path = f"{self.ledger_factory.base_dir}/{channel_id}.wal"
            chain = RaftChain(
                channel_id=channel_id,
                signer=self.signer,
                participants=[c.identity for c in cfg.consenters],
                ledger=ledger,
                batch_config=batch_config,
                latency=cfg.consensus_latency_s or 0.05,
                wal_path=wal_path,
            )
        else:
            chain = Chain(
                channel_id=channel_id,
                signer=self.signer,
                participants=[c.identity for c in cfg.consenters],
                ledger=ledger,
                batch_config=batch_config,
                verifier=self.verifier,
                latency=cfg.consensus_latency_s or 0.05,
                epoch=self.epoch,
            )
        self.chains[channel_id] = chain
        proc = self._make_processor(channel_id, cfg)
        self.processors[channel_id] = proc
        chain.submit_filter = self._make_submit_filter(channel_id)
        chain.on_commit = self._make_commit_hook(channel_id)
        self._warm_consenter_keys(cfg)
        if self.on_chain_created is not None:
            self.on_chain_created(channel_id, chain)

    def _warm_consenter_keys(self, cfg: pb.ChannelConfig) -> None:
        """Key-identity hint: pre-build the TPU provider's pinned-key
        tables for this channel's consenter set (background; a no-op
        for providers without a key cache)."""
        warm = getattr(self.csp, "warm_keys", None)
        if warm is None or not cfg.consenters:
            return
        from bdls_tpu_torch.consensus.verifier import identity_keys

        keys = identity_keys([c.identity for c in cfg.consenters])
        if keys:
            warm(keys, wait=False)

    def _make_processor(
        self, channel_id: str, cfg: pb.ChannelConfig
    ) -> StandardChannelProcessor:
        return StandardChannelProcessor(
            channel_id=channel_id,
            csp=self.csp,
            policy=ChannelPolicy(
                writer_orgs=frozenset(cfg.writer_orgs),
                reader_orgs=frozenset(cfg.reader_orgs),
            ),
            absolute_max_bytes=cfg.absolute_max_bytes or 10 * 1024 * 1024,
            config_seq=cfg.config_seq,
        )

    def _make_submit_filter(self, channel_id: str):
        def _filter(env_bytes: bytes) -> None:
            env = pb.TxEnvelope()
            env.ParseFromString(env_bytes)
            proc = self.processors[channel_id]
            if env.header.type == pb.TxType.TX_CONFIG:
                proc.process_config_msg(env)
            else:
                proc.process_normal_msg(env)

        return _filter

    def _make_commit_hook(self, channel_id: str):
        """Apply committed config transactions: bump config_seq and adopt
        the new batch/policy knobs (the channelconfig-bundle update the
        reference performs in BlockWriter for config blocks)."""

        def _on_commit(block: pb.Block) -> None:
            for raw in block.data.transactions:
                env = pb.TxEnvelope()
                try:
                    env.ParseFromString(raw)
                except Exception:
                    continue
                if env.header.type != pb.TxType.TX_CONFIG:
                    continue
                newcfg = pb.ChannelConfig()
                try:
                    newcfg.ParseFromString(env.payload)
                except Exception:
                    continue
                if newcfg.channel_id and newcfg.channel_id != channel_id:
                    continue
                proc = self.processors.get(channel_id)
                chain = self.chains.get(channel_id)
                if proc is None or chain is None:
                    continue
                proc.config_seq += 1
                if newcfg.capability_level:
                    try:
                        check_capabilities(newcfg)
                    except ErrIncompatibleCapabilities as exc:
                        # committed level above this node: stop consenting
                        # (reference: capability mismatch halts the chain)
                        _LOG.error("%s", exc)
                        self._evicted.add(channel_id)
                        continue
                if newcfg.writer_orgs or newcfg.reader_orgs:
                    # empty fields mean "unchanged", mirroring the other
                    # knobs — clearing a policy requires an explicit new
                    # set, never an omitted field
                    proc.policy = ChannelPolicy(
                        writer_orgs=frozenset(newcfg.writer_orgs)
                        or proc.policy.writer_orgs,
                        reader_orgs=frozenset(newcfg.reader_orgs)
                        or proc.policy.reader_orgs,
                    )
                if newcfg.absolute_max_bytes:
                    proc.absolute_max_bytes = newcfg.absolute_max_bytes
                if newcfg.max_message_count:
                    chain.batch_config.max_message_count = newcfg.max_message_count
                if newcfg.preferred_max_bytes:
                    chain.batch_config.preferred_max_bytes = newcfg.preferred_max_bytes
                if newcfg.batch_timeout_s:
                    chain.batch_config.batch_timeout = newcfg.batch_timeout_s
                # membership reconfiguration (reference
                # etcdraft/membership.go ConfChange application; BDLS/
                # SmartBFT restart-with-new-config): a committed consenter
                # set flows into the live consensus group
                if newcfg.consenters:
                    new_set = [c.identity for c in newcfg.consenters]
                    self._warm_consenter_keys(newcfg)
                    if hasattr(chain, "reconfigure"):
                        try:
                            chain.reconfigure(new_set, 0.0)
                        except Exception as exc:
                            # a committed membership change the engine
                            # cannot adopt (e.g. BDLS minimum of 4
                            # participants) is a silent-divergence
                            # hazard: the node would keep the old set
                            # while the ledger says otherwise. Surface
                            # it loudly.
                            _LOG.error(
                                "channel %s: reconfigure to %d consenters"
                                " failed: %r", channel_id, len(new_set), exc
                            )
                            chain.metrics.proposal_failures += 1
                    # eviction suspector (reference etcdraft/eviction.go +
                    # SwitchChainToFollower): a committed config that drops
                    # this node from the consenter set marks the chain for
                    # demotion; check_evictions() performs the switch
                    # outside the commit path
                    if self.signer.identity not in new_set:
                        self._evicted.add(channel_id)

        return _on_commit

    def check_evictions(self) -> list[str]:
        """Demote evicted consenter chains to followers (the reference's
        SwitchChainToFollower, driven by its eviction suspector). Returns
        the demoted channel ids."""
        demoted = []
        with self._lock:
            for channel_id in sorted(self._evicted):
                self._evicted.discard(channel_id)
                chain = self.chains.pop(channel_id, None)
                if chain is None:
                    continue
                if hasattr(chain, "close"):
                    chain.close()
                ledger = self.ledger_factory.get_or_create(channel_id)
                self.followers[channel_id] = FollowerChain(
                    channel_id, self.signer.identity, ledger
                )
                demoted.append(channel_id)
        return demoted

    # ---- broadcast path (reference broadcast.go:135-207) ----------------
    def broadcast(self, env_bytes: bytes, now: float) -> None:
        """Classify, filter, and order one transaction. Raises
        FilterError/RegistrarError with the rejection reason."""
        env = pb.TxEnvelope()
        try:
            env.ParseFromString(env_bytes)
        except Exception as exc:
            raise FilterError(f"malformed envelope: {exc}")
        channel_id = env.header.channel_id
        with self._lock:
            chain = self.chains.get(channel_id)
            proc = self.processors.get(channel_id)
            is_follower = channel_id in self.followers
        if chain is None:
            if is_follower:
                raise ErrNotConsenter(
                    f"{channel_id} is replicating in follower mode"
                )
            raise ErrUnknownChannel(channel_id)
        if env.header.type == pb.TxType.TX_CONFIG:
            proc.process_config_msg(env)
        else:
            proc.process_normal_msg(env)
        chain.submit(env_bytes, now)

    # ---- deliver path (reference common/deliver) ------------------------
    def deliver(
        self, channel_id: str, start: int = 0, stop: Optional[int] = None
    ) -> Iterator[pb.Block]:
        with self._lock:
            chain = self.chains.get(channel_id)
            follower = self.followers.get(channel_id)
        ledger = chain.ledger if chain is not None else (
            follower.ledger if follower is not None else None
        )
        if ledger is None:
            raise ErrUnknownChannel(channel_id)
        height = ledger.height()
        end = height if stop is None else min(stop + 1, height)
        for n in range(start, end):
            yield ledger.get(n)

    # ---- cluster ingress -------------------------------------------------
    def route_cluster_message(self, channel_id: str, data: bytes, now: float) -> None:
        with self._lock:
            chain = self.chains.get(channel_id)
        if chain is None:
            raise ErrUnknownChannel(channel_id)
        chain.receive_message(data, now)

    # ---- tick ------------------------------------------------------------
    def update(self, now: float) -> None:
        with self._lock:
            chains = list(self.chains.values())
        for chain in chains:
            chain.update(now)
