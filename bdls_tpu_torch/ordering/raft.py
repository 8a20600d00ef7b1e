"""CFT consensus chain: Raft with a write-ahead log — the framework's
etcdraft-parity ordering option.

Reference parity: ``orderer/consensus/etcdraft/`` (~4,160 LoC) — the
production CFT chain with its own raft node, **WAL + snapshots**
(``storage.go:57-200``), leadership tracking, and catch-up. The TPU-first
re-design keeps the same shape as the BDLS chain: **tick-driven and
deterministic** (no goroutines; ``update(now)`` advances elections,
heartbeats, and batch timers), so the same VirtualNetwork test harness
drives both consensus options. Registrar selects the engine by the
channel's ``consensus_type`` — the reference's consenter registry
(``orderer/common/server/main.go:624-628``:
``consenters["etcdraft"] | consenters["BFT"]``).

Model notes:
- Log entries carry whole serialized blocks; an entry's ``index`` IS its
  block number. The ledger is the snapshot: on restart, entries at or
  below the ledger tip are compacted away and the WAL replays only the
  unapplied suffix (``storage.go``'s snapshot+WAL recovery reduced to
  the ledger-is-the-checkpoint story used across this framework).
- The WAL persists term/vote (election safety across crashes) and every
  appended/truncated entry, length-framed with torn-tail truncation.
- CFT trust model: messages are authenticated by the cluster transport
  (identity-auth streams), not individually signed — Raft tolerates
  crashes, not byzantine peers, exactly like the reference's etcdraft.
- Only the leader cuts batches into blocks; submits relay to all
  consenters (FRAME_SUBMIT) so any future leader has the full tx pool.

The port's copy of ``bdls_tpu/ordering/raft.py``: the same elections,
replication and WAL bytes, over :mod:`bdls_tpu_torch.ordering.raft_codec`.
It runs on the host (crash faults, no signatures to verify).
"""

from __future__ import annotations

import hashlib
import json
import os
import random
import struct
from collections import deque
from typing import Callable, Optional

from bdls_tpu_torch.ordering import fabric_codec as pb
from bdls_tpu_torch.ordering import raft_codec as rpb
from bdls_tpu_torch.ordering.block import BlockCreator, validate_chain_link
from bdls_tpu_torch.ordering.blockcutter import BatchConfig, BlockCutter
from bdls_tpu_torch.ordering.chain import FRAME_CONSENSUS, FRAME_SUBMIT, ChainMetrics
from bdls_tpu_torch.ordering.ledger import _LedgerBase
from bdls_tpu_torch.utils.frames import encode_frame, iter_frames

FOLLOWER, CANDIDATE, LEADER = "follower", "candidate", "leader"


def _block_term(block: pb.Block) -> int:
    """The raft term a block was proposed in, stamped by the leader into
    metadata slot 2 (the consensus-proof slot). Keeping the term inside
    the block preserves election safety across log compaction: the
    RequestVote up-to-date check needs the applied tip's true term, and
    snapshot-shipped entries must not launder their terms to 0."""
    entries = block.metadata.entries
    if len(entries) > 2 and len(entries[2]) == 8:
        return struct.unpack("<Q", entries[2])[0]
    return 0


class RaftWAL:
    """Length-framed append-only WAL: hard state + log entries.

    Records: {"hs": [term, voted_hex]} | {"ent": [term, index, data_hex]}
    | {"trunc": index}. Torn tails are truncated on replay (the same
    discipline as the FileLedger / KVState logs)."""

    def __init__(self, path: Optional[str]):
        self.path = path
        self._fh = None
        if path:
            os.makedirs(os.path.dirname(path), exist_ok=True)

    def replay(self) -> tuple[int, Optional[bytes], list[tuple[int, int, bytes]]]:
        """Returns (term, voted_for, entries)."""
        term, voted, entries = 0, None, []
        if not self.path or not os.path.exists(self.path):
            return term, voted, entries
        with open(self.path, "rb") as fh:
            raw = fh.read()
        good = 0
        for off, payload in iter_frames(raw):
            try:
                rec = json.loads(payload)
            except ValueError:
                break
            good = off
            if "hs" in rec:
                term = rec["hs"][0]
                voted = bytes.fromhex(rec["hs"][1]) if rec["hs"][1] else None
            elif "ent" in rec:
                t, i, d = rec["ent"]
                entries = [e for e in entries if e[1] < i]
                entries.append((t, i, bytes.fromhex(d)))
            elif "trunc" in rec:
                entries = [e for e in entries if e[1] < rec["trunc"]]
        if good < len(raw):
            with open(self.path, "r+b") as fh:
                fh.truncate(good)
        return term, voted, entries

    def _append(self, rec: dict) -> None:
        if not self.path:
            return
        if self._fh is None:
            self._fh = open(self.path, "ab")
        self._fh.write(encode_frame(json.dumps(rec).encode()))
        self._fh.flush()
        os.fsync(self._fh.fileno())

    def save_hardstate(self, term: int, voted: Optional[bytes]) -> None:
        self._append({"hs": [term, voted.hex() if voted else ""]})

    def save_entry(self, term: int, index: int, data: bytes) -> None:
        self._append({"ent": [term, index, data.hex()]})

    def save_truncate(self, index: int) -> None:
        self._append({"trunc": index})

    def compact(self, applied_index: int, term: int, voted: Optional[bytes],
                entries: list[tuple[int, int, bytes]]) -> None:
        """Rewrite the WAL with only unapplied entries (snapshot point =
        the ledger tip; storage.go's Snapshot+WAL-release equivalent)."""
        if not self.path:
            return
        if self._fh is not None:
            self._fh.close()
            self._fh = None
        tmp = self.path + ".tmp"
        with open(tmp, "wb") as fh:
            def put(rec):
                fh.write(encode_frame(json.dumps(rec).encode()))
            put({"hs": [term, voted.hex() if voted else ""]})
            for t, i, d in entries:
                if i > applied_index:
                    put({"ent": [t, i, d.hex()]})
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, self.path)

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None


class RaftChain:
    """One channel's CFT ordering pipeline; Chain-interface compatible
    (receive_message/update/submit/join), so the Registrar, cluster
    transport, and VirtualNetwork drive it exactly like the BDLS chain."""

    def __init__(
        self,
        channel_id: str,
        signer,
        participants: list[bytes],
        ledger: _LedgerBase,
        batch_config: Optional[BatchConfig] = None,
        latency: float = 0.05,
        wal_path: Optional[str] = None,
        on_commit: Optional[Callable[[pb.Block], None]] = None,
        **_ignored,
    ):
        assert ledger.height() > 0, "ledger must contain the genesis block"
        self.channel_id = channel_id
        self.identity = signer.identity
        self.participants = list(participants)
        self.ledger = ledger
        self.batch_config = batch_config or BatchConfig()
        self.cutter = BlockCutter(self.batch_config)
        self.on_commit = on_commit
        self.submit_filter: Optional[Callable[[bytes], None]] = None
        self.metrics = ChainMetrics(cluster_size=len(participants))
        self._peers: dict[bytes, object] = {}
        # every relayed/submitted tx parks here until committed: a node
        # elected later must be able to propose txs it saw as a follower,
        # and a deposed leader must not keep half-cut batches (both are
        # leadership-transition correctness bugs otherwise)
        self._pending: dict[bytes, bytes] = {}  # tx hash -> env bytes
        self._committed_window: "deque[bytes]" = deque(maxlen=100_000)
        self.apply_error: Optional[str] = None

        # timing (etcdraft: election = 10 ticks, heartbeat = 1 tick)
        self.heartbeat_interval = max(2 * latency, 0.04)
        self._election_span = (10 * self.heartbeat_interval,
                               20 * self.heartbeat_interval)
        self._rng = random.Random(self.identity)
        self._election_deadline: Optional[float] = None
        self._heartbeat_deadline = 0.0
        self.batch_deadline: Optional[float] = None

        # persistent state
        self.wal = RaftWAL(wal_path)
        self.term, self.voted_for, entries = self.wal.replay()
        tip = ledger.last_block().header.number
        self.log: list[tuple[int, int, bytes]] = [
            e for e in entries if e[1] > tip
        ]  # compaction: the ledger is the snapshot
        self.wal.compact(tip, self.term, self.voted_for, self.log)

        self.role = FOLLOWER
        self.leader_id: Optional[bytes] = None
        self.commit_index = tip
        self._now = 0.0
        self._next_index: dict[bytes, int] = {}
        self._match_index: dict[bytes, int] = {}
        self._votes: set[bytes] = set()

    # ---- transport wiring (Chain interface) ------------------------------
    def join(self, peer) -> bool:
        ident = peer.identity()
        if ident is None or ident in self._peers:
            return False
        self._peers[ident] = peer
        return True

    def height(self) -> int:
        return self.ledger.height()

    def gap(self) -> Optional[tuple[int, int]]:
        return None  # raft catch-up rides the log itself

    def receive_pulled_block(self, block_bytes: bytes, now: float) -> bool:
        return False

    # ---- helpers ----------------------------------------------------------
    def _quorum(self) -> int:
        return len(self.participants) // 2 + 1

    def _last_log(self) -> tuple[int, int]:
        """(index, term) of the last entry; the ledger tip's term survives
        compaction because leaders stamp it into the block itself
        (:func:`_block_term`) — without it, a deposed leader holding a
        stale uncommitted entry could outrank nodes with newer committed
        blocks in the up-to-date vote check."""
        if self.log:
            return self.log[-1][1], self.log[-1][0]
        last = self.ledger.last_block()
        return last.header.number, _block_term(last)

    def _entry_term(self, index: int) -> Optional[int]:
        tip = self.ledger.last_block().header.number
        if index <= tip:
            return -1  # compacted/applied: by definition matched
        for t, i, _ in self.log:
            if i == index:
                return t
        return None

    def _send(self, ident: bytes, msg: rpb.RaftMessage) -> None:
        peer = self._peers.get(ident)
        if peer is None:
            return
        try:
            peer.send(FRAME_CONSENSUS + msg.SerializeToString())
        except Exception:
            pass

    def _broadcast(self, msg: rpb.RaftMessage) -> None:
        for ident in self._peers:
            self._send(ident, msg)

    def _msg(self, mtype) -> rpb.RaftMessage:
        m = rpb.RaftMessage()
        m.type = mtype
        m.term = self.term
        setattr(m, "from", self.identity)  # `from` is a Python keyword
        return m

    def _reset_election_timer(self, now: float) -> None:
        self._election_deadline = now + self._rng.uniform(*self._election_span)

    def _become_follower(self, term: int, now: float) -> None:
        changed = term != self.term
        self.term = term
        self.role = FOLLOWER
        if changed:
            self.voted_for = None
            self.wal.save_hardstate(self.term, self.voted_for)
        self._reset_election_timer(now)

    # ---- ingress (Chain interface) ---------------------------------------
    def receive_message(self, data: bytes, now: float) -> None:
        self._now = max(self._now, now)
        if not data:
            return
        tag, rest = data[:1], data[1:]
        if tag == FRAME_SUBMIT:
            if self.submit_filter is not None:
                try:
                    self.submit_filter(rest)
                except Exception:
                    return
            self.submit(rest, now, relay=False)
            return
        if tag != FRAME_CONSENSUS:
            return
        msg = rpb.RaftMessage()
        try:
            msg.ParseFromString(rest)
        except Exception:
            return
        sender = bytes(getattr(msg, "from"))
        if sender not in self.participants:
            return
        if msg.term > self.term:
            self._become_follower(msg.term, now)
        handler = {
            rpb.RaftMessage.VOTE_REQ: self._on_vote_req,
            rpb.RaftMessage.VOTE_RESP: self._on_vote_resp,
            rpb.RaftMessage.APPEND_REQ: self._on_append_req,
            rpb.RaftMessage.APPEND_RESP: self._on_append_resp,
        }.get(msg.type)
        if handler is not None:
            handler(msg, sender, now)

    # ---- elections ---------------------------------------------------------
    def _start_election(self, now: float) -> None:
        self.role = CANDIDATE
        self.term += 1
        self.voted_for = self.identity
        self.wal.save_hardstate(self.term, self.voted_for)
        self._votes = {self.identity}
        self._reset_election_timer(now)
        last_index, last_term = self._last_log()
        m = self._msg(rpb.RaftMessage.VOTE_REQ)
        m.last_log_index = last_index
        m.last_log_term = last_term
        self._broadcast(m)
        self._maybe_win(now)

    def _on_vote_req(self, msg, sender, now) -> None:
        if msg.term < self.term:
            return self._send(sender, self._msg(rpb.RaftMessage.VOTE_RESP))
        my_index, my_term = self._last_log()
        up_to_date = (msg.last_log_term, msg.last_log_index) >= (my_term, my_index)
        resp = self._msg(rpb.RaftMessage.VOTE_RESP)
        if up_to_date and self.voted_for in (None, sender):
            if self.voted_for is None:
                self.voted_for = sender
                self.wal.save_hardstate(self.term, self.voted_for)
            resp.granted = True
            self._reset_election_timer(now)
        self._send(sender, resp)

    def _on_vote_resp(self, msg, sender, now) -> None:
        if self.role != CANDIDATE or msg.term != self.term or not msg.granted:
            return
        self._votes.add(sender)
        self._maybe_win(now)

    # ---- membership reconfiguration ---------------------------------------
    def reconfigure(self, participants: list[bytes], now: float) -> None:
        """Apply a committed consenter-set change to the raft group — the
        ``etcdraft/membership.go`` ConfChange parity. Joint consensus is
        not needed here because the change itself rode an ordered config
        block: every replica applies it at the same log position, so at
        any moment all voters agree on the active set.

        Added nodes start below the leader's snapshot point and catch up
        through the ledger-shipping append path; removed nodes stop
        counting toward quorum immediately (and a removed self stops
        campaigning — the registrar demotes it to a follower)."""
        now = max(now, self._now)
        old, new = set(self.participants), set(participants)
        self.participants = list(participants)
        self.metrics.cluster_size = len(participants)
        if self.role == LEADER:
            for p in new - old:
                if p != self.identity:
                    self._next_index.setdefault(
                        p, self.ledger.last_block().header.number + 1
                    )
                    self._match_index.setdefault(p, 0)
            for p in old - new:
                self._next_index.pop(p, None)
                self._match_index.pop(p, None)
            if self.identity not in new:
                self._become_follower(self.term, now)
            else:
                # a shrink can lower the quorum: re-check commit progress
                self._advance_commit(now)
        elif self.role == CANDIDATE:
            self._votes &= new | {self.identity}
            if self.identity not in new:
                self._become_follower(self.term, now)
            else:
                self._maybe_win(now)

    def _maybe_win(self, now: float) -> None:
        if self.role == CANDIDATE and len(self._votes) >= self._quorum():
            self.role = LEADER
            self.leader_id = self.identity
            last_index, _ = self._last_log()
            self._next_index = {p: last_index + 1 for p in self.participants}
            self._match_index = {p: 0 for p in self.participants}
            self._heartbeat_deadline = 0.0  # heartbeat immediately
            # fresh cutter: anything a previous leadership left half-cut
            # is rebuilt from the pending pool — minus txs already sitting
            # in retained (uncommitted) log entries, which would otherwise
            # be proposed AGAIN in a new block and commit twice
            self.cutter = BlockCutter(self.batch_config)
            self.batch_deadline = None
            in_log: set[bytes] = set()
            for _, _, data in self.log:
                blk = pb.Block()
                try:
                    blk.ParseFromString(data)
                except Exception:
                    continue
                for raw in blk.data.transactions:
                    in_log.add(hashlib.sha256(raw).digest())
            ingested = False
            for tx_hash, env_bytes in list(self._pending.items()):
                if tx_hash in in_log:
                    continue
                self._leader_ingest(env_bytes, now)
                ingested = True
            if self.log and not ingested:
                # the paper's start-of-term no-op: prior-term entries only
                # commit once a current-term entry replicates; without
                # client traffic that never happens. The no-op block holds
                # a marker envelope (unsigned — peers flag it invalid and
                # apply nothing).
                noop = pb.TxEnvelope()
                noop.header.type = pb.TxType.TX_NORMAL
                noop.header.channel_id = self.channel_id
                noop.header.tx_id = f"raft-noop-term-{self.term}"
                self._propose_block([noop.SerializeToString()])

    # ---- replication -------------------------------------------------------
    def _send_appends(self, now: float) -> None:
        for ident in self._peers:
            self._send_append(ident)
        self._heartbeat_deadline = now + self.heartbeat_interval

    def _send_append(self, ident: bytes) -> None:
        next_idx = self._next_index.get(
            ident, self.ledger.last_block().header.number + 1
        )
        tip = self.ledger.last_block().header.number
        if next_idx <= tip:
            # follower is behind our snapshot point: ship applied blocks
            # straight from the ledger (the InstallSnapshot analogue —
            # blocks ARE the state)
            m = self._msg(rpb.RaftMessage.APPEND_REQ)
            m.prev_index = next_idx - 1
            m.prev_term = 0
            for n in range(next_idx, min(tip, next_idx + 15) + 1):
                e = m.entries.add()
                e.term = 0
                e.index = n
                e.data = self.ledger.get(n).SerializeToString()
            m.commit = self.commit_index
            self._send(ident, m)
            return
        m = self._msg(rpb.RaftMessage.APPEND_REQ)
        m.prev_index = next_idx - 1
        prev_term = self._entry_term(next_idx - 1)
        m.prev_term = max(prev_term or 0, 0)
        for t, i, d in self.log:
            if i >= next_idx and len(m.entries) < 16:
                e = m.entries.add()
                e.term = t
                e.index = i
                e.data = d
        m.commit = self.commit_index
        self._send(ident, m)

    def _on_append_req(self, msg, sender, now) -> None:
        resp = self._msg(rpb.RaftMessage.APPEND_RESP)
        if msg.term < self.term:
            self._send(sender, resp)
            return
        self.leader_id = sender
        if self.role != FOLLOWER:
            self.role = FOLLOWER
        self._reset_election_timer(now)

        tip = self.ledger.last_block().header.number
        prev_term = self._entry_term(msg.prev_index)
        if prev_term is None:
            resp.success = False
            resp.match_index = max(tip, self.commit_index)
            self._send(sender, resp)
            return
        if prev_term >= 0 and msg.prev_term and prev_term != msg.prev_term:
            # conflicting entry: truncate it and everything after
            self.log = [e for e in self.log if e[1] < msg.prev_index]
            self.wal.save_truncate(msg.prev_index)
            resp.success = False
            resp.match_index = tip
            self._send(sender, resp)
            return
        for e in msg.entries:
            if e.index <= tip:
                continue  # already applied
            existing = self._entry_term(e.index)
            if existing is not None and existing == e.term:
                continue
            if existing is not None:
                self.log = [x for x in self.log if x[1] < e.index]
                self.wal.save_truncate(e.index)
            self.log.append((e.term, e.index, bytes(e.data)))
            self.wal.save_entry(e.term, e.index, bytes(e.data))
        # confirm ONLY what this request covered: reporting the whole-log
        # last index would let a new leader count our stale entries (ones
        # it never sent) toward commit — a committed-block-loss hazard
        confirmed = msg.prev_index + len(msg.entries)
        if msg.commit > self.commit_index:
            last_index, _ = self._last_log()
            self.commit_index = min(msg.commit, last_index)
            self._apply(now)
        resp.success = True
        resp.match_index = confirmed
        self._send(sender, resp)

    def _on_append_resp(self, msg, sender, now) -> None:
        if self.role != LEADER or msg.term != self.term:
            return
        if msg.success:
            self._match_index[sender] = max(
                self._match_index.get(sender, 0), msg.match_index
            )
            self._next_index[sender] = msg.match_index + 1
            self._advance_commit(now)
        else:
            # back off (fast: follower told us its tip)
            self._next_index[sender] = max(1, msg.match_index + 1)
            self._send_append(sender)

    def _advance_commit(self, now: float) -> None:
        last_index, _ = self._last_log()
        for n in range(last_index, self.commit_index, -1):
            term_n = self._entry_term(n)
            if term_n is None or term_n != self.term:
                continue  # only current-term entries commit by counting
            members = set(self.participants)
            votes = sum(
                1 for p, m in self._match_index.items()
                if p in members and p != self.identity and m >= n
            )
            if self.identity in members:
                votes += 1
            if votes >= self._quorum():
                self.commit_index = n
                self._apply(now)
                break

    def _apply(self, now: float) -> None:
        applied = False
        while True:
            tip = self.ledger.last_block().header.number
            if self.commit_index <= tip:
                break
            entry = next((e for e in self.log if e[1] == tip + 1), None)
            if entry is None:
                break
            block = pb.Block()
            try:
                block.ParseFromString(entry[2])
            except Exception as exc:
                # a committed entry that cannot apply is a poisoned
                # channel: surface it loudly instead of silently spinning
                self.apply_error = f"entry {tip + 1} unparseable: {exc!r}"
                self.metrics.proposal_failures += 1
                break
            err = validate_chain_link(block, self.ledger.last_block().header)
            if err is not None:
                self.apply_error = f"entry {tip + 1} chain-link: {err}"
                self.metrics.proposal_failures += 1
                break
            self.apply_error = None
            self.ledger.append(block)
            self.metrics.committed_block_number = block.header.number
            for raw in block.data.transactions:
                tx_hash = hashlib.sha256(raw).digest()
                self._pending.pop(tx_hash, None)
                self._committed_window.append(tx_hash)
            if self.on_commit is not None:
                try:
                    self.on_commit(block)
                except Exception:
                    pass
            applied = True
        if applied:
            tip = self.ledger.last_block().header.number
            self.log = [e for e in self.log if e[1] > tip]
            self.wal.compact(tip, self.term, self.voted_for, self.log)

    # ---- client ingress (Chain interface) ----------------------------------
    def submit(self, env_bytes: bytes, now: float, relay: bool = True) -> None:
        env = pb.TxEnvelope()
        try:
            env.ParseFromString(env_bytes)
        except Exception:
            return
        tx_hash = hashlib.sha256(env_bytes).digest()
        if tx_hash in self._pending or tx_hash in self._committed_window:
            return
        self._pending[tx_hash] = env_bytes
        if relay:
            frame = FRAME_SUBMIT + env_bytes
            for peer in self._peers.values():
                try:
                    peer.send(frame)
                except Exception:
                    pass
        if self.role == LEADER:
            self._leader_ingest(env_bytes, now, env=env)

    def _leader_ingest(self, env_bytes: bytes, now: float,
                       env: Optional[pb.TxEnvelope] = None) -> None:
        if env is None:
            env = pb.TxEnvelope()
            try:
                env.ParseFromString(env_bytes)
            except Exception:
                return
        if env.header.type == pb.TxType.TX_CONFIG:
            self.metrics.config_proposals_received += 1
            leftover = self.cutter.cut()
            if leftover:
                self._propose_block(leftover)
            self._propose_block([env_bytes])
            self.batch_deadline = None
            return
        self.metrics.normal_proposals_received += 1
        batches, pending = self.cutter.ordered(env_bytes)
        for batch in batches:
            self._propose_block(batch)
        if pending and self.batch_deadline is None:
            self.batch_deadline = now + self.batch_config.batch_timeout
        if not pending:
            self.batch_deadline = None

    def _propose_block(self, batch: list[bytes]) -> None:
        """Leader: chain a block off the last log entry (or ledger tip)
        and append it to the raft log."""
        if self.log:
            prev = pb.Block()
            prev.ParseFromString(self.log[-1][2])
            creator = BlockCreator(prev.header)
        else:
            creator = BlockCreator(self.ledger.last_block().header)
        block = creator.create_next(batch)
        block.metadata.entries[2] = struct.pack("<Q", self.term)
        index = block.header.number
        self.log.append((self.term, index, block.SerializeToString()))
        self.wal.save_entry(self.term, index, block.SerializeToString())
        self._match_index[self.identity] = index
        # single-node cluster commits immediately
        self._advance_commit(0.0)

    # ---- the tick (Chain interface) -----------------------------------------
    def update(self, now: float) -> None:
        self._now = max(self._now, now)
        if self._election_deadline is None:
            self._reset_election_timer(now)
        if self.role == LEADER:
            if self.batch_deadline is not None and now >= self.batch_deadline:
                self.batch_deadline = None
                batch = self.cutter.cut()
                if batch:
                    self._propose_block(batch)
            if now >= self._heartbeat_deadline:
                self._send_appends(now)
        elif now >= self._election_deadline:
            self._start_election(now)
        self.metrics.is_leader = self.role == LEADER
        if self.leader_id is not None and self.leader_id in self.participants:
            self.metrics.leader_id = self.participants.index(self.leader_id)

    def close(self) -> None:
        self.wal.close()
