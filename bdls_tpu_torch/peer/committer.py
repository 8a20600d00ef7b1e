"""Peer committer: block validation → kv-state commit.

Reference parity: the commit path of ``core/ledger/kvledger``
(``kv_ledger.go:598 CommitLegacy``: validate flags → apply valid txs'
write-sets to the state DB → append to block store) reduced to the
version-checked kv state the benchmarks exercise. The peer's block store
reuses the ordering FileLedger/MemoryLedger.

The port's copy of ``bdls_tpu/peer/committer.py``.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Optional

from bdls_tpu_torch.utils import tracing
from bdls_tpu_torch.utils.frames import encode_frame, iter_frames

from bdls_tpu_torch.crypto.csp import CSP
from bdls_tpu_torch.ordering import fabric_codec as pb
from bdls_tpu_torch.ordering.block import validate_chain_link
from bdls_tpu_torch.ordering.ledger import _LedgerBase
from bdls_tpu_torch.peer.validator import EndorsementPolicy, TxFlag, TxValidator


class KVState:
    """Versioned key-value state with history queries and crash-safe
    incremental persistence.

    Reference parity: ``core/ledger/kvledger`` — the state DB's
    height-version MVCC scheme ((block, tx) versions), the history DB's
    per-key version trail (GetHistoryForKey), and crash recovery. The
    durable form is an append-only log of length-framed JSON records;
    each flushed block appends its write records followed by a commit
    marker. Recovery replays the log, truncates any torn tail, and
    discards records after the last commit marker — a partially-written
    flush rolls back cleanly (the FileLedger's torn-tail discipline).
    """

    def __init__(self, path: Optional[str] = None):
        self._data: dict[str, tuple[bytes, tuple[int, int]]] = {}
        self._hist: dict[str, list[tuple[tuple[int, int], Optional[bytes]]]] = {}
        self._staged: list[dict] = []
        self._path = path
        self._lock = threading.Lock()
        self._fh = None
        if path:
            self._recover()
            self._fh = open(path, "ab")

    # ---- reads -----------------------------------------------------------
    def get(self, key: str) -> Optional[bytes]:
        with self._lock:
            entry = self._data.get(key)
            return entry[0] if entry else None

    def version(self, key: str) -> Optional[tuple[int, int]]:
        with self._lock:
            entry = self._data.get(key)
            return entry[1] if entry else None

    def history(self, key: str) -> list[tuple[tuple[int, int], Optional[bytes]]]:
        """All committed versions of a key, oldest first; a None value is
        a delete (the history DB's GetHistoryForKey)."""
        with self._lock:
            return list(self._hist.get(key, ()))

    def keys(self) -> list[str]:
        with self._lock:
            return sorted(self._data)

    # ---- rich queries (reference statedb GetStateRangeScanIterator /
    # composite keys, core/ledger/kvledger + shim GetStateByRange) ------
    def range_query(self, start: str = "", end: Optional[str] = None,
                    limit: Optional[int] = None
                    ) -> list[tuple[str, bytes]]:
        """Ordered (key, value) pairs with start <= key < end (end=None
        scans to the last key), like the reference's range iterator."""
        import bisect

        with self._lock:
            keys = sorted(self._data)
            out = []
            for i in range(bisect.bisect_left(keys, start), len(keys)):
                k = keys[i]
                if end is not None and k >= end:
                    break
                out.append((k, self._data[k][0]))
                if limit is not None and len(out) >= limit:
                    break
            return out

    @staticmethod
    def composite_key(object_type: str, *attrs: str) -> str:
        """NUL-framed composite key (the shim's CreateCompositeKey):
        prefix scans over (object_type, attr-prefix...) become range
        queries."""
        parts = [object_type, *attrs]
        if any("\x00" in p for p in parts):
            raise ValueError("composite key parts must not contain NUL")
        return "\x00".join(parts) + "\x00"

    def partial_composite_query(self, object_type: str, *attrs: str
                                ) -> list[tuple[str, bytes]]:
        """All keys under a composite-key prefix (GetStateByPartial
        CompositeKey). The upper bound is U+10FFFF (as the reference's
        shim uses): any smaller sentinel (e.g. '\xff') silently drops
        keys whose next attribute starts beyond Latin-1."""
        prefix = self.composite_key(object_type, *attrs)
        return self.range_query(prefix, prefix + "\U0010ffff")

    # ---- writes ----------------------------------------------------------
    def apply(self, writes: pb.WriteSet, version: tuple[int, int]) -> None:
        """Stage one tx's write-set at (block, tx). Visible to reads
        immediately (intra-block MVCC); durable at the next flush."""
        with self._lock:
            for w in writes.writes:
                value = None if w.is_delete else w.value
                if w.is_delete:
                    self._data.pop(w.key, None)
                else:
                    self._data[w.key] = (w.value, version)
                self._hist.setdefault(w.key, []).append((version, value))
                self._staged.append({
                    "k": w.key,
                    "v": None if value is None else value.hex(),
                    "ver": list(version),
                })

    def flush(self) -> None:
        """Durably append staged records + a commit marker. A crash
        mid-flush leaves the tail uncommitted; recovery discards it.
        The file write runs outside the lock so state reads (the
        endorsement path) never wait on an fsync; flush itself is only
        called from the single committer thread."""
        with self._lock:
            staged, self._staged = self._staged, []
        if self._fh is None or not staged:
            return
        for rec in staged:
            self._append(rec)
        self._append({"commit": 1})
        self._fh.flush()
        os.fsync(self._fh.fileno())

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    # ---- log internals ---------------------------------------------------
    def _append(self, rec: dict) -> None:
        self._fh.write(encode_frame(json.dumps(rec).encode()))

    def _recover(self) -> None:
        if not os.path.exists(self._path):
            return
        committed_end = 0
        pending: list[dict] = []
        with open(self._path, "rb") as fh:
            raw = fh.read()
        for off, payload in iter_frames(raw):
            try:
                rec = json.loads(payload)
            except ValueError:
                break  # corrupt frame: treat as torn
            if "commit" in rec:
                for r in pending:
                    self._replay(r)
                pending = []
                committed_end = off
            else:
                pending.append(rec)
        # pending records after the last marker are an incomplete flush —
        # roll them back by truncating the file to the committed prefix
        if committed_end < len(raw):
            with open(self._path, "r+b") as fh:
                fh.truncate(committed_end)

    def _replay(self, rec: dict) -> None:
        key = rec["k"]
        version = tuple(rec["ver"])
        value = None if rec["v"] is None else bytes.fromhex(rec["v"])
        if value is None:
            self._data.pop(key, None)
        else:
            self._data[key] = (value, version)
        self._hist.setdefault(key, []).append((version, value))


class Committer:
    """Validates and commits delivered blocks (reference committer +
    kvledger). Validation flags are recorded in block metadata slot 0 as a
    flag byte per tx (Fabric's txfilter convention)."""

    def __init__(
        self,
        block_store: _LedgerBase,
        state: KVState,
        csp: CSP,
        policy: Optional[EndorsementPolicy] = None,
        msp=None,
        org: str = "",
        pvt_store=None,
        transient_lookup=None,
        transient_purge=None,
    ):
        self.block_store = block_store
        self.state = state
        self.validator = TxValidator(csp, policy, msp=msp,
                                     state_get=state.get)
        self.stats = {"blocks": 0, "valid_txs": 0, "invalid_txs": 0}
        # private-data collections (reference gossip/privdata coordinator)
        self.org = org
        self.pvt_store = pvt_store
        # proposal_hash -> {(collection, key): cleartext}
        self.transient_lookup = transient_lookup or (lambda _h: None)
        self.transient_purge = transient_purge or (lambda _h: None)

    def _reads_valid(self, action: pb.EndorsedAction) -> bool:
        """MVCC check: every recorded read version must still match the
        live state (which already includes earlier txs of this block —
        Fabric's intra-block conflict semantics)."""
        for rd in action.read_set.reads:
            cur = self.state.version(rd.key)
            if not rd.exists:
                if cur is not None:
                    return False
            elif cur != (rd.version_block, rd.version_tx):
                return False
        return True

    def _apply_private(self, action: pb.EndorsedAction, block_num: int,
                       tx_num: int) -> pb.WriteSet:
        public = apply_private_writes(
            action, block_num, tx_num,
            state_get=self.state.get, org=self.org,
            pvt_store=self.pvt_store,
            transient_lookup=self.transient_lookup,
        )
        self.transient_purge(bytes(action.proposal_hash))
        return public

    def height(self) -> int:
        return self.block_store.height()

    def commit_block(self, block: pb.Block) -> list[TxFlag]:
        with tracing.GLOBAL.span(
            "committer.commit_block",
            attrs={"block": block.header.number,
                   "txs": len(block.data.transactions)},
        ) as span:
            flags = self._commit_block(block)
            span.set_attr(
                "valid_txs", sum(1 for f in flags if f == TxFlag.VALID)
            )
            return flags

    def _commit_block(self, block: pb.Block) -> list[TxFlag]:
        last = self.block_store.last_block()
        if last is not None:
            err = validate_chain_link(block, last.header)
            if err is not None and block.header.number != 0:
                raise ValueError(f"block {block.header.number}: {err}")
        # the endorsement-batch verify (a creator batch and one fused
        # block launch) — TorchCSP's tpu.verify_batch and tpu.verify_block
        # spans nest here
        with tracing.GLOBAL.span(
            "committer.validate_block", attrs={"block": block.header.number}
        ):
            flags = self.validator.validate_block(block)
        for t, (raw, flag) in enumerate(zip(block.data.transactions, flags)):
            if flag != TxFlag.VALID:
                self.stats["invalid_txs"] += 1
                continue
            env = pb.TxEnvelope()
            env.ParseFromString(raw)
            if env.header.type == pb.TxType.TX_CONFIG:
                continue
            action = pb.EndorsedAction()
            try:
                action.ParseFromString(env.payload)
            except Exception:
                continue
            if not self._reads_valid(action):
                flags[t] = TxFlag.MVCC_READ_CONFLICT
                self.stats["invalid_txs"] += 1
                continue
            public = self._apply_private(action, block.header.number, t)
            self.state.apply(public, (block.header.number, t))
            self.stats["valid_txs"] += 1
        block.metadata.entries[0] = bytes(int(f) for f in flags)
        self.block_store.append(block)
        self.stats["blocks"] += 1
        self.state.flush()
        return flags


def apply_private_writes(action: pb.EndorsedAction, block_num: int,
                         tx_num: int, *, state_get, org: str = "",
                         pvt_store=None,
                         transient_lookup=None) -> pb.WriteSet:
    """Marry private-collection writes with transient cleartext
    (coordinator.go StoreBlock): the on-chain record is the value HASH
    under a deterministic public key (every peer, versioned); member
    orgs also store the cleartext in the side store, or record it
    missing for reconciliation. Returns the public write-set to apply.
    Module-level so the rebuild utility shares the exact commit-path
    semantics without a throwaway Committer."""
    from bdls_tpu_torch.peer import privdata as pd
    from bdls_tpu_torch.peer.lifecycle import ChaincodeDefinition, defs_key

    if not any(w.collection for w in action.write_set.writes):
        return action.write_set  # common case: no copying at all

    public = pb.WriteSet()
    definition = None
    payloads = None
    cc = action.contract
    for w in action.write_set.writes:
        if not w.collection:
            public.writes.add().CopyFrom(w)
            continue
        # the on-chain record: hash under a deterministic public key
        # namespaced by chaincode (collections are chaincode-scoped)
        hw = public.writes.add()
        hw.key = f"_pvthash/{cc}/{w.collection}/{w.key}"
        hw.value = w.value_hash
        if pvt_store is None:
            continue
        if definition is None:
            raw = state_get(defs_key(cc))
            definition = ChaincodeDefinition.from_bytes(raw) if raw \
                else False
        orgs = definition.collection_orgs(w.collection) \
            if definition else None
        if orgs is None or org not in orgs:
            continue  # not a member: hash only, never cleartext
        if payloads is None:
            payloads = (transient_lookup or (lambda _h: None))(
                bytes(action.proposal_hash)) or {}
        value = payloads.get((w.collection, w.key))
        if value is not None and pd.value_hash(value) == w.value_hash:
            pvt_store.put(cc, w.collection, w.key, value,
                          (block_num, tx_num))
        else:
            pvt_store.record_missing(
                block_num, tx_num, cc, w.collection, w.key,
                bytes(w.value_hash))
    return public


def rebuild_state_from_blocks(block_store: _LedgerBase) -> KVState:
    """Reconstruct the versioned public state from the block store using
    the committed per-tx validation flags — the reference's
    ``rebuild_dbs`` recovery utility (core/ledger/kvledger/rebuild_dbs.go
    + pause_resume.go): state/history DBs are derived data and can
    always be regenerated from blocks without re-validating signatures.

    Private cleartext is NOT regenerated (it never lives in blocks —
    only hashes do); a rebuilt member peer re-fetches it through
    privdata reconciliation."""
    state = KVState()
    for n in range(1, block_store.height()):
        block = block_store.get(n)
        flags = block.metadata.entries[0] if block.metadata.entries else b""
        for t, raw in enumerate(block.data.transactions):
            if t >= len(flags) or flags[t] != int(TxFlag.VALID):
                continue
            env = pb.TxEnvelope()
            try:
                env.ParseFromString(raw)
            except Exception:
                continue
            if env.header.type == pb.TxType.TX_CONFIG:
                continue
            action = pb.EndorsedAction()
            try:
                action.ParseFromString(env.payload)
            except Exception:
                continue
            public = apply_private_writes(action, n, t,
                                          state_get=state.get)
            state.apply(public, (n, t))
    return state
