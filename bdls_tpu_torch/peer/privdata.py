"""Private data collections: hash-on-chain, cleartext side-stored on
member orgs only, with pull-based reconciliation.

Reference parity:
- ``gossip/privdata/coordinator.go`` — at commit, a peer marries each
  private write's on-chain hash with the cleartext it holds (received at
  endorsement time or from other members); what it cannot marry is
  recorded as *missing* and fetched later.
- ``core/ledger/pvtdatastorage/store.go`` — the durable side store of
  private writes keyed by (chaincode, collection, key), separate from
  public state, so non-members never hold cleartext. Collections are
  chaincode-scoped exactly as in the reference: two chaincodes declaring
  the same collection name never share state.
- Collection membership rides the chaincode definition
  (:mod:`bdls_tpu_torch.peer.lifecycle`), as the reference's collection
  configs ride the chaincode definition package.

Contract convention: a simulation write to ``@<collection>/<key>``
targets a collection of the invoked chaincode. The endorser strips the
cleartext out of the public write-set, replacing it with (collection,
key, sha256(value)), and parks the cleartext as a *transient* payload
the client distributes to member-org peers only (the reference's
transient store fed by the client's transient field). Transient entries
are purged when their transaction commits.

The port's copy of ``bdls_tpu/peer/privdata.py``.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
from typing import Optional, Sequence

from bdls_tpu_torch.utils.frames import encode_frame, iter_frames

PRIV_MARK = "@"


def parse_private_key(key: str) -> Optional[tuple[str, str]]:
    """``@coll/key`` -> (coll, key), else None."""
    if not key.startswith(PRIV_MARK):
        return None
    coll, sep, rest = key[len(PRIV_MARK):].partition("/")
    if not sep or not coll or not rest:
        return None
    return coll, rest


def value_hash(value: bytes) -> bytes:
    return hashlib.sha256(value).digest()


class PvtStore:
    """Durable side store of private writes + the missing-data ledger.

    State keys are (chaincode, collection, key) -> (value, version);
    versions are the committing (block, tx), so late reconciliation can
    never roll current state back to an older value. The durable form is
    the same length-framed append-only log discipline as KVState."""

    def __init__(self, path: Optional[str] = None):
        self._kv: dict[tuple[str, str, str],
                       tuple[bytes, tuple[int, int]]] = {}
        # (block, tx, chaincode, collection, key) -> expected value hash
        self.missing: dict[tuple[int, int, str, str, str], bytes] = {}
        self._path = path
        self._fh = None
        # the peer server reads (endorser pvt_get, serve_private) from
        # gRPC threads while the delivery thread commits — same
        # discipline as KVState
        self._lock = threading.Lock()
        if path:
            self._recover()
            self._fh = open(path, "ab")

    # ---- durability ------------------------------------------------------
    def _append(self, rec: dict) -> None:
        if self._fh is None:
            return
        self._fh.write(encode_frame(json.dumps(rec).encode()))
        self._fh.flush()
        os.fsync(self._fh.fileno())

    def _recover(self) -> None:
        if not os.path.exists(self._path):
            return
        good = 0
        with open(self._path, "rb") as fh:
            raw = fh.read()
        for off, payload in iter_frames(raw):
            try:
                rec = json.loads(payload)
            except ValueError:
                break
            good = off
            if "p" in rec:
                cc, coll, key, v, ver = rec["p"]
                self._apply_put(cc, coll, key,
                                None if v is None else bytes.fromhex(v),
                                tuple(ver))
            elif "m" in rec:
                blk, tx, cc, coll, key, h = rec["m"]
                self.missing[(blk, tx, cc, coll, key)] = bytes.fromhex(h)
            elif "r" in rec:
                blk, tx, cc, coll, key = rec["r"]
                self.missing.pop((blk, tx, cc, coll, key), None)
        if good < len(raw):
            with open(self._path, "r+b") as fh:
                fh.truncate(good)

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    # ---- state -----------------------------------------------------------
    def _apply_put(self, chaincode: str, collection: str, key: str,
                   value: Optional[bytes], version: tuple[int, int]) -> None:
        k = (chaincode, collection, key)
        if value is None:
            self._kv.pop(k, None)
        else:
            self._kv[k] = (value, version)

    def _put_locked(self, chaincode: str, collection: str, key: str,
                    value: Optional[bytes],
                    version: tuple[int, int]) -> None:
        self._apply_put(chaincode, collection, key, value, version)
        self._append({"p": [chaincode, collection, key,
                            None if value is None else value.hex(),
                            list(version)]})

    def put(self, chaincode: str, collection: str, key: str,
            value: Optional[bytes],
            version: tuple[int, int] = (0, 0)) -> None:
        with self._lock:
            self._put_locked(chaincode, collection, key, value, version)

    def get(self, chaincode: str, collection: str,
            key: str) -> Optional[bytes]:
        with self._lock:
            entry = self._kv.get((chaincode, collection, key))
            return entry[0] if entry else None

    def version(self, chaincode: str, collection: str,
                key: str) -> Optional[tuple[int, int]]:
        with self._lock:
            entry = self._kv.get((chaincode, collection, key))
            return entry[1] if entry else None

    def missing_snapshot(self) -> list[tuple[int, int, str, str, str]]:
        """Locked snapshot of the missing-data keys (reconciliation
        iterates while the commit thread may record new entries)."""
        with self._lock:
            return list(self.missing)

    # ---- missing-data ledger (reconciliation) ----------------------------
    def record_missing(self, block: int, tx: int, chaincode: str,
                       collection: str, key: str,
                       expect_hash: bytes) -> None:
        with self._lock:
            self.missing[(block, tx, chaincode, collection, key)] = \
                expect_hash
            self._append({"m": [block, tx, chaincode, collection, key,
                                expect_hash.hex()]})

    def resolve_missing(self, block: int, tx: int, chaincode: str,
                        collection: str, key: str, value: bytes) -> bool:
        """Accept a reconciled value iff it matches the on-chain hash.
        The value only lands in current state if no NEWER version has
        committed since (stale reconciliation must not roll state
        back)."""
        mkey = (block, tx, chaincode, collection, key)
        with self._lock:
            expect = self.missing.get(mkey)
            if expect is None or value_hash(value) != expect:
                return False
            # durability order matters: persist the VALUE before the
            # resolved marker — a crash between the two then merely
            # re-resolves on restart, instead of dropping the cleartext
            # with no missing record left to drive reconciliation
            cur_entry = self._kv.get((chaincode, collection, key))
            cur = cur_entry[1] if cur_entry else None
            if cur is None or cur <= (block, tx):
                self._put_locked(chaincode, collection, key, value,
                                 (block, tx))
            del self.missing[mkey]
            self._append({"r": [block, tx, chaincode, collection, key]})
            return True


def split_private_writes(writes: Sequence[tuple[str, Optional[bytes]]]):
    """Simulation writes -> (public_writes, private_payloads).

    private_payloads: {(collection, key): value} — the transient data
    the client must hand to member-org peers."""
    public: list[tuple[str, Optional[bytes]]] = []
    private: dict[tuple[str, str], bytes] = {}
    for key, value in writes:
        parsed = parse_private_key(key)
        if parsed is None:
            public.append((key, value))
            continue
        coll, k = parsed
        if value is None:
            raise ValueError("private deletes need a tombstone value")
        private[(coll, k)] = value
    return public, private
