"""The pinned-key table cache — ``KeyTableCache`` of the port.

The counterpart of ``bdls_tpu/crypto/tpu_provider.py:KeyTableCache``
(``tpu_provider.py:179-487``), its snapshots included. The consensus
workload re-verifies the same ≤128 consenter keys every round; for a key
seen before, ``u2·Q`` rides host-built positioned tables
(:func:`bdls_tpu_torch.ops.verify_fold.build_pinned_tables`) through the
pinned-key kernel. This cache owns those tables:

- keyed by the SHA-256 of the SEC1 point (``PublicKey.ski()``), LRU-
  bounded at ``capacity`` keys per curve (default 256, the reference's);
- one pool per curve on the provider's device, ``(capacity, npos, 9,
  8)`` int32 per coordinate in Montgomery form; dispatches pass the pool
  and per-lane slot indices;
- **copy-on-write**: an insert clones the pool, writes the new key's
  slot and publishes the clone under the lock (on the card after a
  synchronise of the inserting stream). A published pool is never
  written again, so the slots a dispatch looked up always index the
  pool it looked them up in, whatever is evicted and re-pinned while
  its launch is in flight. The provider keeps that pool alive with the
  launch (``torch_provider._Inflight``) until the verdict is back;
- populated eagerly by :meth:`KeyTableCache.warm` (the channel's
  consenter set) and lazily by a builder thread on a lookup miss, so
  the next flush hits;
- **snapshots**: :meth:`KeyTableCache.snapshot_to` writes every resident
  key (its point and its pool entries) to one file
  (:mod:`bdls_tpu_torch.ops.table_snapshot`), and
  :meth:`KeyTableCache.restore_from` brings them back at start-up: into
  a curve with no resident keys as one new pool made by a single bulk
  copy to the device, otherwise through the normal insert. Neither
  writes a published pool. A bad snapshot never fails start-up: it
  restores what passes the checks (0 keys for a rejected file) and
  counts its rejects.
"""

from __future__ import annotations

import queue
import threading
from typing import Optional, Sequence

import numpy as np
import torch

from bdls_tpu_torch.ops import table_snapshot
from bdls_tpu_torch.ops import verify_fold as vf
from bdls_tpu_torch.utils.device import DeviceLike, resolve_device

DEFAULT_KEY_CACHE_SIZE = 256


class KeyTableCache:
    """Device-resident positioned tables for pinned public keys."""

    def __init__(self, capacity: int = DEFAULT_KEY_CACHE_SIZE,
                 device: DeviceLike = None):
        self.capacity = max(0, int(capacity))
        self.device = resolve_device(device)
        self._lock = threading.Lock()
        # curve -> {ski: slot}, insertion order == LRU order
        self._slots: dict[str, dict[bytes, int]] = {}
        self._next_slot: dict[str, int] = {}
        self._pools: dict[str, dict[str, torch.Tensor]] = {}
        # ski -> (curve, x, y): the point behind each pinned slot, carried
        # so a snapshot can be checked again on restore
        self._pubs: dict[bytes, tuple[str, int, int]] = {}
        self._pending: set[bytes] = set()
        self._miss_q: "queue.Queue[Optional[object]]" = queue.Queue()
        self._builder: Optional[threading.Thread] = None
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.built = 0
        self.build_errors = 0

    # ---- introspection ---------------------------------------------------
    @property
    def stats(self) -> dict:
        with self._lock:
            return {
                "capacity": self.capacity,
                "keys": {c: len(m) for c, m in self._slots.items()},
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
                "built": self.built,
                "build_errors": self.build_errors,
            }

    def __len__(self) -> int:
        with self._lock:
            return sum(len(m) for m in self._slots.values())

    def contains(self, key) -> bool:
        ski = key.ski()
        with self._lock:
            return ski in self._slots.get(key.curve, ())

    def skis(self) -> dict[str, list[str]]:
        """Hex SKIs currently resident, per curve."""
        with self._lock:
            return {c: [s.hex() for s in m] for c, m in self._slots.items()}

    # ---- population ------------------------------------------------------
    def pin(self, key) -> int:
        """Build and insert one key's tables now; returns its pool slot.
        Idempotent. Raises ``ValueError`` for a point the reference
        rejects (out of range, infinity, off the curve)."""
        ski = key.ski()
        with self._lock:
            slots = self._slots.get(key.curve)
            if slots is not None and ski in slots:
                return slots[ski]
        # the host EC math stays outside the lock; a concurrent duplicate
        # build is wasted work, never wrong (_insert is idempotent)
        tabs = vf.pinned_device_tables(
            key.curve, vf.build_pinned_tables(key.curve, key.x, key.y))
        return self._insert(key.curve, ski, tabs, (key.x, key.y))

    def warm(self, keys: Sequence, wait: bool = False) -> None:
        """Populate from a known key set (the channel's consenters or
        endorsers). ``wait=False`` builds on the builder thread, so the
        caller and the first flush never wait for table builds. Invalid
        points are skipped and counted in ``build_errors``."""
        if self.capacity <= 0:
            return
        if not wait:
            for k in keys:
                self._schedule(k)
            return
        for k in keys:
            try:
                self.pin(k)
            except ValueError:
                with self._lock:
                    self.build_errors += 1

    def _schedule(self, key) -> None:
        ski = key.ski()
        with self._lock:
            if ski in self._pending or ski in self._slots.get(key.curve, ()):
                return
            self._pending.add(ski)
        self._miss_q.put(key)
        self._ensure_builder()

    def _ensure_builder(self) -> None:
        with self._lock:
            if self._builder is not None and self._builder.is_alive():
                return
            self._builder = threading.Thread(
                target=self._build_loop, daemon=True,
                name="torch-key-cache-build")
            self._builder.start()

    def _build_loop(self) -> None:
        while True:
            key = self._miss_q.get()
            if key is None:
                return
            try:
                self.pin(key)
            except Exception:
                with self._lock:
                    self.build_errors += 1
            finally:
                with self._lock:
                    self._pending.discard(key.ski())

    def _insert(self, curve: str, ski: bytes, tabs: dict,
                point: tuple[int, int]) -> int:
        entries = {nm: torch.from_numpy(v) for nm, v in tabs.items()}
        with self._lock:
            slots = self._slots.setdefault(curve, {})
            if ski in slots:
                return slots[ski]
            if len(slots) >= self.capacity:
                # LRU = the first entry in insertion order; its slot is
                # reused in the NEW pool only
                old_ski = next(iter(slots))
                slot = slots.pop(old_ski)
                self._pubs.pop(old_ski, None)
                self.evictions += 1
            else:
                slot = self._next_slot.get(curve, 0)
                self._next_slot[curve] = slot + 1
            old = self._pools.get(curve)
            if old is None:
                shape = (self.capacity, vf.pinned_positions(curve), 9, 8)
                new = {nm: torch.zeros(shape, dtype=torch.int32,
                                       device=self.device)
                       for nm in vf.PINNED_COORDS[curve]}
            else:
                new = {nm: t.clone() for nm, t in old.items()}
            for nm, t in new.items():
                t[slot].copy_(entries[nm])
            if self.device.type == "cuda":
                # the clone and copy ran on this thread's stream: finish
                # them before any launch stream can see the new pool
                torch.cuda.current_stream(self.device).synchronize()
            self._pools[curve] = new
            slots[ski] = slot
            self._pubs[ski] = (curve, *point)
            self.built += 1
            return slot

    # ---- snapshots ---------------------------------------------------------
    def snapshot_entries(self) -> list[dict]:
        """Every resident key as a pinned snapshot entry: curve, ski,
        point and its pool entries (``(npos, 9, 8)`` int32 Montgomery
        words a coordinate) copied back to the host."""
        with self._lock:
            view = {curve: (dict(slots), self._pools.get(curve))
                    for curve, slots in self._slots.items()}
            pubs = dict(self._pubs)
        out: list[dict] = []
        for curve, (slots, pools) in view.items():
            if pools is None:
                continue
            # a published pool is never written: read it outside the lock
            host = {nm: t.cpu().numpy() for nm, t in pools.items()}
            for ski, slot in slots.items():
                pub = pubs.get(ski)
                if pub is None:
                    continue
                out.append({"curve": curve, "ski": ski, "x": pub[1],
                            "y": pub[2],
                            "tabs": {nm: host[nm][slot].copy()
                                     for nm in host}})
        return out

    def snapshot_to(self, path: str) -> int:
        """Write the resident set as one snapshot file; returns the entry
        count (0: nothing resident, no file)."""
        entries = self.snapshot_entries()
        if not entries:
            return 0
        table_snapshot.save_pinned_snapshot(path, entries)
        return len(entries)

    def restore(self, entries: list[dict]) -> int:
        """Pin checked snapshot entries again. A curve with no resident
        keys gets one new pool, assembled on the host and copied to the
        device in one copy, and published whole; otherwise each entry
        goes through the normal (copy-on-write) insert. Returns the keys
        restored."""
        if self.capacity <= 0 or not entries:
            return 0
        by_curve: dict[str, list[dict]] = {}
        for e in entries:
            by_curve.setdefault(e["curve"], []).append(e)
        restored = 0
        for curve, ents in by_curve.items():
            with self._lock:
                bulk = curve not in self._slots
            if bulk:
                kept = list({e["ski"]: e for e in ents}.values())
                kept = kept[:self.capacity]
                pools = self._pool_of(curve, kept)
                with self._lock:
                    # a key pinned meanwhile: insert one by one instead
                    bulk = curve not in self._slots
                    if bulk:
                        self._slots[curve] = {e["ski"]: i
                                              for i, e in enumerate(kept)}
                        self._next_slot[curve] = len(kept)
                        self._pools[curve] = pools
                        for e in kept:
                            self._pubs[e["ski"]] = (curve, e["x"], e["y"])
                        self.built += len(kept)
                        restored += len(kept)
            if not bulk:
                for e in ents:
                    self._insert(curve, e["ski"], e["tabs"], (e["x"], e["y"]))
                    restored += 1
        return restored

    def _pool_of(self, curve: str, entries: list[dict]) -> dict:
        """A new pool holding ``entries`` in slots 0, 1, …: every
        coordinate assembled on the host and copied to the device in one
        copy (finished before it is returned)."""
        names = vf.PINNED_COORDS[curve]
        host = np.zeros((len(names), self.capacity,
                         vf.pinned_positions(curve), 9, 8), np.int32)
        for slot, e in enumerate(entries):
            for c, nm in enumerate(names):
                host[c, slot] = e["tabs"][nm]
        whole = torch.from_numpy(host).to(self.device)
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        return {nm: whole[c] for c, nm in enumerate(names)}

    def restore_from(self, path: str, on_reject=None) -> int:
        """Load, check and restore a pinned snapshot; 0 keys on a
        rejected file (the cache then fills lazily as before). Rejects
        are counted through ``on_reject``; a bad snapshot never raises."""
        try:
            entries = table_snapshot.load_pinned_snapshot(
                path, on_reject=on_reject)
        except Exception:  # noqa: BLE001 — a bad snapshot never fails boot
            return 0
        return self.restore(entries)

    # ---- the dispatch-path lookup ---------------------------------------
    def lookup_batch(self, curve: str, keys: Sequence):
        """Atomic per-flush lookup: ``(slots, pools)`` where ``slots[i]``
        is keys[i]'s pool slot (``None`` = miss) and ``pools`` the pool
        those slots are valid for (``None`` before the curve's first
        key). Misses are queued for the background builder. A key may
        also be a verify request (``ski()`` and ``key``): a wire request
        hashes its key's bytes as they came, and its ``PublicKey`` is
        made only on a miss."""
        missed = []
        with self._lock:
            slots_map = self._slots.get(curve)
            pools = self._pools.get(curve)
            out: list[Optional[int]] = []
            for k in keys:
                ski = k.ski()
                slot = None if slots_map is None else slots_map.get(ski)
                if slot is None:
                    self.misses += 1
                    missed.append(k)
                else:
                    # touch LRU order (dicts keep insertion order)
                    slots_map[ski] = slots_map.pop(ski)
                    self.hits += 1
                out.append(slot)
        for k in missed:
            self._schedule(getattr(k, "key", k))
        return out, pools

    def close(self) -> None:
        with self._lock:
            builder = self._builder
        if builder is not None and builder.is_alive():
            self._miss_q.put(None)
            builder.join(timeout=5.0)
