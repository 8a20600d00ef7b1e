"""Consistent-hash ring routing SKIs across a verifyd fleet.

The port's copy of ``bdls_tpu/sidecar/router.py`` (hashlib only): the
same ring function, so the port's clients and the reference's route a
key to the same replica.

One daemon's pinned-key table is a cache over device HBM; a fleet of N
daemons should hold N× the keys, not N copies of the same keys. The
router makes that true by construction: every request's subject key
identifier (SKI — the same sha256-of-point digest the daemon's
:class:`KeyTableCache` slots are keyed by) hashes to a point on a ring,
and the first replica at-or-after that point owns the key. All clients
share the ring function, so a key is warmed, pinned, and verified on
exactly one replica — the pools *partition*.

Properties the fleet depends on (asserted in ``tests/test_router.py``;
the port's ring is held to the reference's in
``tests/test_torch_router.py``):

- **uniformity** — each endpoint is planted at ``vnodes`` virtual
  points, so expected load per replica is ``1/N`` with bounded skew;
- **minimal movement** — adding/removing a replica remaps only the arc
  segments adjacent to its virtual points (~``1/N`` of keys), so a
  rolling restart does not shuffle the whole fleet's cache residency;
- **failover determinism** — ``lookup(ski, alive)`` walks the ring past
  dead replicas, so every client that agrees on the alive set agrees on
  the failover target (warmup and traffic re-converge on one host);
- **vote affinity** — a quorum batch routes whole via the *minimum*
  lane SKI (:func:`affinity_ski`), which is order-independent: every
  node verifying the same committee's votes lands on the same replica,
  keeping the daemon's speculative quorum flush armed.
"""

from __future__ import annotations

import bisect
import hashlib
from typing import Iterable, Optional, Sequence

DEFAULT_VNODES = 64


def _point(data: bytes) -> int:
    """Ring coordinate: first 8 bytes of sha256, big-endian."""
    return int.from_bytes(hashlib.sha256(data).digest()[:8], "big")


def affinity_ski(skis: Iterable[bytes]) -> bytes:
    """Order-independent representative SKI for a batch that must stay
    together (a quorum's vote lanes): the lexicographic minimum. Every
    node holding the same committee computes the same value regardless
    of lane order, so their vote batches co-locate on one replica."""
    it = iter(skis)
    try:
        best = next(it)
    except StopIteration:
        return b""
    for s in it:
        if s < best:
            best = s
    return best


class HashRing:
    """Consistent-hash ring over verifyd endpoints.

    Deterministic: the ring is a pure function of the endpoint strings,
    so independently-constructed clients route identically (no shared
    coordination service needed for affinity to hold).
    """

    def __init__(self, endpoints: Sequence[str],
                 vnodes: int = DEFAULT_VNODES):
        if vnodes < 1:
            raise ValueError("vnodes must be >= 1")
        self.vnodes = vnodes
        self._endpoints: list[str] = []
        self._points: list[int] = []
        self._owners: list[str] = []
        for ep in endpoints:
            self.add(ep)

    # ---- membership -------------------------------------------------------
    @property
    def endpoints(self) -> tuple[str, ...]:
        return tuple(self._endpoints)

    def __len__(self) -> int:
        return len(self._endpoints)

    def add(self, endpoint: str) -> None:
        if endpoint in self._endpoints:
            return
        self._endpoints.append(endpoint)
        for i in range(self.vnodes):
            p = _point(f"{endpoint}#{i}".encode())
            at = bisect.bisect_left(self._points, p)
            # ties broken by endpoint string so insertion order of the
            # membership list never changes routing
            while (at < len(self._points) and self._points[at] == p
                   and self._owners[at] < endpoint):
                at += 1
            self._points.insert(at, p)
            self._owners.insert(at, endpoint)

    def remove(self, endpoint: str) -> None:
        if endpoint not in self._endpoints:
            return
        self._endpoints.remove(endpoint)
        keep = [(p, o) for p, o in zip(self._points, self._owners)
                if o != endpoint]
        self._points = [p for p, _ in keep]
        self._owners = [o for _, o in keep]

    # ---- routing ----------------------------------------------------------
    def lookup(self, ski: bytes,
               alive: Optional[Iterable[str]] = None) -> Optional[str]:
        """Home endpoint for ``ski``; with ``alive``, the first live
        endpoint at-or-after the key's point (failover walk). ``None``
        when the ring is empty or nothing in ``alive`` is a member."""
        if not self._points:
            return None
        live = None if alive is None else set(alive)
        if live is not None and not live.intersection(self._endpoints):
            return None
        start = bisect.bisect_right(self._points, _point(ski))
        n = len(self._points)
        for step in range(n):
            owner = self._owners[(start + step) % n]
            if live is None or owner in live:
                return owner
        return None

    def partition(self, skis: Sequence[bytes],
                  alive: Optional[Iterable[str]] = None
                  ) -> dict[str, list[int]]:
        """Group lane indices by home endpoint (one ring walk per lane).
        Lanes with no live home are grouped under ``""``."""
        live = None if alive is None else set(alive)
        out: dict[str, list[int]] = {}
        for i, ski in enumerate(skis):
            ep = self.lookup(ski, live)
            out.setdefault(ep or "", []).append(i)
        return out
