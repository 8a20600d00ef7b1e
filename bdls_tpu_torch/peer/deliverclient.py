"""BFT-aware block delivery client.

Reference parity: ``internal/pkg/peer/blocksprovider`` — the peer pulls
blocks from the ordering service; in BFT mode it must not trust a single
orderer (``bft_deliverer.go`` + ``bft_censorship_monitor.go``): it pulls
from one source while cross-checking block availability against the
others, rotating away from a withholding (censoring) orderer.

This client is transport-agnostic: sources expose ``height()`` and
``get_block(n)`` (the in-process OrdererNode surface or a gRPC stub).

The port's copy of ``bdls_tpu/peer/deliverclient.py``.
"""

from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import Callable, Optional, Protocol

from bdls_tpu_torch.ordering import fabric_codec as pb


class BlockSource(Protocol):
    def height(self) -> int: ...
    def get_block(self, number: int) -> Optional[pb.Block]: ...


@dataclass
class DeliverStats:
    pulled: int = 0
    rotations: int = 0
    censorship_suspicions: int = 0


class BFTDeliverer:
    """Pulls blocks sequentially for a consumer callback, rotating sources
    on failure or suspected censorship."""

    def __init__(
        self,
        sources: list[BlockSource],
        on_block: Callable[[pb.Block], None],
        start_height: int = 1,
        censorship_threshold: int = 2,
        seed: int = 0,
    ):
        if not sources:
            raise ValueError("need at least one block source")
        self.sources = sources
        self.on_block = on_block
        self.next_number = start_height
        self.censorship_threshold = censorship_threshold
        self._rng = random.Random(seed)
        self._current = self._rng.randrange(len(sources))
        self._behind_count = 0
        self.stats = DeliverStats()

    def poll(self) -> int:
        """Pull every block currently available; returns number pulled.
        Call periodically (the reference runs a retry loop with backoff)."""
        pulled = 0
        while True:
            src = self.sources[self._current]
            try:
                blk = (
                    src.get_block(self.next_number)
                    if src.height() > self.next_number
                    else None
                )
            except Exception:
                blk = None
            if blk is None:
                # censorship check: does any OTHER source have this block?
                if self._others_have(self.next_number):
                    self._behind_count += 1
                    self.stats.censorship_suspicions += 1
                    if self._behind_count >= self.censorship_threshold:
                        self._rotate()
                        continue
                break
            self._behind_count = 0
            self.on_block(blk)
            self.next_number += 1
            pulled += 1
            self.stats.pulled += 1
        return pulled

    def _others_have(self, number: int) -> bool:
        for i, src in enumerate(self.sources):
            if i == self._current:
                continue
            try:
                if src.height() > number:
                    return True
            except Exception:
                continue
        return False

    def _rotate(self) -> None:
        self._behind_count = 0
        self.stats.rotations += 1
        choices = [i for i in range(len(self.sources)) if i != self._current]
        self._current = self._rng.choice(choices) if choices else self._current
