"""Batch cutting by count/size (reference:
``orderer/common/blockcutter/blockcutter.go:74-140``).

Same cutting rules: an oversized message first flushes the pending batch
then rides alone; a message that would overflow ``preferred_max_bytes``
flushes first; reaching ``max_message_count`` cuts immediately. Config
transactions are isolated by the chain, not here (same split as the
reference).

The port's copy of ``bdls_tpu/ordering/blockcutter.py``.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class BatchConfig:
    max_message_count: int = 500
    preferred_max_bytes: int = 2 * 1024 * 1024
    absolute_max_bytes: int = 10 * 1024 * 1024
    batch_timeout: float = 2.0  # seconds


@dataclass
class BlockCutter:
    config: BatchConfig
    pending: list[bytes] = field(default_factory=list)
    pending_bytes: int = 0

    def ordered(self, msg: bytes) -> tuple[list[list[bytes]], bool]:
        """Enqueue one message; returns (cut batches, has_pending)."""
        batches: list[list[bytes]] = []
        size = len(msg)

        if size > self.config.preferred_max_bytes:
            if self.pending:
                batches.append(self._cut())
            batches.append([msg])
            return batches, False

        if self.pending_bytes + size > self.config.preferred_max_bytes:
            batches.append(self._cut())

        self.pending.append(msg)
        self.pending_bytes += size

        if len(self.pending) >= self.config.max_message_count:
            batches.append(self._cut())

        return batches, bool(self.pending)

    def cut(self) -> list[bytes]:
        """Flush the pending batch (batch-timer expiry)."""
        return self._cut() if self.pending else []

    def _cut(self) -> list[bytes]:
        batch, self.pending, self.pending_bytes = self.pending, [], 0
        return batch
