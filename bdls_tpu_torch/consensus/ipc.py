"""In-process fake peers + virtual clock for deterministic protocol tests.

The reference tests its engine by wiring N ``Consensus`` objects with
``IPCPeer`` fakes that deliver messages by direct call under emulated
latency, driving ``Update(now)`` manually (``vendor/.../bdls/ipc_peer.go``,
``timer/timedsched.go``). This harness does the same but with a *virtual*
clock and a priority queue instead of wall-clock timers — runs are exactly
reproducible and faster than real time.

The port's copy of ``bdls_tpu/consensus/ipc.py``, unchanged in
behaviour: the one seeded ``random.Random`` draws in :meth:`post` in
the reference's order, :meth:`due_frames` pulls the due prefix, each
frame carries the sender's traceparent, and :meth:`_deliver` swallows a
receiver's errors as the reference does.
"""

from __future__ import annotations

import heapq
import random
from collections import deque
from typing import Optional

from bdls_tpu_torch.consensus.engine import Consensus
from bdls_tpu_torch.utils import tracing


class VirtualNetwork:
    """Deterministic message scheduler between in-process nodes.

    Beyond base latency/jitter, the network exposes the full
    fault-injection surface the reference's chaos layer
    (``bdls_tpu/chaos``) schedules on its timeline — all driven by the
    one seeded RNG, so a FaultPlan replays bit-identically:

    - ``loss``: per-message drop probability;
    - ``dup``: per-message duplication probability (the copy lands a
      random extra delay later — at-least-once delivery under retries);
    - ``reorder``: probability a message is held back by up to
      ``reorder_spread`` extra seconds, overtaking later traffic;
    - ``partitioned``: the standing split set (traffic to/from these is
      dropped), mutated mid-run for partition windows;
    - ``crashed``: dead processes (``crash``/``recover``) — same drop
      semantics, tracked separately so a chaos plan can overlay crash
      windows on top of an independent partition.
    """

    def __init__(self, seed: int = 0, latency: float = 0.05, jitter: float = 0.0,
                 loss: float = 0.0, dup: float = 0.0, reorder: float = 0.0,
                 reorder_spread: float = 0.1,
                 tracer: Optional[tracing.Tracer] = None):
        self.rng = random.Random(seed)
        self.latency = latency
        self.jitter = jitter
        self.loss = loss
        self.dup = dup
        self.reorder = reorder
        self.reorder_spread = reorder_spread
        self.tracer = tracer or tracing.GLOBAL
        # (deliver_at, seq, dst_index, data, traceparent)
        self._queue: list = []
        # due prefix pulled off the heap by due_frames() but not yet
        # delivered; always sorted (heap-pop order) and globally <= the
        # heap remainder, so delivering due-first preserves exact
        # (deliver_at, seq) order
        self._due: deque = deque()
        self._seq = 0
        self.nodes: list[Consensus] = []
        self.now = 0.0
        # wire stats, like the reference's IPCPeer counters
        self.tx_msgs = 0
        self.tx_bytes = 0
        self.dropped_msgs = 0
        self.dup_msgs = 0
        self.reordered_msgs = 0
        # per-destination partition set: messages to/from these are dropped
        self.partitioned: set[int] = set()
        # crashed nodes: no receive AND no update ticks until recover()
        self.crashed: set[int] = set()

    def add_node(self, node: Consensus) -> int:
        self.nodes.append(node)
        return len(self.nodes) - 1

    def connect_all(self) -> None:
        for i, src in enumerate(self.nodes):
            for j in range(len(self.nodes)):
                if i != j:
                    src.join(IPCPeer(self, i, j))

    # ---- chaos controls --------------------------------------------------
    def crash(self, i: int) -> None:
        """Kill node ``i``: queued and future messages to it are dropped
        and its ``update`` stops ticking until :meth:`recover`."""
        self.crashed.add(i)

    def recover(self, i: int) -> None:
        """Restart node ``i`` with the state it crashed with; it catches
        up from the next <decide> broadcast (the engine's height sync)."""
        self.crashed.discard(i)

    def _down(self, i: int) -> bool:
        return i in self.partitioned or i in self.crashed

    def post(self, src: int, dst: int, data: bytes) -> None:
        if self._down(src) or self._down(dst):
            self.dropped_msgs += 1
            return
        if self.loss and self.rng.random() < self.loss:
            self.dropped_msgs += 1
            return
        delay = self.latency
        if self.jitter:
            delay = max(0.0, self.rng.gauss(self.latency, self.jitter))
        if self.reorder and self.rng.random() < self.reorder:
            # held back: later messages overtake this one
            delay += self.rng.uniform(0.0, self.reorder_spread)
            self.reordered_msgs += 1
        self.tx_msgs += 1
        self.tx_bytes += len(data)
        # stamp the sender's span context on the frame — the in-process
        # analogue of the traceparent field on cluster step frames
        tp = self.tracer.current_traceparent()
        self._push(self.now + delay, dst, data, tp)
        if self.dup and self.rng.random() < self.dup:
            # the duplicate trails by up to one extra spread window
            self.dup_msgs += 1
            self._push(
                self.now + delay
                + self.rng.uniform(0.0, self.reorder_spread or self.latency),
                dst, data, tp)

    def _push(self, deliver_at: float, dst: int, data: bytes,
              tp: Optional[str]) -> None:
        self._seq += 1
        heapq.heappush(self._queue, (deliver_at, self._seq, dst, data, tp))

    def _deliver(self, dst: int, data: bytes, tp: Optional[str]) -> None:
        try:
            if tp is not None:
                with self.tracer.span(
                    "ipc.deliver", parent=tp, attrs={"dst": dst}
                ):
                    self.nodes[dst].receive_message(data, self.now)
            else:
                self.nodes[dst].receive_message(data, self.now)
        except Exception:
            pass

    def due_frames(self, t_end: float) -> list:
        """Frames scheduled to deliver at or before ``t_end``, in
        delivery order — the pre-pass index for drive loops that want
        to batch-verify a tick's traffic before delivering it.

        The old consumers scanned the ENTIRE in-flight heap every tick
        (``for ... in net._queue``): with n validators broadcasting,
        that's O(n²) messages re-scanned per tick, and the scan —
        not the consensus math — dominated large-committee drives.
        This pops just the due prefix (O(due · log q)) into an internal
        buffer that :meth:`run_until` delivers first, so scheduling
        order, drop accounting, and the seeded-RNG draw sequence (all
        draws happen in :meth:`post`) are bit-identical to the scan."""
        while self._queue and self._queue[0][0] <= t_end:
            self._due.append(heapq.heappop(self._queue))
        return list(self._due)

    def run_until(self, t_end: float, tick: float = 0.02) -> None:
        """Advance virtual time, delivering messages and ticking Update."""
        while self.now < t_end:
            self.now = round(self.now + tick, 9)
            while self._due and self._due[0][0] <= self.now:
                _, _, dst, data, tp = self._due.popleft()
                if self._down(dst):
                    self.dropped_msgs += 1
                    continue
                self._deliver(dst, data, tp)
            while self._queue and self._queue[0][0] <= self.now:
                _, _, dst, data, tp = heapq.heappop(self._queue)
                if self._down(dst):
                    self.dropped_msgs += 1
                    continue
                self._deliver(dst, data, tp)
            for i, node in enumerate(self.nodes):
                if not self._down(i):
                    node.update(self.now)

    def heights(self) -> list[int]:
        return [n.latest_height for n in self.nodes]


class IPCPeer:
    """PeerInterface implementation delivering through a VirtualNetwork."""

    def __init__(self, net: VirtualNetwork, src: int, dst: int):
        self.net = net
        self.src = src
        self.dst = dst

    def remote_addr(self) -> str:
        return f"ipc://{self.dst}"

    def identity(self) -> Optional[bytes]:
        return self.net.nodes[self.dst].identity

    def send(self, data: bytes) -> None:
        self.net.post(self.src, self.dst, data)
