"""Cross-tenant batch coalescing — the reason the sidecar exists.

The port's copy of ``bdls_tpu/sidecar/coalescer.py``: the same
admission, routing, flush and demux rules, instruments and spans, over
the port's provider (:class:`~bdls_tpu_torch.crypto.torch_provider.TorchCSP`
on the card).

One orderer's vote batch is 2t+1 lanes; one committer's endorsement
batch a few hundred. Individually they land in the small buckets where
the measured ~110 ms dispatch floor dominates. The coalescer merges
the batches of *every connected node process* arriving inside one
flush window into a single dispatcher submission, so the device sees
the big (curve, bucket) groups where the fold/mxu/pinned kernels
already win — and then demuxes the verdict bitmap back to each
tenant's request. Mechanics:

- **submit** appends a whole client batch (already ingress-screened
  into byte-backed :class:`~bdls_tpu_torch.crypto.csp.WireVerifyRequest`
  lanes — zero re-copy wire→limbs from here on) under one lock;
  invalid lanes resolve False immediately;
- **flush** (deadline-or-size, same discipline as the TpuCSP
  accumulator beneath) drains everything pending into ONE
  ``csp.verify_batch`` call on a small worker pool, so flush N+1 is
  coalescing while flush N is still on the device — the sidecar-level
  pipeline above the dispatcher-level one;
- **demux**: each batch's verdict slice becomes its response bitmap;
  per-request spans (parented by the client's traceparent, so traces
  stitch across the socket) close at reply time;
- **quotas**: per-tenant in-flight lane caps — one greedy tenant
  cannot wedge every channel sharing the daemon (rejections are
  reported to the client, which degrades to local verify);
- **deadlines**: ``deadline_ms`` is enforced server-side at flush
  time — an already-expired batch gets an explicit deadline verdict
  (``verifyd_deadline_expirations_total{tenant}``) instead of riding
  a stale flush the client stopped waiting for;
- **accounting**: per-tenant counters/gauges/queue-wait histograms and
  the coalesced-bucket composition ring (``stats``, the daemon's stats
  frame);
- **two-lane routing**: quorum-shaped batches (<=
  ``vote_lane_max`` valid lanes, or tagged via the wire frame's
  ``lane_hint``) ride a separate VOTE lane flushed into its own
  dispatcher call — they reach the dispatcher's latency tier instead of
  being merged under a firehose bucket — and a lane-hinted vote lane
  flushes SPECULATIVELY the moment its pending lanes reach the hinted
  quorum size, not at the window deadline. Firehose batches keep the
  deadline-or-size throughput discipline. One daemon serves both
  regimes.
"""

from __future__ import annotations

import json
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Optional, Sequence

from bdls_tpu_torch.crypto.csp import DEFAULT_VOTE_CLASS_MAX_LANES
from bdls_tpu_torch.utils import tracing
from bdls_tpu_torch.utils.metrics import MetricOpts, MetricsProvider

DEFAULT_FLUSH_INTERVAL = 0.002
DEFAULT_TENANT_QUOTA = 65536
# batches at/below this many valid lanes (or carrying a lane_hint)
# route to the vote lane — the shared vote-class bound, so this default
# cannot drift from the dispatcher's latency-tier bound
DEFAULT_VOTE_LANE_MAX = DEFAULT_VOTE_CLASS_MAX_LANES
_LANE_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 2048,
                 4096, 8192, 16384)
_TENANT_BUCKETS = (1.0, 2.0, 3.0, 4.0, 6.0, 8.0, 12.0, 16.0, 24.0, 32.0)


class QuotaExceeded(Exception):
    """Tenant is over its in-flight lane budget."""


class Shed(Exception):
    """Firehose batch refused by overload backpressure.

    Carries the watermark ``reason`` and a deterministic
    ``retry_after_ms`` hint for the client's brownout controller;
    vote-lane batches are never shed.
    """

    def __init__(self, reason: str, retry_after_ms: float, msg: str):
        super().__init__(msg)
        self.reason = reason
        self.retry_after_ms = retry_after_ms


class ClientBatch:
    """One client VerifyBatchRequest in flight through the coalescer."""

    __slots__ = ("tenant", "seq", "reqs", "n", "verdicts", "deadline_ms",
                 "lane_hint", "reply", "t_enqueue", "span", "done",
                 "error")

    def __init__(self, tenant: str, seq: int, reqs: Sequence,
                 reply: Callable[["ClientBatch"], None],
                 traceparent: str = "", deadline_ms: float = 0.0,
                 lane_hint: int = 0,
                 tracer: Optional[tracing.Tracer] = None):
        self.tenant = tenant
        self.seq = seq
        self.reqs = list(reqs)  # WireVerifyRequest | None (invalid lane)
        self.n = len(self.reqs)
        self.verdicts = bytearray((self.n + 7) // 8)
        self.deadline_ms = deadline_ms
        # quorum-size tag from the wire frame: >0 pins the batch to the
        # vote lane and arms its speculative (occupancy) flush
        self.lane_hint = max(0, int(lane_hint or 0))
        self.reply = reply
        self.t_enqueue = time.perf_counter()
        self.done = False
        self.error = ""  # set on deadline expiry; rides the verdict frame
        tracer = tracer or tracing.GLOBAL
        # parented by the CLIENT's span context: the daemon's spans join
        # the node's trace, so /debug/traces on either side shows the
        # stitched round
        self.span = tracer.start_span(
            "verifyd.request",
            parent=tracing.SpanContext.from_traceparent(traceparent),
            attrs={"tenant": tenant, "n": self.n, "seq": seq})

    def set_verdict(self, lane: int, ok: bool) -> None:
        if ok:
            self.verdicts[lane >> 3] |= 1 << (lane & 7)

    def lane_verdicts(self) -> list[bool]:
        return [bool(self.verdicts[i >> 3] >> (i & 7) & 1)
                for i in range(self.n)]


class BlockBatch:
    """One whole-block verify request in flight through the
    coalescer's block lane. Unlike :class:`ClientBatch` lanes, a block
    is an indivisible unit of work — it is never merged with other
    tenants' lanes; the lane exists so blocks share the flusher
    pipeline, the watermark/shed plane, and the per-tenant quotas."""

    __slots__ = ("tenant", "seq", "req", "nlanes", "flags", "deadline_ms",
                 "reply", "t_enqueue", "span", "done", "error")

    def __init__(self, tenant: str, seq: int, req,
                 reply: Callable[["BlockBatch"], None],
                 traceparent: str = "", deadline_ms: float = 0.0,
                 tracer: Optional[tracing.Tracer] = None):
        self.tenant = tenant
        self.seq = seq
        self.req = req  # blocklane.BlockVerifyRequest
        self.nlanes = len(req.lanes)
        self.flags = None  # per-tx int32 verdicts, set at flush
        self.deadline_ms = deadline_ms
        self.reply = reply
        self.t_enqueue = time.perf_counter()
        self.done = False
        self.error = ""
        tracer = tracer or tracing.GLOBAL
        self.span = tracer.start_span(
            "verifyd.block_request",
            parent=tracing.SpanContext.from_traceparent(traceparent),
            attrs={"tenant": tenant, "lanes": self.nlanes,
                   "txs": req.ntx, "seq": seq})


class Coalescer:
    """Merges concurrent tenants' batches into shared dispatcher flushes.

    ``csp`` is any batch-capable provider — production uses a
    :class:`~bdls_tpu_torch.crypto.torch_provider.TorchCSP` whose own accumulator
    then groups the joint batch per (curve, bucket, pinned) beneath
    this layer.
    """

    def __init__(
        self,
        csp,
        flush_interval: float = DEFAULT_FLUSH_INTERVAL,
        tenant_quota: int = DEFAULT_TENANT_QUOTA,
        flush_lanes: Optional[int] = None,
        vote_lane_max: int = DEFAULT_VOTE_LANE_MAX,
        workers: int = 4,
        watermarks: Optional[Sequence[int]] = None,
        tenant_watermark: int = 0,
        metrics: Optional[MetricsProvider] = None,
        tracer: Optional[tracing.Tracer] = None,
    ):
        self.csp = csp
        self.flush_interval = flush_interval
        self.tenant_quota = max(1, int(tenant_quota))
        # size trigger: flush as soon as a full top bucket is pending
        self.flush_lanes = flush_lanes or max(
            getattr(csp, "buckets", (8192,)))
        self.vote_lane_max = max(0, int(vote_lane_max))
        # overload watermarks: (low, high, hard) bounds on the
        # FIREHOSE lane's pending-lane depth. Crossing high enters
        # shedding (hysteresis: exits at <= low); hard sheds a batch that
        # would overflow it regardless of hysteresis state. None = the
        # pre-overload-plane unbounded behavior. Vote-lane batches are
        # exempt by construction — they route before the check.
        if watermarks is not None:
            low, high, hard = (int(v) for v in watermarks)
            if not 0 <= low <= high <= hard:
                raise ValueError(
                    f"watermarks must satisfy 0 <= low <= high <= hard, "
                    f"got {watermarks!r}")
            self.watermarks: Optional[tuple[int, int, int]] = (
                low, high, hard)
        else:
            self.watermarks = None
        # per-tenant pending-lane shed mark (0 = disabled): bounds one
        # greedy tenant's share of the firehose queue *before* the hard
        # QuotaExceeded budget is reached
        self.tenant_watermark = max(0, int(tenant_watermark))
        self._shedding = False
        self.metrics = metrics or MetricsProvider()
        self.tracer = tracer or tracing.GLOBAL
        self._lock = threading.Lock()
        self._pending: list[ClientBatch] = []
        self._pending_lanes = 0
        # the vote lane: quorum-shaped batches flush into
        # their own dispatcher call so they hit the latency tier;
        # _vote_hint is the largest lane_hint among pending vote batches
        # and arms the speculative (occupancy) flush
        self._pending_vote: list[ClientBatch] = []
        self._pending_vote_lanes = 0
        self._vote_hint = 0
        self._spec = False   # vote lane hit quorum occupancy
        self._full = False   # firehose lane hit the size trigger
        # the block lane: whole-block fused verify requests.
        # Its own depth + hysteresis flag (same watermark numbers) so
        # block traffic sheds independently of the firehose lane — the
        # firehose's deterministic shed sequence under an endorsement
        # storm is not perturbed by blocks and vice versa.
        self._pending_block: list[BlockBatch] = []
        self._pending_block_lanes = 0
        self._block_shedding = False
        self._inflight_by_tenant: dict[str, int] = {}
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._flusher: Optional[threading.Thread] = None
        self._pool = ThreadPoolExecutor(
            max_workers=workers, thread_name_prefix="verifyd-flush")
        # coalesced-bucket composition ring (bench / stats surface)
        self.bucket_ring: deque = deque(maxlen=256)
        self.counts = {
            "requests": 0, "lanes": 0, "invalid_lanes": 0,
            "quota_rejections": 0, "flushes": 0, "coalesced_buckets": 0,
            "multi_tenant_buckets": 0, "verify_errors": 0,
            "deadline_expirations": 0, "vote_lane_batches": 0,
            "vote_lane_flushes": 0, "quorum_flushes": 0,
            "shed_batches": 0, "shed_lanes": 0,
            "block_batches": 0, "block_lanes": 0, "block_flushes": 0,
            "block_shed_batches": 0, "block_verify_errors": 0,
        }

        self._c_requests = self.metrics.new_counter(MetricOpts(
            namespace="verifyd", name="requests_total",
            label_names=("tenant",),
            help="Client verify batches accepted, per tenant."))
        self._c_lanes = self.metrics.new_counter(MetricOpts(
            namespace="verifyd", name="lanes_total",
            label_names=("tenant",),
            help="Verify lanes accepted, per tenant."))
        self._c_invalid = self.metrics.new_counter(MetricOpts(
            namespace="verifyd", name="invalid_lanes_total",
            label_names=("tenant",),
            help="Lanes rejected by the wire screen (oversized fields)."))
        self._c_quota = self.metrics.new_counter(MetricOpts(
            namespace="verifyd", name="quota_rejections_total",
            label_names=("tenant",),
            help="Batches rejected by the per-tenant in-flight quota."))
        self._c_deadline = self.metrics.new_counter(MetricOpts(
            namespace="verifyd", name="deadline_expirations_total",
            label_names=("tenant",),
            help="Batches whose client deadline expired before their "
                 "flush (answered with an explicit deadline verdict)."))
        self._g_inflight = self.metrics.new_gauge(MetricOpts(
            namespace="verifyd", name="inflight_lanes",
            label_names=("tenant",),
            help="Lanes currently between submit and reply, per tenant."))
        self._h_queue_wait = self.metrics.new_histogram(MetricOpts(
            namespace="verifyd", name="queue_wait_seconds",
            label_names=("tenant",),
            help="Time a client batch waited in the coalescer before "
                 "its flush."))
        self._h_bucket_lanes = self.metrics.new_histogram(MetricOpts(
            namespace="verifyd", subsystem="coalesce", name="bucket_lanes",
            buckets=tuple(float(b) for b in _LANE_BUCKETS),
            help="Lanes per coalesced (flush, curve) dispatcher bucket."))
        self._h_bucket_tenants = self.metrics.new_histogram(MetricOpts(
            namespace="verifyd", subsystem="coalesce", name="bucket_tenants",
            buckets=_TENANT_BUCKETS,
            help="Distinct tenants sharing one coalesced bucket."))
        self._c_shed = self.metrics.new_counter(MetricOpts(
            namespace="verifyd", name="shed_total",
            label_names=("tenant", "reason"),
            help="Firehose batches shed by the overload watermarks "
                 "(high_watermark | hard_watermark | tenant_watermark); "
                 "vote-lane batches are never shed."))
        self._g_depth = self.metrics.new_gauge(MetricOpts(
            namespace="verifyd", name="queue_depth_lanes",
            label_names=("lane",),
            help="Pending (unflushed) lanes per coalescer lane "
                 "(vote | firehose | block)."))

    # ---- ingress ---------------------------------------------------------
    def submit(self, batch: ClientBatch) -> None:
        """Accept one client batch (raises :class:`QuotaExceeded` over
        the tenant's in-flight budget). Invalid lanes (``None`` in
        ``batch.reqs``) are already False in the verdict bitmap; a batch
        with no valid lane replies immediately."""
        valid = sum(1 for r in batch.reqs if r is not None)
        invalid = batch.n - valid
        with self._lock:
            inflight = self._inflight_by_tenant.get(batch.tenant, 0)
            if inflight + valid > self.tenant_quota:
                self.counts["quota_rejections"] += 1
                self._c_quota.add(1, (batch.tenant,))
                raise QuotaExceeded(
                    f"tenant {batch.tenant!r} over quota "
                    f"({inflight} in flight + {valid} > "
                    f"{self.tenant_quota})")
            is_vote = valid and (batch.lane_hint > 0
                                 or valid <= self.vote_lane_max)
            if valid and not is_vote:
                reason = self._shed_reason(valid, inflight)
                if reason:
                    self.counts["shed_batches"] += 1
                    self.counts["shed_lanes"] += valid
                    self._c_shed.add(1, (batch.tenant, reason))
                    depth = self._pending_lanes
                    retry = self.flush_interval * 1000.0 * (
                        1.0 + depth / max(1, self.flush_lanes))
                    raise Shed(
                        reason, retry,
                        f"shed ({reason}): {depth} firehose lanes "
                        f"pending, retry after {retry:.1f}ms")
            self.counts["requests"] += 1
            self.counts["lanes"] += valid
            self.counts["invalid_lanes"] += invalid
            self._inflight_by_tenant[batch.tenant] = inflight + valid
            full = False
            if valid:
                # two-lane router: quorum-shaped (or lane-hinted)
                # batches ride the vote lane toward the dispatcher's
                # latency tier; firehose batches keep the throughput
                # lane's deadline-or-size discipline
                if is_vote:
                    self.counts["vote_lane_batches"] += 1
                    self._pending_vote.append(batch)
                    self._pending_vote_lanes += valid
                    if batch.lane_hint:
                        self._vote_hint = max(self._vote_hint,
                                              batch.lane_hint)
                    if (self._vote_hint and self._pending_vote_lanes
                            >= self._vote_hint):
                        # quorum occupancy: flush now, not at deadline
                        self._spec = True
                else:
                    self._pending.append(batch)
                    self._pending_lanes += valid
                    full = self._pending_lanes >= self.flush_lanes
            depth_fire = self._pending_lanes
            depth_vote = self._pending_vote_lanes
        self._g_depth.set(depth_fire, ("firehose",))
        self._g_depth.set(depth_vote, ("vote",))
        self._c_requests.add(1, (batch.tenant,))
        if valid:
            self._c_lanes.add(valid, (batch.tenant,))
        if invalid:
            self._c_invalid.add(invalid, (batch.tenant,))
        self._g_inflight.set(
            self._inflight_by_tenant.get(batch.tenant, 0), (batch.tenant,))
        if not valid:
            self._finish(batch)
            return
        self._ensure_flusher()
        # wake on every enqueue: the flusher re-anchors its
        # sleep at the oldest pending batch's deadline — or flushes
        # immediately on a size/occupancy trigger — instead of polling
        if full:
            with self._lock:
                self._full = True
        self._wake.set()

    def submit_block(self, batch: BlockBatch) -> None:
        """Accept one whole-block verify request onto the block lane
        Same admission plane as the firehose: per-tenant
        in-flight quota (:class:`QuotaExceeded`), tenant watermark, and
        the block lane's OWN depth watermarks (:class:`Shed`) — votes
        keep absolute priority and block sheds never perturb the
        firehose's deterministic shed sequence."""
        valid = batch.nlanes
        with self._lock:
            inflight = self._inflight_by_tenant.get(batch.tenant, 0)
            if inflight + valid > self.tenant_quota:
                self.counts["quota_rejections"] += 1
                self._c_quota.add(1, (batch.tenant,))
                raise QuotaExceeded(
                    f"tenant {batch.tenant!r} over quota "
                    f"({inflight} in flight + {valid} > "
                    f"{self.tenant_quota})")
            reason = self._shed_reason(valid, inflight, lane="block")
            if reason:
                self.counts["block_shed_batches"] += 1
                self.counts["shed_lanes"] += valid
                self._c_shed.add(1, (batch.tenant, reason))
                depth = self._pending_block_lanes
                retry = self.flush_interval * 1000.0 * (
                    1.0 + depth / max(1, self.flush_lanes))
                raise Shed(
                    reason, retry,
                    f"shed ({reason}): {depth} block lanes pending, "
                    f"retry after {retry:.1f}ms")
            self.counts["block_batches"] += 1
            self.counts["block_lanes"] += valid
            self._inflight_by_tenant[batch.tenant] = inflight + valid
            self._pending_block.append(batch)
            self._pending_block_lanes += valid
            depth_block = self._pending_block_lanes
        self._g_depth.set(depth_block, ("block",))
        self._c_requests.add(1, (batch.tenant,))
        if valid:
            self._c_lanes.add(valid, (batch.tenant,))
        self._g_inflight.set(
            self._inflight_by_tenant.get(batch.tenant, 0), (batch.tenant,))
        self._ensure_flusher()
        self._wake.set()

    def _shed_reason(self, valid: int, tenant_inflight: int,
                     lane: str = "firehose") -> str:
        """Overload verdict for one firehose or block-lane batch (caller
        holds ``_lock``). Empty string = admit. Hysteresis: crossing the
        high watermark enters shedding until the depth falls to <= low
        (a flush drains to 0, which always clears it); the hard
        watermark refuses any batch that would overflow it regardless of
        state; the tenant watermark bounds one tenant's pending share.
        The two lanes share the watermark NUMBERS but keep separate
        depth counters and hysteresis flags, so their shed sequences
        stay independently deterministic."""
        if (self.tenant_watermark
                and tenant_inflight + valid > self.tenant_watermark):
            return "tenant_watermark"
        if self.watermarks is None:
            return ""
        low, high, hard = self.watermarks
        if lane == "block":
            depth = self._pending_block_lanes
            shedding = self._block_shedding
        else:
            depth = self._pending_lanes
            shedding = self._shedding
        if depth + valid > hard:
            return "hard_watermark"
        if shedding and depth <= low:
            shedding = False
        if not shedding and depth > high:
            shedding = True
        if lane == "block":
            self._block_shedding = shedding
        else:
            self._shedding = shedding
        return "high_watermark" if shedding else ""

    # ---- flush machinery -------------------------------------------------
    def _ensure_flusher(self) -> None:
        with self._lock:
            if self._flusher is not None and self._flusher.is_alive():
                return
            self._flusher = threading.Thread(
                target=self._run, daemon=True, name="verifyd-coalesce")
            self._flusher.start()

    def _run(self) -> None:
        # condition-variable flusher: wakes on enqueue,
        # re-anchors its sleep at the oldest pending batch's window
        # deadline, and fires immediately on a quorum-occupancy or
        # size trigger — an idle daemon parks instead of polling, and
        # no batch waits a full interval past its own deadline
        while not self._stop.is_set():
            with self._lock:
                heads = [lane[0].t_enqueue
                         for lane in (self._pending, self._pending_vote,
                                      self._pending_block)
                         if lane]
                oldest = min(heads) if heads else None
                urgent = self._spec or self._full
            if oldest is None:
                self._wake.wait(self.flush_interval)
                self._wake.clear()
                continue
            remaining = self.flush_interval - (time.perf_counter() - oldest)
            if urgent or remaining <= 0:
                self.flush()
                continue
            self._wake.wait(remaining)
            self._wake.clear()

    def flush(self) -> None:
        """Drain both lanes into joint dispatcher calls on the worker
        pool (never blocks the flusher on device results). The vote lane
        flushes SEPARATELY from the firehose lane, so quorum batches are
        never merged under a firehose bucket."""
        with self._lock:
            batches, self._pending = self._pending, []
            votes, self._pending_vote = self._pending_vote, []
            blocks, self._pending_block = self._pending_block, []
            self._pending_lanes = 0
            self._pending_vote_lanes = 0
            self._pending_block_lanes = 0
            self._vote_hint = 0
            spec, self._spec = self._spec, False
            self._full = False
            if votes:
                self.counts["vote_lane_flushes"] += 1
                if spec:
                    self.counts["quorum_flushes"] += 1
        self._g_depth.set(0, ("firehose",))
        self._g_depth.set(0, ("vote",))
        self._g_depth.set(0, ("block",))
        if votes:
            self._pool.submit(self._flush_job, votes, "latency")
        if batches:
            self._pool.submit(self._flush_job, batches, "throughput")
        if blocks:
            self._pool.submit(self._flush_block_job, blocks)

    def _flush_job(self, batches: list[ClientBatch],
                   tier: str = "throughput") -> None:
        now = time.perf_counter()
        # server-side deadline enforcement: a batch whose client deadline
        # has already lapsed gets an explicit deadline verdict instead of
        # riding a stale flush — the client has long since fallen back to
        # local sw, so answering it with device work is pure waste and a
        # seq the client no longer listens for
        live: list[ClientBatch] = []
        for b in batches:
            waited_ms = (now - b.t_enqueue) * 1000.0
            if b.deadline_ms > 0.0 and waited_ms > b.deadline_ms:
                b.error = (f"deadline expired: waited {waited_ms:.1f}ms "
                           f"> {b.deadline_ms:.1f}ms")
                with self._lock:
                    self.counts["deadline_expirations"] += 1
                self._c_deadline.add(1, (b.tenant,))
                self._finish(b)
                continue
            live.append(b)
        batches = live
        if not batches:
            return
        # joint request list + (batch, lane) back-references for demux
        joint: list = []
        backrefs: list[tuple[ClientBatch, int]] = []
        by_curve: dict[str, dict[str, int]] = {}
        for b in batches:
            self._h_queue_wait.observe(now - b.t_enqueue, (b.tenant,))
            qw = self.tracer.start_span(
                "verifyd.queue_wait", parent=b.span,
                attrs={"tenant": b.tenant})
            qw.end(duration=now - b.t_enqueue)
            for lane, req in enumerate(b.reqs):
                if req is None:
                    continue
                joint.append(req)
                backrefs.append((b, lane))
                per = by_curve.setdefault(req.curve, {})
                per[b.tenant] = per.get(b.tenant, 0) + 1

        # coalesced-bucket accounting: one dispatcher bucket per
        # (flush, curve) group — the merge the whole subsystem is for
        for curve, tenants in by_curve.items():
            lanes = sum(tenants.values())
            multi = len(tenants) >= 2
            with self._lock:
                self.counts["coalesced_buckets"] += 1
                if multi:
                    self.counts["multi_tenant_buckets"] += 1
                self.bucket_ring.append({
                    "curve": curve, "lanes": lanes,
                    "tenants": dict(tenants), "multi": multi,
                    "tier": tier,
                })
            self._h_bucket_lanes.observe(float(lanes))
            self._h_bucket_tenants.observe(float(len(tenants)))

        # the flush is a root trace of its own (one device launch serves
        # many client rounds); "links" names the client trace ids it
        # served, OpenTelemetry-span-link style, so the fleet view can
        # hop from a round to the flush that carried it
        links = sorted({b.span.trace_id for b in batches})
        fspan = self.tracer.start_span("verifyd.flush", attrs={
            "batches": len(batches), "lanes": len(joint),
            "tenants": len({b.tenant for b in batches}),
            "tier": tier, "links": links[:8]})
        try:
            with self.tracer.use(fspan):
                oks = self.csp.verify_batch(joint)
        except Exception as exc:  # noqa: BLE001 — lanes fail closed
            with self._lock:
                self.counts["verify_errors"] += 1
            fspan.end(error=repr(exc)[:200])
            oks = [False] * len(joint)
        else:
            fspan.end()
        with self._lock:
            self.counts["flushes"] += 1
        for (b, lane), ok in zip(backrefs, oks):
            b.set_verdict(lane, bool(ok))
        for b in batches:
            self._finish(b)

    def _flush_block_job(self, blocks: list[BlockBatch]) -> None:
        """Serve a drained block-lane slice: one ``csp.verify_block``
        call per block (a block is indivisible — there is nothing to
        coalesce across tenants), same deadline discipline as the lane
        flushes. A verify failure answers with an error (flags stay
        ``None``) so the client degrades to its local host path."""
        now = time.perf_counter()
        for b in blocks:
            waited_ms = (now - b.t_enqueue) * 1000.0
            if b.deadline_ms > 0.0 and waited_ms > b.deadline_ms:
                b.error = (f"deadline expired: waited {waited_ms:.1f}ms "
                           f"> {b.deadline_ms:.1f}ms")
                with self._lock:
                    self.counts["deadline_expirations"] += 1
                self._c_deadline.add(1, (b.tenant,))
                self._finish_block(b)
                continue
            self._h_queue_wait.observe(now - b.t_enqueue, (b.tenant,))
            fspan = self.tracer.start_span("verifyd.block_flush", attrs={
                "tenant": b.tenant, "lanes": b.nlanes, "txs": b.req.ntx,
                "links": [b.span.trace_id]})
            try:
                with self.tracer.use(fspan):
                    b.flags = self.csp.verify_block(b.req)
            except Exception as exc:  # noqa: BLE001 — client falls back
                with self._lock:
                    self.counts["block_verify_errors"] += 1
                b.error = f"verify_block failed: {repr(exc)[:200]}"
                fspan.end(error=repr(exc)[:200])
            else:
                fspan.end()
            with self._lock:
                self.counts["block_flushes"] += 1
            self._finish_block(b)

    def _finish_block(self, batch: BlockBatch) -> None:
        if batch.done:
            return
        batch.done = True
        with self._lock:
            left = (self._inflight_by_tenant.get(batch.tenant, 0)
                    - batch.nlanes)
            self._inflight_by_tenant[batch.tenant] = max(0, left)
        self._g_inflight.set(
            self._inflight_by_tenant.get(batch.tenant, 0), (batch.tenant,))
        batch.span.end(error=batch.error or None)
        try:
            batch.reply(batch)
        except Exception:  # noqa: BLE001 — a dead client must not wedge
            pass           # the flush worker

    def _finish(self, batch: ClientBatch) -> None:
        if batch.done:
            return
        batch.done = True
        valid = sum(1 for r in batch.reqs if r is not None)
        with self._lock:
            left = self._inflight_by_tenant.get(batch.tenant, 0) - valid
            self._inflight_by_tenant[batch.tenant] = max(0, left)
        self._g_inflight.set(
            self._inflight_by_tenant.get(batch.tenant, 0), (batch.tenant,))
        batch.span.end(error=batch.error or None)
        try:
            batch.reply(batch)
        except Exception:  # noqa: BLE001 — a dead client must not wedge
            pass           # the flush worker

    # ---- introspection ---------------------------------------------------
    @property
    def stats(self) -> dict:
        with self._lock:
            out = dict(self.counts)
            out["inflight_by_tenant"] = {
                t: n for t, n in self._inflight_by_tenant.items() if n}
            out["tenant_quota"] = self.tenant_quota
            out["vote_lane_max"] = self.vote_lane_max
            out["watermarks"] = (list(self.watermarks)
                                 if self.watermarks else None)
            out["tenant_watermark"] = self.tenant_watermark
            out["shedding"] = self._shedding
            out["block_shedding"] = self._block_shedding
            out["recent_buckets"] = list(self.bucket_ring)[-32:]
        return out

    def stats_json(self) -> str:
        blob = {"coalescer": self.stats}
        csp_stats = getattr(self.csp, "stats", None)
        if isinstance(csp_stats, dict):
            blob["dispatcher"] = csp_stats
        return json.dumps(blob)

    def close(self) -> None:
        self._stop.set()
        self._wake.set()
        flusher = self._flusher
        if flusher is not None and flusher.is_alive():
            flusher.join(timeout=2.0)
        self.flush()
        self._pool.shutdown(wait=True)
