"""Process-local span tracing with W3C ``traceparent`` propagation.

The port's own copy of ``bdls_tpu/utils/tracing.py`` (stdlib only), kept
unchanged so span names and trace export match the JAX package.

The measurement substrate for the consensus → batch-verify → TPU
pipeline: a round's latency budget is invisible in aggregate
metrics — what matters is *where inside one round* the time went
(queue wait vs padding vs kernel launch vs host fold), which only a
per-round span tree can show. Design points:

- **Spans** carry (trace_id, span_id, parent_id, name, start, duration,
  attrs, error). A trace is the set of spans sharing a trace_id.
- **Context** crosses process boundaries as a W3C-style ``traceparent``
  string (``00-<32 hex trace>-<16 hex span>-01``), carried by the
  existing wire paths: ipc frames (:mod:`bdls_tpu.consensus.ipc`),
  cluster step frames (:mod:`bdls_tpu.comm.cluster`), and in-process
  gossip calls (plain contextvar flow).
- **In-process context** uses a :mod:`contextvars` variable, so spans
  opened via :meth:`Tracer.span` nest automatically through synchronous
  call chains (engine → verifier → TpuCSP kernel stages) without
  threading span objects through every signature.
- **Export** is two-way: every completed span's duration feeds a
  ``trace_span_duration_seconds{name=...}`` histogram on a bound
  :class:`~bdls_tpu.utils.metrics.MetricsProvider` (rendered by the
  operations server's ``/metrics``), and completed traces land in a
  ring buffer served as JSON by ``/debug/traces``
  (:mod:`bdls_tpu.utils.operations`).

A trace is *finalized* (moved into the ring buffer) when its count of
open spans drops to zero; spans arriving for an already-finalized
trace_id are merged back into the same ring entry at the next
quiescence, so cross-node traces assembled out of order still render
as one trace.

For cross-process stitching (:mod:`bdls_tpu.obs`) every tracer records
a **wall-clock anchor** at construction — ``anchor_unix_ns`` (epoch
nanoseconds) paired with ``anchor_mono_ns`` (the monotonic clock at the
same instant) — and every exported span record carries ``mono_ns``, its
monotonic offset from that anchor. Within one process the monotonic
offsets are mutually consistent even if the wall clock steps under NTP;
across processes the collector aligns timelines by comparing anchors
and correcting residual skew from parent/child edges. The ring size
defaults to 64 and is configurable via the ``BDLS_TRACE_RING``
environment variable (soak runs need deeper rings so parents of
still-open traces aren't evicted mid-flight).

**Tail-based sampling**: the ring no longer evicts purely
newest-wins. Each finalized trace is classified — ``error`` (any span
ended with an error), ``shed`` (any span tagged ``outcome=shed`` /
``cause=shed``), ``fallback`` (a fallback span or ``outcome=fallback``),
``slowest`` (top-k slowest for its root span name, ``BDLS_TRACE_TOPK``),
else ``sampled`` — and overflow evicts the oldest *least interesting*
entry first, so under a shed storm every error/shed trace survives
while the ring stays hard-bounded. Plain traces are additionally
admitted with probability ``BDLS_TRACE_SAMPLE`` (default 1.0,
hash-of-trace-id so the decision is deterministic). Every eviction is
counted in :attr:`Tracer.evictions` and, when metrics are bound, on
the ``trace_ring_evictions_total{policy=...}`` counter; each ring
entry carries the ``policy`` that kept it.
"""

from __future__ import annotations

import contextlib
import contextvars
import os
import threading
import time
from collections import OrderedDict
from typing import Iterator, Optional, Sequence, Union

from bdls_tpu_torch.utils.metrics import Histogram, MetricOpts, MetricsProvider


def _percentile(sorted_values: list, q: float) -> float:
    """Linear-interpolated percentile over an already-sorted list (the
    numpy 'linear' method, dependency-free)."""
    if not sorted_values:
        return 0.0
    if len(sorted_values) == 1:
        return sorted_values[0]
    pos = (len(sorted_values) - 1) * min(max(q, 0.0), 1.0)
    lo = int(pos)
    hi = min(lo + 1, len(sorted_values) - 1)
    frac = pos - lo
    return sorted_values[lo] * (1 - frac) + sorted_values[hi] * frac


_TP_VERSION = "00"
_TP_FLAGS_SAMPLED = "01"

# sentinel: "parent not given — use the context-local current span"
_CURRENT = object()

_DEFAULT_RING = 64


def _ring_size_from_env() -> int:
    """Completed-trace ring depth: ``BDLS_TRACE_RING`` or 64."""
    raw = os.environ.get("BDLS_TRACE_RING", "")
    try:
        n = int(raw)
    except ValueError:
        return _DEFAULT_RING
    return n if n > 0 else _DEFAULT_RING


_DEFAULT_TOPK = 4


def _topk_from_env() -> int:
    """Slow-trace protection depth per root span name:
    ``BDLS_TRACE_TOPK`` or 4."""
    try:
        n = int(os.environ.get("BDLS_TRACE_TOPK", _DEFAULT_TOPK))
    except ValueError:
        return _DEFAULT_TOPK
    return n if n >= 0 else _DEFAULT_TOPK


def _sample_rate_from_env() -> float:
    """Admission probability for plain (untagged, not-slow) traces:
    ``BDLS_TRACE_SAMPLE`` or 1.0."""
    try:
        r = float(os.environ.get("BDLS_TRACE_SAMPLE", 1.0))
    except ValueError:
        return 1.0
    return min(max(r, 0.0), 1.0)


def _sample_hash(trace_id: str) -> float:
    """Deterministic [0, 1) admission draw from the trace id — the same
    trace makes the same sampling decision on every node."""
    try:
        return int(trace_id[:8], 16) / float(0x100000000)
    except ValueError:
        return 0.0


# victim-selection priority: lower ranks evict first. Plain sampled
# traces go before slow-protected ones; tagged traces go last (so under
# a storm the ring bound is honored by shedding boring traces, and an
# error trace is only evicted when the ring holds nothing but tagged
# traces).
_POLICY_RANK = {"sampled": 0, "slowest": 1, "fallback": 2, "shed": 3,
                "error": 4}


def _classify_spans(spans: list) -> Optional[str]:
    """Static tail tag for a finalized trace's span records: ``error`` >
    ``shed`` > ``fallback``; None for a plain trace."""
    tag = None
    for r in spans:
        if r.get("error"):
            return "error"
        a = r.get("attrs") or {}
        if a.get("outcome") == "shed" or a.get("cause") == "shed":
            tag = "shed"
        elif tag is None and (a.get("outcome") == "fallback"
                              or "fallback" in (r.get("name") or "")):
            tag = "fallback"
    return tag


def _hex_ok(s: str, n: int) -> bool:
    if len(s) != n:
        return False
    try:
        int(s, 16)
        return True
    except ValueError:
        return False


class SpanContext:
    """The propagatable identity of a span: (trace_id, span_id)."""

    __slots__ = ("trace_id", "span_id")

    def __init__(self, trace_id: str, span_id: str):
        self.trace_id = trace_id
        self.span_id = span_id

    def traceparent(self) -> str:
        return f"{_TP_VERSION}-{self.trace_id}-{self.span_id}-{_TP_FLAGS_SAMPLED}"

    @classmethod
    def from_traceparent(
        cls, header: Union[str, bytes, None]
    ) -> Optional["SpanContext"]:
        """Parse a ``version-traceid-spanid-flags`` header; None if the
        header is absent or malformed (never raises — wire input)."""
        if not header:
            return None
        if isinstance(header, bytes):
            try:
                header = header.decode("ascii")
            except UnicodeDecodeError:
                return None
        parts = header.split("-")
        if len(parts) != 4:
            return None
        _, trace_id, span_id, _ = parts
        if not _hex_ok(trace_id, 32) or not _hex_ok(span_id, 16):
            return None
        if trace_id == "0" * 32 or span_id == "0" * 16:
            return None
        return cls(trace_id, span_id)


class Span:
    """One timed operation. End with :meth:`end` or use as a context
    manager (``with tracer.span(...)``) to also become the context-local
    current span."""

    __slots__ = (
        "_tracer", "name", "trace_id", "span_id", "parent_id",
        "start_unix", "mono_ns", "_t0", "duration", "attrs", "error",
        "_ended", "_token",
    )

    def __init__(self, tracer: "Tracer", name: str, trace_id: str,
                 parent_id: str, attrs: Optional[dict]):
        self._tracer = tracer
        self.name = name
        self.trace_id = trace_id
        self.span_id = os.urandom(8).hex()
        self.parent_id = parent_id
        self.start_unix = time.time()
        # monotonic offset from the tracer's anchor: the process-consistent
        # start time used by cross-process stitching (wall clocks step;
        # monotonic offsets within one process don't)
        self.mono_ns = time.monotonic_ns() - tracer.anchor_mono_ns
        self._t0 = time.perf_counter()
        self.duration: Optional[float] = None  # seconds, set at end()
        self.attrs = dict(attrs) if attrs else {}
        self.error: Optional[str] = None
        self._ended = False
        self._token = None

    @property
    def context(self) -> SpanContext:
        return SpanContext(self.trace_id, self.span_id)

    def traceparent(self) -> str:
        return self.context.traceparent()

    def set_attr(self, key: str, value) -> None:
        self.attrs[key] = value

    def end(self, error: Optional[str] = None,
            duration: Optional[float] = None) -> None:
        """Close the span. ``duration`` (seconds) overrides the measured
        wall time — used for derived spans like queue-wait, whose extent
        was measured elsewhere."""
        if self._ended:
            return
        self._ended = True
        self.duration = (
            duration if duration is not None
            else time.perf_counter() - self._t0
        )
        if error is not None:
            self.error = error
        self._tracer._on_end(self)

    def record(self) -> dict:
        return {
            "name": self.name,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "start_unix": self.start_unix,
            "mono_ns": self.mono_ns,
            "duration_ms": round((self.duration or 0.0) * 1e3, 3),
            "attrs": self.attrs,
            "error": self.error,
        }

    # ---- context-manager protocol (current-span handling) ---------------
    def __enter__(self) -> "Span":
        self._token = self._tracer._current.set(self)
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if self._token is not None:
            self._tracer._current.reset(self._token)
            self._token = None
        self.end(error=repr(exc) if exc is not None else None)


class _LiveTrace:
    __slots__ = ("spans", "open")

    def __init__(self):
        self.spans: list[dict] = []
        self.open = 0


class Tracer:
    """Process-local tracer: span factory + completed-trace ring buffer
    + optional histogram export."""

    def __init__(self, metrics: Optional[MetricsProvider] = None,
                 max_traces: Optional[int] = None,
                 max_spans_per_trace: int = 2048,
                 sample_rate: Optional[float] = None,
                 slow_topk: Optional[int] = None):
        self._lock = threading.Lock()
        self._live: dict[str, _LiveTrace] = {}
        self._completed: "OrderedDict[str, dict]" = OrderedDict()
        if max_traces is None:
            max_traces = _ring_size_from_env()
        self.max_traces = max_traces
        self.max_spans_per_trace = max_spans_per_trace
        self.sample_rate = (_sample_rate_from_env() if sample_rate is None
                            else min(max(float(sample_rate), 0.0), 1.0))
        self.slow_topk = (_topk_from_env() if slow_topk is None
                          else max(int(slow_topk), 0))
        # evictions by the policy stamp of the trace that was dropped
        # (plus "probabilistic" for sample-rate rejections); mirrored on
        # trace_ring_evictions_total when metrics are bound
        self.evictions: dict[str, int] = {}
        self._c_evictions = None
        # wall-clock anchor: epoch ns and the monotonic clock captured at
        # the same instant. Exported span records carry monotonic offsets
        # from this anchor (see module docstring / bdls_tpu.obs).
        self.anchor_unix_ns = time.time_ns()
        self.anchor_mono_ns = time.monotonic_ns()
        self._current: contextvars.ContextVar[Optional[Span]] = (
            contextvars.ContextVar("bdls_tpu_span", default=None)
        )
        self._hist: Optional[Histogram] = None
        if metrics is not None:
            self.bind_metrics(metrics)

    # ---- metrics export --------------------------------------------------
    def bind_metrics(self, metrics: MetricsProvider) -> None:
        """Register the span-duration histogram on ``metrics`` (the
        operations server calls this so spans render on ``/metrics``)."""
        self._hist = metrics.new_histogram(MetricOpts(
            namespace="trace",
            subsystem="span",
            name="duration_seconds",
            help="Completed span durations by span name.",
            label_names=("name",),
        ))
        self._c_evictions = metrics.new_counter(MetricOpts(
            namespace="trace",
            subsystem="ring",
            name="evictions_total",
            help="Completed traces dropped from the ring, by the "
                 "eviction policy of the dropped trace.",
            label_names=("policy",),
        ))
        with self._lock:
            for policy, n in self.evictions.items():
                self._c_evictions.add(n, (policy,))

    # ---- span creation ---------------------------------------------------
    def start_span(self, name: str, parent=_CURRENT,
                   attrs: Optional[dict] = None) -> Span:
        """Open a span. ``parent`` may be a Span, a SpanContext, a
        traceparent string/bytes, None (force a new root), or omitted
        (adopt the context-local current span)."""
        if parent is _CURRENT:
            parent = self._current.get()
        if isinstance(parent, (str, bytes)):
            parent = SpanContext.from_traceparent(parent)
        if parent is None:
            trace_id, parent_id = os.urandom(16).hex(), ""
        else:
            trace_id, parent_id = parent.trace_id, parent.span_id
        span = Span(self, name, trace_id, parent_id, attrs)
        with self._lock:
            self._live.setdefault(trace_id, _LiveTrace()).open += 1
        return span

    def span(self, name: str, parent=_CURRENT,
             attrs: Optional[dict] = None) -> Span:
        """Like :meth:`start_span`, but intended for ``with`` use: while
        entered, the span is the context-local current span."""
        return self.start_span(name, parent=parent, attrs=attrs)

    @contextlib.contextmanager
    def use(self, span: Optional[Span]) -> Iterator[Optional[Span]]:
        """Make an existing (still-open) span the current context without
        opening a new one — e.g. the engine's round span around a
        timeout-triggered broadcast."""
        if span is None:
            yield None
            return
        token = self._current.set(span)
        try:
            yield span
        finally:
            self._current.reset(token)

    def current(self) -> Optional[Span]:
        return self._current.get()

    def current_traceparent(self) -> Optional[str]:
        cur = self._current.get()
        return cur.traceparent() if cur is not None else None

    # ---- completion ------------------------------------------------------
    def _on_end(self, span: Span) -> None:
        if self._hist is not None:
            # the exemplar links a histogram bucket straight back to the
            # /debug/traces record that produced it (rendered
            # OpenMetrics-style on /metrics, read by trace_report)
            self._hist.observe(span.duration or 0.0, (span.name,),
                               exemplar={"trace_id": span.trace_id})
        with self._lock:
            lt = self._live.get(span.trace_id)
            if lt is None:  # trace evicted under us; drop silently
                return
            if len(lt.spans) < self.max_spans_per_trace:
                lt.spans.append(span.record())
            lt.open -= 1
            if lt.open <= 0:
                del self._live[span.trace_id]
                self._finalize(span.trace_id, lt.spans)

    def _finalize(self, trace_id: str, spans: list[dict]) -> None:
        # lock held
        entry = self._completed.get(trace_id)
        if entry is not None:
            entry["spans"].extend(spans)
            self._completed.move_to_end(trace_id)
        else:
            entry = {"trace_id": trace_id, "spans": spans,
                     "anchor_unix_ns": self.anchor_unix_ns}
            self._completed[trace_id] = entry
        allspans = entry["spans"]
        allspans.sort(key=lambda r: r["start_unix"])
        t0 = min(r["start_unix"] for r in allspans)
        t1 = max(r["start_unix"] + r["duration_ms"] / 1e3 for r in allspans)
        entry["root"] = next(
            (r["name"] for r in allspans if not r["parent_id"]),
            allspans[0]["name"],
        )
        entry["start_unix"] = t0
        entry["duration_ms"] = round((t1 - t0) * 1e3, 3)
        entry["span_count"] = len(allspans)
        entry["tag"] = _classify_spans(allspans)
        self._stamp_policies()
        # probabilistic admission: plain traces (untagged AND not slow-
        # protected) roll a deterministic hash-of-trace-id die
        if (entry["policy"] == "sampled" and self.sample_rate < 1.0
                and _sample_hash(trace_id) >= self.sample_rate):
            del self._completed[trace_id]
            self._count_eviction("probabilistic")
            return
        # tail-based overflow: evict oldest-first within the least
        # interesting policy class, so tagged (error/shed/fallback) and
        # top-k-slowest traces outlive plain ones while the ring bound
        # stays hard
        while len(self._completed) > self.max_traces:
            victim_id, victim_rank = None, None
            for tid, e in self._completed.items():  # oldest first
                rank = _POLICY_RANK.get(e["policy"], 0)
                if victim_rank is None or rank < victim_rank:
                    victim_id, victim_rank = tid, rank
                    if rank == 0:
                        break
            dropped = self._completed.pop(victim_id)
            self._count_eviction(dropped["policy"])
            self._stamp_policies()

    def _stamp_policies(self) -> None:
        # lock held. Tagged traces keep their static tag; untagged ones
        # are "slowest" while in the top-k durations for their root span
        # name, else "sampled". Recomputed after ring mutations so the
        # slow-protection set tracks the current ring contents.
        by_root: dict[str, list[tuple[float, str]]] = {}
        for tid, e in self._completed.items():
            by_root.setdefault(e["root"], []).append(
                (e["duration_ms"], tid))
        slow: set[str] = set()
        for ranked in by_root.values():
            ranked.sort(reverse=True)
            slow.update(tid for _, tid in ranked[:self.slow_topk])
        for tid, e in self._completed.items():
            e["policy"] = e["tag"] if e["tag"] else (
                "slowest" if tid in slow else "sampled")

    def _count_eviction(self, policy: str) -> None:
        # lock held
        self.evictions[policy] = self.evictions.get(policy, 0) + 1
        if self._c_evictions is not None:
            self._c_evictions.add(1, (policy,))

    # ---- read side -------------------------------------------------------
    def completed(self, limit: Optional[int] = None) -> list[dict]:
        """Completed traces, newest-finalized first."""
        with self._lock:
            traces = list(self._completed.values())
        traces.reverse()
        if limit is not None:
            traces = traces[:limit]
        # shallow-copy entries so callers can't corrupt the ring
        return [dict(t, spans=list(t["spans"])) for t in traces]

    def trace(self, trace_id: str) -> Optional[dict]:
        with self._lock:
            entry = self._completed.get(trace_id)
            return dict(entry, spans=list(entry["spans"])) if entry else None

    def aggregate(self, limit: Optional[int] = None,
                  quantiles: Sequence[float] = (0.5, 0.95, 0.99),
                  ) -> dict[str, dict]:
        """Per-span-name totals over the completed ring: the stage-by-
        stage latency table (bench summaries, tools/trace_report.py, and
        the SLO evaluator's span objectives).

        Each entry carries count/total/avg/max plus exact quantiles
        (``p50_ms``/``p95_ms``/``p99_ms`` by default — computed from the
        raw per-span durations in the ring, not bucket-interpolated) and
        ``max_trace_id``, the trace containing the slowest instance of
        that span (the ``/debug/traces`` link for "why was the worst one
        slow")."""
        durations: dict[str, list[float]] = {}
        max_trace: dict[str, tuple[float, str]] = {}
        for t in self.completed(limit):
            for r in t["spans"]:
                durations.setdefault(r["name"], []).append(r["duration_ms"])
                cur = max_trace.get(r["name"])
                if cur is None or r["duration_ms"] > cur[0]:
                    max_trace[r["name"]] = (r["duration_ms"], t["trace_id"])
        out: dict[str, dict] = {}
        for name, ds in durations.items():
            ds.sort()
            agg = {
                "count": len(ds),
                "total_ms": round(sum(ds), 3),
                "max_ms": ds[-1],
                "avg_ms": round(sum(ds) / len(ds), 3),
                "max_trace_id": max_trace[name][1],
            }
            for q in quantiles:
                agg[f"p{int(q * 100)}_ms"] = round(_percentile(ds, q), 3)
            out[name] = agg
        return out

    def reset(self) -> None:
        """Drop all live and completed traces (test hook)."""
        with self._lock:
            self._live.clear()
            self._completed.clear()
            self.evictions.clear()


GLOBAL = Tracer()


def get_tracer() -> Tracer:
    return GLOBAL
