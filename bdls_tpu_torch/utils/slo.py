"""Declarative SLO spec + evaluator: the performance-judgment layer.

Four PRs of instrumentation (span tracing, hot-path metrics, the
pipelined dispatcher, the pinned-key cache) produce *numbers*; this
module produces an *answer*: a structured pass/fail verdict with
per-objective margins, computed from exactly the surfaces the
instrumentation already exports —

- :meth:`bdls_tpu_torch.utils.tracing.Tracer.aggregate` span quantiles
  (p50/p95/p99 over the completed-trace ring), and
- :class:`bdls_tpu_torch.utils.metrics.MetricsProvider` instrument snapshots
  (counter ratios, gauge values, histogram quantile estimates).

The paper's north star is itself an SLO — >=50k P-256 verifies/s at
>=10x CPU with round latency unchanged (BASELINE.md) — and the related
hardware-offload engines (Blockchain Machine arXiv:2104.06968, the FPGA
ECDSA engines arXiv:2112.02229) are quoted entirely through standing
latency/throughput envelopes. ``evaluate()`` is how one chip session,
one soak run, or one CI dryrun turns its histograms into a committed,
machine-checked verdict instead of an eyeballed log.

An :class:`Objective` is one assertion over one measurement source::

    Objective(name="round_latency_p99", source="span",
              target="engine.height", stat="p99", op="<=",
              threshold=0.195, unit="s")

Sources:

``span``
    ``target`` is a span name; ``stat`` picks ``p50``/``p95``/``p99``/
    ``avg``/``max`` from ``Tracer.aggregate()`` (exact quantiles over
    raw durations). Values are converted to seconds.
``histogram``
    ``target`` is a metric fqname; ``stat`` is a quantile estimated from
    the cumulative bucket counts (PromQL ``histogram_quantile``
    semantics, merged across label sets).
``counter_ratio``
    ``target`` is ``"numerator_fq/denominator_fq"``; the value is the
    ratio of the two counters (hit rates, engagement ratios). A zero
    denominator skips the objective.
``gauge``
    ``target`` is a gauge fqname; the value is its current reading
    (max across label sets).
``value``
    ``target`` is a key into the ``values`` dict the caller passes to
    :func:`evaluate` — for measurements the harness computes itself
    (e.g. ``bench_consensus.py`` binds its round-latency delta here;
    inside the virtual-clock harness a wall-time span is NOT round
    latency, the virtual delta is). Absent key = skipped.

``min_count`` observations are required before an objective binds —
below that it reports ``skipped`` (insufficient data), never a fake
pass/fail. ``gate`` names a metric that must be nonzero for the
objective to apply at all (e.g. the pinned-lane ratio only applies when
``tpu_key_cache_keys`` shows the key cache is enabled and populated).

The default spec (:func:`default_spec`) covers the standing objectives
from ROADMAP items 1/5; every threshold has a ``BDLS_SLO_*`` env
override (documented in the reference's docs/OBSERVABILITY.md). ``/debug/slo`` on the
operations server serves the live verdict; ``tools/perf_gate.py``
embeds it next to the regression matrix.

The port's copy of ``bdls_tpu/utils/slo.py``, whole: the same
objectives, names, thresholds and ``BDLS_SLO_*`` variables, read off the
port's instruments, which keep the reference's names.
"""

from __future__ import annotations

import os
from dataclasses import asdict, dataclass
from typing import Optional, Sequence

from bdls_tpu_torch.utils import tracing
from bdls_tpu_torch.utils.metrics import (Counter, Gauge, Histogram,
                                          MetricsProvider)

SOURCES = ("span", "histogram", "counter_ratio", "gauge", "value")
_SPAN_STATS = ("p50", "p95", "p99", "avg", "max")

# the BDLS round budget: the 128-validator bench config's measured
# virtual round duration (BENCH_consensus.json cpu column, the number
# VERDICT quotes as "0.195 s round budget")
DEFAULT_ROUND_BUDGET_S = 0.195


def _envf(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except (TypeError, ValueError):
        return default


@dataclass(frozen=True)
class Objective:
    """One SLO assertion: ``<stat of target> <op> <threshold>``."""

    name: str
    source: str                # one of SOURCES
    target: str                # span name / metric fqname / "num/den"
    stat: str = "p99"
    op: str = "<="             # "<=" or ">="
    threshold: float = 0.0
    unit: str = "s"
    min_count: int = 1         # observations required to bind
    gate: str = ""             # metric fqname that must be nonzero
    description: str = ""

    def __post_init__(self):
        if self.source not in SOURCES:
            raise ValueError(f"{self.name}: unknown source {self.source!r}")
        if self.op not in ("<=", ">="):
            raise ValueError(f"{self.name}: op must be '<=' or '>='")
        if self.source == "span" and self.stat not in _SPAN_STATS:
            raise ValueError(
                f"{self.name}: span stat must be one of {_SPAN_STATS}")


def spec_from_dicts(rows: Sequence[dict]) -> tuple[Objective, ...]:
    """Build a spec from plain dicts (a JSON-declared SLO file)."""
    return tuple(Objective(**row) for row in rows)


def default_spec(round_budget_s: Optional[float] = None) -> tuple[Objective, ...]:
    """The standing objectives. Thresholds are env-overridable so a
    deployment (or a chip-window gate) tightens them without code:

    - ``BDLS_SLO_ROUND_BUDGET_S``   (default 0.195, the measured
      128-validator virtual round duration)
    - ``BDLS_SLO_QUEUE_WAIT_S``     (default 0.020 — 10x the default
      2 ms flush interval: waits beyond that mean the accumulator is
      starving callers, not batching them)
    - ``BDLS_SLO_MARSHAL_S``        (default 0.010 — the "2048 lanes
      under 10 ms" marshal ceiling the reference asserts)
    - ``BDLS_SLO_PINNED_RATIO``     (default 0.5 — with the key cache
      on, at least half of all verify lanes should ride the
      zero-doubling pinned kernel)
    - ``BDLS_SLO_KEY_CACHE_HIT``    (default 0.9 — the stable consenter
      workload should almost always hit)
    - ``BDLS_SLO_MAX_INFLIGHT``     (default 32 — deeper means the
      device is falling behind the flush thread)

    Sidecar objectives (bind only where verifyd/RemoteCSP
    metrics exist — gated, so node-local and offline evaluations skip
    them cleanly):

    - ``BDLS_SLO_COALESCED_BUCKET_LANES`` (default 8 — the median
      coalesced (flush, curve) bucket should beat a lone node's vote
      batch, else the sidecar is not actually merging tenants)
    - ``BDLS_SLO_SIDECAR_QUEUE_WAIT_S``   (default 0.020 — per-tenant
      coalescer wait stays inside the deadline-flush window)
    - ``BDLS_SLO_SIDECAR_FALLBACKS``      (default 0 — in steady state
      no client batch should be degrading to local sw verify; any
      nonzero count means the daemon dropped out)

    Latency-tier objective (gated on the vote-RTT histogram,
    so runs without vote-lane traffic skip it cleanly):

    - ``BDLS_SLO_VOTE_RTT_S``             (default 0.020 — the on-chip
      target for a quorum-shaped secp256k1 vote bucket's
      submit->verdict round trip; makes verify_fits_round true with
      10x margin at 128 validators)
    """
    rb = (_envf("BDLS_SLO_ROUND_BUDGET_S", DEFAULT_ROUND_BUDGET_S)
          if round_budget_s is None else round_budget_s)
    return (
        Objective(
            name="round_latency_p99", source="span", target="engine.height",
            stat="p99", op="<=", threshold=rb, unit="s",
            description="p99 decided-height latency within the BDLS "
                        "round budget (round latency unchanged)"),
        Objective(
            name="verify_queue_wait_p99", source="histogram",
            target="tpu_verify_queue_wait_seconds", stat="p99", op="<=",
            threshold=_envf("BDLS_SLO_QUEUE_WAIT_S", 0.020), unit="s",
            description="accumulator wait before a flush stays bounded "
                        "by the deadline window"),
        Objective(
            name="marshal_p99", source="histogram",
            target="tpu_verify_marshal_seconds", stat="p99", op="<=",
            threshold=_envf("BDLS_SLO_MARSHAL_S", 0.010), unit="s",
            description="host numpy marshal+pad per launch under the "
                        "vectorized-path ceiling"),
        Objective(
            name="pinned_lane_ratio", source="counter_ratio",
            target="tpu_verify_pinned_lanes_total/tpu_verify_requests_total",
            stat="ratio", op=">=",
            threshold=_envf("BDLS_SLO_PINNED_RATIO", 0.5), unit="ratio",
            min_count=1, gate="tpu_key_cache_keys",
            description="share of verify lanes riding the zero-doubling "
                        "pinned kernel (applies only with the key cache "
                        "enabled and populated)"),
        Objective(
            name="key_cache_hit_rate", source="counter_ratio",
            target="tpu_key_cache_hits_total/tpu_key_cache_lookups_total",
            stat="ratio", op=">=",
            threshold=_envf("BDLS_SLO_KEY_CACHE_HIT", 0.9), unit="ratio",
            # a hit rate over a handful of lookups is noise (every cold
            # start begins at 0%); bind only once the workload has
            # really exercised the cache
            min_count=100, gate="tpu_key_cache_keys",
            description="pinned-table cache hit rate over the stable "
                        "validator/endorser key set"),
        Objective(
            name="inflight_depth", source="gauge",
            target="tpu_dispatch_inflight_batches", stat="value", op="<=",
            threshold=_envf("BDLS_SLO_MAX_INFLIGHT", 32), unit="batches",
            description="async pipeline depth stays bounded (the device "
                        "keeps up with the flush thread)"),
        Objective(
            name="coalesced_bucket_floor", source="histogram",
            target="verifyd_coalesce_bucket_lanes", stat="p50", op=">=",
            threshold=_envf("BDLS_SLO_COALESCED_BUCKET_LANES", 8.0),
            unit="lanes", min_count=4, gate="verifyd_requests_total",
            description="median coalesced (flush, curve) bucket beats a "
                        "lone node's batch — the sidecar is actually "
                        "merging tenants (applies on verifyd daemons)"),
        Objective(
            name="sidecar_queue_wait_p99", source="histogram",
            target="verifyd_queue_wait_seconds", stat="p99", op="<=",
            threshold=_envf("BDLS_SLO_SIDECAR_QUEUE_WAIT_S", 0.020),
            unit="s", min_count=4, gate="verifyd_requests_total",
            description="per-tenant coalescer wait stays inside the "
                        "deadline-flush window"),
        Objective(
            name="sidecar_fallback_zero", source="gauge",
            target="verifyd_client_fallbacks_total", stat="value", op="<=",
            threshold=_envf("BDLS_SLO_SIDECAR_FALLBACKS", 0.0),
            unit="batches", gate="verifyd_client_requests_total",
            description="no client batch degraded to local sw verify in "
                        "steady state (applies on nodes with RemoteCSP)"),
        Objective(
            name="vote_rtt_p99", source="histogram",
            target="tpu_vote_rtt_seconds", stat="p99", op="<=",
            threshold=_envf("BDLS_SLO_VOTE_RTT_S", 0.020), unit="s",
            min_count=1, gate="tpu_vote_rtt_seconds",
            description="latency-tier vote bucket submit->verdict round "
                        "trip inside the BDLS round budget (applies "
                        "where the vote lane carried traffic)"),
    )


# ------------------------------------------------------------ evaluation

def _span_value(agg: dict, obj: Objective):
    entry = agg.get(obj.target)
    if entry is None:
        return None, 0, None
    key = {"avg": "avg_ms", "max": "max_ms"}.get(obj.stat,
                                                 f"{obj.stat}_ms")
    val_ms = entry.get(key)
    if val_ms is None:
        return None, entry["count"], None
    return val_ms / 1e3, entry["count"], entry.get("max_trace_id")


def _metric_count_value(inst) -> Optional[float]:
    if isinstance(inst, (Counter, Gauge)):
        return inst.value()
    if isinstance(inst, Histogram):
        return float(inst.snapshot()["count"])
    return None


def _evaluate_one(obj: Objective, agg: dict,
                  metrics: Optional[MetricsProvider],
                  values: Optional[dict] = None) -> dict:
    row = {
        "name": obj.name, "source": obj.source, "target": obj.target,
        "stat": obj.stat, "op": obj.op, "threshold": obj.threshold,
        "unit": obj.unit, "status": "skipped", "ok": None,
        "value": None, "margin": None, "margin_pct": None,
    }
    if obj.description:
        row["description"] = obj.description

    if obj.gate:
        if metrics is None:
            row["reason"] = "no metrics provider (gated objective)"
            return row
        gate_inst = metrics.find(obj.gate)
        gate_val = (_metric_count_value(gate_inst)
                    if gate_inst is not None else None)
        if not gate_val:
            row["reason"] = f"gate {obj.gate} is zero/absent"
            return row

    value: Optional[float] = None
    count = 0
    if obj.source == "value":
        if values is None or obj.target not in values:
            row["reason"] = f"no caller-supplied value {obj.target!r}"
            return row
        value, count = float(values[obj.target]), obj.min_count
    elif obj.source == "span":
        value, count, max_trace = _span_value(agg, obj)
        if max_trace:
            row["max_trace_id"] = max_trace
        if value is None:
            row["reason"] = f"no completed '{obj.target}' spans"
            return row
    elif metrics is None:
        row["reason"] = "no metrics provider"
        return row
    elif obj.source == "histogram":
        inst = metrics.find(obj.target)
        if not isinstance(inst, Histogram):
            row["reason"] = f"histogram {obj.target} not registered"
            return row
        q = float(obj.stat.lstrip("p")) / 100.0
        value = inst.quantile(q)
        count = inst.snapshot()["count"]
        if value is None:
            row["reason"] = "no observations"
            return row
    elif obj.source == "counter_ratio":
        num_fq, _, den_fq = obj.target.partition("/")
        num, den = metrics.find(num_fq), metrics.find(den_fq)
        if num is None or den is None:
            row["reason"] = "ratio metrics not registered"
            return row
        den_val = _metric_count_value(den) or 0.0
        if den_val <= 0:
            row["reason"] = f"denominator {den_fq} is zero"
            return row
        value = (_metric_count_value(num) or 0.0) / den_val
        count = int(den_val)
    elif obj.source == "gauge":
        inst = metrics.find(obj.target)
        if inst is None:
            row["reason"] = f"gauge {obj.target} not registered"
            return row
        value = _metric_count_value(inst)
        count = obj.min_count  # a gauge reading is always one sample

    if count < obj.min_count:
        row["reason"] = (f"insufficient data "
                         f"({count} < min_count {obj.min_count})")
        return row

    row["value"] = round(value, 6)
    row["count"] = count
    ok = value <= obj.threshold if obj.op == "<=" else value >= obj.threshold
    margin = (obj.threshold - value) if obj.op == "<=" else (value - obj.threshold)
    row["status"] = "pass" if ok else "fail"
    row["ok"] = ok
    row["margin"] = round(margin, 6)
    if obj.threshold:
        row["margin_pct"] = round(100.0 * margin / abs(obj.threshold), 2)
    return row


def evaluate(tracer: Optional[tracing.Tracer] = None,
             metrics: Optional[MetricsProvider] = None,
             spec: Optional[Sequence[Objective]] = None,
             round_budget_s: Optional[float] = None,
             aggregate: Optional[dict] = None,
             values: Optional[dict] = None) -> dict:
    """Evaluate ``spec`` (default: :func:`default_spec`) against a
    tracer's completed spans and a metrics provider's instruments.

    Returns a JSON-serializable verdict::

        {"metric": "slo_verdict", "ok": bool,
         "evaluated": N, "passed": N, "failed": N, "skipped": N,
         "objectives": [{name, status, value, threshold, margin_pct,
                         ...}, ...]}

    ``ok`` is True when no *evaluated* objective failed; skipped
    objectives (insufficient data, gated off, metric absent) never fail
    the verdict but are reported so a gate can require coverage.

    ``aggregate`` replaces the live ``tracer.aggregate()`` read with a
    saved span summary (the ``stage_summary`` block a bench JSON
    carries) so span objectives evaluate offline — how
    ``tools/perf_gate.py`` re-judges a committed bench file chip-free.
    ``values`` supplies the measurements for ``source="value"``
    objectives (harness-computed numbers like a round-latency delta).
    """
    tracer = tracer or tracing.GLOBAL
    if spec is None:
        spec = default_spec(round_budget_s)
    agg = aggregate if aggregate is not None else tracer.aggregate()
    rows = [_evaluate_one(obj, agg, metrics, values) for obj in spec]
    failed = [r for r in rows if r["status"] == "fail"]
    passed = [r for r in rows if r["status"] == "pass"]
    skipped = [r for r in rows if r["status"] == "skipped"]
    return {
        "metric": "slo_verdict",
        "ok": not failed,
        "evaluated": len(passed) + len(failed),
        "passed": len(passed),
        "failed": len(failed),
        "skipped": len(skipped),
        "objectives": rows,
    }


def evaluate_fleet(fleet_aggregate: dict,
                   per_process_aggregates: Optional[dict] = None,
                   metrics: Optional[MetricsProvider] = None,
                   per_process_metrics: Optional[dict] = None,
                   spec: Optional[Sequence[Objective]] = None,
                   round_budget_s: Optional[float] = None,
                   values: Optional[dict] = None) -> dict:
    """Judge the objective spec at fleet scope.

    ``fleet_aggregate`` is the merged cross-process span aggregate
    (the reference's ``bdls_tpu.obs.stitch.aggregate_spans`` over
    stitched traces)
    and ``metrics`` the merged fleet exposition
    (the reference's ``bdls_tpu.obs.collector.merge_metrics`` — every
    label set
    gains a ``process`` label, so counters sum and gauges max across
    the fleet exactly as the single-process read side does across label
    sets). ``per_process_aggregates`` / ``per_process_metrics`` map the
    collector's endpoint labels (one per tenant/daemon) to their
    process-local views; each gets its own sub-verdict.

    The fleet is green only when the whole-fleet verdict AND every
    per-process verdict pass — a single tenant busting the round budget
    must not hide inside a healthy fleet-wide p99.
    """
    fleet = evaluate(aggregate=fleet_aggregate, metrics=metrics,
                     spec=spec, round_budget_s=round_budget_s,
                     values=values)
    per: dict[str, dict] = {}
    for label, agg in sorted((per_process_aggregates or {}).items()):
        per[label] = evaluate(
            aggregate=agg,
            metrics=(per_process_metrics or {}).get(label),
            spec=spec, round_budget_s=round_budget_s)
    return {
        "metric": "fleet_slo_verdict",
        "ok": fleet["ok"] and all(v["ok"] for v in per.values()),
        "fleet": fleet,
        "per_process": per,
    }


def spec_to_dicts(spec: Sequence[Objective]) -> list[dict]:
    """The inverse of :func:`spec_from_dicts` (committing a spec next to
    a gate verdict keeps the verdict self-describing)."""
    return [asdict(o) for o in spec]


def render_verdict(verdict: dict) -> str:
    """Human-readable one-line-per-objective table (perf_gate, CLIs)."""
    lines = [
        f"SLO verdict: {'PASS' if verdict['ok'] else 'FAIL'} "
        f"({verdict['passed']} pass / {verdict['failed']} fail / "
        f"{verdict['skipped']} skipped)"
    ]
    for r in verdict["objectives"]:
        if r["status"] == "skipped":
            lines.append(f"  - {r['name']:24s} SKIP  "
                         f"({r.get('reason', 'no data')})")
            continue
        mp = (f"{r['margin_pct']:+.1f}% margin"
              if r.get("margin_pct") is not None else "")
        lines.append(
            f"  - {r['name']:24s} {r['status'].upper():4s}  "
            f"{r['value']} {r['op']} {r['threshold']} {r['unit']}  {mp}")
    return "\n".join(lines)
