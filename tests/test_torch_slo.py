"""SLO engine tests on the port (``bdls_tpu_torch/utils/slo.py``): every
case of ``tests/test_slo.py`` — objective evaluation on both the pass
and near-miss sides of each threshold, synthetic histograms, gating,
skip semantics, the /debug/slo endpoint, and the verdict renderer — over
the port's tracer, metrics and operations server, and the reference's
verdict on the same data equal to the port's."""

import json
import urllib.request

import pytest

from bdls_tpu_torch.utils import slo
from bdls_tpu_torch.utils.metrics import MetricOpts, MetricsProvider
from bdls_tpu_torch.utils.operations import OperationsSystem
from bdls_tpu_torch.utils.tracing import Tracer


def _span(tracer, name, seconds, n=1):
    for _ in range(n):
        sp = tracer.start_span(name)
        sp.end(duration=seconds)


def _counter(prov, fq_parts, value, labels=()):
    c = prov.new_counter(MetricOpts(*fq_parts))
    if value:
        c.add(value, labels)
    return c


# ------------------------------------------------------------- objectives

def test_span_objective_pass_and_near_miss():
    spec = [slo.Objective(name="lat", source="span", target="round",
                          stat="p99", op="<=", threshold=0.2)]
    t = Tracer()
    _span(t, "round", 0.05, n=20)
    v = slo.evaluate(tracer=t, spec=spec)
    assert v["ok"] and v["passed"] == 1
    row = v["objectives"][0]
    assert row["status"] == "pass"
    assert row["value"] <= 0.2
    assert row["margin_pct"] > 0
    assert "max_trace_id" in row

    # near miss: p99 just over the threshold flips the verdict
    t2 = Tracer()
    _span(t2, "round", 0.201, n=20)
    v2 = slo.evaluate(tracer=t2, spec=spec)
    assert not v2["ok"] and v2["failed"] == 1
    assert v2["objectives"][0]["margin"] < 0


def test_span_quantile_uses_tail_not_average():
    """19 fast + 1 slow round: the average would pass, p99 must fail."""
    spec = [slo.Objective(name="lat", source="span", target="round",
                          stat="p99", op="<=", threshold=0.1)]
    t = Tracer(max_traces=64)
    _span(t, "round", 0.01, n=19)
    _span(t, "round", 1.0)
    v = slo.evaluate(tracer=t, spec=spec)
    assert not v["ok"]
    avg_spec = [slo.Objective(name="lat", source="span", target="round",
                              stat="avg", op="<=", threshold=0.1)]
    assert slo.evaluate(tracer=t, spec=avg_spec)["ok"]


def test_histogram_objective_synthetic_pass_and_near_miss():
    prov = MetricsProvider()
    h = prov.new_histogram(MetricOpts(
        namespace="tpu", subsystem="verify", name="queue_wait_seconds"))
    for _ in range(99):
        h.observe(0.003)
    spec = [slo.Objective(name="qw", source="histogram",
                          target="tpu_verify_queue_wait_seconds",
                          stat="p99", op="<=", threshold=0.02)]
    assert slo.evaluate(tracer=Tracer(), metrics=prov, spec=spec)["ok"]
    # pile the tail into a bucket above the threshold: near miss fails
    for _ in range(30):
        h.observe(0.04)
    v = slo.evaluate(tracer=Tracer(), metrics=prov, spec=spec)
    assert not v["ok"]
    assert v["objectives"][0]["value"] > 0.02


def test_counter_ratio_and_gate():
    prov = MetricsProvider()
    _counter(prov, ("tpu", "verify", "pinned_lanes_total"), 80)
    _counter(prov, ("tpu", "verify", "requests_total"), 100)
    gate_gauge = prov.new_gauge(MetricOpts("tpu", "key_cache", "keys"))
    spec = [slo.Objective(name="pinned", source="counter_ratio",
                          target="tpu_verify_pinned_lanes_total/"
                                 "tpu_verify_requests_total",
                          stat="ratio", op=">=", threshold=0.5,
                          unit="ratio", gate="tpu_key_cache_keys")]
    # gate zero -> skipped, not failed
    v = slo.evaluate(tracer=Tracer(), metrics=prov, spec=spec)
    assert v["ok"] and v["skipped"] == 1
    assert "gate" in v["objectives"][0]["reason"]
    # gate nonzero -> evaluated (0.8 >= 0.5 passes)
    gate_gauge.set(4)
    v = slo.evaluate(tracer=Tracer(), metrics=prov, spec=spec)
    assert v["ok"] and v["passed"] == 1
    assert v["objectives"][0]["value"] == pytest.approx(0.8)


def test_counter_ratio_zero_denominator_skips():
    prov = MetricsProvider()
    _counter(prov, ("a", "", "num"), 5)
    _counter(prov, ("a", "", "den"), 0)
    spec = [slo.Objective(name="r", source="counter_ratio",
                          target="a_num/a_den", op=">=", threshold=0.5)]
    v = slo.evaluate(tracer=Tracer(), metrics=prov, spec=spec)
    assert v["skipped"] == 1 and v["ok"]


def test_gauge_objective_and_min_count_skip():
    prov = MetricsProvider()
    g = prov.new_gauge(MetricOpts("tpu", "dispatch", "inflight_batches"))
    g.set(48)
    spec = [slo.Objective(name="depth", source="gauge",
                          target="tpu_dispatch_inflight_batches",
                          stat="value", op="<=", threshold=32,
                          unit="batches")]
    v = slo.evaluate(tracer=Tracer(), metrics=prov, spec=spec)
    assert not v["ok"] and v["objectives"][0]["value"] == 48

    # min_count: a 3-observation histogram must not bind at min_count=10
    h = prov.new_histogram(MetricOpts("x", "", "seconds"))
    for _ in range(3):
        h.observe(9.0)
    spec = [slo.Objective(name="x", source="histogram", target="x_seconds",
                          stat="p99", op="<=", threshold=0.1,
                          min_count=10)]
    v = slo.evaluate(tracer=Tracer(), metrics=prov, spec=spec)
    assert v["ok"] and v["skipped"] == 1


def test_value_source_and_missing_value_skips():
    spec = [slo.Objective(name="delta", source="value",
                          target="round_latency_delta_pct", op="<=",
                          threshold=5.0, unit="pct")]
    v = slo.evaluate(tracer=Tracer(), spec=spec,
                     values={"round_latency_delta_pct": 1.2})
    assert v["ok"] and v["objectives"][0]["value"] == pytest.approx(1.2)
    v = slo.evaluate(tracer=Tracer(), spec=spec,
                     values={"round_latency_delta_pct": 9.9})
    assert not v["ok"]
    v = slo.evaluate(tracer=Tracer(), spec=spec)
    assert v["skipped"] == 1 and v["ok"]


def test_default_spec_covers_required_objectives_without_data():
    """A bare evaluate() must still produce the full standing verdict —
    every required objective appears (skipped where no data exists),
    nothing fails spuriously."""
    v = slo.evaluate(tracer=Tracer(), metrics=MetricsProvider())
    names = {r["name"] for r in v["objectives"]}
    assert {"round_latency_p99", "verify_queue_wait_p99", "marshal_p99",
            "pinned_lane_ratio", "key_cache_hit_rate",
            "inflight_depth"} <= names
    assert v["ok"] and v["failed"] == 0


def test_offline_aggregate_evaluation():
    """perf_gate's path: span objectives from a saved stage_summary."""
    t = Tracer()
    _span(t, "engine.height", 0.15, n=10)
    saved = t.aggregate()
    spec = [slo.Objective(name="lat", source="span",
                          target="engine.height", stat="p99", op="<=",
                          threshold=0.195)]
    v = slo.evaluate(tracer=Tracer(), spec=spec, aggregate=saved)
    assert v["ok"] and v["objectives"][0]["value"] == pytest.approx(0.15)


def test_spec_round_trip_and_validation():
    spec = slo.default_spec()
    rows = slo.spec_to_dicts(spec)
    assert slo.spec_from_dicts(rows) == tuple(spec)
    with pytest.raises(ValueError):
        slo.Objective(name="bad", source="nope", target="x")
    with pytest.raises(ValueError):
        slo.Objective(name="bad", source="span", target="x", op="==")
    with pytest.raises(ValueError):
        slo.Objective(name="bad", source="span", target="x", stat="p42")


def test_round_budget_override(monkeypatch):
    monkeypatch.setenv("BDLS_SLO_ROUND_BUDGET_S", "0.5")
    spec = slo.default_spec()
    assert spec[0].threshold == 0.5
    assert slo.default_spec(round_budget_s=1.0)[0].threshold == 1.0


def test_render_verdict_mentions_every_objective():
    t = Tracer()
    _span(t, "engine.height", 0.01, n=3)
    v = slo.evaluate(tracer=t, metrics=MetricsProvider())
    text = slo.render_verdict(v)
    for r in v["objectives"]:
        assert r["name"] in text
    assert "PASS" in text


# --------------------------------------------------------------- endpoint

def test_debug_slo_endpoint_serves_live_verdict():
    prov = MetricsProvider()
    tracer = Tracer()
    ops = OperationsSystem(metrics=prov, tracer=tracer)
    # give the verdict real data on both surfaces
    _span(tracer, "engine.height", 0.05, n=5)
    h = prov.new_histogram(MetricOpts(
        namespace="tpu", subsystem="verify", name="marshal_seconds"))
    h.observe(0.001)
    ops.start()
    try:
        url = f"http://{ops.host}:{ops.port}/debug/slo"
        with urllib.request.urlopen(url) as resp:
            body = json.loads(resp.read())
        assert body["metric"] == "slo_verdict"
        assert body["ok"] is True
        by_name = {r["name"]: r for r in body["objectives"]}
        assert by_name["round_latency_p99"]["status"] == "pass"
        assert by_name["marshal_p99"]["status"] == "pass"
        # the acceptance surface: all standing objectives present
        assert {"round_latency_p99", "verify_queue_wait_p99",
                "marshal_p99", "pinned_lane_ratio",
                "key_cache_hit_rate"} <= set(by_name)
    finally:
        ops.stop()


# ------------------------------------------------- against the reference

def _fill(metrics_mod, tracing_mod):
    """The same instruments and spans on either package's classes."""
    prov = metrics_mod.MetricsProvider()
    tracer = tracing_mod.Tracer()
    for seconds in (0.01, 0.05, 0.15, 0.3):
        _span(tracer, "engine.height", seconds, n=5)
    mk = metrics_mod.MetricOpts
    h = prov.new_histogram(mk("tpu", "verify", "queue_wait_seconds"))
    for v in (0.001, 0.004, 0.03):
        h.observe(v)
    prov.new_counter(mk("tpu", "verify", "pinned_lanes_total")).add(30)
    prov.new_counter(mk("tpu", "verify", "requests_total")).add(100)
    prov.new_gauge(mk("tpu", "key_cache", "keys")).set(8)
    prov.new_counter(mk("verifyd", "", "requests_total",
                        label_names=("tenant",))).add(6, ("t",))
    b = prov.new_histogram(mk("verifyd", "coalesce", "bucket_lanes",
                              buckets=(1, 8, 64, 512)))
    for v in (4, 12, 40, 100, 3):
        b.observe(v)
    return tracer, prov


def test_default_verdict_equals_the_reference():
    from bdls_tpu.utils import metrics as jmetrics
    from bdls_tpu.utils import slo as jslo
    from bdls_tpu.utils import tracing as jtracing
    from bdls_tpu_torch.utils import metrics, tracing

    def strip(v):
        for r in v["objectives"]:
            r.pop("max_trace_id", None)
        return v

    jt, jp = _fill(jmetrics, jtracing)
    t, p = _fill(metrics, tracing)
    for budget in (None, 0.1, 0.5):
        want = strip(jslo.evaluate(tracer=jt, metrics=jp,
                                   round_budget_s=budget))
        got = strip(slo.evaluate(tracer=t, metrics=p, round_budget_s=budget))
        assert got == want
    assert slo.render_verdict(got) == jslo.render_verdict(want)
    assert slo.spec_to_dicts(slo.default_spec()) == jslo.spec_to_dicts(
        jslo.default_spec())
