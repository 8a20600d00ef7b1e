"""Flight-recorder tests on the port (``bdls_tpu_torch/obs/tsdb.py``):
the cases of ``tests/test_tsdb.py`` that hold the flight recorder and
the tracer's tail sampler — the TimeSeriesDB sampler under concurrent
instrument registration, on the virtual clock (bit-identical series and
incidents across runs), through the archive round-trip and the windowed
queries, and at /debug/tsdb, and the storm-retention contract of the
tail-based trace sampler. The virtual-clock case reads its incidents
with the reference's detector (``bdls_tpu/obs/detect.py``, not ported)
over the port's series. The fleet merge's cases stay with the reference:
the port has no fleet collector. The reference's recorder fed the same
instruments gives the port's snapshot, exactly.
"""

import json
import os
import tempfile
import threading
import urllib.request

import pytest

from bdls_tpu.obs import detect
from bdls_tpu_torch.obs.tsdb import TimeSeriesDB, read_archive
from bdls_tpu_torch.utils.metrics import MetricOpts, MetricsProvider
from bdls_tpu_torch.utils.operations import OperationsSystem
from bdls_tpu_torch.utils.tracing import Tracer


def _counter(prov, name, labels=()):
    return prov.new_counter(MetricOpts(
        namespace="t", name=name, label_names=tuple(labels)))


# ---------------------------------------------------------------------------
# sampler


def test_sampler_under_concurrent_instrument_registration():
    """Instruments registered WHILE the sampler sweeps must appear in
    the store without racing it: instruments() is a locked snapshot, so
    a sweep and a registration interleave safely."""
    prov = MetricsProvider()
    tsdb = TimeSeriesDB(prov, interval=0.001, process="race")
    n_threads, per_thread = 4, 25
    start = threading.Barrier(n_threads + 1)
    errors: list = []

    def register(tid):
        try:
            start.wait(timeout=5.0)
            for j in range(per_thread):
                c = _counter(prov, f"c{tid}_{j}")
                c.add(1.0)
        except Exception as exc:  # noqa: BLE001 - surfaced below
            errors.append(exc)

    threads = [threading.Thread(target=register, args=(i,))
               for i in range(n_threads)]
    for th in threads:
        th.start()
    start.wait(timeout=5.0)
    for _ in range(200):
        tsdb.sample()
    for th in threads:
        th.join(timeout=10.0)
    tsdb.sample()  # final sweep sees every instrument
    assert not errors
    fqs = {fq for fq, _labels in tsdb.series_keys()}
    assert len(fqs) == n_threads * per_thread
    for fq in fqs:
        pts = tsdb.range(fq)
        assert pts and pts[-1][1] == 1.0


def test_maybe_sample_gates_on_virtual_interval():
    prov = MetricsProvider()
    _counter(prov, "x").add(1.0)
    tsdb = TimeSeriesDB(prov, interval=0.5)
    assert tsdb.maybe_sample(0.0) is True
    assert tsdb.maybe_sample(0.25) is False  # inside the interval
    assert tsdb.maybe_sample(0.5) is True
    assert tsdb.samples_taken == 2


def _drive_virtual():
    """One deterministic virtual-clock run: a counter stepped at fixed
    ticks, sampled through maybe_sample. Returns (snapshot_json,
    incidents) — both must be bit-identical across calls."""
    prov = MetricsProvider()
    c = _counter(prov, "sheds", labels=("tenant",))
    tsdb = TimeSeriesDB(prov, interval=0.25, process="vclock")
    for i in range(20):
        t = round(i * 0.25, 9)
        if i in (4, 5, 12):
            c.add(2.0, ("endorser",))
        tsdb.maybe_sample(t)
    snap = json.dumps(tsdb.snapshot(), sort_keys=True)
    incidents = detect.incidents_from_counter(
        tsdb.range("t_sheds"), gap_s=1.0, signal="t_sheds")
    return snap, incidents


def test_virtual_clock_series_bit_identical():
    snap_a, inc_a = _drive_virtual()
    snap_b, inc_b = _drive_virtual()
    assert snap_a == snap_b
    assert json.dumps(inc_a, sort_keys=True) == \
        json.dumps(inc_b, sort_keys=True)
    # two bursts split by > gap_s of quiet: two incidents, the counter
    # baseline of 0 making the first materialized sample an onset
    assert [i["onset"] for i in inc_a] == [1.0, 3.0]
    assert inc_a[0]["clear"] == 1.5  # first quiet sample after burst 1
    assert inc_a[0]["delta"] == 4.0
    assert inc_a[1]["delta"] == 2.0


def test_range_merges_label_sets_and_rate():
    prov = MetricsProvider()
    c = _counter(prov, "req", labels=("tenant",))
    g = prov.new_gauge(MetricOpts(namespace="t", name="depth",
                                  label_names=("lane",)))
    tsdb = TimeSeriesDB(prov, interval=1.0)
    for t in range(4):
        c.add(1.0, ("a",))
        c.add(3.0, ("b",))
        g.set(float(t), ("l0",))
        g.set(float(2 * t), ("l1",))
        tsdb.maybe_sample(float(t))
    merged = tsdb.range("t_req")
    assert [p[1] for p in merged] == [4.0, 8.0, 12.0, 16.0]  # summed
    only_a = tsdb.range("t_req", labels=("a",))
    assert [p[1] for p in only_a] == [1.0, 2.0, 3.0, 4.0]
    depth = tsdb.range("t_depth")
    assert [p[1] for p in depth] == [0.0, 2.0, 4.0, 6.0]  # gauge maxes
    assert tsdb.rate("t_req") == pytest.approx(4.0)  # 12 over 3 s
    assert tsdb.rate("t_req", window=1.0) == pytest.approx(4.0)


def test_quantile_over_time_windows_the_distribution():
    prov = MetricsProvider()
    h = prov.new_histogram(MetricOpts(
        namespace="t", name="lat", buckets=(0.01, 0.1, 1.0)))
    tsdb = TimeSeriesDB(prov, interval=1.0)
    for _ in range(10):
        h.observe(0.005)  # early, fast
    tsdb.maybe_sample(0.0)
    for _ in range(10):
        h.observe(0.5)  # late, slow
    tsdb.maybe_sample(1.0)
    # whole-series view mixes both; the trailing window only sees the
    # slow observations (cumulative buckets diffed at the edges)
    q_all = tsdb.quantile_over_time("t_lat", 0.5)
    q_late = tsdb.quantile_over_time("t_lat", 0.5, t0=0.0, t1=1.0)
    assert q_all is not None and q_all <= 0.1
    assert q_late is not None and 0.1 < q_late <= 1.0
    assert tsdb.quantile_over_time("t_missing", 0.5) is None


def test_archive_round_trip():
    prov = MetricsProvider()
    c = _counter(prov, "req", labels=("tenant",))
    h = prov.new_histogram(MetricOpts(namespace="t", name="lat",
                                      buckets=(0.01, 1.0)))
    tsdb = TimeSeriesDB(prov, interval=1.0, process="archiver")
    for t in range(3):
        c.add(1.0, ("a",))
        h.observe(0.005)
        tsdb.maybe_sample(float(t))
    fd, path = tempfile.mkstemp(suffix=".jsonl")
    os.close(fd)
    try:
        n = tsdb.write_archive(path)
        back = read_archive(path)
    finally:
        os.unlink(path)
    assert n == 2 == back["meta"]["n_series"]
    assert back["meta"]["schema"] == 1
    assert back["meta"]["process"] == "archiver"
    by_fq = {s["fq"]: s for s in back["series"]}
    assert by_fq["t_req"]["labels"] == {"tenant": "a"}
    assert by_fq["t_req"]["points"] == [(0.0, 1.0), (1.0, 2.0),
                                        (2.0, 3.0)]
    hist = by_fq["t_lat"]
    assert hist["type"] == "histogram"
    assert hist["buckets"] == [0.01, 1.0]
    assert hist["points"][-1][1] == 3  # count


def test_wall_clock_sampler_thread_collects():
    prov = MetricsProvider()
    _counter(prov, "beat").add(1.0)
    tsdb = TimeSeriesDB(prov, interval=0.01)
    tsdb.start()
    try:
        deadline = threading.Event()
        deadline.wait(0.15)
    finally:
        tsdb.stop()
    assert tsdb.samples_taken >= 2  # several beats + the final sweep
    assert tsdb.range("t_beat")


def test_debug_tsdb_endpoint():
    prov = MetricsProvider()
    _counter(prov, "hits").add(5.0)
    tsdb = TimeSeriesDB(prov, interval=1.0, process="ops")
    tsdb.maybe_sample(0.0)
    tsdb.maybe_sample(1.0)
    ops = OperationsSystem(metrics=prov, tsdb=tsdb)
    ops.start()
    base = f"http://{ops.host}:{ops.port}"
    try:
        with urllib.request.urlopen(base + "/debug/tsdb") as resp:
            body = json.loads(resp.read())
        assert body["schema"] == 1
        assert body["process"] == "ops"
        assert body["samples_taken"] == 2
        fqs = [s["fq"] for s in body["series"]]
        assert "t_hits" in fqs
        with urllib.request.urlopen(base + "/debug/tsdb?limit=1") as resp:
            body = json.loads(resp.read())
        assert all(len(s["points"]) == 1 for s in body["series"])
    finally:
        ops.stop()

    bare = OperationsSystem(metrics=prov)
    bare.start()
    try:
        with pytest.raises(urllib.error.HTTPError) as exc_info:
            urllib.request.urlopen(
                f"http://{bare.host}:{bare.port}/debug/tsdb")
        assert exc_info.value.code == 404
    finally:
        bare.stop()


# ---------------------------------------------------------------------------
# tail-based trace sampling


def test_tail_sampler_storm_retains_all_shed_and_error_traces():
    """The acceptance contract: under a synthetic storm that overflows
    the ring, EVERY shed- and error-tagged trace survives, the bound
    holds, and the evictions are counted by the victim's policy."""
    prov = MetricsProvider()
    tracer = Tracer(metrics=prov, max_traces=16, sample_rate=1.0,
                    slow_topk=2)
    shed_ids, error_ids = [], []
    for i in range(28):
        sp = tracer.span("verifyd.batch")
        if i % 7 == 3:  # 4 shed traces
            sp.set_attr("outcome", "shed")
            shed_ids.append(sp.trace_id)
            sp.end()
        elif i % 7 == 5:  # 4 error traces
            error_ids.append(sp.trace_id)
            sp.end(error="boom")
        else:
            sp.end()
    done = tracer.completed()
    assert len(done) == 16  # ring bound held
    kept = {t["trace_id"] for t in done}
    assert set(shed_ids) <= kept
    assert set(error_ids) <= kept
    by_id = {t["trace_id"]: t for t in done}
    assert all(by_id[i]["policy"] == "shed" for i in shed_ids)
    assert all(by_id[i]["policy"] == "error" for i in error_ids)
    # 12 plain traces evicted, all from the lowest-value policies
    assert sum(tracer.evictions.values()) == 12
    assert set(tracer.evictions) <= {"sampled", "slowest"}
    c = prov.find("trace_ring_evictions_total")
    assert c is not None and c.value() == 12.0


def test_tail_sampler_probabilistic_admission_counts_evictions():
    tracer = Tracer(max_traces=64, sample_rate=0.0, slow_topk=1)
    err = tracer.span("work")
    err.end(error="kept anyway")
    for _ in range(10):
        tracer.span("work").end()
    done = tracer.completed()
    ids = {t["trace_id"] for t in done}
    assert err.trace_id in ids  # error traces bypass sampling
    assert tracer.evictions.get("probabilistic", 0) >= 1
    assert len(done) < 11


def test_tail_sampler_policy_stamps_on_ring_entries():
    tracer = Tracer(max_traces=8, slow_topk=1)
    sp = tracer.span("fast")
    sp.end()
    with tracer.span("tpu.cpu_fallback") as fb:
        fb.set_attr("outcome", "fallback")
    done = {t["root"]: t for t in tracer.completed()}
    assert done["fast"]["policy"] == "slowest"  # top-1 for its root
    assert done["tpu.cpu_fallback"]["policy"] == "fallback"
    assert done["tpu.cpu_fallback"]["tag"] == "fallback"


# ---------------------------------------------------------------------------
# against the reference


def _record(tsdb_mod, metrics_mod):
    prov = metrics_mod.MetricsProvider()
    mk = metrics_mod.MetricOpts
    c = prov.new_counter(mk(namespace="t", name="req",
                            label_names=("tenant",)))
    g = prov.new_gauge(mk(namespace="t", name="depth"))
    h = prov.new_histogram(mk(namespace="t", name="lat",
                              buckets=(0.01, 0.1, 1.0)))
    tsdb = tsdb_mod.TimeSeriesDB(prov, interval=0.5, retention=6,
                                 process="same")
    for i in range(12):
        c.add(1.0 + i % 3, ("a" if i % 2 else "b",))
        g.set(float(i * i % 7))
        h.observe(0.003 * (i + 1))
        tsdb.maybe_sample(round(i * 0.25, 9))
    return tsdb


def test_snapshot_and_queries_equal_the_reference():
    from bdls_tpu.obs import tsdb as jtsdb
    from bdls_tpu.utils import metrics as jmetrics
    from bdls_tpu_torch.obs import tsdb as ptsdb
    from bdls_tpu_torch.utils import metrics

    want = _record(jtsdb, jmetrics)
    got = _record(ptsdb, metrics)
    snap_w, snap_g = want.snapshot(), got.snapshot()
    for s in (snap_w, snap_g):
        s.pop("anchor_unix_ns", None)
    assert json.dumps(snap_g, sort_keys=True) == \
        json.dumps(snap_w, sort_keys=True)
    assert got.rate("t_req") == want.rate("t_req")
    assert got.range("t_req", labels=("a",)) == \
        want.range("t_req", labels=("a",))
    for q in (0.5, 0.9):
        assert got.quantile_over_time("t_lat", q) == \
            want.quantile_over_time("t_lat", q)
