"""The fleet observability plane on the port (``bdls_tpu_torch.obs``:
``stitch``, ``detect``, ``collector``, ``trace_report``) against the
reference's ``bdls_tpu.obs`` and ``tools/trace_report.py``, on the CPU.

- ``stitch`` and ``detect`` give the reference's output on seeded
  inputs (rings with clock skew; counter, gauge and burn-rate series;
  the detector suite over a flight recorder);
- ``parse_prometheus`` and ``merge_metrics`` read and merge an
  exposition as the reference does, histogram bucket conflicts too;
- the collector stitches a round across a port client and the port's
  verifyd, in process and over HTTP from the port's
  ``OperationsSystem`` (skew corrected), survives a dead endpoint,
  writes an archive that reads back, serves its verdict, and its
  ``--dryrun`` exits green;
- ``python -m bdls_tpu_torch.obs.trace_report`` prints what the
  reference's tool prints on the same archive and flight recorder.
"""

from __future__ import annotations

import importlib.util
import io
import json
import subprocess
import sys
import urllib.error
import urllib.request
from contextlib import redirect_stderr, redirect_stdout
from pathlib import Path

import numpy as np
import pytest

from bdls_tpu_torch.crypto.csp import VerifyRequest
from bdls_tpu_torch.crypto.sw import SwCSP
from bdls_tpu_torch.crypto.torch_provider import TorchCSP
from bdls_tpu_torch.obs import collector as PC
from bdls_tpu_torch.obs import detect as PD
from bdls_tpu_torch.obs import stitch as PS
from bdls_tpu_torch.obs import trace_report as PT
from bdls_tpu_torch.obs.tsdb import TimeSeriesDB as PTsdb
from bdls_tpu_torch.sidecar.remote_csp import RemoteCSP
from bdls_tpu_torch.sidecar.verifyd import VerifydServer
from bdls_tpu_torch.utils import tracing
from bdls_tpu_torch.utils.metrics import MetricOpts as PO
from bdls_tpu_torch.utils.metrics import MetricsProvider as PM
from bdls_tpu_torch.utils.operations import OperationsSystem

from bdls_tpu.obs import collector as JC
from bdls_tpu.obs import detect as JD
from bdls_tpu.obs import stitch as JS
from bdls_tpu.obs.tsdb import TimeSeriesDB as JTsdb
from bdls_tpu.utils.metrics import MetricOpts as JO
from bdls_tpu.utils.metrics import MetricsProvider as JM

ROOT = Path(__file__).resolve().parents[1]


def _reference_trace_report():
    spec = importlib.util.spec_from_file_location(
        "trace_report_reference", ROOT / "tools" / "trace_report.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---- seeded rings ------------------------------------------------------------

def _rings(seed: int, processes: int = 3, traces: int = 6) -> dict:
    """Per-process completed-trace rings: each trace a random tree whose
    spans live in random processes, each process's anchor off by a
    random skew (so cross-process edges need correcting)."""
    rng = np.random.default_rng(seed)
    labels = [f"p{i}" for i in range(processes)]
    anchor = {p: 1_700_000_000_000_000_000
              - int(rng.integers(0, 3_000_000_000)) for p in labels}
    rings: dict = {p: [] for p in labels}
    for t in range(traces):
        tid = f"{seed:04x}{t:028x}"
        nspans = int(rng.integers(1, 9))
        spans = []
        for k in range(nspans):
            parent = (spans[int(rng.integers(0, k))] if k else None)
            proc = labels[int(rng.integers(0, processes))]
            start = (0 if parent is None else parent["_t"]
                     + int(rng.integers(0, 2_000_000)))
            spans.append({
                "name": f"stage{int(rng.integers(0, 5))}",
                "span_id": f"{t:04x}{k:012x}",
                "parent_id": parent["span_id"] if parent else "",
                "trace_id": tid,
                "start_unix": (anchor[proc] + start) / 1e9,
                "duration_ms": round(float(rng.uniform(0.01, 9.0)), 3),
                "mono_ns": start, "attrs": {"k": k},
                "error": "boom" if rng.random() < 0.1 else "",
                "_proc": proc, "_t": start})
        for p in labels:
            mine = [{k: v for k, v in s.items() if not k.startswith("_")}
                    for s in spans if s["_proc"] == p]
            if mine:
                rings[p].append({"trace_id": tid,
                                 "anchor_unix_ns": anchor[p],
                                 "spans": mine})
    return rings


@pytest.mark.parametrize("seed", [1, 2, 3, 4])
def test_stitch_equals_the_reference(seed):
    rings = _rings(seed)
    port, ref = PS.stitch(rings), JS.stitch(rings)
    assert port == ref
    assert any(len(t["processes"]) > 1 for t in port)
    for tr in port:
        assert PS.critical_path(tr) == JS.critical_path(tr)
        assert PS.render_waterfall(tr) == JS.render_waterfall(tr)
    edges = PS.edge_attribution(port)
    assert edges == JS.edge_attribution(ref)
    assert PS.render_edge_table(edges) == JS.render_edge_table(edges)
    assert PS.aggregate_spans(port) == JS.aggregate_spans(ref)
    assert PS.render_edge_table([]) == JS.render_edge_table([])


# ---- incident detection -----------------------------------------------------

def _series(seed: int):
    rng = np.random.default_rng(seed)
    ts = np.round(np.cumsum(rng.uniform(0.01, 0.4, 120)), 6)
    counter, v = [], 0.0
    for t in ts:
        if rng.random() < 0.25:
            v += float(rng.integers(1, 4))
        if rng.random() < 0.02:
            v = 0.0  # a restarted process
        counter.append((float(t), v))
    gauge = [(float(t), float(rng.normal(10.0, 1.0))
              + (40.0 if 40 <= i < 48 else 0.0))
             for i, t in enumerate(ts)]
    total, errs, n, e = [], [], 0.0, 0.0
    for t in ts:
        n += float(rng.integers(5, 20))
        e += float(rng.integers(0, 3)) if rng.random() < 0.3 else 0.0
        total.append((float(t), n))
        errs.append((float(t), e))
    return counter, gauge, errs, total


@pytest.mark.parametrize("seed", [5, 6, 7])
def test_detectors_equal_the_reference(seed):
    counter, gauge, errs, total = _series(seed)
    for kw in ({}, {"gap_s": 0.2}, {"baseline": None},
               {"signal": "s", "detector": "d"}):
        assert PD.incidents_from_counter(counter, **kw) == \
            JD.incidents_from_counter(counter, **kw)
    for kw in ({}, {"alpha": 0.1, "z": 2.0, "min_samples": 3}):
        assert PD.ewma_incidents(gauge, **kw) == JD.ewma_incidents(gauge,
                                                                   **kw)
    assert PD.ewma_incidents(gauge)
    assert PD.burn_rate(errs, total) == JD.burn_rate(errs, total)
    assert PD.burn_rate([], total) == 0.0
    for kw in ({}, {"slo": 0.99, "window_s": 2.0, "threshold": 0.5}):
        assert PD.burn_rate_incidents(errs, total, **kw) == \
            JD.burn_rate_incidents(errs, total, **kw)


def _recorder(metrics_cls, opts_cls, tsdb_cls):
    """One daemon-shaped registry sampled on a virtual clock."""
    m = metrics_cls()
    shed = m.new_counter(opts_cls(namespace="verifyd", name="shed_total"))
    fb = m.new_counter(opts_cls(
        namespace="verifyd", subsystem="client", name="fallbacks_total",
        label_names=("reason",)))
    req = m.new_counter(opts_cls(namespace="verifyd",
                                 name="requests_total"))
    depth = m.new_gauge(opts_cls(namespace="verifyd",
                                 name="queue_depth_lanes"))
    rtt = m.new_histogram(opts_cls(namespace="tpu", name="vote_rtt_seconds",
                                   buckets=(0.001, 0.01, 0.1)))
    db = tsdb_cls(m, interval=0.1, process="verifyd")
    rng = np.random.default_rng(11)
    for i in range(80):
        req.add(float(rng.integers(1, 6)))
        if 20 <= i < 26 or 50 <= i < 52:
            shed.add(2.0)
            fb.add(1.0, ("shed",))
        depth.set(float(rng.integers(0, 4)) + (60.0 if 30 <= i < 34 else 0))
        rtt.observe(float(rng.uniform(0.0, 0.2)),
                    exemplar={"trace_id": f"{i:032x}"})
        db.maybe_sample(round(0.1 * i, 9))
    return m, db


def test_standard_incidents_and_exemplar_equal_the_reference():
    pm, pdb = _recorder(PM, PO, PTsdb)
    jm, jdb = _recorder(JM, JO, JTsdb)
    port = PD.standard_incidents(pdb, metrics=pm)
    assert port == JD.standard_incidents(jdb, metrics=jm)
    assert {i["detector"] for i in port} >= {"counter_onset", "ewma_z",
                                            "burn_rate"}
    assert PD.link_exemplar(pm, "tpu_vote_rtt_seconds") == \
        JD.link_exemplar(jm, "tpu_vote_rtt_seconds") is not None
    assert PD.link_exemplar(pm, "absent") is None


# ---- the exposition ------------------------------------------------------------

def _exposition(buckets, scale: float) -> str:
    m = PM()
    c = m.new_counter(PO(namespace="verifyd", name="requests_total",
                         label_names=("tenant",)))
    g = m.new_gauge(PO(namespace="tpu", name="inflight"))
    h = m.new_histogram(PO(namespace="tpu", name="rtt_seconds",
                           label_names=("tier",), buckets=buckets))
    c.add(3 * scale, ("a",))
    c.add(5 * scale, ("b",))
    g.set(2 * scale)
    for i, v in enumerate((0.0005, 0.004, 0.04, 0.4, 2.0)):
        h.observe(v * scale, ("latency",),
                  exemplar={"trace_id": f"{i:032x}"})
    return m.render_prometheus()


def test_parse_and_merge_equal_the_reference():
    a = _exposition((0.001, 0.01, 0.1, 1.0), 1.0)
    b = _exposition((0.001, 0.05, 1.0), 2.0)
    for text in (a, b):
        assert PC.parse_prometheus(text) == JC.parse_prometheus(text)
    fleet = {"orderer": a, "verifyd": b}
    port, ref = PC.merge_metrics(fleet), JC.merge_metrics(fleet)
    assert port.render_prometheus() == ref.render_prometheus()
    conflicts = port.find("obs_merge_bucket_conflicts_total")
    assert conflicts.values() == {("tpu_rtt_seconds", "orderer"): 1.0,
                                  ("tpu_rtt_seconds", "verifyd"): 1.0}
    assert port.find("verifyd_requests_total").value() == 24.0
    assert port.find("tpu_inflight").value() == 4.0


# ---- the collector over the port's daemon ----------------------------------------

def _requests(n: int, seq: int) -> tuple[list, list]:
    sw = SwCSP()
    reqs, want = [], []
    for j in range(n):
        key = sw.key_from_scalar("secp256k1", 0x3100 + j)
        d = sw.hash(b"round %d lane %d" % (seq, j))
        r, s = sw.sign(key, d)
        bad = j == n - 1
        reqs.append(VerifyRequest(key.public_key(),
                                  sw.hash(b"other") if bad else d, r, s))
        want.append(not bad)
    return reqs, want


@pytest.fixture(scope="module")
def fleet():
    """A client 'process' and the port's verifyd 'process', each with its
    own tracer and metrics, after three rounds through the daemon."""
    m_d = PM()
    t_d = tracing.Tracer(metrics=m_d)
    m_c = PM()
    t_c = tracing.Tracer(metrics=m_c)
    csp = TorchCSP(device="cpu", kernel_field="sw", key_cache_size=0,
                   metrics=m_d, tracer=t_d)
    srv = VerifydServer(csp=csp, transport="socket", ops_port=None,
                        flush_interval=0.005, metrics=m_d,
                        tracer=t_d).start()
    client = RemoteCSP(f"127.0.0.1:{srv.port}", transport="socket",
                       tenant="tenant-0", metrics=m_c, tracer=t_c)
    try:
        # the daemon's anchor 2 s in the past before any trace finalizes:
        # the collector must put its spans back after their parents
        t_d.anchor_unix_ns -= 2_000_000_000
        for i in range(3):
            reqs, want = _requests(4, i)
            with t_c.span("bench.round", attrs={"seq": i}):
                assert client.verify_batch(reqs) == want
        assert client._c_fallbacks.value() == 0
        yield {"m_d": m_d, "t_d": t_d, "m_c": m_c, "t_c": t_c}
    finally:
        client.close()
        srv.stop()
        csp.close()


def _endpoints(fx):
    return [PC.Endpoint("client", tracer=fx["t_c"], metrics=fx["m_c"]),
            PC.Endpoint("verifyd", tracer=fx["t_d"], metrics=fx["m_d"])]


def _check_round(snap) -> None:
    assert len(snap.cross_process) >= 1
    tr = snap.cross_process[0]
    assert tr["processes"] == ["client", "verifyd"]
    assert tr["skew_ns"].get("verifyd", 0) >= 1_000_000_000
    by_id = {s["span_id"]: s for s in tr["spans"]}
    for s in tr["spans"]:
        parent = by_id.get(s["parent_id"])
        if parent is not None:
            assert s["abs_ns"] >= parent["abs_ns"]
    path = PS.critical_path(tr)
    assert [r["name"] for r in path][:3] == [
        "bench.round", "verifyd.client_verify", "verifyd.request"]
    assert {"client", "verifyd"} <= {r["process"] for r in path}


def test_collector_stitches_across_the_wire(fleet):
    snap = PC.FleetCollector(_endpoints(fleet), limit=64).scrape()
    _check_round(snap)
    assert snap.metrics.find("verifyd_requests_total").value() == 3.0
    assert snap.verdict["metric"] == "fleet_slo_verdict"
    assert set(snap.verdict["per_process"]) == {"client", "verifyd"}
    summary = snap.summary()
    assert summary["metric"] == "fleet_observability"
    assert summary["cross_process_traces"] >= 1


def test_collector_scrapes_operations_over_http(fleet):
    ops = OperationsSystem(metrics=fleet["m_d"], tracer=fleet["t_d"],
                           port=0, process="verifyd0")
    ops.start()
    try:
        snap = PC.FleetCollector([
            PC.Endpoint("client", tracer=fleet["t_c"], metrics=fleet["m_c"]),
            PC.Endpoint("verifyd", url=f"http://127.0.0.1:{ops.port}/"),
        ], limit=64).scrape()
    finally:
        ops.stop()
    _check_round(snap)
    assert snap.endpoints["verifyd"] == f"http://127.0.0.1:{ops.port}"
    assert snap.metrics.find("verifyd_requests_total").value() == 3.0


def test_a_dead_endpoint_scrapes_as_empty(fleet):
    err = io.StringIO()
    with redirect_stderr(err):
        snap = PC.FleetCollector([
            PC.Endpoint("client", tracer=fleet["t_c"], metrics=fleet["m_c"]),
            PC.Endpoint("gone", url="http://127.0.0.1:1"),
        ], limit=8, timeout=0.3).scrape()
    assert "gone" in err.getvalue()
    assert snap.summary()["traces"] >= 1
    assert snap.traces_by_process["gone"] == []
    with pytest.raises(ValueError, match="need a url or a tracer"):
        PC.Endpoint("nothing")
    with pytest.raises(ValueError, match="duplicate endpoint labels"):
        PC.FleetCollector(_endpoints(fleet) + _endpoints(fleet))


def test_collector_server_serves_the_verdict(fleet):
    server = PC.CollectorServer(PC.FleetCollector(_endpoints(fleet)),
                                port=0, interval=60.0)
    server.start()
    base = f"http://127.0.0.1:{server.port}"
    try:
        def get(path):
            with urllib.request.urlopen(base + path, timeout=5) as resp:
                return json.loads(resp.read())

        assert get("/healthz") == {"status": "OK"}
        assert get("/fleet/slo")["metric"] == "fleet_slo_verdict"
        assert get("/fleet/summary")["processes"] == ["client", "verifyd"]
        with pytest.raises(urllib.error.HTTPError) as exc:
            get("/nowhere")
        assert exc.value.code == 404
    finally:
        server.stop()


@pytest.fixture(scope="module")
def archive(fleet, tmp_path_factory):
    snap = PC.FleetCollector(_endpoints(fleet), limit=64).scrape()
    path = str(tmp_path_factory.mktemp("fleet") / "fleet_traces.jsonl")
    snap.write_archive(path)
    return path, snap


def test_archive_round_trip(archive):
    path, snap = archive
    back = PC.read_archive(path)
    assert back == JC.read_archive(path)
    assert back["meta"]["schema"] == PC.ARCHIVE_SCHEMA == 1
    assert back["meta"]["endpoints"] == {"client": "in-process",
                                         "verifyd": "in-process"}
    assert len(back["traces"]) == len(snap.stitched)
    assert back["aggregate"]["fleet"] == snap.fleet_aggregate
    assert back["slo"]["ok"] == snap.verdict["ok"]


def _report(main, args) -> tuple[int, str, str]:
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        rc = main(args)
    return rc, out.getvalue(), err.getvalue()


def test_trace_report_prints_what_the_references_prints(archive, fleet,
                                                       tmp_path):
    path, snap = archive
    ref = _reference_trace_report()
    tid = snap.cross_process[0]["trace_id"]
    db = PTsdb(fleet["m_d"], interval=0.5, process="verifyd")
    for k in range(4):
        db.sample(float(k))
    tsdb_path = str(tmp_path / "tsdb.jsonl")
    db.write_archive(tsdb_path)
    views = (["--archive", path], ["--archive", path, "--fleet"],
             ["--archive", path, "--trace", tid[:8]],
             ["--archive", path, "--fleet", "--limit", "1"],
             ["--tsdb", tsdb_path], ["--tsdb", tsdb_path, "--limit", "2"],
             ["--archive", path, "--trace", "zzzz"],
             ["--archive", path + ".missing"],
             ["--archive", path, "--url", "http://x"],
             ["--fleet", "--url", "http://127.0.0.1:1"],
             ["--tsdb", tsdb_path, "--archive", path])
    for args in views:
        port = _report(PT.main, args)
        assert port == _report(ref.main, args), args
    rc, out, _ = _report(PT.main, ["--archive", path, "--fleet"])
    assert rc == 0 and "critical-path edge" in out
    assert "verifyd.client_verify -> verifyd.request" in out
    assert f"trace {tid}" in _report(PT.main, ["--archive", path, "--trace",
                                               tid[:8]])[1]


def test_trace_report_over_a_live_endpoint(fleet):
    ops = OperationsSystem(metrics=fleet["m_d"], tracer=fleet["t_d"],
                           port=0, process="verifyd0")
    ops.start()
    try:
        url = f"http://127.0.0.1:{ops.port}"
        ref = _reference_trace_report()
        rc, out, _ = _report(PT.main, ["--url", url])
        assert (rc, out) == _report(ref.main, ["--url", url])[:2]
        tid = fleet["t_d"].completed()[0]["trace_id"]
        rc, tree, _ = _report(PT.main, ["--url", url, "--trace", tid[:8]])
        assert rc == 0 and "- verifyd.request" in tree
        assert tree == _report(ref.main, ["--url", url, "--trace",
                                          tid[:8]])[1]
    finally:
        ops.stop()
    assert rc == 0 and "verifyd.request" in out


def test_collector_dryrun_exits_green(tmp_path):
    summary = tmp_path / "fleet.json"
    rc, _, err = _report(PC.main, ["--dryrun", "--archive",
                                   str(tmp_path / "a.jsonl"),
                                   "--summary", str(summary)])
    assert rc == 0, err
    assert "cross-process" in err
    blob = json.loads(summary.read_text())
    assert blob["metric"] == "fleet_observability"
    assert blob["cross_process_traces"] >= 1 and blob["slo"]["ok"] is True
    assert _report(PC.main, [])[0] == 2
    proc = subprocess.run(
        [sys.executable, "-m", "bdls_tpu_torch.obs.collector", "--dryrun",
         "--summary", "-"], cwd=ROOT, capture_output=True, text=True,
        timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout)["processes"] == ["orderer", "verifyd"]
