"""Fleet collector: scrape N processes, stitch, archive, judge.

The port's copy of ``bdls_tpu/obs/collector.py``, whole. One collector
owns the fleet view of a deployment — every orderer/peer tenant plus the
shared verifyd sidecar — and turns their per-process observability
surfaces into cluster-level artifacts:

- **scrape**: ``/debug/traces?limit=N`` + ``/metrics`` from each
  endpoint over HTTP (the port's :mod:`bdls_tpu_torch.utils.operations`
  serves both), or directly from in-process ``(label, tracer, metrics)``
  tuples — the ``--dryrun`` path, with no sockets at all (the chaos
  runner uses the same path to judge a scenario);
- **stitch**: merge the trace rings by trace_id across processes
  (:mod:`bdls_tpu_torch.obs.stitch`), aligning per-process wall-clock
  anchors and correcting skew from cross-process parent/child edges;
- **archive**: write the durable JSONL trace archive (one ``meta``
  line, one line per stitched trace, one merged ``aggregate`` line, one
  fleet ``slo`` line) that ``python -m bdls_tpu_torch.obs.trace_report
  --archive`` replays;
- **judge**: merge the Prometheus expositions into one fleet
  :class:`~bdls_tpu_torch.utils.metrics.MetricsProvider` (every label
  set gains a ``process`` label so counters sum and gauges max across
  the fleet) and evaluate :func:`bdls_tpu_torch.utils.slo.evaluate_fleet`
  — whole-fleet and per-process verdicts. ``--serve`` exposes the latest
  verdict + summary over HTTP.

CLI::

    python -m bdls_tpu_torch.obs.collector \
        --endpoint orderer0=http://127.0.0.1:9443 \
        --endpoint verifyd=http://127.0.0.1:9444 \
        --archive fleet_traces.jsonl --summary build/FLEET.json
    python -m bdls_tpu_torch.obs.collector --dryrun   # no sockets

The archive's schema is the reference's (its docs/OBSERVABILITY.md
§Fleet), so either package's trace report reads the other's archive.
"""

from __future__ import annotations

import argparse
import json
import re
import sys
import threading
import time
import urllib.request
from typing import Optional

from bdls_tpu_torch.obs import stitch
from bdls_tpu_torch.utils import slo, tracing
from bdls_tpu_torch.utils.metrics import MetricOpts, MetricsProvider

ARCHIVE_SCHEMA = 1

_SAMPLE_RE = re.compile(
    r'^([a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{(.*)\})?\s+(\S+)')
_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="([^"]*)"')


# ------------------------------------------------------------- endpoints

class Endpoint:
    """One scrape target: an operations-server base URL, or an
    in-process (tracer, metrics) pair for the sockets-free path."""

    def __init__(self, label: str, url: Optional[str] = None,
                 tracer: Optional[tracing.Tracer] = None,
                 metrics: Optional[MetricsProvider] = None):
        if url is None and tracer is None:
            raise ValueError(f"endpoint {label!r}: need a url or a tracer")
        self.label = label
        self.url = url.rstrip("/") if url else None
        self.tracer = tracer
        self.metrics = metrics

    def scrape_traces(self, limit: int, timeout: float) -> list[dict]:
        if self.url is None:
            return self.tracer.completed(limit)
        with urllib.request.urlopen(
                f"{self.url}/debug/traces?limit={limit}",
                timeout=timeout) as resp:
            return json.loads(resp.read())["traces"]

    def scrape_metrics(self, timeout: float) -> str:
        if self.url is None:
            return (self.metrics.render_prometheus()
                    if self.metrics is not None else "")
        with urllib.request.urlopen(f"{self.url}/metrics",
                                    timeout=timeout) as resp:
            return resp.read().decode()

    def describe(self) -> str:
        return self.url or "in-process"


# ------------------------------------------- prometheus text -> provider

def parse_prometheus(text: str) -> dict[str, dict]:
    """Parse a Prometheus 0.0.4 exposition back into per-metric state:
    ``{fq: {"kind", "label_names", "series"}}``. Counter/gauge series
    map label-value tuples to values; histogram series map label-value
    tuples (without ``le``) to ``{"buckets": {le: cum}, "sum", "count"}``
    (bucket counts are cumulative, exactly as rendered). OpenMetrics
    exemplar suffixes are stripped."""
    types: dict[str, str] = {}
    out: dict[str, dict] = {}
    for raw in text.splitlines():
        line = raw.strip()
        if line.startswith("# TYPE "):
            parts = line.split()
            if len(parts) >= 4:
                types[parts[2]] = parts[3]
            continue
        if not line or line.startswith("#"):
            continue
        line = line.split(" # ")[0].rstrip()  # exemplar suffix
        m = _SAMPLE_RE.match(line)
        if not m:
            continue
        name, labels_raw, val_raw = m.group(1), m.group(2), m.group(3)
        try:
            value = float(val_raw)
        except ValueError:
            continue
        labels = _LABEL_RE.findall(labels_raw or "")

        base, suffix = name, ""
        for sfx in ("_bucket", "_sum", "_count"):
            trimmed = name[: -len(sfx)]
            if (name.endswith(sfx)
                    and types.get(trimmed) == "histogram"):
                base, suffix = trimmed, sfx
                break
        kind = types.get(base)
        if kind is None:
            continue
        entry = out.setdefault(base, {"kind": kind, "label_names": None,
                                      "series": {}})
        names = tuple(k for k, _ in labels if k != "le")
        vals = tuple(v for k, v in labels if k != "le")
        if entry["label_names"] is None:
            entry["label_names"] = names
        if kind == "histogram":
            series = entry["series"].setdefault(
                vals, {"buckets": {}, "sum": 0.0, "count": 0})
            if suffix == "_bucket":
                le = dict(labels).get("le", "+Inf")
                series["buckets"][le] = value
            elif suffix == "_sum":
                series["sum"] = value
            elif suffix == "_count":
                series["count"] = int(value)
        else:
            entry["series"][vals] = value
    return out


def merge_metrics(texts_by_process: dict[str, str]) -> MetricsProvider:
    """Rebuild the fleet's instruments on one fresh provider. Every
    label set is extended with a ``process`` label, which preserves the
    single-process SLO read semantics at fleet scope: ``Counter.value()``
    sums across label sets (fleet totals), ``Gauge.value()`` maxes (the
    worst process binds), ``Histogram.snapshot()`` merges bucket counts
    (the fleet distribution).

    Histogram bucket layouts may differ across processes (a rolling
    deploy changing bucket bounds, or per-process tuning). The merged
    instrument uses the **superset** of every process's finite bounds,
    each process's cumulative counts are re-gridded onto it (a bound a
    process never rendered carries that process's previous cumulative
    count — cumulative histograms lose no mass, only resolution), and
    every process whose layout differs from the superset is recorded on
    ``obs_merge_bucket_conflicts_total{metric,process}`` instead of
    being silently mis-summed."""
    prov = MetricsProvider()
    built: dict[str, object] = {}
    parsed = {process: parse_prometheus(text)
              for process, text in texts_by_process.items()}
    # superset of finite bucket bounds per histogram fq across the fleet
    hist_bounds: dict[str, set[float]] = {}
    for entries in parsed.values():
        for fq, entry in entries.items():
            if entry["kind"] != "histogram":
                continue
            hist_bounds.setdefault(fq, set()).update(
                float(le)
                for series in entry["series"].values()
                for le in series["buckets"]
                if le != "+Inf")
    conflicts = prov.new_counter(MetricOpts(
        namespace="obs", subsystem="merge", name="bucket_conflicts_total",
        help="Histogram series merged from a process whose bucket "
             "layout differed from the fleet superset.",
        label_names=("metric", "process")))
    for process, entries in parsed.items():
        for fq, entry in entries.items():
            label_names = tuple(entry["label_names"] or ()) + ("process",)
            inst = built.get(fq)
            if entry["kind"] == "histogram":
                superset = sorted(hist_bounds.get(fq, ()))
                if inst is None:
                    inst = prov.new_histogram(MetricOpts(
                        name=fq, label_names=label_names,
                        buckets=tuple(superset) or MetricOpts().buckets))
                    built[fq] = inst
                local = {
                    float(le)
                    for series in entry["series"].values()
                    for le in series["buckets"]
                    if le != "+Inf"}
                if local and superset and local != set(superset):
                    conflicts.add(1.0, (fq, process))
                for vals, series in entry["series"].items():
                    key = tuple(vals) + (process,)
                    counts, prev = [], 0.0
                    for le in inst.opts.buckets:
                        c = series["buckets"].get(str(le))
                        if c is None:
                            # bound unknown to this process: carry the
                            # previous cumulative count (no resolution
                            # below it)
                            c = prev
                        prev = c
                        counts.append(int(c))
                    # reconstructed state, not re-observed: the render
                    # emits cumulative counts, which is exactly the
                    # internal representation
                    with inst._lock:
                        inst._counts[key] = counts
                        inst._sums[key] = series["sum"]
                        inst._totals[key] = series["count"]
            elif entry["kind"] == "gauge":
                if inst is None:
                    inst = prov.new_gauge(MetricOpts(
                        name=fq, label_names=label_names))
                    built[fq] = inst
                for vals, value in entry["series"].items():
                    inst.set(value, tuple(vals) + (process,))
            else:  # counter (and any unknown kind degrades to counter)
                if inst is None:
                    inst = prov.new_counter(MetricOpts(
                        name=fq, label_names=label_names))
                    built[fq] = inst
                for vals, value in entry["series"].items():
                    inst.add(value, tuple(vals) + (process,))
    return prov


# -------------------------------------------------------------- snapshot

class FleetSnapshot:
    """One scrape's worth of fleet state: stitched traces, merged
    aggregates/metrics, and the fleet SLO verdict."""

    def __init__(self, endpoints: dict[str, str],
                 traces_by_process: dict[str, list[dict]],
                 metrics_text_by_process: dict[str, str],
                 spec=None, round_budget_s: Optional[float] = None,
                 values: Optional[dict] = None):
        self.captured_unix_ns = time.time_ns()
        self.endpoints = endpoints
        self.traces_by_process = traces_by_process
        self.metrics_text_by_process = metrics_text_by_process

        self.stitched = stitch.stitch(traces_by_process)
        self.cross_process = [t for t in self.stitched
                              if len(t["processes"]) >= 2]
        self.fleet_aggregate = stitch.aggregate_spans(self.stitched)
        self.per_process_aggregates = {
            label: stitch.aggregate_spans(entries)
            for label, entries in traces_by_process.items()}
        self.edges = stitch.edge_attribution(self.stitched)

        self.metrics = merge_metrics(metrics_text_by_process)
        self.per_process_metrics = {
            label: merge_metrics({label: text})
            for label, text in metrics_text_by_process.items()}
        self.verdict = slo.evaluate_fleet(
            self.fleet_aggregate,
            per_process_aggregates=self.per_process_aggregates,
            metrics=self.metrics,
            per_process_metrics=self.per_process_metrics,
            spec=spec, round_budget_s=round_budget_s, values=values)

    def summary(self) -> dict:
        """The artifact form (the reference's ``FLEET_*.json`` shape)."""
        return {
            "metric": "fleet_observability",
            "schema": ARCHIVE_SCHEMA,
            "captured_unix_ns": self.captured_unix_ns,
            "endpoints": self.endpoints,
            "processes": sorted(self.traces_by_process),
            "traces": len(self.stitched),
            "cross_process_traces": len(self.cross_process),
            "span_aggregate": self.fleet_aggregate,
            "edges": self.edges,
            "slo": self.verdict,
        }

    def write_archive(self, path: str) -> str:
        """Durable JSONL archive: ``meta`` line, one ``trace`` line per
        stitched round, the merged ``aggregate``, the fleet ``slo``."""
        with open(path, "w") as fh:
            fh.write(json.dumps({
                "kind": "meta", "schema": ARCHIVE_SCHEMA,
                "captured_unix_ns": self.captured_unix_ns,
                "endpoints": self.endpoints,
            }) + "\n")
            for tr in self.stitched:
                fh.write(json.dumps(dict(tr, kind="trace")) + "\n")
            fh.write(json.dumps({
                "kind": "aggregate",
                "fleet": self.fleet_aggregate,
                "per_process": self.per_process_aggregates,
            }) + "\n")
            fh.write(json.dumps(dict(self.verdict, kind="slo")) + "\n")
        return path


def read_archive(path: str) -> dict:
    """Load a collector archive back into
    ``{"meta", "traces", "aggregate", "slo"}`` (the trace report's
    input)."""
    out = {"meta": None, "traces": [], "aggregate": None, "slo": None}
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            row = json.loads(line)
            kind = row.get("kind")
            if kind == "trace":
                out["traces"].append(row)
            elif kind in ("meta", "aggregate", "slo"):
                out[kind] = row
    return out


# ------------------------------------------------------------- collector

class FleetCollector:
    def __init__(self, endpoints: list[Endpoint], limit: int = 64,
                 timeout: float = 5.0, spec=None,
                 round_budget_s: Optional[float] = None):
        if not endpoints:
            raise ValueError("collector needs at least one endpoint")
        labels = [e.label for e in endpoints]
        if len(set(labels)) != len(labels):
            raise ValueError(f"duplicate endpoint labels: {labels}")
        self.endpoints = endpoints
        self.limit = limit
        self.timeout = timeout
        self.spec = spec
        self.round_budget_s = round_budget_s

    def scrape(self, values: Optional[dict] = None) -> FleetSnapshot:
        traces: dict[str, list[dict]] = {}
        texts: dict[str, str] = {}
        for ep in self.endpoints:
            try:
                traces[ep.label] = ep.scrape_traces(self.limit,
                                                   self.timeout)
                texts[ep.label] = ep.scrape_metrics(self.timeout)
            except Exception as exc:  # noqa: BLE001 - a down endpoint
                # must not sink the fleet view; it scrapes as empty and
                # its absence is visible in the summary's process list
                print(f"collector: scrape {ep.label} "
                      f"({ep.describe()}) failed: {exc!r}",
                      file=sys.stderr)
                traces.setdefault(ep.label, [])
                texts.setdefault(ep.label, "")
        return FleetSnapshot(
            {ep.label: ep.describe() for ep in self.endpoints},
            traces, texts, spec=self.spec,
            round_budget_s=self.round_budget_s, values=values)


class CollectorServer:
    """Serve the newest fleet verdict over HTTP (``/fleet/slo``,
    ``/fleet/summary``, ``/healthz``), rescraping every ``interval``
    seconds — the standing-verdict deployment mode."""

    def __init__(self, collector: FleetCollector, host: str = "127.0.0.1",
                 port: int = 0, interval: float = 5.0):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        self.collector = collector
        self.interval = interval
        self._snapshot: Optional[FleetSnapshot] = None
        self._lock = threading.Lock()
        self._stop = threading.Event()
        srv = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_GET(self):
                with srv._lock:
                    snap = srv._snapshot
                if self.path.startswith("/healthz"):
                    body, code = b'{"status":"OK"}', 200
                elif snap is None:
                    body, code = b'{"error":"no scrape yet"}', 503
                elif self.path.startswith("/fleet/slo"):
                    body, code = json.dumps(snap.verdict).encode(), 200
                elif self.path.startswith("/fleet/summary"):
                    body, code = json.dumps(snap.summary()).encode(), 200
                else:
                    body, code = b'{"error":"not found"}', 404
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self._server = ThreadingHTTPServer((host, port), Handler)
        self.host, self.port = self._server.server_address
        self._threads: list[threading.Thread] = []

    def refresh(self) -> FleetSnapshot:
        snap = self.collector.scrape()
        with self._lock:
            self._snapshot = snap
        return snap

    def _scrape_loop(self):
        while not self._stop.wait(self.interval):
            try:
                self.refresh()
            except Exception as exc:  # noqa: BLE001 - keep serving
                print(f"collector: periodic scrape failed: {exc!r}",
                      file=sys.stderr)

    def start(self) -> None:
        self.refresh()
        self._threads = [
            threading.Thread(target=self._server.serve_forever,
                             daemon=True),
            threading.Thread(target=self._scrape_loop, daemon=True),
        ]
        for t in self._threads:
            t.start()

    def stop(self) -> None:
        self._stop.set()
        self._server.shutdown()
        for t in self._threads:
            t.join(timeout=2.0)
        self._server.server_close()


# ---------------------------------------------------------------- dryrun

def dryrun_fleet() -> tuple[list[Endpoint], object]:
    """The sockets-free fixture: two in-process "processes" (an
    orderer-like client and a verifyd-like daemon), each with its own
    tracer + metrics, joined by traceparent hand-off exactly as
    RemoteCSP joins them over the wire. Returns (endpoints, closer)."""
    m_ord, m_vfy = MetricsProvider(), MetricsProvider()
    t_ord = tracing.Tracer(metrics=m_ord)
    t_vfy = tracing.Tracer(metrics=m_vfy)
    c_req = m_vfy.new_counter(MetricOpts(
        namespace="verifyd", name="requests_total",
        help="requests", label_names=("tenant",)))

    def daemon_verify(traceparent: str, tenant: str) -> None:
        c_req.add(1.0, (tenant,))
        with t_vfy.span("verifyd.request", parent=traceparent,
                        attrs={"tenant": tenant}):
            qw = t_vfy.start_span("verifyd.queue_wait")
            qw.end(duration=0.002)

    def one_round(i: int) -> None:
        with t_ord.span("bench.round", attrs={"seq": i}):
            with t_ord.span("verifyd.client_verify",
                            attrs={"n": 4}) as cspan:
                daemon_verify(cspan.traceparent(), "dryrun")

    threads = [threading.Thread(target=one_round, args=(i,))
               for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    endpoints = [Endpoint("orderer", tracer=t_ord, metrics=m_ord),
                 Endpoint("verifyd", tracer=t_vfy, metrics=m_vfy)]
    return endpoints, None


# ------------------------------------------------------------------ main

def _parse_endpoint(arg: str) -> Endpoint:
    label, sep, url = arg.partition("=")
    if not sep:
        label, url = re.sub(r"^https?://", "", arg).replace(":", "_"), arg
    if not url.startswith("http"):
        url = "http://" + url
    return Endpoint(label, url=url)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__.splitlines()[0],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--endpoint", action="append", default=[],
                    metavar="LABEL=URL",
                    help="operations-server base URL to scrape "
                         "(repeatable; LABEL= prefix optional)")
    ap.add_argument("--limit", type=int, default=64,
                    help="traces to pull per endpoint")
    ap.add_argument("--timeout", type=float, default=5.0)
    ap.add_argument("--archive", default=None,
                    help="write the JSONL trace archive here")
    ap.add_argument("--summary", default=None,
                    help="write the fleet summary JSON here, or '-' "
                         "for stdout")
    ap.add_argument("--serve", type=int, default=None, metavar="PORT",
                    help="keep running: serve /fleet/slo + "
                         "/fleet/summary on PORT, rescraping "
                         "--interval seconds")
    ap.add_argument("--interval", type=float, default=5.0)
    ap.add_argument("--dryrun", action="store_true",
                    help="no sockets: drive two in-process threads "
                         "through a traceparent hand-off and collect "
                         "them (the CPU-only smoke)")
    args = ap.parse_args(argv)

    if args.dryrun:
        endpoints, _ = dryrun_fleet()
    elif args.endpoint:
        endpoints = [_parse_endpoint(a) for a in args.endpoint]
    else:
        print("error: need --endpoint (or --dryrun)", file=sys.stderr)
        return 2

    collector = FleetCollector(endpoints, limit=args.limit,
                               timeout=args.timeout)
    if args.serve is not None:
        server = CollectorServer(collector, port=args.serve,
                                 interval=args.interval)
        server.start()
        print(f"collector serving http://{server.host}:{server.port}"
              f"/fleet/slo (rescrape every {args.interval}s)",
              file=sys.stderr)
        try:
            while True:
                time.sleep(3600)
        except KeyboardInterrupt:
            server.stop()
            return 0

    snap = collector.scrape()
    if args.archive:
        snap.write_archive(args.archive)
        print(f"wrote {args.archive} ({len(snap.stitched)} traces, "
              f"{len(snap.cross_process)} cross-process)",
              file=sys.stderr)
    if args.summary:
        blob = json.dumps(snap.summary())
        if args.summary == "-":
            print(blob)
        else:
            with open(args.summary, "w") as fh:
                fh.write(blob + "\n")
            print(f"wrote {args.summary}", file=sys.stderr)

    for tr in snap.cross_process[:1]:
        sys.stderr.write(stitch.render_waterfall(tr))
    sys.stderr.write(stitch.render_edge_table(snap.edges))
    sys.stderr.write(slo.render_verdict(snap.verdict["fleet"]) + "\n")

    if args.dryrun and not snap.cross_process:
        print("collector --dryrun: no cross-process trace stitched",
              file=sys.stderr)
        return 1
    return 0 if snap.verdict["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
