"""Latency reports over traces: a live /debug/traces endpoint or a
fleet collector archive.

The port's copy of the reference's ``tools/trace_report.py``, whole,
over the port's :mod:`bdls_tpu_torch.obs.stitch` and
:mod:`bdls_tpu_torch.obs.tsdb`: the same views and the same text for the
same input.

Views (the reference's docs/OBSERVABILITY.md):

- default: a per-phase table aggregated across the last N traces —
  span name, count, total/avg/max milliseconds — the stage-by-stage
  breakdown of where rounds spend their time;
- ``--trace <id-prefix>``: one trace in detail — the indented span
  tree (live endpoint) or the cross-process waterfall with the
  critical path starred (archive);
- ``--fleet`` (archive only): the fleet view — every stitched
  cross-process round as a waterfall, the per-edge p50/p99
  critical-path attribution table, and the archived fleet SLO verdict;
- ``--tsdb tsdb.jsonl``: the flight-recorder view — per-series tables
  over a :mod:`bdls_tpu_torch.obs.tsdb` archive
  (``TimeSeriesDB.write_archive``): type, span of the retention ring,
  last value, and per-second rate for counters.

Inputs:

- ``--url http://host:port`` — a running node's operations server;
- ``--archive fleet_traces.jsonl`` — a fleet collector JSONL archive
  (:meth:`bdls_tpu_torch.obs.collector.FleetSnapshot.write_archive`, or
  the reference collector's, which has the same schema);
- ``--tsdb tsdb.jsonl`` — a ``TimeSeriesDB.write_archive`` JSONL file.

Stdlib-only on purpose (stitch, tsdb and the collector's archive
reader are pure stdlib): it runs anywhere a node runs.

Usage:
    python -m bdls_tpu_torch.obs.trace_report --url http://127.0.0.1:9443
    python -m bdls_tpu_torch.obs.trace_report --url ... --trace 4f2a
    python -m bdls_tpu_torch.obs.trace_report --archive a.jsonl --fleet
    python -m bdls_tpu_torch.obs.trace_report --archive a.jsonl --trace 4f2a
    python -m bdls_tpu_torch.obs.trace_report --tsdb tsdb.jsonl
"""

from __future__ import annotations

import argparse
import json
import sys
import urllib.request

from bdls_tpu_torch.obs import stitch, tsdb
from bdls_tpu_torch.obs.collector import read_archive as load_archive


def fetch_traces(url: str, limit: int, timeout: float = 5.0) -> list[dict]:
    endpoint = f"{url.rstrip('/')}/debug/traces?limit={limit}"
    with urllib.request.urlopen(endpoint, timeout=timeout) as resp:
        return json.loads(resp.read())["traces"]


def phase_table(traces: list[dict]) -> list[tuple[str, int, float, float, float, float, str]]:
    """(name, count, total_ms, avg_ms, p99_ms, max_ms, slowest_trace)
    rows, largest total first. ``slowest_trace`` is the trace id holding
    that span's worst instance — the exemplar link: feed its prefix to
    ``--trace`` to see exactly why the slow one was slow."""
    agg: dict[str, list[float]] = {}
    worst: dict[str, tuple[float, str]] = {}
    for t in traces:
        for s in t.get("spans", ()):
            agg.setdefault(s["name"], []).append(s["duration_ms"])
            cur = worst.get(s["name"])
            if cur is None or s["duration_ms"] > cur[0]:
                worst[s["name"]] = (s["duration_ms"], t.get("trace_id", ""))
    rows = []
    for name, ds in agg.items():
        ds.sort()
        p99 = ds[min(len(ds) - 1, int(0.99 * (len(ds) - 1) + 0.5))]
        rows.append((name, len(ds), round(sum(ds), 3),
                     round(sum(ds) / len(ds), 3), round(p99, 3),
                     round(ds[-1], 3), worst[name][1]))
    rows.sort(key=lambda r: -r[2])
    return rows


def render_phase_table(traces: list[dict]) -> str:
    rows = phase_table(traces)
    if not rows:
        return "no completed traces\n"
    lines = [
        f"{len(traces)} trace(s)",
        f"{'span':32s} {'count':>6s} {'total_ms':>10s} {'avg_ms':>9s} "
        f"{'p99_ms':>9s} {'max_ms':>9s}  {'slowest_trace':16s}",
    ]
    for name, count, total, avg, p99, mx, slowest in rows:
        lines.append(
            f"{name:32s} {count:6d} {total:10.2f} {avg:9.2f} "
            f"{p99:9.2f} {mx:9.2f}  {slowest[:16]}")
    return "\n".join(lines) + "\n"


def render_trace_tree(trace: dict) -> str:
    spans = trace.get("spans", [])
    by_parent: dict[str, list[dict]] = {}
    ids = {s["span_id"] for s in spans}
    for s in spans:
        # spans whose parent is remote/absent render at the top level
        parent = s["parent_id"] if s["parent_id"] in ids else ""
        by_parent.setdefault(parent, []).append(s)
    for children in by_parent.values():
        children.sort(key=lambda s: s["start_unix"])

    lines = [
        f"trace {trace['trace_id']}  root={trace.get('root', '?')}  "
        f"spans={trace.get('span_count', len(spans))}  "
        f"duration={trace.get('duration_ms', 0):.2f}ms"
    ]

    def walk(parent: str, depth: int) -> None:
        for s in by_parent.get(parent, ()):
            attrs = " ".join(f"{k}={v}" for k, v in s.get("attrs", {}).items())
            err = f"  ERROR {s['error']}" if s.get("error") else ""
            lines.append(
                f"{'  ' * depth}- {s['name']}  {s['duration_ms']:.2f}ms"
                + (f"  [{attrs}]" if attrs else "") + err
            )
            walk(s["span_id"], depth + 1)

    walk("", 1)
    return "\n".join(lines) + "\n"


def render_one(trace: dict) -> str:
    """Waterfall for stitched (archive) traces, span tree otherwise."""
    if trace.get("processes"):
        return stitch.render_waterfall(trace)
    return render_trace_tree(trace)


def render_tsdb(path: str, limit: int) -> str:
    """The --tsdb view: one row per series in a
    :mod:`bdls_tpu_torch.obs.tsdb` archive — newest value, ring span,
    and (for counters / histogram counts) the per-second rate over the
    retained window."""
    arch = tsdb.read_archive(path)
    meta, series = arch["meta"], arch["series"]
    lines = [
        f"tsdb archive: process={meta.get('process', '?')!r} "
        f"interval={meta.get('interval_s', '?')}s "
        f"samples={meta.get('samples_taken', '?')} "
        f"series={len(series)}",
        f"{'series':44s} {'type':9s} {'pts':>5s} {'t0':>9s} "
        f"{'t1':>9s} {'last':>12s} {'rate/s':>10s}",
    ]
    rows = []
    for s in series:
        labels = ",".join(f"{k}={v}" for k, v in sorted(
            s.get("labels", {}).items()))
        name = s["fq"] + (f"{{{labels}}}" if labels else "")
        pts = s["points"]
        if not pts:
            continue
        t0, t1 = pts[0][0], pts[-1][0]
        if s["type"] == "histogram":
            # (t, count, sum, buckets): report count as the value
            last = float(pts[-1][1])
            rate = ((pts[-1][1] - pts[0][1]) / (t1 - t0)
                    if t1 > t0 else 0.0)
            shown = f"n={pts[-1][1]}"
        else:
            last = float(pts[-1][1])
            rate = ((last - pts[0][1]) / (t1 - t0)
                    if s["type"] == "counter" and t1 > t0 else 0.0)
            shown = f"{last:.6g}"
        rows.append((name, s["type"], len(pts), t0, t1, shown, rate))
    rows.sort(key=lambda r: r[0])
    for name, typ, n, t0, t1, shown, rate in rows[:limit]:
        lines.append(
            f"{name:44s} {typ:9s} {n:5d} {t0:9.3f} {t1:9.3f} "
            f"{shown:>12s} {rate:10.3f}")
    if len(rows) > limit:
        lines.append(f"... {len(rows) - limit} more series "
                     f"(raise --limit)")
    return "\n".join(lines) + "\n"


def render_fleet(archive: dict, limit: int) -> str:
    """The --fleet view: stitched cross-process rounds, the per-edge
    critical-path attribution, and the archived fleet SLO verdict."""
    traces = archive["traces"]
    cross = [t for t in traces if len(t.get("processes", ())) >= 2]
    parts = [
        f"fleet archive: {len(traces)} trace(s), "
        f"{len(cross)} cross-process\n"
    ]
    for t in cross[:limit]:
        parts.append(stitch.render_waterfall(t))
    parts.append(stitch.render_edge_table(stitch.edge_attribution(traces)))
    verdict = archive.get("slo")
    if verdict:
        fleet = verdict.get("fleet", {})
        parts.append(
            f"fleet SLO: {'PASS' if verdict.get('ok') else 'FAIL'} "
            f"(fleet {fleet.get('passed', 0)} pass / "
            f"{fleet.get('failed', 0)} fail / "
            f"{fleet.get('skipped', 0)} skipped)\n")
        for label, v in sorted(verdict.get("per_process", {}).items()):
            parts.append(
                f"  {label:16s} {'PASS' if v.get('ok') else 'FAIL'} "
                f"({v.get('passed', 0)}p/{v.get('failed', 0)}f/"
                f"{v.get('skipped', 0)}s)\n")
    return "".join(parts)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--url", default=None,
                    help="operations server base url, e.g. http://127.0.0.1:9443")
    ap.add_argument("--archive", default=None,
                    help="read a fleet collector JSONL archive "
                         "instead of a live endpoint")
    ap.add_argument("--limit", type=int, default=16,
                    help="how many recent traces to fetch/print")
    ap.add_argument("--trace", default=None,
                    help="print one trace (waterfall for stitched "
                         "archives, span tree for live endpoints) whose "
                         "id starts with this prefix")
    ap.add_argument("--fleet", action="store_true",
                    help="fleet view over an --archive: stitched "
                         "waterfalls + per-edge critical-path "
                         "attribution + the archived SLO verdict")
    ap.add_argument("--tsdb", default=None,
                    help="render per-series tables over a "
                         "TimeSeriesDB JSONL archive")
    args = ap.parse_args(argv)

    if args.tsdb is not None:
        if args.url or args.archive:
            print("error: --tsdb is its own input; don't combine it "
                  "with --url / --archive", file=sys.stderr)
            return 2
        try:
            sys.stdout.write(render_tsdb(args.tsdb, max(args.limit, 1)))
        except Exception as exc:  # noqa: BLE001 - CLI boundary
            print(f"error: could not read tsdb archive {args.tsdb}: "
                  f"{exc}", file=sys.stderr)
            return 1
        return 0

    if bool(args.url) == bool(args.archive):
        print("error: pass exactly one of --url / --archive",
              file=sys.stderr)
        return 2
    if args.fleet and not args.archive:
        print("error: --fleet needs an --archive", file=sys.stderr)
        return 2

    archive = None
    try:
        if args.archive:
            archive = load_archive(args.archive)
            traces = archive["traces"]
        else:
            traces = fetch_traces(args.url, args.limit)
    except Exception as exc:  # noqa: BLE001 - CLI boundary
        src = args.archive or args.url
        print(f"error: could not fetch traces from {src}: {exc}",
              file=sys.stderr)
        return 1

    if args.trace is not None:
        matches = [t for t in traces
                   if t["trace_id"].startswith(args.trace)]
        if not matches:
            print(f"error: no trace id starts with {args.trace!r} "
                  f"in the last {len(traces)} traces", file=sys.stderr)
            return 1
        for t in matches:
            sys.stdout.write(render_one(t))
        return 0

    if args.fleet:
        sys.stdout.write(render_fleet(archive, args.limit))
        return 0

    sys.stdout.write(render_phase_table(traces))
    return 0


if __name__ == "__main__":
    sys.exit(main())
