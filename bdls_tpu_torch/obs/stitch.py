"""Cross-process trace stitching + round critical-path analysis.

The port's copy of ``bdls_tpu/obs/stitch.py``, whole: the same stitched
traces, critical paths, attributions and renderings.

Pure stdlib on purpose (like :mod:`bdls_tpu_torch.obs.trace_report`,
which imports it):
stitching must run anywhere an archive lands — a laptop reading a chip
session's JSONL, the CPU-only CI container — with no jax and no
cryptography wheel.

**Stitching.** Each process exports its completed-trace ring
(:meth:`bdls_tpu_torch.utils.tracing.Tracer.completed`): entries carry an
``anchor_unix_ns`` (the tracer's wall-clock anchor) and spans carry
``mono_ns``, their monotonic offset from that anchor. :func:`stitch`
groups entries from N processes by trace_id and places every span on
one absolute timeline: ``abs_ns = anchor_unix_ns + mono_ns``. Within a
process that ordering is exact (monotonic clock); *across* processes
the anchors disagree by clock skew, so residual skew is corrected from
the causal edges we know: a span whose parent lives in another process
cannot start before its parent did. Each process's spans are shifted
forward by the smallest amount that restores parent-before-child on
every cross-process edge (fixpoint over the process graph).

**Critical path.** :func:`critical_path` walks a stitched trace from
its root, at each node descending into the child that *ends last* (the
child the parent was blocked on), and attributes to each node its
self-time — duration not explained by the on-path child. Summed over
the path this decomposes the round's end-to-end duration into the
stages that actually gated it (engine phase → client encode → sidecar
queue-wait → coalesce → kernel), which is the per-stage latency
attribution the Blockchain Machine work (arXiv 2104.06968) used to
justify hardware offload.

Renderers: :func:`render_waterfall` (text flame view of one stitched
round, critical path starred) and :func:`render_edge_table` (per-edge
p50/p99 attribution across many rounds).
"""

from __future__ import annotations

from typing import Optional

# maximum fixpoint sweeps for skew correction: shifts only grow, and a
# realistic fleet graph (client -> sidecar -> ...) is a short chain
_MAX_SKEW_SWEEPS = 8


def _percentile(sorted_values: list, q: float) -> float:
    """Linear-interpolated percentile over an already-sorted list (same
    math as Tracer.aggregate; duplicated so this module stays
    import-free)."""
    if not sorted_values:
        return 0.0
    if len(sorted_values) == 1:
        return sorted_values[0]
    pos = (len(sorted_values) - 1) * min(max(q, 0.0), 1.0)
    lo = int(pos)
    hi = min(lo + 1, len(sorted_values) - 1)
    frac = pos - lo
    return sorted_values[lo] * (1 - frac) + sorted_values[hi] * frac


def span_abs_ns(span: dict, anchor_unix_ns: Optional[int]) -> int:
    """Absolute (epoch-ns) start of one exported span record: the
    process anchor plus the span's monotonic offset; records from older
    tracers (no ``mono_ns``) fall back to their sampled wall clock."""
    mono = span.get("mono_ns")
    if anchor_unix_ns is not None and mono is not None:
        return int(anchor_unix_ns) + int(mono)
    return int(span["start_unix"] * 1e9)


def stitch(traces_by_process: dict[str, list[dict]]) -> list[dict]:
    """Merge per-process trace-ring entries into cross-process traces.

    ``traces_by_process`` maps a process label (the collector's endpoint
    label) to that process's ``completed()`` list. Returns stitched
    entries sorted oldest-first, each shaped like a ring entry plus::

        {"trace_id": ..., "spans": [... + "process", "abs_ns",
         "rel_ms" ...], "processes": [...], "skew_ns": {process: shift},
         "root": name, "start_unix": s, "duration_ms": ms,
         "span_count": n}
    """
    groups: dict[str, list[tuple[str, dict]]] = {}
    order: list[str] = []
    for process, entries in traces_by_process.items():
        for entry in entries:
            tid = entry["trace_id"]
            if tid not in groups:
                groups[tid] = []
                order.append(tid)
            groups[tid].append((process, entry))

    stitched = [_stitch_one(tid, groups[tid]) for tid in order]
    stitched.sort(key=lambda t: t["start_unix"])
    return stitched


def _stitch_one(trace_id: str, parts: list[tuple[str, dict]]) -> dict:
    spans: list[dict] = []
    for process, entry in parts:
        anchor = entry.get("anchor_unix_ns")
        for s in entry["spans"]:
            rec = dict(s)
            rec["process"] = process
            rec["abs_ns"] = span_abs_ns(s, anchor)
            spans.append(rec)

    by_id = {s["span_id"]: s for s in spans}

    # skew correction: shift whole processes forward until no span
    # starts before its (cross-process) parent. The reference frame is
    # the root span's process (or the earliest top-level span's).
    roots = [s for s in spans if s["parent_id"] not in by_id]
    ref = min(roots or spans, key=lambda s: s["abs_ns"])
    shifts: dict[str, int] = {ref["process"]: 0}
    for _ in range(_MAX_SKEW_SWEEPS):
        changed = False
        for child in spans:
            parent = by_id.get(child["parent_id"])
            if parent is None or parent["process"] == child["process"]:
                continue
            if parent["process"] not in shifts:
                continue
            p_start = parent["abs_ns"] + shifts[parent["process"]]
            need = p_start - child["abs_ns"]
            cur = shifts.get(child["process"])
            if cur is None:
                shifts[child["process"]] = max(0, need)
                changed = True
            elif need > cur:
                shifts[child["process"]] = need
                changed = True
        if not changed:
            break
    for s in spans:
        s["abs_ns"] += shifts.get(s["process"], 0)

    spans.sort(key=lambda s: s["abs_ns"])
    t0 = min(s["abs_ns"] for s in spans)
    t1 = max(s["abs_ns"] + int(s["duration_ms"] * 1e6) for s in spans)
    for s in spans:
        s["rel_ms"] = round((s["abs_ns"] - t0) / 1e6, 3)
    root = next((s for s in spans if s["parent_id"] not in by_id), spans[0])
    return {
        "trace_id": trace_id,
        "spans": spans,
        "processes": sorted({s["process"] for s in spans}),
        "skew_ns": {p: n for p, n in sorted(shifts.items()) if n},
        "root": root["name"],
        "start_unix": t0 / 1e9,
        "duration_ms": round((t1 - t0) / 1e6, 3),
        "span_count": len(spans),
    }


# ---------------------------------------------------------- critical path

def _children_index(spans: list[dict]) -> dict[str, list[dict]]:
    ids = {s["span_id"] for s in spans}
    children: dict[str, list[dict]] = {}
    for s in spans:
        parent = s["parent_id"] if s["parent_id"] in ids else ""
        children.setdefault(parent, []).append(s)
    for kids in children.values():
        kids.sort(key=lambda s: s.get("abs_ns", s["start_unix"]))
    return children


def _span_end(s: dict) -> float:
    return s.get("rel_ms", 0.0) + s["duration_ms"]


def critical_path(stitched: dict) -> list[dict]:
    """The blocking path of one stitched round: from the root, descend
    into the last-ending child at every level. Each row carries
    ``self_ms``, the node's duration not explained by its on-path child
    (where the time actually went)."""
    spans = stitched["spans"]
    if not spans:
        return []
    children = _children_index(spans)
    tops = children.get("", [])
    node = max(tops, key=_span_end) if tops else spans[0]
    path = []
    seen = set()
    while node is not None and node["span_id"] not in seen:
        seen.add(node["span_id"])
        kids = children.get(node["span_id"], [])
        nxt = max(kids, key=_span_end) if kids else None
        self_ms = node["duration_ms"] - (nxt["duration_ms"] if nxt else 0.0)
        path.append({
            "name": node["name"],
            "process": node.get("process", ""),
            "span_id": node["span_id"],
            "rel_ms": node.get("rel_ms", 0.0),
            "duration_ms": node["duration_ms"],
            "self_ms": round(max(0.0, self_ms), 3),
        })
        node = nxt
    return path


def edge_attribution(stitched_list: list[dict]) -> list[dict]:
    """Per-edge latency attribution across many stitched rounds: for
    every critical-path edge ``parent -> child``, the distribution of
    the child's self-time (the blocking time that edge added). The
    synthetic ``(start) -> root`` edge carries the root's own
    self-time, so the rows sum to ~the end-to-end durations."""
    samples: dict[str, list[float]] = {}
    for st in stitched_list:
        path = critical_path(st)
        if not path:
            continue
        prev_name = "(start)"
        for row in path:
            key = f"{prev_name} -> {row['name']}"
            samples.setdefault(key, []).append(row["self_ms"])
            prev_name = row["name"]
    rows = []
    for edge, ds in samples.items():
        ds.sort()
        rows.append({
            "edge": edge,
            "count": len(ds),
            "total_ms": round(sum(ds), 3),
            "p50_ms": round(_percentile(ds, 0.5), 3),
            "p99_ms": round(_percentile(ds, 0.99), 3),
            "max_ms": round(ds[-1], 3),
        })
    rows.sort(key=lambda r: -r["total_ms"])
    return rows


def aggregate_spans(stitched_list: list[dict],
                    quantiles=(0.5, 0.95, 0.99)) -> dict[str, dict]:
    """Per-span-name aggregate over stitched traces, in the exact shape
    of :meth:`Tracer.aggregate` — so :func:`bdls_tpu_torch.utils.slo.evaluate`
    judges fleet span objectives with no changes."""
    durations: dict[str, list[float]] = {}
    max_trace: dict[str, tuple[float, str]] = {}
    for st in stitched_list:
        for s in st["spans"]:
            durations.setdefault(s["name"], []).append(s["duration_ms"])
            cur = max_trace.get(s["name"])
            if cur is None or s["duration_ms"] > cur[0]:
                max_trace[s["name"]] = (s["duration_ms"], st["trace_id"])
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


# -------------------------------------------------------------- rendering

def render_waterfall(stitched: dict, width: int = 48) -> str:
    """Text waterfall of one stitched round: DFS span tree, one bar per
    span positioned on the shared timeline, critical-path spans starred,
    process label on every row."""
    spans = stitched["spans"]
    total = max(stitched["duration_ms"], 1e-9)
    children = _children_index(spans)
    on_path = {r["span_id"] for r in critical_path(stitched)}
    lines = [
        f"trace {stitched['trace_id']}  root={stitched['root']}  "
        f"processes={','.join(stitched['processes'])}  "
        f"spans={stitched['span_count']}  "
        f"duration={stitched['duration_ms']:.2f}ms"
    ]
    if stitched.get("skew_ns"):
        shifts = " ".join(f"{p}:+{n / 1e6:.3f}ms"
                          for p, n in stitched["skew_ns"].items())
        lines.append(f"  (clock skew corrected: {shifts})")

    def bar(rel_ms: float, dur_ms: float) -> str:
        lo = int(width * rel_ms / total)
        ln = max(1, int(width * dur_ms / total))
        lo = min(lo, width - 1)
        ln = min(ln, width - lo)
        return " " * lo + "#" * ln + " " * (width - lo - ln)

    def walk(parent: str, depth: int) -> None:
        for s in children.get(parent, ()):
            mark = "*" if s["span_id"] in on_path else " "
            label = ("  " * depth + s["name"])[:30]
            err = "  ERROR" if s.get("error") else ""
            lines.append(
                f" {mark}{label:30s} |{bar(s['rel_ms'], s['duration_ms'])}|"
                f" {s['rel_ms']:9.2f} +{s['duration_ms']:8.2f}ms"
                f"  [{s['process']}]{err}")
            walk(s["span_id"], depth + 1)

    walk("", 0)
    lines.append("  (* = on the round's critical path)")
    return "\n".join(lines) + "\n"


def render_edge_table(rows: list[dict]) -> str:
    """The per-edge attribution table (trace_report --fleet)."""
    if not rows:
        return "no critical-path edges\n"
    lines = [
        f"{'critical-path edge':44s} {'count':>6s} {'total_ms':>10s} "
        f"{'p50_ms':>9s} {'p99_ms':>9s} {'max_ms':>9s}",
    ]
    for r in rows:
        lines.append(
            f"{r['edge'][:44]:44s} {r['count']:6d} {r['total_ms']:10.2f} "
            f"{r['p50_ms']:9.2f} {r['p99_ms']:9.2f} {r['max_ms']:9.2f}")
    return "\n".join(lines) + "\n"
