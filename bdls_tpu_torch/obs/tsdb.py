"""Bounded in-memory time-series store over a :class:`MetricsProvider`.

The flight recorder: every other observability surface —
``Tracer.aggregate()``, ``FleetCollector.scrape()``, the SLO verdict —
is a snapshot taken *after* a run, so nothing records *when* a counter
moved or how fast a gauge came back down. :class:`TimeSeriesDB` closes
that gap by snapshotting every instrument of one provider on a fixed
interval into per-series retention rings, with PromQL-shaped read
queries (:meth:`range` / :meth:`rate` / :meth:`quantile_over_time`)
and a JSONL archive schema mirroring the fleet collector's.

Two sampling drivers, same store:

* ``start()`` spawns a wall-clock daemon thread sampling every
  ``BDLS_TSDB_INTERVAL`` seconds — the production shape, wired into
  ``VerifydServer`` and served at ``/debug/tsdb``.
* ``maybe_sample(now)`` is the **virtual-clock hook**: the chaos
  runner calls it with ``VirtualNetwork.now`` after every engine step,
  so chaos series carry simulated timestamps and are bit-identical
  across reruns (the determinism contract every judged chaos value
  obeys).

Series identity is ``(fqname, label-values)`` exactly as the
instrument exposes it; histogram points keep the full cumulative
bucket vector so windowed quantiles interpolate the same way
:meth:`Histogram.quantile` does. The reference's online detectors
(``bdls_tpu/obs/detect.py``) consume these series.

The port's copy of ``bdls_tpu/obs/tsdb.py``, whole and unchanged in
behaviour, over the port's own :mod:`bdls_tpu_torch.utils.metrics`.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Optional, Sequence

from bdls_tpu_torch.utils.metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsProvider,
)

TSDB_SCHEMA = 1

DEFAULT_INTERVAL_S = 0.25
DEFAULT_RETENTION = 2048


def _interval_from_env() -> float:
    try:
        v = float(os.environ.get("BDLS_TSDB_INTERVAL", DEFAULT_INTERVAL_S))
        return v if v > 0 else DEFAULT_INTERVAL_S
    except ValueError:
        return DEFAULT_INTERVAL_S


def _retention_from_env() -> int:
    try:
        v = int(os.environ.get("BDLS_TSDB_RETENTION", DEFAULT_RETENTION))
        return v if v > 0 else DEFAULT_RETENTION
    except ValueError:
        return DEFAULT_RETENTION


class _Series:
    """One instrument label-set's retention ring.

    Point shapes (tuples, cheap and immutable):

    * counter / gauge — ``(t, value)``
    * histogram — ``(t, count, sum, (cum_bucket_counts...))``
    """

    __slots__ = ("fq", "labels", "label_names", "kind", "buckets", "points")

    def __init__(self, fq: str, labels: tuple[str, ...],
                 label_names: tuple[str, ...], kind: str,
                 retention: int, buckets: tuple[float, ...] = ()):
        self.fq = fq
        self.labels = labels
        self.label_names = label_names
        self.kind = kind
        self.buckets = buckets
        self.points: deque = deque(maxlen=retention)

    def to_record(self) -> dict:
        rec = {
            "kind": "series",
            "fq": self.fq,
            "type": self.kind,
            "labels": dict(zip(self.label_names, self.labels)),
            "points": [list(p) for p in self.points],
        }
        if self.kind == "histogram":
            rec["buckets"] = list(self.buckets)
        return rec


class TimeSeriesDB:
    """Sampler + store + query engine for one process's metrics."""

    def __init__(self, metrics: MetricsProvider,
                 interval: Optional[float] = None,
                 retention: Optional[int] = None,
                 process: str = ""):
        self.metrics = metrics
        self.interval = float(interval) if interval else _interval_from_env()
        self.retention = int(retention) if retention else _retention_from_env()
        self.process = process
        self._series: dict[tuple[str, tuple[str, ...]], _Series] = {}
        self._lock = threading.Lock()
        self._last_t: Optional[float] = None
        self.samples_taken = 0
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # ------------------------------------------------------------------
    # sampling

    def sample(self, now: Optional[float] = None) -> float:
        """Snapshot every instrument at timestamp ``now`` (wall clock
        when omitted). Instruments registered after construction are
        picked up naturally — ``instruments()`` is a locked snapshot,
        so concurrent registration never races the sweep."""
        t = time.time() if now is None else float(now)
        for inst in self.metrics.instruments():
            fq = inst.opts.fqname()
            if not fq:
                continue
            if isinstance(inst, Histogram):
                self._sample_histogram(t, fq, inst)
            elif isinstance(inst, (Counter, Gauge)):
                kind = "counter" if isinstance(inst, Counter) else "gauge"
                for labels, value in sorted(inst.values().items()):
                    self._append(fq, labels, inst.opts.label_names, kind,
                                 (t, float(value)))
        with self._lock:
            self._last_t = t
            self.samples_taken += 1
        return t

    def _sample_histogram(self, t: float, fq: str, inst: Histogram) -> None:
        with inst._lock:
            keys = sorted(inst._counts)
        for key in keys:
            snap = inst.snapshot(labels=key)
            self._append(
                fq, key, inst.opts.label_names, "histogram",
                (t, int(snap["count"]), float(snap["sum"]),
                 tuple(snap["counts"])),
                buckets=tuple(snap["buckets"]))

    def _append(self, fq: str, labels: Sequence[str],
                label_names: Sequence[str], kind: str, point: tuple,
                buckets: tuple[float, ...] = ()) -> None:
        key = (fq, tuple(labels))
        with self._lock:
            s = self._series.get(key)
            if s is None:
                s = _Series(fq, tuple(labels), tuple(label_names), kind,
                            self.retention, buckets)
                self._series[key] = s
            s.points.append(point)

    def maybe_sample(self, now: float) -> bool:
        """Virtual-clock driver: sample only when ``now`` has advanced
        at least one interval past the previous sample. The chaos
        runner calls this after every engine step with the simulated
        clock, giving deterministic series regardless of wall time."""
        with self._lock:
            last = self._last_t
        if last is not None and now - last < self.interval - 1e-12:
            return False
        self.sample(now=now)
        return True

    def start(self) -> None:
        """Wall-clock sampler thread (production / sidecar shape)."""
        if self._thread is not None:
            return
        self._stop.clear()

        def loop():
            while not self._stop.wait(self.interval):
                try:
                    self.sample()
                except Exception:  # noqa: BLE001 — sampler must survive
                    pass

        self._thread = threading.Thread(
            target=loop, name="tsdb-sampler", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        t, self._thread = self._thread, None
        if t is None:
            return
        self._stop.set()
        t.join(timeout=5.0)
        # one final sweep so short-lived processes still archive a point
        self.sample()

    # ------------------------------------------------------------------
    # queries

    def series_keys(self) -> list[tuple[str, tuple[str, ...]]]:
        with self._lock:
            return sorted(self._series)

    def range(self, fq: str, t0: Optional[float] = None,
              t1: Optional[float] = None,
              labels: Optional[Sequence[str]] = None) -> list[tuple]:
        """Points for one series in ``[t0, t1]``. ``labels=None`` merges
        all label sets per timestamp: counters/histograms sum, gauges
        max (matching each instrument's ``value()`` convention)."""
        with self._lock:
            matches = [s for (f, lv), s in self._series.items()
                       if f == fq and (labels is None
                                       or lv == tuple(labels))]
            snaps = [(s.kind, list(s.points)) for s in matches]
        if not snaps:
            return []

        def keep(p):
            return ((t0 is None or p[0] >= t0)
                    and (t1 is None or p[0] <= t1))

        if len(snaps) == 1:
            return [p for p in snaps[0][1] if keep(p)]
        kind = snaps[0][0]
        merged: dict[float, list] = {}
        for _, pts in snaps:
            for p in pts:
                if not keep(p):
                    continue
                cur = merged.get(p[0])
                if cur is None:
                    merged[p[0]] = list(p)
                elif kind == "gauge":
                    cur[1] = max(cur[1], p[1])
                elif kind == "counter":
                    cur[1] += p[1]
                else:  # histogram: sum count, sum, cum buckets
                    cur[1] += p[1]
                    cur[2] += p[2]
                    cur[3] = tuple(a + b for a, b in zip(cur[3], p[3]))
        return [tuple(merged[t]) for t in sorted(merged)]

    def rate(self, fq: str, window: Optional[float] = None,
             labels: Optional[Sequence[str]] = None) -> float:
        """Per-second increase of a counter (or histogram count) over
        the trailing ``window`` seconds (whole series when None)."""
        pts = self.range(fq, labels=labels)
        if len(pts) < 2:
            return 0.0
        t1 = pts[-1][0]
        t0 = t1 - window if window is not None else pts[0][0]
        win = [p for p in pts if p[0] >= t0 - 1e-12]
        if len(win) < 2:
            return 0.0
        dt = win[-1][0] - win[0][0]
        if dt <= 0:
            return 0.0
        return (win[-1][1] - win[0][1]) / dt

    def quantile_over_time(self, fq: str, q: float,
                           t0: Optional[float] = None,
                           t1: Optional[float] = None,
                           labels: Optional[Sequence[str]] = None
                           ) -> Optional[float]:
        """PromQL-shaped windowed quantile: diff the cumulative bucket
        vectors at the window edges, then interpolate exactly like
        :meth:`Histogram.quantile`. None when the window saw no
        observations or the series is not a histogram."""
        with self._lock:
            buckets: tuple[float, ...] = ()
            for (f, lv), s in self._series.items():
                if f == fq and s.kind == "histogram":
                    buckets = s.buckets
                    break
        if not buckets:
            return None
        pts = self.range(fq, t0=t0, t1=t1, labels=labels)
        pts = [p for p in pts if len(p) == 4]
        if not pts:
            return None
        last = pts[-1]
        if len(pts) == 1 or t0 is None:
            base_counts = (0,) * len(buckets)
            base_total = 0
        else:
            first = pts[0]
            base_counts, base_total = first[3], first[1]
        counts = [c - b for c, b in zip(last[3], base_counts)]
        total = last[1] - base_total
        if total <= 0:
            # fall back to the full cumulative view (single-point case)
            counts, total = list(last[3]), last[1]
        if total <= 0:
            return None
        q = min(max(q, 0.0), 1.0)
        rank = q * total
        prev_cum, prev_bound = 0, 0.0
        for bound, cum in zip(buckets, counts):
            if cum >= rank:
                in_bucket = cum - prev_cum
                if in_bucket <= 0:
                    return bound
                frac = (rank - prev_cum) / in_bucket
                return prev_bound + (bound - prev_bound) * frac
            prev_cum, prev_bound = cum, bound
        return buckets[-1] if buckets else None

    # ------------------------------------------------------------------
    # exposition / archive

    def snapshot(self, limit: Optional[int] = None) -> dict:
        """JSON-safe dump for ``/debug/tsdb``: meta block + every
        series with its newest ``limit`` points (all when None)."""
        with self._lock:
            series = [self._series[k] for k in sorted(self._series)]
            out = []
            for s in series:
                rec = s.to_record()
                if limit is not None and len(rec["points"]) > limit:
                    rec["points"] = rec["points"][-limit:]
                out.append(rec)
            return {
                "schema": TSDB_SCHEMA,
                "process": self.process,
                "interval_s": self.interval,
                "retention": self.retention,
                "samples_taken": self.samples_taken,
                "series": out,
            }

    def write_archive(self, path: str) -> int:
        """Kind-tagged JSONL (same framing as the fleet collector's
        trace archive): one ``meta`` line, then one ``series`` line per
        (fq, labels). Returns the number of series written."""
        snap = self.snapshot()
        series = snap.pop("series")
        snap["kind"] = "meta"
        snap["n_series"] = len(series)
        with open(path, "w") as fh:
            fh.write(json.dumps(snap, sort_keys=True) + "\n")
            for rec in series:
                fh.write(json.dumps(rec, sort_keys=True) + "\n")
        return len(series)


def read_archive(path: str) -> dict:
    """Parse a :meth:`TimeSeriesDB.write_archive` file back into
    ``{"meta": {...}, "series": [...]}`` with tuple-ified points."""
    meta: dict = {}
    series: list[dict] = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            kind = rec.get("kind")
            if kind == "meta":
                meta = rec
            elif kind == "series":
                rec["points"] = [tuple(p) for p in rec.get("points", ())]
                series.append(rec)
    return {"meta": meta, "series": series}
