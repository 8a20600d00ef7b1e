"""Online incident detection over :mod:`bdls_tpu_torch.obs.tsdb` series.

The port's copy of ``bdls_tpu/obs/detect.py``, whole: the same incidents
from the same series.

Three detector families, all pure functions over point lists so chaos
runs stay deterministic (same series in → bit-identical incidents out):

* **Counter onset/clear** (:func:`incidents_from_counter`) — groups a
  counter's positive deltas into incidents: onset is the timestamp of
  the first increase, clear is the first sample *after* the last
  increase inside the same ``gap_s`` window. This is how the chaos
  runner derives the ``endorsement_storm`` shed timeline from the
  ``verifyd_shed_total`` series instead of the end-of-run counter.
* **EWMA z-score change detection** (:func:`ewma_incidents`) — flags a
  gauge (queue depth, shed rate) departing its exponentially-weighted
  baseline by more than ``z`` standard deviations; incident clears
  when the signal re-enters the band.
* **SLO burn rate** (:func:`burn_rate`, :func:`burn_rate_incidents`) —
  the multi-window error-budget math: with objective ``slo`` (e.g.
  0.999), burn rate is ``error_rate / (1 - slo)``; a sustained burn
  above ``threshold`` means the window is consuming budget faster
  than the objective allows.

Incident records are plain dicts::

    {"detector": "counter_onset", "signal": "verifyd_shed_total",
     "onset": 1.001, "clear": 2.25, "duration_s": 1.249,
     "delta": 3.0, "peak": 2.0, "exemplar_trace_id": "…"}

``exemplar_trace_id`` (when a histogram with bucket exemplars is
handy) links the incident back to a retained trace — the tail sampler
in :mod:`bdls_tpu_torch.utils.tracing` guarantees error/shed traces survive
ring eviction, so the link stays live.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence


def _round(t: float) -> float:
    # chaos timeline convention: 9 decimal places, so incident
    # timestamps digest identically across reruns
    return round(float(t), 9)


def incidents_from_counter(points: Sequence[tuple], gap_s: float = 1.5,
                           signal: str = "",
                           detector: str = "counter_onset",
                           baseline: Optional[float] = 0.0) -> list[dict]:
    """Group a counter series' increases into onset/clear incidents.

    ``points`` are ``(t, cumulative_value)`` tuples. Consecutive
    increases closer than ``gap_s`` apart merge into one incident (the
    storm's 1 s waves form a single incident at the default gap);
    ``clear`` is the first sample timestamp after the last increase —
    i.e. the first observation proving the counter went quiet.
    An incident still rising at the end of the series has
    ``clear=None`` and ``duration_s=None`` (unresolved).

    ``baseline`` is the assumed pre-series value. Counters start at 0
    and a label set's series only materializes on its first increment,
    so the default 0.0 makes that first nonzero sample an onset. Pass
    ``baseline=None`` when attaching to an already-running process
    (first sample becomes the baseline instead of an incident).
    """
    incidents: list[dict] = []
    cur: Optional[dict] = None
    prev_v: Optional[float] = baseline
    last_rise_t: Optional[float] = None
    for p in points:
        t, v = float(p[0]), float(p[1])
        rising = prev_v is not None and v > prev_v
        if rising:
            if cur is not None and last_rise_t is not None \
                    and t - last_rise_t > gap_s:
                incidents.append(cur)
                cur = None
            if cur is None:
                cur = {"detector": detector, "signal": signal,
                       "onset": _round(t), "clear": None,
                       "duration_s": None, "delta": 0.0,
                       "peak": 0.0}
            cur["delta"] = _round(cur["delta"] + (v - prev_v))
            cur["peak"] = max(cur["peak"], _round(v - prev_v))
            # a rise inside the gap re-opens the incident: the clear
            # stamp only sticks if the counter stays quiet
            cur["clear"] = None
            cur["duration_s"] = None
            last_rise_t = t
        elif cur is not None and cur["clear"] is None \
                and last_rise_t is not None and t > last_rise_t:
            cur["clear"] = _round(t)
            cur["duration_s"] = _round(t - cur["onset"])
            if t - last_rise_t > gap_s:
                incidents.append(cur)
                cur = None
        if prev_v is None or v >= prev_v:
            prev_v = v
        else:
            prev_v = v  # counter reset: re-baseline, don't count down
    if cur is not None:
        incidents.append(cur)
    return incidents


def ewma_incidents(points: Sequence[tuple], alpha: float = 0.3,
                   z: float = 3.0, min_samples: int = 5,
                   min_sigma: float = 1e-9, signal: str = "",
                   detector: str = "ewma_z") -> list[dict]:
    """EWMA mean/variance change detection on a gauge series.

    The first ``min_samples`` points only train the baseline. After
    that, a point whose |value - ewma| exceeds ``z`` EW standard
    deviations opens an incident; it clears at the first in-band
    point. Out-of-band points do NOT update the baseline (so a long
    excursion stays detected instead of being absorbed)."""
    incidents: list[dict] = []
    mean = var = 0.0
    n = 0
    cur: Optional[dict] = None
    for p in points:
        t, v = float(p[0]), float(p[1])
        if n >= min_samples:
            sigma = math.sqrt(max(var, 0.0))
            dev = abs(v - mean)
            out = dev > z * max(sigma, min_sigma)
            if out and cur is None:
                cur = {"detector": detector, "signal": signal,
                       "onset": _round(t), "clear": None,
                       "duration_s": None, "delta": _round(v - mean),
                       "peak": _round(v)}
            elif out and cur is not None:
                cur["peak"] = max(cur["peak"], _round(v))
            elif not out and cur is not None:
                cur["clear"] = _round(t)
                cur["duration_s"] = _round(t - cur["onset"])
                incidents.append(cur)
                cur = None
            if out:
                continue  # freeze baseline during the excursion
        delta = v - mean
        mean += alpha * delta
        var = (1.0 - alpha) * (var + alpha * delta * delta)
        n += 1
    if cur is not None:
        incidents.append(cur)
    return incidents


def burn_rate(err_points: Sequence[tuple], total_points: Sequence[tuple],
              slo: float = 0.999) -> float:
    """Error-budget burn rate over the whole window covered by the
    series: ``(errors/total) / (1 - slo)``. 1.0 means budget consumed
    exactly at the objective's allowed pace; 14.4 is the classic
    page-now threshold for a 1 h window on a 30 d budget."""
    if not err_points or not total_points:
        return 0.0
    errs = float(err_points[-1][1]) - float(err_points[0][1])
    total = float(total_points[-1][1]) - float(total_points[0][1])
    if total <= 0:
        # single-sample series: fall back to the cumulative values
        errs = float(err_points[-1][1])
        total = float(total_points[-1][1])
    if total <= 0:
        return 0.0
    budget = max(1.0 - slo, 1e-12)
    return max(errs, 0.0) / total / budget


def burn_rate_incidents(err_points: Sequence[tuple],
                        total_points: Sequence[tuple],
                        slo: float = 0.999, window_s: float = 5.0,
                        threshold: float = 1.0,
                        signal: str = "") -> list[dict]:
    """Sliding-window burn-rate detector: at each sample timestamp,
    compute the burn rate over the trailing ``window_s`` and open an
    incident while it exceeds ``threshold``."""
    if not total_points:
        return []
    err_by_t = {float(p[0]): float(p[1]) for p in err_points}
    incidents: list[dict] = []
    cur: Optional[dict] = None
    times = [float(p[0]) for p in total_points]
    for i, t in enumerate(times):
        t0 = t - window_s
        win_total = [p for p in total_points
                     if t0 <= float(p[0]) <= t]
        win_err = [(tt, err_by_t.get(tt, 0.0))
                   for tt in (float(p[0]) for p in win_total)]
        rate = burn_rate(win_err, win_total, slo=slo)
        if rate > threshold and cur is None:
            cur = {"detector": "burn_rate", "signal": signal,
                   "onset": _round(t), "clear": None,
                   "duration_s": None, "delta": _round(rate),
                   "peak": _round(rate)}
        elif rate > threshold and cur is not None:
            cur["peak"] = max(cur["peak"], _round(rate))
        elif rate <= threshold and cur is not None:
            cur["clear"] = _round(t)
            cur["duration_s"] = _round(t - cur["onset"])
            incidents.append(cur)
            cur = None
    if cur is not None:
        incidents.append(cur)
    return incidents


def link_exemplar(metrics, fq: str) -> Optional[str]:
    """Best-effort trace link: the trace id of the slowest-bucket
    exemplar on histogram ``fq`` (the observation most likely retained
    by the tail sampler's slow/error policies). None when the
    instrument is absent or carries no exemplars."""
    inst = metrics.find(fq) if metrics is not None else None
    exemplars = getattr(inst, "exemplars", None)
    if exemplars is None:
        return None
    best: Optional[tuple[int, str]] = None
    with inst._lock:
        keys = list(inst._exemplars)
    for key in keys:
        for idx, (labels, _value) in inst.exemplars(labels=key).items():
            tid = labels.get("trace_id")
            if tid and (best is None or idx > best[0]):
                best = (idx, tid)
    return best[1] if best else None


def standard_incidents(tsdb, metrics=None) -> list[dict]:
    """The default detector suite over one process's series — the
    taxonomy documented in OBSERVABILITY.md §Time series & incidents:

    * ``counter_onset`` on ``verifyd_shed_total`` (shed storms)
    * ``counter_onset`` on ``verifyd_client_fallbacks_total``
      (client-side degradation)
    * ``ewma_z`` on ``verifyd_queue_depth_lanes`` (queue excursions)
    * ``burn_rate`` on shed vs submitted requests when both exist

    Each incident gets an ``exemplar_trace_id`` from the vote-RTT
    histogram when one is linkable. Sorted by onset for stable output.
    """
    incidents: list[dict] = []
    for fq in ("verifyd_shed_total", "verifyd_client_fallbacks_total"):
        pts = tsdb.range(fq)
        if pts:
            incidents.extend(incidents_from_counter(pts, signal=fq))
    depth = tsdb.range("verifyd_queue_depth_lanes")
    if depth:
        incidents.extend(ewma_incidents(depth,
                                        signal="verifyd_queue_depth_lanes"))
    shed = tsdb.range("verifyd_shed_total")
    total = tsdb.range("verifyd_requests_total")
    if shed and total:
        incidents.extend(burn_rate_incidents(
            shed, total, signal="verifyd_shed_total/requests"))
    exemplar = link_exemplar(metrics, "tpu_vote_rtt_seconds") \
        if metrics is not None else None
    if exemplar:
        for inc in incidents:
            inc.setdefault("exemplar_trace_id", exemplar)
    incidents.sort(key=lambda i: (i["onset"], i["signal"], i["detector"]))
    return incidents
