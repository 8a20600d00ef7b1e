"""Metrics SPI: Counter/Gauge/Histogram with a Prometheus text backend.

The port's own copy of ``bdls_tpu/utils/metrics.py`` (stdlib only), kept
unchanged so instrument names and exposition match the JAX package.

Reference parity: ``common/metrics/provider.go`` (the three-instrument SPI
with label support) + the prometheus provider; a ``DisabledProvider``
mirrors the disabled backend. Rendered by the operations server's
``/metrics`` endpoint.

Read-side additions for the SLO engine (:mod:`bdls_tpu.utils.slo`):
every instrument exposes a snapshot of its state (``value()`` /
``values()`` / :meth:`Histogram.quantile`), the provider resolves
instruments by fully-qualified name (:meth:`MetricsProvider.find`), and
:func:`audit_exposition` cross-checks that every registered instrument
actually renders on ``/metrics`` with a consistent label set.
Histograms additionally carry one exemplar per bucket (e.g. the trace
id of the observation that landed there), rendered OpenMetrics-style
after the bucket sample.
"""

from __future__ import annotations

import threading
from bisect import bisect_left
from dataclasses import dataclass
from typing import Optional, Sequence


@dataclass(frozen=True)
class MetricOpts:
    namespace: str = ""
    subsystem: str = ""
    name: str = ""
    help: str = ""
    label_names: tuple[str, ...] = ()
    buckets: tuple[float, ...] = (
        0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
        1.0, 2.5, 5.0, 10.0,
    )

    def fqname(self) -> str:
        return "_".join(p for p in (self.namespace, self.subsystem, self.name) if p)


def _label_key(label_values: Sequence[str]) -> tuple[str, ...]:
    return tuple(label_values)


def _fmt_labels(names: Sequence[str], values: Sequence[str], extra: str = "") -> str:
    pairs = [f'{n}="{v}"' for n, v in zip(names, values)]
    if extra:
        pairs.append(extra)
    return "{" + ",".join(pairs) + "}" if pairs else ""


class Counter:
    def __init__(self, opts: MetricOpts):
        self.opts = opts
        self._values: dict[tuple[str, ...], float] = {}
        self._lock = threading.Lock()

    def with_labels(self, *values: str) -> "_BoundCounter":
        return _BoundCounter(self, _label_key(values))

    def add(self, delta: float = 1.0, labels: Sequence[str] = ()) -> None:
        key = _label_key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + delta

    def value(self, labels: Optional[Sequence[str]] = None) -> float:
        """Current value for one label set, or the sum over all label
        sets when ``labels`` is None (the backward-compat dict views)."""
        with self._lock:
            if labels is not None:
                return self._values.get(_label_key(labels), 0.0)
            return sum(self._values.values())

    def values(self) -> dict[tuple[str, ...], float]:
        """Snapshot of every label set's value."""
        with self._lock:
            return dict(self._values)

    def render(self) -> list[str]:
        out = [
            f"# HELP {self.opts.fqname()} {self.opts.help}",
            f"# TYPE {self.opts.fqname()} counter",
        ]
        with self._lock:
            items = sorted(self._values.items())
        if not items and not self.opts.label_names:
            # an unlabeled instrument always has one sample; a labeled
            # one has no children until a label set is observed
            items = [((), 0.0)]
        for key, val in items:
            out.append(
                f"{self.opts.fqname()}{_fmt_labels(self.opts.label_names, key)} {val}"
            )
        return out


class _BoundCounter:
    def __init__(self, parent: Counter, key: tuple[str, ...]):
        self._parent, self._key = parent, key

    def add(self, delta: float = 1.0) -> None:
        self._parent.add(delta, self._key)


class Gauge:
    def __init__(self, opts: MetricOpts):
        self.opts = opts
        self._values: dict[tuple[str, ...], float] = {}
        self._lock = threading.Lock()

    def set(self, value: float, labels: Sequence[str] = ()) -> None:
        with self._lock:
            self._values[_label_key(labels)] = value

    def add(self, delta: float = 1.0, labels: Sequence[str] = ()) -> None:
        key = _label_key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + delta

    def value(self, labels: Optional[Sequence[str]] = None) -> float:
        """Current value for one label set, or the max over all label
        sets when ``labels`` is None (the SLO read side: for a depth or
        occupancy gauge, the worst label set is the binding one)."""
        with self._lock:
            if labels is not None:
                return self._values.get(_label_key(labels), 0.0)
            return max(self._values.values(), default=0.0)

    def values(self) -> dict[tuple[str, ...], float]:
        """Snapshot of every label set's value."""
        with self._lock:
            return dict(self._values)

    def render(self) -> list[str]:
        out = [
            f"# HELP {self.opts.fqname()} {self.opts.help}",
            f"# TYPE {self.opts.fqname()} gauge",
        ]
        with self._lock:
            items = sorted(self._values.items())
        if not items and not self.opts.label_names:
            items = [((), 0.0)]
        for key, val in items:
            out.append(
                f"{self.opts.fqname()}{_fmt_labels(self.opts.label_names, key)} {val}"
            )
        return out


class Histogram:
    def __init__(self, opts: MetricOpts):
        self.opts = opts
        self._counts: dict[tuple[str, ...], list[int]] = {}
        self._sums: dict[tuple[str, ...], float] = {}
        self._totals: dict[tuple[str, ...], int] = {}
        # per (label set, bucket index incl. +Inf): the most recent
        # exemplar — (exemplar labels dict, observed value)
        self._exemplars: dict[tuple[str, ...], dict[int, tuple[dict, float]]] = {}
        self._lock = threading.Lock()

    def observe(self, value: float, labels: Sequence[str] = (),
                exemplar: Optional[dict] = None) -> None:
        """Record one observation. ``exemplar`` is an optional small
        label dict (e.g. ``{"trace_id": …}``) attached to the bucket the
        value lands in — the link from a slow histogram bucket back to
        its ``/debug/traces`` record."""
        key = _label_key(labels)
        with self._lock:
            if key not in self._counts:
                self._counts[key] = [0] * len(self.opts.buckets)
                self._sums[key] = 0.0
                self._totals[key] = 0
            idx = bisect_left(self.opts.buckets, value)
            for i in range(idx, len(self.opts.buckets)):
                self._counts[key][i] += 1
            self._sums[key] += value
            self._totals[key] += 1
            if exemplar:
                self._exemplars.setdefault(key, {})[idx] = (
                    dict(exemplar), value)

    def exemplars(self, labels: Sequence[str] = ()) -> dict[int, tuple[dict, float]]:
        """Latest exemplar per bucket index for one label set."""
        with self._lock:
            return dict(self._exemplars.get(_label_key(labels), {}))

    def snapshot(self, labels: Optional[Sequence[str]] = None) -> dict:
        """Cumulative bucket counts / sum / count, merged across all
        label sets when ``labels`` is None (the SLO read side)."""
        with self._lock:
            if labels is not None:
                key = _label_key(labels)
                counts = list(self._counts.get(key, ()))
                return {"buckets": tuple(self.opts.buckets),
                        "counts": counts,
                        "sum": self._sums.get(key, 0.0),
                        "count": self._totals.get(key, 0)}
            counts = [0] * len(self.opts.buckets)
            for per in self._counts.values():
                for i, c in enumerate(per):
                    counts[i] += c
            return {"buckets": tuple(self.opts.buckets),
                    "counts": counts,
                    "sum": sum(self._sums.values()),
                    "count": sum(self._totals.values())}

    def quantile(self, q: float,
                 labels: Optional[Sequence[str]] = None) -> Optional[float]:
        """Prometheus-style ``histogram_quantile``: locate the bucket
        whose cumulative count crosses ``q * total`` and interpolate
        linearly inside it. Returns None with zero observations. The
        +Inf bucket clamps to the largest finite bound (same convention
        as PromQL)."""
        snap = self.snapshot(labels)
        total = snap["count"]
        if total <= 0:
            return None
        q = min(max(q, 0.0), 1.0)
        rank = q * total
        prev_cum, prev_bound = 0, 0.0
        for bound, cum in zip(snap["buckets"], snap["counts"]):
            if cum >= rank:
                in_bucket = cum - prev_cum
                if in_bucket <= 0:
                    return bound
                frac = (rank - prev_cum) / in_bucket
                return prev_bound + (bound - prev_bound) * frac
            prev_cum, prev_bound = cum, bound
        return snap["buckets"][-1] if snap["buckets"] else None

    def render(self) -> list[str]:
        fq = self.opts.fqname()
        out = [f"# HELP {fq} {self.opts.help}", f"# TYPE {fq} histogram"]
        with self._lock:
            for key in sorted(self._counts):
                exs = self._exemplars.get(key, {})
                for i, (le, cnt) in enumerate(
                        zip(self.opts.buckets, self._counts[key])):
                    le_label = 'le="%s"' % le
                    line = (f"{fq}_bucket"
                            f"{_fmt_labels(self.opts.label_names, key, le_label)}"
                            f" {cnt}")
                    out.append(line + _fmt_exemplar(exs.get(i)))
                inf_label = 'le="+Inf"'
                inf_line = (
                    f"{fq}_bucket{_fmt_labels(self.opts.label_names, key, inf_label)} {self._totals[key]}"
                )
                out.append(
                    inf_line + _fmt_exemplar(exs.get(len(self.opts.buckets))))
                out.append(
                    f"{fq}_sum{_fmt_labels(self.opts.label_names, key)} {self._sums[key]}"
                )
                out.append(
                    f"{fq}_count{_fmt_labels(self.opts.label_names, key)} {self._totals[key]}"
                )
        return out


def _fmt_exemplar(ex: Optional[tuple[dict, float]]) -> str:
    """OpenMetrics exemplar suffix (``… # {trace_id="…"} value``) —
    appended after the sample so plain 0.0.4 text parsers that stop at
    the value still read the line."""
    if not ex:
        return ""
    labels, value = ex
    inner = ",".join(f'{k}="{v}"' for k, v in labels.items())
    return f" # {{{inner}}} {value}"


class MetricsProvider:
    """Registry + instrument factory (one per process/node)."""

    def __init__(self):
        self._instruments: list = []
        self._lock = threading.Lock()

    def new_counter(self, opts: MetricOpts) -> Counter:
        c = Counter(opts)
        with self._lock:
            self._instruments.append(c)
        return c

    def new_gauge(self, opts: MetricOpts) -> Gauge:
        g = Gauge(opts)
        with self._lock:
            self._instruments.append(g)
        return g

    def new_histogram(self, opts: MetricOpts) -> Histogram:
        h = Histogram(opts)
        with self._lock:
            self._instruments.append(h)
        return h

    def render_prometheus(self) -> str:
        lines: list[str] = []
        for inst in self.instruments():
            lines.extend(inst.render())
        return "\n".join(lines) + "\n"

    def instruments(self) -> list:
        """Snapshot of every registered instrument."""
        with self._lock:
            return list(self._instruments)

    def find(self, fqname: str):
        """Resolve an instrument by its fully-qualified name
        (``namespace_subsystem_name``); None if never registered. With
        duplicate registrations the FIRST wins (matching render order —
        and the audit flags the duplicate)."""
        for inst in self.instruments():
            if inst.opts.fqname() == fqname:
                return inst
        return None


class DisabledProvider(MetricsProvider):
    def render_prometheus(self) -> str:
        return ""


def audit_exposition(provider: MetricsProvider) -> list[str]:
    """Cross-check the registry against the rendered exposition: every
    registered instrument must render (HELP/TYPE + at least one sample
    line), label value counts must match the declared ``label_names``,
    and no two instruments may claim the same fully-qualified name with
    different types or label sets (the "registered but never exported /
    inconsistent labels" bug class). Returns a list of human-readable
    problems — empty means the exposition is consistent."""
    problems: list[str] = []
    text = provider.render_prometheus()
    seen: dict[str, tuple[str, tuple[str, ...]]] = {}
    for inst in provider.instruments():
        fq = inst.opts.fqname()
        kind = type(inst).__name__.lower()
        if not fq:
            problems.append(f"{kind} registered with an empty name")
            continue
        key = (kind, tuple(inst.opts.label_names))
        if fq in seen and seen[fq] != key:
            problems.append(
                f"{fq}: duplicate registration with conflicting "
                f"type/labels {seen[fq]} vs {key}")
        seen.setdefault(fq, key)
        if f"# TYPE {fq} " not in text:
            problems.append(f"{fq}: registered but absent from exposition")
            continue
        # every rendered sample of this instrument must carry exactly
        # the declared labels (histograms add 'le' on _bucket lines)
        want = set(inst.opts.label_names)
        for line in text.splitlines():
            if line.startswith("#") or not line.startswith(fq):
                continue
            name, _, rest = line.partition("{")
            base = name.split(" ")[0]
            if base not in (fq, f"{fq}_bucket", f"{fq}_sum", f"{fq}_count"):
                continue
            got = set()
            if rest:
                body = rest.split("}")[0]
                got = {p.split("=")[0] for p in body.split(",") if "=" in p}
            allowed = want | ({"le"} if base == f"{fq}_bucket" else set())
            if not (want <= got <= allowed):
                problems.append(
                    f"{fq}: sample labels {sorted(got)} inconsistent with "
                    f"declared {sorted(want)} ({line[:120]})")
                break
    return problems
