"""FaultPlan: the seeded, deterministic, JSON round-trippable fault DSL.

The port's copy of ``bdls_tpu/chaos/plan.py``, whole: the same taxonomy,
the same validation errors and byte-equal ``to_json``.

A plan is a timeline of :class:`FaultEvent` rows — *what* breaks,
*when* (virtual seconds), for *how long*, with kind-specific
parameters — plus one seed that feeds every RNG a scenario touches
(the VirtualNetwork's message scheduler, the payload mix). Running the
same plan twice replays the same run bit-for-bit: faults land on the
virtual clock, never the wall clock, so a CI box and a laptop see the
same message drops in the same ticks.

The schema is intentionally flat (the reference's docs/ROBUSTNESS.md
has the full table)::

    {"name": "loss_crash", "seed": 7, "events": [
        {"kind": "net.loss",   "at": 0.5, "duration": 2.0,
         "params": {"p": 0.25}},
        {"kind": "node.crash", "at": 3.0, "duration": 2.0,
         "params": {"node": 3}}]}

``FaultPlan.from_json(plan.to_json())`` is exact — plans are committed
artifacts and wire payloads, not just in-memory config.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Sequence

# the fault taxonomy: one kind per seam the stack exposes
KINDS = (
    "net.loss",       # p: per-message drop probability
    "net.dup",        # p: per-message duplication probability
    "net.reorder",    # p [, spread]: hold-back probability / window
    "net.partition",  # nodes: standing split set for the window
    "node.crash",     # node: dead (no receive, no update) then recover
    "sidecar.kill",   # [replica]: kill the verifyd daemon (or fleet
                      # replica i), restart at window end
    "cache.churn",    # keys [, interval, stride]: membership churn
                      # waves against the pinned-key LRU
    "device.stall",   # stall_s: slow-device seam below the dispatcher
    "load.surge",     # blocks [, txs, interval]: endorsement-storm
                      # waves fanned through the committer's batch
                      # verifier into the shared sidecar
)

# params each kind cannot run without (validated up front, not at
# engage time — a broken plan should fail before the run starts)
_REQUIRED = {
    "net.loss": ("p",),
    "net.dup": ("p",),
    "net.reorder": ("p",),
    "net.partition": ("nodes",),
    "node.crash": ("node",),
    "sidecar.kill": (),
    "cache.churn": ("keys",),
    "device.stall": ("stall_s",),
    "load.surge": ("blocks",),
}


@dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault: engage at ``at``, revert at
    ``at + duration`` (both virtual seconds)."""

    kind: str
    at: float
    duration: float = 0.0
    params: dict = field(default_factory=dict)

    def validate(self) -> None:
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r} "
                             f"(taxonomy: {', '.join(KINDS)})")
        if self.at < 0.0 or self.duration < 0.0:
            raise ValueError(f"{self.kind}: at/duration must be >= 0")
        missing = [p for p in _REQUIRED[self.kind]
                   if p not in self.params]
        if missing:
            raise ValueError(
                f"{self.kind} at t={self.at}: missing params {missing}")

    @property
    def end(self) -> float:
        return self.at + self.duration

    def to_dict(self) -> dict:
        return {"kind": self.kind, "at": self.at,
                "duration": self.duration, "params": dict(self.params)}

    @classmethod
    def from_dict(cls, row: dict) -> "FaultEvent":
        return cls(kind=row["kind"], at=float(row["at"]),
                   duration=float(row.get("duration", 0.0)),
                   params=dict(row.get("params", {})))


@dataclass(frozen=True)
class FaultPlan:
    """A named, seeded fault timeline."""

    seed: int
    events: tuple = ()
    name: str = ""

    def validate(self) -> "FaultPlan":
        for ev in self.events:
            ev.validate()
        return self

    def windows(self) -> list[tuple[float, float, "FaultEvent"]]:
        """``(start, end, event)`` rows, sorted by start time."""
        return sorted(((ev.at, ev.end, ev) for ev in self.events),
                      key=lambda w: (w[0], w[1]))

    def horizon(self) -> float:
        """Virtual time by which every fault window has closed."""
        return max((ev.end for ev in self.events), default=0.0)

    def to_dict(self) -> dict:
        return {"name": self.name, "seed": self.seed,
                "events": [ev.to_dict() for ev in self.events]}

    @classmethod
    def from_dict(cls, row: dict) -> "FaultPlan":
        return cls(seed=int(row["seed"]),
                   events=tuple(FaultEvent.from_dict(e)
                                for e in row.get("events", [])),
                   name=row.get("name", ""))

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), sort_keys=True)

    @classmethod
    def from_json(cls, blob: str) -> "FaultPlan":
        return cls.from_dict(json.loads(blob))


def make_plan(name: str, seed: int,
              events: Sequence[FaultEvent]) -> FaultPlan:
    """Build + validate in one step (the scenario catalog's helper)."""
    return FaultPlan(seed=seed, events=tuple(events),
                     name=name).validate()
