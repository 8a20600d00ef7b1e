"""Engage/revert actuators binding each fault kind to its seam.

An injector is two moves: ``engage(ctx, event)`` applies the fault and
returns a revert closure that restores exactly the state it saved.
The :class:`ChaosEngine` sequences them on the virtual clock — called
once per drive tick from the scenario runner, it engages events whose
``at`` has arrived, fires churn waves inside open ``cache.churn``
windows, and reverts events whose window has closed. Everything is
synchronous with the drive loop, so a plan replays deterministically.

The port's copy of ``bdls_tpu/chaos/injectors.py``, whole: the same
``records`` and ``chaos_*`` instruments.

Seams (the reference's docs/ROBUSTNESS.md §taxonomy):

- ``net.*`` mutate the live :class:`VirtualNetwork` fault knobs
  (loss/dup/reorder probabilities, the ``partitioned`` set);
- ``node.crash`` uses ``net.crash``/``net.recover`` — the node keeps
  its state and catches up from the next <decide> broadcast;
- ``sidecar.kill`` drives the runner's sidecar controller (stop the
  verifyd daemon; restart it on the same port at window end and wait
  for the client's redialer to latch on);
- ``cache.churn`` calls the runner's churn hook each ``interval``
  virtual seconds — each wave warms a fresh key set into the
  pinned-key LRU, evicting resident consenters mid-workload;
- ``device.stall`` sets ``TorchCSP.chaos_stall_s`` — every launch's
  result materializes late in the drainer, below the dispatcher, so
  the flush thread keeps pipelining into a throttled device.
"""

from __future__ import annotations

from typing import Callable, Optional

from bdls_tpu_torch.chaos.plan import FaultEvent, FaultPlan
from bdls_tpu_torch.utils.metrics import MetricOpts, MetricsProvider


class ChaosContext:
    """The seams a scenario hands the engine. Any of them may be None —
    engaging a fault whose seam is absent raises, which is a plan
    authoring error, not a runtime degradation."""

    def __init__(self, net=None, sidecar=None, csp=None,
                 churn: Optional[Callable[[dict, int], None]] = None,
                 surge: Optional[Callable[[dict, int], None]] = None):
        self.net = net          # VirtualNetwork
        self.sidecar = sidecar  # controller with .kill()/.restart()
        self.csp = csp          # TorchCSP (chaos_stall_s seam)
        self.churn = churn      # churn hook: (params, wave_index)
        self.surge = surge      # load-surge hook: (params, wave_index)

    def _need(self, attr: str, kind: str):
        seam = getattr(self, attr)
        if seam is None:
            raise ValueError(
                f"fault {kind!r} needs a {attr!r} seam in ChaosContext")
        return seam


def _set_net_attr(ctx: ChaosContext, ev: FaultEvent, attr: str):
    net = ctx._need("net", ev.kind)
    saved = getattr(net, attr)
    setattr(net, attr, float(ev.params["p"]))
    if "spread" in ev.params:
        saved_spread = net.reorder_spread
        net.reorder_spread = float(ev.params["spread"])

        def revert():
            setattr(net, attr, saved)
            net.reorder_spread = saved_spread
        return revert
    return lambda: setattr(net, attr, saved)


def _engage_partition(ctx: ChaosContext, ev: FaultEvent):
    net = ctx._need("net", ev.kind)
    nodes = [int(i) for i in ev.params["nodes"]]
    added = [i for i in nodes if i not in net.partitioned]
    net.partitioned.update(added)
    return lambda: net.partitioned.difference_update(added)


def _engage_crash(ctx: ChaosContext, ev: FaultEvent):
    net = ctx._need("net", ev.kind)
    node = int(ev.params["node"])
    net.crash(node)
    return lambda: net.recover(node)


def _engage_sidecar_kill(ctx: ChaosContext, ev: FaultEvent):
    ctl = ctx._need("sidecar", ev.kind)
    replica = ev.params.get("replica")
    if replica is None:
        ctl.kill()
        return ctl.restart
    # fleet scenarios (rolling_restart) address one replica at a time;
    # the fleet controller exposes the same kill/restart verbs per index
    idx = int(replica)
    ctl.kill(idx)
    return lambda: ctl.restart(idx)


def _engage_stall(ctx: ChaosContext, ev: FaultEvent):
    csp = ctx._need("csp", ev.kind)
    saved = csp.chaos_stall_s
    csp.chaos_stall_s = float(ev.params["stall_s"])

    def revert():
        csp.chaos_stall_s = saved
    return revert


def _engage_churn(ctx: ChaosContext, ev: FaultEvent):
    # waves are fired by the engine's step loop; engage fires wave 0
    churn = ctx._need("churn", ev.kind)
    churn(ev.params, 0)
    return lambda: None


def _engage_surge(ctx: ChaosContext, ev: FaultEvent):
    # same wave discipline as churn: engage fires wave 0 (the first
    # endorsement burst), the step loop fires the rest each interval
    surge = ctx._need("surge", ev.kind)
    surge(ev.params, 0)
    return lambda: None


# wave-firing fault kinds: hook attribute called (params, wave) each
# `interval` virtual seconds strictly inside the open window
_WAVE_HOOKS = {"cache.churn": "churn", "load.surge": "surge"}


_ENGAGE = {
    "net.loss": lambda c, e: _set_net_attr(c, e, "loss"),
    "net.dup": lambda c, e: _set_net_attr(c, e, "dup"),
    "net.reorder": lambda c, e: _set_net_attr(c, e, "reorder"),
    "net.partition": _engage_partition,
    "node.crash": _engage_crash,
    "sidecar.kill": _engage_sidecar_kill,
    "cache.churn": _engage_churn,
    "device.stall": _engage_stall,
    "load.surge": _engage_surge,
}


class ChaosEngine:
    """Sequences a validated :class:`FaultPlan` over a run.

    The runner calls :meth:`step` once per drive tick with the current
    virtual time, and :meth:`finish` after the run so any window still
    open at exit reverts (a plan longer than the run must not leak
    faults into provider teardown). ``records`` carries one row per
    event — kind, scheduled/actual engage and revert times — which the
    scenario verdict commits next to the SLO values.
    """

    def __init__(self, plan: FaultPlan, ctx: ChaosContext,
                 metrics: Optional[MetricsProvider] = None):
        self.plan = plan.validate()
        self.ctx = ctx
        self._todo = sorted(plan.events, key=lambda e: (e.at, e.end))
        # (event, revert, record) rows currently engaged
        self._active: list[tuple[FaultEvent, Callable[[], None], dict]] = []
        self._waves_fired: dict[int, int] = {}
        self.records: list[dict] = []
        self._c_engaged = None
        if metrics is not None:
            self._c_engaged = metrics.new_counter(MetricOpts(
                namespace="chaos", name="faults_engaged_total",
                label_names=("kind",),
                help="Fault events engaged by the chaos engine."))

    def step(self, now: float) -> None:
        """Engage due events, fire churn waves, revert closed windows."""
        while self._todo and self._todo[0].at <= now:
            ev = self._todo.pop(0)
            revert = _ENGAGE[ev.kind](self.ctx, ev)
            record = {"kind": ev.kind, "at": ev.at, "end": ev.end,
                      "t_engaged": round(now, 6), "params": dict(ev.params)}
            self.records.append(record)
            self._active.append((ev, revert, record))
            if self._c_engaged is not None:
                self._c_engaged.add(1, (ev.kind,))
        for ev, _, record in self._active:
            hook_attr = _WAVE_HOOKS.get(ev.kind)
            if hook_attr is None:
                continue
            hook = getattr(self.ctx, hook_attr)
            interval = float(ev.params.get("interval", 0.5))
            # waves fire strictly inside [at, end): one landing on the
            # window close belongs to the revert, not the fault
            horizon = min(now, ev.end)
            due = int((horizon - ev.at) / interval) if interval > 0 else 0
            while due > 0 and ev.at + due * interval >= ev.end:
                due -= 1
            fired = self._waves_fired.setdefault(id(ev), 0)
            while fired < due:
                fired += 1
                hook(ev.params, fired)
            self._waves_fired[id(ev)] = fired
            record["waves"] = fired + 1  # + the engage-time wave 0
        still = []
        for ev, revert, record in self._active:
            if ev.end <= now:
                revert()
                record["t_reverted"] = round(now, 6)
            else:
                still.append((ev, revert, record))
        self._active = still

    def finish(self, now: float) -> None:
        """Revert anything still engaged (run ended inside a window)."""
        for ev, revert, record in self._active:
            revert()
            record["t_reverted"] = round(now, 6)
            record["truncated"] = True
        self._active = []

    @property
    def done(self) -> bool:
        return not self._todo and not self._active
