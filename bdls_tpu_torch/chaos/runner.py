"""Scenario runner: loadgen traffic + a FaultPlan, judged by the fleet.

The port's copy of ``bdls_tpu/chaos/runner.py``. One scenario is one
deterministic soak: an N-validator BDLS cluster on the VirtualNetwork
drives sustained proposal traffic (the firehose, parameterized by client
count and payload mix) while a
:class:`~bdls_tpu_torch.chaos.injectors.ChaosEngine` replays the plan's
fault windows on the same virtual clock. Verification rides the sidecar
pre-pass of :mod:`bdls_tpu_torch.consensus.rounds`: every envelope
deliverable in the next tick — embedded proofs included — is
batch-verified through the provider under test (a ``TorchCSP``, or a
fleet of verifyd daemons, each over its own ``TorchCSP``, behind a
``RemoteCSP``) into a digest-keyed cache the engines answer from.

The verdict comes from the same plane that judges production: all
"processes" are scraped through
:class:`bdls_tpu_torch.obs.collector.FleetCollector` and the scenario's
pass/fail is ``slo.evaluate_fleet()`` over chaos objectives —

- **liveness**: decided heights reach the target AND advance after
  every fault window (``unrecovered_windows == 0``), with the worst
  post-window recovery time inside the scenario budget;
- **safety**: no two nodes ever commit different states at one height
  (``fork_heights == 0``) and tampered envelopes are rejected even
  mid-fault (``tamper_accepts == 0``);
- **degraded mode**: client fallbacks to local sw verify stay inside
  the scenario's budget, virtual round latency stays inside its
  budget, and (sidecar scenarios) server-side deadline expirations
  stay bounded.

All judged values are virtual-clock or count measurements — never
wall-clock — so a scenario's verdict AND its cells replay bit-identically
(``timeline_digest`` proves it), on the card as on the host.

Where the port differs from the reference, on purpose:

- **The provider.** The reference verifies on ``TpuCSP(kernel_field=
  "sw")``, the host, in the client and in every daemon. The port's
  :func:`run_scenario` takes ``device`` and ``kernel_field`` and builds
  ``TorchCSP(device=device, kernel_field=kernel_field, ...)``: by
  default the card with its default field, and no silent move to the
  host when there is no card (``TorchCSP`` raises). ``device="cpu",
  kernel_field="sw"`` is the reference's shape.
- **Cache misses.** The engines' misses (each node's own loopback
  messages) go to the pre-pass verifier, the provider under test, as in
  :mod:`bdls_tpu_torch.consensus.rounds`; the reference sends them to a
  host verifier of its own. The pre-pass plumbing is ``rounds``'s
  (``extract_envelopes``, ``CacheVerifier``), not a third copy.
- **A restart's wait.** :class:`SidecarController` does not wait for a
  replica the client was not connected to when it was killed (wall
  time: no judged value moves).
- **The growth soak** keeps the reference's ``CpuBatchVerifier`` and its
  host pairings in the anchors.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import tempfile
import time
from dataclasses import dataclass, field
from typing import Optional

from bdls_tpu_torch.chaos.injectors import ChaosContext, ChaosEngine
from bdls_tpu_torch.chaos.plan import FaultPlan
from bdls_tpu_torch.consensus import wire_codec as W
from bdls_tpu_torch.consensus.rounds import (CacheVerifier, _env_key,
                                             extract_envelopes)


@dataclass
class ScenarioSpec:
    """One canned scenario: traffic shape + plan + budgets."""

    name: str
    plan: FaultPlan
    clients: int = 4                 # validators driving traffic
    target_heights: int = 5
    tick: float = 0.01
    net_latency: float = 0.02
    engine_latency: float = 0.05
    payload_mix: tuple = (32, 128, 512)   # proposal sizes, cycled
    tamper_every: int = 25           # tamper lane cadence (pre-pass calls)
    sidecar: bool = False            # verify through verifyd + RemoteCSP
    replicas: int = 1                # verifyd fleet size (sidecar only)
    key_cache_size: int = 0          # pinned-key LRU capacity (0 = off)
    # coalescer overload plane: global (low, high, hard)
    # pending-lane watermarks and the per-tenant pending shed mark —
    # passed straight to each replica's VerifydServer
    watermarks: Optional[tuple] = None
    tenant_watermark: int = 0
    max_virtual_s: float = 120.0
    max_wall_s: float = 180.0
    recovery_grace_s: float = 10.0   # virtual tail after the horizon
    budgets: dict = field(default_factory=dict)
    # budgets keys (defaults in chaos_spec): recovery_s,
    # fallback_batches, virtual_s_per_height, deadline_expirations;
    # the presence of storm_vote_rtt_p99_ms arms the storm objectives
    # (storm_shed_ratio optional alongside it); the presence of
    # rewarm_sent_keys arms the warm-handoff rewarm objective


def chaos_spec(spec: ScenarioSpec) -> list:
    """The chaos objective spec: liveness, safety, degraded mode.

    Value-source objectives bind the runner's virtual measurements at
    fleet scope (per-process sub-verdicts skip them cleanly); the
    deadline objective is gauge-source and gated on
    ``verifyd_requests_total`` so it binds only on daemons."""
    from bdls_tpu_torch.utils import slo

    b = spec.budgets
    objectives = [
        slo.Objective(
            name="liveness_heights", source="value",
            target="heights_decided", stat="value", op=">=",
            threshold=float(spec.target_heights), unit="heights",
            description="every node's decided height reaches the "
                        "scenario target despite the fault windows"),
        slo.Objective(
            name="all_windows_recovered", source="value",
            target="unrecovered_windows", stat="value", op="<=",
            threshold=0.0, unit="windows",
            description="heights advance after EVERY fault window "
                        "(liveness recovery, not just eventual totals)"),
        slo.Objective(
            name="recovery_within_budget", source="value",
            target="recovery_s", stat="value", op="<=",
            threshold=float(b.get("recovery_s", 30.0)), unit="s",
            description="worst virtual time from a window closing to "
                        "the fleet min height advancing again"),
        slo.Objective(
            name="no_divergent_commits", source="value",
            target="fork_heights", stat="value", op="<=",
            threshold=0.0, unit="heights",
            description="safety: no height where two nodes committed "
                        "different states"),
        slo.Objective(
            name="tamper_always_rejected", source="value",
            target="tamper_accepts", stat="value", op="<=",
            threshold=0.0, unit="envelopes",
            description="safety: tampered envelopes rejected even "
                        "mid-fault (the verify plane never fails open)"),
        slo.Objective(
            name="bounded_fallbacks", source="value",
            target="fallback_batches", stat="value", op="<=",
            threshold=float(b.get("fallback_batches", 0.0)),
            unit="batches",
            description="degraded mode: local-sw fallbacks stay inside "
                        "the scenario budget (0 when no sidecar dies)"),
        slo.Objective(
            name="round_latency_budget", source="value",
            target="virtual_s_per_height", stat="value", op="<=",
            threshold=float(b.get("virtual_s_per_height", 2.0)),
            unit="s/height",
            description="virtual round latency under fault stays "
                        "inside the per-scenario budget"),
        slo.Objective(
            name="deadline_expirations_bounded", source="gauge",
            target="verifyd_deadline_expirations_total", stat="value",
            op="<=", threshold=float(b.get("deadline_expirations", 64.0)),
            unit="batches", gate="verifyd_requests_total",
            description="server-side deadline verdicts stay bounded "
                        "(binds only on verifyd daemons)"),
        slo.Objective(
            name="no_lost_requests", source="value",
            target="requests_lost", stat="value", op="<=",
            threshold=0.0, unit="batches",
            description="every pre-pass verify call is answered — "
                        "failover/fallback may degrade a batch, but a "
                        "rolling restart must never LOSE one"),
        slo.Objective(
            name="series_recovery_within_budget", source="value",
            target="series_recovery_s", stat="value", op="<=",
            threshold=float(b.get("recovery_s", 30.0)), unit="s",
            description="recovery re-derived from the chaos_min_height "
                        "time series (the flight recorder) — the "
                        "trajectory judgment must agree with the "
                        "timeline-derived recovery"),
    ]
    if "storm_vote_rtt_p99_ms" in b:
        # the endorsement-storm judgment: only armed when
        # the scenario budgets carry the storm keys, so every other
        # scenario's spec is unchanged
        objectives += [
            slo.Objective(
                name="storm_vote_rtt_within_budget", source="value",
                target="storm_vote_rtt_p99_ms", stat="value", op="<=",
                threshold=float(b["storm_vote_rtt_p99_ms"]), unit="ms",
                description="modeled vote-lane p99 RTT (dispatch floor "
                            "+ quorum lanes + storm lanes ADMITTED to "
                            "the remote firehose) stays inside the "
                            "round budget while the storm rages"),
            slo.Objective(
                name="storm_shed_ratio_bounded", source="value",
                target="storm_shed_ratio", stat="value", op="<=",
                threshold=float(b.get("storm_shed_ratio", 0.5)),
                unit="ratio",
                description="the watermarks shed enough to protect the "
                            "daemon, and the brownout tiers keep the "
                            "remote shed share bounded (the breaker "
                            "degrades the rest locally)"),
            slo.Objective(
                name="storm_votes_never_shed", source="value",
                target="storm_vote_sheds", stat="value", op="<=",
                threshold=0.0, unit="batches",
                description="every daemon-side shed is accounted to the "
                            "storm tenant's client — vote-class batches "
                            "are never shed, by construction"),
            slo.Objective(
                name="storm_no_lost_batches", source="value",
                target="storm_lost", stat="value", op="<=",
                threshold=0.0, unit="batches",
                description="every storm batch is answered — SHED "
                            "verdict or brownout-local verify, never "
                            "dropped"),
        ]
    if "storm_block_bad" in b:
        # the block-lane judgment: only armed when the
        # scenario budgets carry the key, so every other scenario's
        # spec is unchanged
        objectives.append(
            slo.Objective(
                name="storm_blocks_all_valid", source="value",
                target="storm_block_bad", stat="value", op="<=",
                threshold=float(b["storm_block_bad"]), unit="blocks",
                description="every whole-block verdict through the "
                            "verifyd block lane matches the host "
                            "oracle's per-tx TXFLAG vector — admitted "
                            "remotely or answered by the local "
                            "fallback, never wrong and never lost"))
    if "shed_onset_lag_s" in b:
        # the trajectory judgment: shed onset and clear are
        # read off the verifyd shed-counter time series sampled on the
        # virtual clock, not from end-of-run counters — armed by the
        # incident budget keys so other scenarios' specs are unchanged
        objectives += [
            slo.Objective(
                name="storm_shed_onset_within_budget", source="value",
                target="shed_onset_lag_s", stat="value", op="<=",
                threshold=float(b["shed_onset_lag_s"]), unit="s",
                description="virtual seconds from the surge window "
                            "opening to the first shed sample on the "
                            "daemon shed-counter series — the overload "
                            "plane engages within budget"),
            slo.Objective(
                name="storm_shed_cleared_within_budget", source="value",
                target="shed_clear_s", stat="value", op="<=",
                threshold=float(b.get("shed_clear_s", 30.0)), unit="s",
                description="virtual timestamp of the shed incident "
                            "clearing (first quiet sample after the "
                            "last shed) stays inside the budget — the "
                            "storm does not smear past its windows"),
        ]
    if "rewarm_sent_keys" in b:
        # the warm-handoff judgment: only armed when the
        # scenario budgets carry the key (rolling_restart), so every
        # other scenario's spec is unchanged
        objectives.append(
            slo.Objective(
                name="rewarm_within_budget", source="value",
                target="rewarm_sent_keys", stat="value", op="<=",
                threshold=float(b["rewarm_sent_keys"]), unit="keys",
                description="reconnect rewarms that actually re-sent "
                            "key material stay inside the budget — a "
                            "restarted replica restores its warmth "
                            "from the handoff snapshot, so the client "
                            "re-transmits only the delta (0 when the "
                            "handoff plane works)"))
    return objectives


# ------------------------------------------------------ sidecar control

class SidecarController:
    """kill()/restart() seam for ``sidecar.kill``: stop the daemon,
    bring a fresh one up on the SAME port at window end, and block
    (wall-bounded) until the client's redialer has latched back on —
    post-window traffic deterministically rides the daemon again.

    One difference from the reference, in wall time: a daemon the client
    was not connected to when it was killed (in the catalog, a replica
    no lane hashed to) is not waited for. Nothing dials a replica no
    lane is routed to while the drive loop sits in :meth:`restart`, so
    there the reference waits out the whole 15 s bound and then goes on
    as the port does at once.
    """

    def __init__(self, make_server, wait_latch=None):
        self._make = make_server
        self.server = make_server(0).start()
        self.port = self.server.port
        self.remote = None  # RemoteCSP, attached by the runner
        # fleet runs override the latch: "connected" must mean THIS
        # replica's channel, not any-replica-up
        self.wait_latch = wait_latch
        self.kills = 0
        self.restarts = 0
        self._was_latched = True

    def _latched(self) -> bool:
        if self.wait_latch is not None:
            return self.wait_latch()
        return self.remote is None or self.remote.connected

    def kill(self) -> None:
        self.kills += 1
        self._was_latched = self._latched()
        self.server.stop()

    def restart(self) -> None:
        self.restarts += 1
        self.server = self._make(self.port).start()
        if not self._was_latched:
            return
        deadline = time.perf_counter() + 15.0
        while not self._latched() and time.perf_counter() < deadline:
            time.sleep(0.01)

    def close(self) -> None:
        try:
            self.server.stop()
        except Exception:  # noqa: BLE001 — already dead is fine
            pass


class FleetSidecarController:
    """The rolling-restart seam: N independent same-port controllers,
    addressed per replica by ``sidecar.kill`` events carrying a
    ``replica`` param. ``kill()``/``restart()`` without an index keep
    the single-daemon contract (replica 0)."""

    def __init__(self, controllers: list):
        self.controllers = controllers

    @property
    def ports(self) -> list[int]:
        return [c.port for c in self.controllers]

    @property
    def kills(self) -> int:
        return sum(c.kills for c in self.controllers)

    @property
    def restarts(self) -> int:
        return sum(c.restarts for c in self.controllers)

    def kill(self, replica: int = 0) -> None:
        self.controllers[replica].kill()

    def restart(self, replica: int = 0) -> None:
        self.controllers[replica].restart()

    def close(self) -> None:
        for c in self.controllers:
            c.close()


# -------------------------------------------------------------- scoring

def _recoveries(timeline, windows):
    """Per fault window: (start, end, height_at_end, recovery_s|None).
    Recovery = first timeline point after the window where the fleet
    min height exceeds its value at window close."""
    out = []
    for start, end, _ev in windows:
        h_end = 0
        for t, h in timeline:
            if t > end:
                break
            h_end = h
        rec = None
        for t, h in timeline:
            if t > end and h > h_end:
                rec = round(t - end, 6)
                break
        out.append((start, end, h_end, rec))
    return out


def _metric_value(metrics, fqname: str) -> float:
    inst = metrics.find(fqname)
    if inst is None:
        return 0.0
    try:
        return float(inst.value())
    except Exception:  # noqa: BLE001 — histograms etc.
        return 0.0


def _label_value(metrics, fqname: str, labels: tuple) -> float:
    """One label set's value on a labeled counter/gauge (0.0 when the
    instrument or the label set was never observed)."""
    inst = metrics.find(fqname)
    if inst is None:
        return 0.0
    try:
        return float(inst.value(labels))
    except Exception:  # noqa: BLE001 — unlabeled instrument
        return 0.0


# ----------------------------------------------------- envelope plumbing

def _tampered(env):
    """A bit-flipped copy: same key, same payload, corrupt signature —
    the tamper lane the safety objective watches."""
    bad = W.copy_envelope(env)
    sig = bytearray(bad.sig_s or b"\x00" * 32)
    sig[-1] ^= 0x01
    bad.sig_s = bytes(sig)
    return bad


# --------------------------------------------------------------- runner

def run_scenario(spec: ScenarioSpec, inject_regression: bool = False,
                 device=None, kernel_field: Optional[str] = None) -> dict:
    """Run one scenario; returns the record (``ok`` is the
    ``evaluate_fleet`` verdict). ``inject_regression`` inflates the
    degraded-mode values past their budgets after the run — the
    provably-flips-the-verdict variant.

    Every provider of the run — the client's, or each verifyd replica's
    — is its own ``TorchCSP(device=device, kernel_field=kernel_field)``:
    by default the card (raising where there is none); the host run is
    ``device="cpu", kernel_field="sw"``."""
    from bdls_tpu_torch.consensus import Config, Consensus, Signer
    from bdls_tpu_torch.consensus.ipc import VirtualNetwork
    from bdls_tpu_torch.consensus.verifier import CspBatchVerifier
    from bdls_tpu_torch.crypto.torch_provider import TorchCSP
    from bdls_tpu_torch.obs.collector import Endpoint, FleetCollector
    from bdls_tpu_torch.obs.detect import incidents_from_counter
    from bdls_tpu_torch.obs.tsdb import TimeSeriesDB
    from bdls_tpu_torch.utils import tracing
    from bdls_tpu_torch.utils.device import resolve_device
    from bdls_tpu_torch.utils.metrics import MetricOpts, MetricsProvider

    t_wall0 = time.perf_counter()
    plan = spec.plan.validate()
    n = spec.clients
    # no card and none asked for: raise before anything is started
    device = resolve_device(device)

    def provider(metrics, tracer) -> TorchCSP:
        return TorchCSP(device=device, kernel_field=kernel_field,
                        key_cache_size=spec.key_cache_size,
                        metrics=metrics, tracer=tracer)

    client_metrics = MetricsProvider()
    client_tracer = tracing.Tracer(metrics=client_metrics)
    # the flight recorder: one tsdb per "process" registry, driven by
    # maybe_sample(net.now) each tick — virtual-clock series,
    # bit-identical across reruns for every deterministically-updated
    # instrument (wall-clock-fed series ride along as evidence only)
    g_minh = client_metrics.new_gauge(MetricOpts(
        namespace="chaos", name="min_height",
        help="Fleet min decided height per virtual tick (the recovery "
             "trajectory the series objectives re-judge)."))
    tsdbs: dict[str, TimeSeriesDB] = {
        "client": TimeSeriesDB(client_metrics, interval=spec.tick,
                               process="client"),
    }

    # ---- the provider under test -------------------------------------
    daemons: list[tuple] = []  # (metrics, tracer, csp) per replica
    ctl = None
    remote = None
    warm_dir = None
    storm_metrics = storm_remote = storm_verifier = None
    block_metrics = block_remote = None
    if spec.sidecar:
        from bdls_tpu_torch.sidecar.remote_csp import RemoteCSP
        from bdls_tpu_torch.sidecar.verifyd import VerifydServer

        n_rep = max(1, int(spec.replicas))
        if n_rep > 1 and spec.key_cache_size:
            # warm handoff: each replica gets a stable snapshot path — a
            # restarting daemon writes its pinned warmth on stop and its
            # successor restores it on start, so the client's reconnect
            # rewarm re-sends only the delta
            warm_dir = tempfile.mkdtemp(prefix="bdls_chaos_warm_")
        controllers: list[SidecarController] = []
        for _ri in range(n_rep):
            d_metrics = MetricsProvider()
            d_tracer = tracing.Tracer(metrics=d_metrics)
            d_csp = provider(d_metrics, d_tracer)
            daemons.append((d_metrics, d_tracer, d_csp))
            snap_path = (os.path.join(warm_dir, f"warm_{_ri}.npz")
                         if warm_dir else None)

            def make_server(port: int, _csp=d_csp, _m=d_metrics,
                            _t=d_tracer, _snap=snap_path) -> VerifydServer:
                return VerifydServer(
                    csp=_csp, transport="socket", port=port,
                    ops_port=None, flush_interval=0.001,
                    watermarks=spec.watermarks,
                    tenant_watermark=spec.tenant_watermark,
                    warm_snapshot=_snap,
                    metrics=_m, tracer=_t)

            controllers.append(SidecarController(make_server))
            tsdbs[f"verifyd-{_ri}" if n_rep > 1 else "verifyd"] = (
                TimeSeriesDB(d_metrics, interval=spec.tick,
                             process=f"verifyd-{_ri}"))
        chaos_csp = daemons[0][2]
        fleet_eps = [f"127.0.0.1:{c.port}" for c in controllers]
        remote = RemoteCSP(
            endpoint=fleet_eps, transport="socket",
            tenant=spec.name or "chaos", request_timeout=2.0,
            retry_backoff=(0.02, 0.25), metrics=client_metrics,
            tracer=client_tracer)
        for c, ep in zip(controllers, fleet_eps):
            c.remote = remote
            # a restarted replica is "back" when ITS channel latched,
            # not when any fleet session happens to be up
            c.wait_latch = (
                lambda _ep=ep: remote.replica_connected(_ep))
        ctl = (controllers[0] if n_rep == 1
               else FleetSidecarController(controllers))
        pre_verifier = CspBatchVerifier(remote)
        if any(ev.kind == "load.surge" for ev in plan.events):
            # the endorsement-storm committer: its OWN RemoteCSP with its
            # own metrics registry (the main client's fallback objective
            # stays unpolluted) and NO quorum hint, so its batches are
            # firehose-class. The brownout hold-down is pinned longer
            # than any wall run: no half-open probe fires mid-run, so
            # the shed count is exactly brownout_threshold and the tier
            # walk replays bit-identically
            storm_metrics = MetricsProvider()
            storm_remote = RemoteCSP(
                endpoint=fleet_eps, transport="socket",
                tenant="endorser", request_timeout=2.0,
                retry_backoff=(0.02, 0.25),
                brownout_threshold=3, brownout_hold=600.0,
                metrics=storm_metrics,
                tracer=tracing.Tracer(metrics=storm_metrics))
            storm_verifier = CspBatchVerifier(storm_remote)
            tsdbs["storm-client"] = TimeSeriesDB(
                storm_metrics, interval=spec.tick,
                process="storm-client")
            # the block lane: a committer client with its OWN registry
            # and breaker submits one whole-block VerifyBlockRequest per
            # wave through the daemon's block lane. Separate client on
            # purpose: block admissions must never reset the storm
            # client's consecutive-shed walk, so the shed/brownout
            # replay stays bit-identical with the block lane live.
            # Blocks are sized under the tenant watermark, so they are
            # ADMITTED while the 500-lane firehose batches shed — votes
            # and blocks both keep flowing. Judged values are
            # flag-correctness counts (flags are deterministic whether
            # the verdict came remotely or via the local fallback),
            # never wall-clock.
            block_metrics = MetricsProvider()
            block_remote = RemoteCSP(
                endpoint=fleet_eps, transport="socket",
                tenant="committer", request_timeout=2.0,
                retry_backoff=(0.02, 0.25),
                metrics=block_metrics,
                tracer=tracing.Tracer(metrics=block_metrics))
    else:
        chaos_csp = provider(client_metrics, client_tracer)
        pre_verifier = CspBatchVerifier(chaos_csp)

    # ---- the cluster -------------------------------------------------
    signers = [Signer.from_scalar(0x6000 + i) for i in range(n)]
    participants = [s.identity for s in signers]
    if spec.key_cache_size:
        # consenters resident from round one — churn waves then fight
        # them for LRU slots (synchronous so the start state replays)
        from bdls_tpu_torch.consensus.verifier import identity_keys

        keys = identity_keys(participants)
        if len(daemons) > 1:
            # fleet: warm over the wire so the hash ring partitions
            # the consenter set across replica caches
            remote.warm_keys(keys)
        else:
            chaos_csp.warm_keys(keys, wait=True)
    net = VirtualNetwork(seed=plan.seed, latency=spec.net_latency)
    cache: dict = {}
    for s in signers:
        cfg = Config(
            epoch=0.0,
            signer=s,
            participants=participants,
            state_compare=lambda a, b: (a > b) - (a < b),
            state_validate=lambda s_, h_: True,
            latency=spec.engine_latency,
            verifier=CacheVerifier(cache, pre_verifier),
        )
        net.add_node(Consensus(cfg))
    net.connect_all()

    # ---- chaos engine ------------------------------------------------
    def churn_hook(params: dict, wave: int) -> None:
        stride = int(params.get("stride", 101))
        nkeys = int(params["keys"])
        base = 0x7000 + wave * stride
        keys = [chaos_csp.key_from_scalar("secp256k1", base + i)
                .public_key() for i in range(nkeys)]
        chaos_csp.warm_keys(keys, wait=True)

    storm = {"waves": 0, "batches": 0, "lanes": 0, "lost": 0,
             "wall_s": 0.0, "blocks": 0, "block_ok": 0, "block_lanes": 0,
             "block_wall_s": 0.0}
    storm_envs: list = []
    storm_block: list = []  # [(BlockVerifyRequest, expected flags)]

    def _make_storm_block():
        """One deterministic 4-tx x 3-org endorsement block: three
        endorser keys each sign every tx's raw payload, the first
        three policies are satisfiable 2-of-3, the last demands an org
        outside its counting set — so the expected TXFLAG vector
        exercises both verdicts. Lane count (12) stays far under the
        tenant watermark: blocks are ADMITTED while the firehose
        sheds."""
        from bdls_tpu_torch.crypto import blocklane

        ntx, norg = 4, 3
        keys = [chaos_csp.key_from_scalar("secp256k1", 0x9100 + o)
                for o in range(norg)]
        lanes = []
        for t in range(ntx):
            msg = b"chaos-block|tx%02d|" % t + bytes(16)
            digest = chaos_csp.hash(msg)
            for o, kh in enumerate(keys):
                r, s = chaos_csp.sign(kh, digest)
                pub = kh.public_key()
                lanes.append(blocklane.BlockLane(
                    msg=msg,
                    qx=pub.x.to_bytes(32, "big"),
                    qy=pub.y.to_bytes(32, "big"),
                    r=r.to_bytes(32, "big"), s=s.to_bytes(32, "big"),
                    tx=t, org=o))
        policies = tuple(
            [blocklane.BlockPolicy(required=2, orgs=())] * (ntx - 1)
            + [blocklane.BlockPolicy(required=1, orgs=(norg,))])
        req = blocklane.BlockVerifyRequest(
            curve="secp256k1", lanes=tuple(lanes), policies=policies,
            norgs=norg)
        want = ([blocklane.TXFLAG_VALID] * (ntx - 1)
                + [blocklane.TXFLAG_POLICY_FAILURE])
        return req, want

    def surge_hook(params: dict, wave: int) -> None:
        # one endorsement wave: per block, one committer batch per
        # endorsement SLOT (an N-of-M policy needs N=policy slots), each
        # batch carrying one endorsement lane per tx — lanes cycle the M
        # endorser envelopes, so signing cost is M once, not txs*policy
        # per wave
        blocks = int(params.get("blocks", 1))
        txs = int(params.get("txs", 500))
        policy = int(params.get("policy", 2))
        if not storm_envs:
            endorsers = [Signer.from_scalar(0x8000 + i)
                         for i in range(int(params.get("endorsers", 3)))]
            manifest = b"endorse|" + bytes(24)
            storm_envs.extend(s.sign_payload(manifest)
                              for s in endorsers)
        storm["waves"] += 1
        for _b in range(blocks * policy):
            batch = [storm_envs[(i + _b) % len(storm_envs)]
                     for i in range(txs)]
            storm["batches"] += 1
            storm["lanes"] += len(batch)
            t0 = time.perf_counter()
            oks = None
            try:
                oks = storm_verifier.verify_envelopes(batch)
            except Exception:  # noqa: BLE001 — a LOST storm batch
                pass
            storm["wall_s"] += time.perf_counter() - t0
            if oks is None or len(oks) != len(batch):
                storm["lost"] += 1
        if block_remote is not None:
            # one whole block through the verifyd block lane per wave
            if not storm_block:
                storm_block.append(_make_storm_block())
            req, want = storm_block[0]
            storm["blocks"] += 1
            storm["block_lanes"] += len(req.lanes)
            t0 = time.perf_counter()
            flags = None
            try:
                flags = block_remote.verify_block(req)
            except Exception:  # noqa: BLE001 — a bad block verdict
                pass
            storm["block_wall_s"] += time.perf_counter() - t0
            if flags is not None and [int(f) for f in flags] == want:
                storm["block_ok"] += 1

    ctx = ChaosContext(
        net=net, sidecar=ctl, csp=chaos_csp, churn=churn_hook,
        surge=surge_hook if storm_verifier is not None else None)
    engine = ChaosEngine(plan, ctx, metrics=client_metrics)
    windows = plan.windows()
    horizon = plan.horizon()

    # ---- the drive loop ----------------------------------------------
    seen: set = set()
    timeline: list[tuple[float, int]] = []
    decided: dict[int, set] = {}
    last_h = [0] * n
    pre_calls = tamper_attempts = tamper_accepts = lost_calls = 0
    timed_out = False
    try:
        while net.now < spec.max_virtual_s:
            if time.perf_counter() - t_wall0 > spec.max_wall_s:
                timed_out = True
                break
            engine.step(net.now)
            t_next = round(net.now + spec.tick, 9)
            # sidecar pre-pass: every envelope deliverable this tick,
            # proofs included, in ONE provider call
            batch: list = []
            for deliver_at, _, dst, data, *_rest in net.due_frames(t_next):
                if not net._down(dst):
                    extract_envelopes(data, batch, seen)
            if batch:
                pre_calls += 1
                oks = None
                try:
                    oks = pre_verifier.verify_envelopes(batch)
                except Exception:  # noqa: BLE001 — a LOST call
                    pass
                if oks is None or len(oks) != len(batch):
                    # the no-lost-requests objective: the provider
                    # stack must always answer (failover or fallback),
                    # never raise or short-change a batch
                    lost_calls += 1
                else:
                    for env, ok in zip(batch, oks):
                        cache[_env_key(env)] = ok
                    if spec.tamper_every and (
                            pre_calls % spec.tamper_every == 0):
                        tamper_attempts += 1
                        bad = _tampered(batch[0])
                        if pre_verifier.verify_envelopes([bad])[0]:
                            tamper_accepts += 1
            net.run_until(t_next, tick=spec.tick)
            for i, node in enumerate(net.nodes):
                h = node.latest_height
                if h > last_h[i]:
                    decided.setdefault(h, set()).add(
                        bytes(node.latest_state or b""))
                    last_h[i] = h
            minh = min(net.heights())
            timeline.append((round(net.now, 9), minh))
            # flight recorder tick: sample every registry on the
            # virtual clock. Storm/pre-pass verify calls are
            # synchronous inside engine.step / the pre-pass above, so
            # counter deltas land at deterministic virtual timestamps
            g_minh.set(float(minh))
            t_sample = round(net.now, 9)
            for db in tsdbs.values():
                db.maybe_sample(t_sample)
            # the firehose: always data to order, sized by the mix
            for i, node in enumerate(net.nodes):
                if net._down(i):
                    continue
                h_next = node.latest_height + 1
                size = spec.payload_mix[h_next % len(spec.payload_mix)]
                state = (b"h%08d|" % h_next).ljust(max(10, size), b"s")
                node.propose(state)
            if minh >= spec.target_heights and net.now > horizon:
                recs = _recoveries(timeline, windows)
                if (all(r[3] is not None for r in recs)
                        or net.now > horizon + spec.recovery_grace_s):
                    break
    finally:
        engine.finish(net.now)

    # ---- score -------------------------------------------------------
    recs = _recoveries(timeline, windows)
    heights = min(net.heights())
    values = {
        "heights_decided": float(heights),
        "unrecovered_windows": float(
            sum(1 for r in recs if r[3] is None)),
        "recovery_s": max((r[3] for r in recs if r[3] is not None),
                          default=0.0),
        "fork_heights": float(
            sum(1 for states in decided.values() if len(states) > 1)),
        "tamper_accepts": float(tamper_accepts),
        "fallback_batches": _metric_value(
            client_metrics, "verifyd_client_fallbacks_total"),
        "virtual_s_per_height": round(net.now / max(1, heights), 4),
        "requests_lost": float(lost_calls),
    }
    # trajectory judgment: recovery re-derived from the chaos_min_height
    # series — same math as the timeline, but read from the flight
    # recorder, proving the series plane carries the judgment (and
    # agrees with the counter plane)
    series_pts = tsdbs["client"].range("chaos_min_height")
    series_recs = _recoveries(series_pts, windows)
    values["series_recovery_s"] = max(
        (r[3] for r in series_recs if r[3] is not None), default=0.0)
    if "rewarm_sent_keys" in spec.budgets:
        # keys the reconnect rewarm actually RE-SENT across the whole
        # motion (the handoff snapshot makes this 0; without it every
        # restarted replica's hash range is re-transmitted)
        values["rewarm_sent_keys"] = _metric_value(
            client_metrics, "verifyd_client_rewarm_sent_total")
    # incident timeline: counter-onset detection over the
    # deterministically-sampled series (daemon sheds + client
    # fallbacks). Queue-depth/ewma detection stays out of the record —
    # the depth gauge is flusher-timing-dependent, evidence only.
    incidents: list = []
    if spec.sidecar:
        merged_shed: dict[float, float] = {}
        for nm, db in tsdbs.items():
            if not nm.startswith("verifyd"):
                continue
            for t, v in db.range("verifyd_shed_total"):
                merged_shed[t] = merged_shed.get(t, 0.0) + v
        for inc in incidents_from_counter(
                sorted(merged_shed.items()),
                signal="verifyd_shed_total"):
            inc["process"] = "verifyd"
            incidents.append(inc)
        for nm in ("client", "storm-client"):
            db = tsdbs.get(nm)
            if db is None:
                continue
            for inc in incidents_from_counter(
                    db.range("verifyd_client_fallbacks_total"),
                    signal="verifyd_client_fallbacks_total"):
                inc["process"] = nm
                incidents.append(inc)
        incidents.sort(
            key=lambda i: (i["onset"], i["process"], i["signal"]))
    daemon_sheds = client_sheds = admitted_lanes = 0.0
    if storm_verifier is not None:
        # every judged storm value is a deterministic count or a model
        # over deterministic counts — never a wall-clock measurement
        # (the live wall RTT rides the record, non-judged)
        daemon_sheds = sum(
            _metric_value(d_m, "verifyd_shed_total")
            for d_m, _t, _c in daemons)
        client_sheds = _label_value(
            storm_metrics, "verifyd_client_fallbacks_total", ("shed",))
        admitted_lanes = sum(
            _label_value(d_m, "verifyd_lanes_total", ("endorser",))
            for d_m, _t, _c in daemons)
        # modeled vote RTT during the storm: the dispatch floor plus
        # one lane per quorum signature, plus every storm lane the
        # daemon ADMITTED to the remote firehose (0 when the watermark
        # sheds them all — the whole point of the overload plane);
        # same constants as the committee-growth cost model
        values.update({
            "storm_batches": float(storm["batches"]),
            "storm_shed_batches": float(client_sheds),
            "storm_shed_ratio": round(
                client_sheds / max(1, storm["batches"]), 4),
            "storm_vote_sheds": float(daemon_sheds - client_sheds),
            "storm_vote_rtt_p99_ms": round(
                GROWTH_DISPATCH_FLOOR_MS + GROWTH_PER_LANE_MS
                * (growth_quorum(n) + admitted_lanes), 2),
            "storm_lost": float(storm["lost"]),
        })
    if block_remote is not None:
        # the block lane's judged values: counts and a virtual-window
        # rate — blocks whose TXFLAG vector matched the oracle, per
        # virtual second of surge window. Deterministic by
        # construction: the wave count is plan-driven and the flag
        # vector is the same whether the verdict came over the wire or
        # via the client's local fallback.
        surge_window_s = sum(
            ev.duration for ev in plan.events if ev.kind == "load.surge")
        values.update({
            "storm_blocks": float(storm["blocks"]),
            "storm_block_bad": float(storm["blocks"] - storm["block_ok"]),
            "storm_blocks_per_s": round(
                storm["block_ok"] / max(surge_window_s, spec.tick), 4),
        })
    if "shed_onset_lag_s" in spec.budgets:
        # shed onset/clear read off the daemon shed-counter series —
        # the deterministic incident timeline. No incident means the
        # overload plane never engaged: both values saturate to the
        # horizon so the objectives fail loudly instead of vacuously
        # passing
        surge_start = min(
            (ev.at for ev in plan.events if ev.kind == "load.surge"),
            default=0.0)
        shed_incs = [i for i in incidents
                     if i["signal"] == "verifyd_shed_total"]
        if shed_incs:
            onset = shed_incs[0]["onset"]
            clears = [i["clear"] for i in shed_incs]
            clear = (max(c for c in clears if c is not None)
                     if any(c is not None for c in clears)
                     else float(spec.max_virtual_s))
            values["shed_onset_s"] = onset
            values["shed_onset_lag_s"] = round(onset - surge_start, 9)
            values["shed_clear_s"] = clear
        else:
            values["shed_onset_s"] = float(spec.max_virtual_s)
            values["shed_onset_lag_s"] = float(spec.max_virtual_s)
            values["shed_clear_s"] = float(spec.max_virtual_s)
    if inject_regression:
        _inject_regression(spec.budgets, values, incidents)

    objectives = chaos_spec(spec)
    endpoints = [Endpoint("client", tracer=client_tracer,
                          metrics=client_metrics)]
    for ri, (d_metrics, d_tracer, _csp) in enumerate(daemons):
        nm = "verifyd" if len(daemons) == 1 else f"verifyd-{ri}"
        endpoints.append(Endpoint(nm, tracer=d_tracer,
                                  metrics=d_metrics))
    snap = FleetCollector(endpoints, limit=64,
                          spec=objectives).scrape(values=values)
    verdict = snap.verdict

    digest = hashlib.sha256(json.dumps(
        {"timeline": timeline, "heights": net.heights(),
         "values": values, "incidents": incidents},
        sort_keys=True).encode()).hexdigest()

    record = {
        "name": spec.name,
        "seed": plan.seed,
        "ok": bool(verdict["ok"]) and not timed_out,
        "injected_regression": bool(inject_regression),
        "timed_out": timed_out,
        "values": values,
        "budgets": dict(spec.budgets),
        "heights": net.heights(),
        "virtual_s": round(net.now, 4),
        "wall_s": round(time.perf_counter() - t_wall0, 2),
        "pre_pass_calls": pre_calls,
        "tamper_attempts": tamper_attempts,
        "net": {"tx_msgs": net.tx_msgs, "dropped": net.dropped_msgs,
                "dup": net.dup_msgs, "reordered": net.reordered_msgs},
        "faults": engine.records,
        "recoveries": [
            {"start": s, "end": e, "height_at_end": h,
             "recovery_s": r} for s, e, h, r in recs],
        "timeline_digest": digest,
        "incidents": incidents,
        "tsdb": {
            "interval_s": spec.tick,
            "samples": {nm: db.samples_taken
                        for nm, db in sorted(tsdbs.items())},
            "series": {nm: len(db.series_keys())
                       for nm, db in sorted(tsdbs.items())},
        },
        "slo": verdict,
        "fleet": snap.summary(),
        "provider": {"device": str(device),
                     "kernel_field": chaos_csp.kernel_field},
    }
    if spec.sidecar:
        record["sidecar"] = {
            "kills": ctl.kills, "restarts": ctl.restarts,
            "deadline_expirations": sum(
                _metric_value(d_m, "verifyd_deadline_expirations_total")
                for d_m, _t, _c in daemons),
        }
        if len(daemons) > 1:
            # fleet shape: per-replica pinned residency proves the ring
            # partitioned (no SKI should be resident twice)
            record["sidecar"]["replicas"] = len(daemons)
            record["sidecar"]["pinned_keys"] = [
                (len(c.key_cache) if c.key_cache is not None else 0)
                for _m, _t, c in daemons]
            record["sidecar"]["rewarms"] = _metric_value(
                client_metrics, "verifyd_client_rewarm_total")
            record["sidecar"]["rewarms_sent"] = _metric_value(
                client_metrics, "verifyd_client_rewarm_sent_total")
            record["sidecar"]["rewarms_skipped"] = _metric_value(
                client_metrics, "verifyd_client_rewarm_skipped_total")
            record["sidecar"]["handoff_snapshot"] = bool(
                remote.last_handoff_snapshot)
    if storm_verifier is not None:
        record["storm"] = {
            "waves": storm["waves"],
            "batches": storm["batches"],
            "lanes": storm["lanes"],
            "daemon_sheds": daemon_sheds,
            "client_shed_fallbacks": client_sheds,
            "brownout_fallbacks": _label_value(
                storm_metrics, "verifyd_client_fallbacks_total",
                ("brownout",)),
            "admitted_lanes": admitted_lanes,
            # live wall time spent in storm verify calls — evidence,
            # never judged (wall clock is not deterministic)
            "wall_s": round(storm["wall_s"], 3),
            "brownout": storm_remote.brownout_snapshot(),
        }
        if block_remote is not None:
            # block-lane evidence: the remote vs fallback split is
            # wall-timing-dependent, so it rides the record un-judged;
            # the judged flag-correctness counts live in ``values``
            record["storm"]["blocks"] = {
                "submitted": storm["blocks"],
                "flag_matches": storm["block_ok"],
                "lanes": storm["block_lanes"],
                "wall_s": round(storm["block_wall_s"], 3),
                "remote": _metric_value(
                    block_metrics, "verifyd_client_remote_total"),
                "fallbacks": _metric_value(
                    block_metrics, "verifyd_client_fallbacks_total"),
            }

    # ---- teardown ----------------------------------------------------
    if block_remote is not None:
        block_remote.close()
    if storm_remote is not None:
        storm_remote.close()
    if remote is not None:
        remote.close()
    if ctl is not None:
        ctl.close()
    if daemons:
        for _m, _t, c in daemons:
            c.close()
    else:
        chaos_csp.close()
    if warm_dir is not None:
        shutil.rmtree(warm_dir, ignore_errors=True)
    return record


def _inject_regression(b: dict, values: dict, incidents: list) -> None:
    """The provably-flips variant: bust the degraded-mode budgets ``b``
    in ``values`` (and the shed incident's timeline) in place."""
    values["fallback_batches"] = (
        float(b.get("fallback_batches", 0.0)) + 100.0)
    values["recovery_s"] = (
        2.0 * float(b.get("recovery_s", 30.0)) + 5.0)
    if "storm_vote_rtt_p99_ms" in b:
        # a storm the overload plane failed to absorb: votes queue
        # behind admitted endorsement lanes AND some sheds landed on the
        # vote lane — both storm objectives provably flip
        values["storm_vote_rtt_p99_ms"] = round(
            2.0 * float(b["storm_vote_rtt_p99_ms"]) + 5.0, 2)
        values["storm_vote_sheds"] = 3.0
    if "storm_block_bad" in b:
        # a block lane returning wrong TXFLAG vectors: the
        # flag-correctness objective provably flips
        values["storm_block_bad"] = float(b["storm_block_bad"]) + 2.0
    if "rewarm_sent_keys" in b:
        # a fleet whose handoff plane silently broke: every restart
        # re-transmits its whole hash range and then some
        values["rewarm_sent_keys"] = float(b["rewarm_sent_keys"]) + 25.0
    if "shed_onset_lag_s" in b:
        # late detection that never cleared: shift the shed incident's
        # onset past its budget and leave it unresolved — the recorded
        # timeline provably moves AND extends, and both trajectory
        # objectives flip
        shift = float(b["shed_onset_lag_s"]) + 2.0
        values["shed_onset_lag_s"] = round(
            values.get("shed_onset_lag_s", 0.0) + shift, 9)
        values["shed_clear_s"] = round(
            2.0 * float(b.get("shed_clear_s", 30.0)) + 5.0, 2)
        values["shed_onset_s"] = round(
            values.get("shed_onset_s", 0.0) + shift, 9)
        for inc in incidents:
            if inc["signal"] != "verifyd_shed_total":
                continue
            inc["onset"] = round(inc["onset"] + shift, 9)
            inc["clear"] = None
            inc["duration_s"] = None


# ------------------------------------------------- committee-growth soak
#
# The validator-set growth axis: per-signature proof bundles re-verify
# 2t+1 ECDSA lanes per <decide>, so round verify cost grows with the
# committee; a one-pairing aggregate-BLS certificate is flat in n. Two
# REAL 4-validator anchor clusters (one per vote mode) prove both paths
# live on the wire under the virtual clock, then the committee axis is
# extended 4 -> 128 -> 512 -> 1024 with the deterministic cost model
# below — deterministic numbers, judged by the same fleet SLO plane as
# every other scenario. The constants are the reference's, calibrated
# against its measured dryrun dispatch floor and its docs/PERFORMANCE.md's
# scheme-crossover math (arXiv:2302.00418): per-signature crosses the
# round budget between 128 and 512 validators; aggregate never does.

GROWTH_SIZES = (4, 128, 512, 1024)
GROWTH_BUDGET_MS = 195.0          # per-round certificate verify budget
GROWTH_DISPATCH_FLOOR_MS = 110.0  # fixed dispatch + coalesce cost per round
GROWTH_PER_LANE_MS = 0.3          # marginal ECDSA lane per quorum signature
GROWTH_PAIRING_MS = 38.0          # one pairing in kernel steady state
GROWTH_HASH_MS = 9.0              # hash_to_g2(digest), LRU-amortized
GROWTH_FLATNESS = 1.2             # agg max/min bound across 128 -> 1024


def growth_quorum(n: int) -> int:
    """2t+1 for the largest t with n >= 3t+1 (the BDLS quorum rule)."""
    return 2 * ((n - 1) // 3) + 1


def growth_verify_ms(mode: str, n: int) -> float:
    """Modeled per-round verify cost at committee size ``n``.

    ``per_signature`` pays the dispatch floor plus one lane per quorum
    signature (linear in n); ``aggregate`` pays two pairings plus one
    hash-to-curve regardless of n (the bitmap-keyed aggregated-pubkey
    LRU makes the G1 additions a dict hit in steady state)."""
    if mode == "aggregate":
        return 2 * GROWTH_PAIRING_MS + GROWTH_HASH_MS
    return GROWTH_DISPATCH_FLOOR_MS + growth_quorum(n) * GROWTH_PER_LANE_MS


def _growth_anchor(mode: str, seed: int, target_heights: int = 2,
                   tick: float = 0.01, max_virtual_s: float = 60.0,
                   max_wall_s: float = 120.0) -> dict:
    """One real 4-validator cluster in ``mode``, driven to
    ``target_heights`` on the virtual clock. Returns the anchor
    evidence: decided heights, virtual round latency, fork count, and
    the wire-level decide shape (certificate-carrying vs proof-bundle)
    — the aggregate anchor must decide with certs and ZERO proof
    bundles, or the modeled table above is describing a path that does
    not exist."""
    from bdls_tpu_torch.consensus import Config, Consensus, Signer
    from bdls_tpu_torch.consensus import threshold as TH
    from bdls_tpu_torch.consensus.ipc import VirtualNetwork
    from bdls_tpu_torch.consensus.verifier import CpuBatchVerifier

    t0 = time.perf_counter()
    n = 4
    quorum = growth_quorum(n)
    signers = [Signer.from_scalar(0x6000 + i) for i in range(n)]
    participants = [s.identity for s in signers]
    vote_signers = pks = None
    if mode == "aggregate":
        vote_signers = [TH.VoteSigner.from_seed(i + 1) for i in range(n)]
        pks = [vs.pk for vs in vote_signers]
    net = VirtualNetwork(seed=seed, latency=0.02)
    for i, s in enumerate(signers):
        kw = {}
        if mode == "aggregate":
            kw = dict(vote_mode="aggregate",
                      vote_signer=vote_signers[i],
                      vote_aggregator=TH.ThresholdAggregator(pks, quorum))
        net.add_node(Consensus(Config(
            epoch=0.0, signer=s, participants=participants,
            state_compare=lambda a, b: (a > b) - (a < b),
            state_validate=lambda s_, h_: True,
            latency=0.05, verifier=CpuBatchVerifier(), **kw)))
    net.connect_all()

    cert_decides = proof_decides = 0
    timeline: list[tuple[float, int]] = []
    decided: dict[int, set] = {}
    last_h = [0] * n
    while net.now < max_virtual_s:
        if time.perf_counter() - t0 > max_wall_s:
            break
        t_next = round(net.now + tick, 9)
        # wire-evidence pre-pass: classify every due <decide> by shape
        for _at, _, _dst, data, *_rest in net.due_frames(t_next):
            try:
                msg = W.decode_message(W.decode_envelope(data).payload)
            except W.DecodeError:  # non-envelope frame
                continue
            if msg.type == W.MsgType.DECIDE:
                if msg.commit_cert:
                    cert_decides += 1
                if len(msg.proof):
                    proof_decides += 1
        net.run_until(t_next, tick=tick)
        for i, node in enumerate(net.nodes):
            h = node.latest_height
            if h > last_h[i]:
                decided.setdefault(h, set()).add(
                    bytes(node.latest_state or b""))
                last_h[i] = h
        minh = min(net.heights())
        timeline.append((round(net.now, 9), minh))
        if minh >= target_heights:
            break
        for node in net.nodes:
            h_next = node.latest_height + 1
            node.propose((b"h%08d|" % h_next).ljust(32, b"g"))

    minh = min(net.heights())
    return {
        "mode": mode,
        "heights": net.heights(),
        "reached": minh >= target_heights,
        "virtual_s": round(net.now, 4),
        "virtual_s_per_height": round(net.now / max(1, minh), 4),
        "fork_heights": sum(
            1 for states in decided.values() if len(states) > 1),
        "cert_decides": cert_decides,
        "proof_decides": proof_decides,
        "tx_msgs": net.tx_msgs,
        "timeline": timeline,
        "wall_s": round(time.perf_counter() - t0, 2),
    }


def run_growth(spec: ScenarioSpec,
               inject_regression: bool = False) -> dict:
    """The committee-growth soak: anchor clusters + modeled scale table,
    one scenario-shaped record (:mod:`bdls_tpu_torch.chaos.loadgen`
    dispatches here for the ``committee_growth`` catalog entry).
    ``inject_regression`` busts the aggregate cells past the round
    budget — the verdict provably flips."""
    from bdls_tpu_torch.obs.collector import Endpoint, FleetCollector
    from bdls_tpu_torch.utils import slo, tracing
    from bdls_tpu_torch.utils.metrics import MetricsProvider

    t_wall0 = time.perf_counter()
    seed = spec.plan.seed
    anchors = {
        mode: _growth_anchor(
            mode, seed=seed + k, target_heights=spec.target_heights,
            tick=spec.tick, max_virtual_s=spec.max_virtual_s,
            max_wall_s=spec.max_wall_s)
        for k, mode in enumerate(("per_signature", "aggregate"))
    }
    timed_out = not all(a["reached"] for a in anchors.values())

    # ---- the committee axis (deterministic model) --------------------
    configs: list[dict] = []
    agg_ms: dict[int, float] = {}
    for nv in GROWTH_SIZES:
        for mode in ("per_signature", "aggregate"):
            ms = growth_verify_ms(mode, nv)
            if inject_regression and mode == "aggregate":
                ms = round(2.0 * GROWTH_BUDGET_MS, 2)
            configs.append({
                "mode": mode, "validators": nv,
                "quorum": growth_quorum(nv),
                "verify_ms": round(ms, 2),
                "budget_ms": GROWTH_BUDGET_MS,
                "within_budget": ms <= GROWTH_BUDGET_MS,
            })
            if mode == "aggregate":
                agg_ms[nv] = ms
    flat = [agg_ms[nv] for nv in GROWTH_SIZES if nv >= 128]
    flat_ratio = (max(flat) / min(flat)) if flat and min(flat) else 1.0

    values = {
        "heights_decided": float(
            min(min(a["heights"]) for a in anchors.values())),
        "virtual_s_per_height": max(
            a["virtual_s_per_height"] for a in anchors.values()),
        "fork_heights": float(
            sum(a["fork_heights"] for a in anchors.values())),
        "cert_decides": float(anchors["aggregate"]["cert_decides"]),
        "cert_proof_decides": float(
            anchors["aggregate"]["proof_decides"]),
        "agg_over_budget": float(sum(
            1 for c in configs if c["mode"] == "aggregate"
            and not c["within_budget"])),
        "persig_over_budget_small": float(sum(
            1 for c in configs if c["mode"] == "per_signature"
            and c["validators"] < 512 and not c["within_budget"])),
        "persig_within_budget_at_512": float(sum(
            1 for c in configs if c["mode"] == "per_signature"
            and c["validators"] >= 512 and c["within_budget"])),
        "agg_flatness_ratio": round(flat_ratio, 4),
    }

    objectives = [
        slo.Objective(
            name="anchor_liveness", source="value",
            target="heights_decided", stat="value", op=">=",
            threshold=float(spec.target_heights), unit="heights",
            description="both real anchor clusters (per-signature AND "
                        "aggregate) decide the target heights"),
        slo.Objective(
            name="round_latency_budget", source="value",
            target="virtual_s_per_height", stat="value", op="<=",
            threshold=float(
                spec.budgets.get("virtual_s_per_height", 5.0)),
            unit="s/height",
            description="worst-anchor virtual round latency stays "
                        "inside the scenario budget"),
        slo.Objective(
            name="no_divergent_commits", source="value",
            target="fork_heights", stat="value", op="<=",
            threshold=0.0, unit="heights",
            description="safety holds in both vote modes"),
        slo.Objective(
            name="aggregate_decides_carry_certs", source="value",
            target="cert_decides", stat="value", op=">=",
            threshold=1.0, unit="decides",
            description="the aggregate anchor's <decide>s ride "
                        "one-pairing certificates on the wire"),
        slo.Objective(
            name="aggregate_decides_proofless", source="value",
            target="cert_proof_decides", stat="value", op="<=",
            threshold=0.0, unit="decides",
            description="no aggregate decide fell back to the 2t+1 "
                        "proof bundle"),
        slo.Objective(
            name="aggregate_within_budget_all_sizes", source="value",
            target="agg_over_budget", stat="value", op="<=",
            threshold=0.0, unit="configs",
            description=f"aggregate cert verify inside the "
                        f"{GROWTH_BUDGET_MS:.0f} ms round budget at "
                        f"every committee size"),
        slo.Objective(
            name="per_signature_green_small", source="value",
            target="persig_over_budget_small", stat="value", op="<=",
            threshold=0.0, unit="configs",
            description="per-signature stays in budget below the "
                        "crossover (4, 128)"),
        slo.Objective(
            name="per_signature_busts_at_512", source="value",
            target="persig_within_budget_at_512", stat="value",
            op="<=", threshold=0.0, unit="configs",
            description="the axis is real: per-signature exceeds the "
                        "budget at 512+ — aggregate is the only "
                        "in-budget config there"),
        slo.Objective(
            name="aggregate_cost_flat", source="value",
            target="agg_flatness_ratio", stat="value", op="<=",
            threshold=GROWTH_FLATNESS, unit="ratio",
            description="aggregate verify cost flat (max/min <= 1.2) "
                        "from 128 to 1024 validators"),
    ]
    metrics = MetricsProvider()
    tracer = tracing.Tracer(metrics=metrics)
    snap = FleetCollector(
        [Endpoint("growth-client", tracer=tracer, metrics=metrics)],
        limit=64, spec=objectives).scrape(values=values)
    verdict = snap.verdict

    digest = hashlib.sha256(json.dumps(
        {"timeline": {m: a["timeline"] for m, a in anchors.items()},
         "heights": {m: a["heights"] for m, a in anchors.items()},
         "configs": configs, "values": values},
        sort_keys=True).encode()).hexdigest()

    return {
        "name": spec.name,
        "seed": seed,
        "ok": bool(verdict["ok"]) and not timed_out,
        "injected_regression": bool(inject_regression),
        "timed_out": timed_out,
        "values": values,
        "budgets": dict(spec.budgets, verify_ms=GROWTH_BUDGET_MS),
        "heights": anchors["aggregate"]["heights"],
        "virtual_s": max(a["virtual_s"] for a in anchors.values()),
        "wall_s": round(time.perf_counter() - t_wall0, 2),
        "anchors": {m: {k: v for k, v in a.items() if k != "timeline"}
                    for m, a in anchors.items()},
        "growth": {
            "budget_ms": GROWTH_BUDGET_MS,
            "sizes": list(GROWTH_SIZES),
            "model": {
                "dispatch_floor_ms": GROWTH_DISPATCH_FLOOR_MS,
                "per_lane_ms": GROWTH_PER_LANE_MS,
                "pairing_ms": GROWTH_PAIRING_MS,
                "hash_ms": GROWTH_HASH_MS,
            },
            "configs": configs,
        },
        "timeline_digest": digest,
        "slo": verdict,
        "fleet": snap.summary(),
    }
