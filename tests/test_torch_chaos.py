"""The chaos soak on the port (``bdls_tpu_torch.chaos``) against the
reference's ``bdls_tpu.chaos``, on the CPU.

- the catalog's plans serialize to the reference's bytes, and broken
  plans fail with the reference's errors;
- ``ChaosEngine`` gives the reference's ``records`` (truncation
  included) and drives the same seams in the same order, over fakes;
- the catalog's specs are the reference's, field for field;
- the port's runner on ``device="cpu", kernel_field="sw"`` (the
  reference's dryrun shape) gives the reference's ``values``,
  ``heights``, ``incidents`` and ``timeline_digest`` for
  ``loss_crash``, ``churn_storm``, ``endorsement_storm`` and
  ``committee_growth``; its ``rolling_restart`` and ``sidecar_flap``
  pass the reference's own assertions (``tests/test_loadgen.py``; the
  pinned pools' spread also admits the ring's draw that homes every
  consenter on one replica);
- ``inject_regression`` flips the verdict; the default provider needs
  a card.

The runs are shared at module scope, as the reference's ``suite``
fixture shares its one.
"""

from __future__ import annotations

import dataclasses
import time

import _ecstub
import pytest
import torch

from bdls_tpu_torch.chaos import injectors as PI
from bdls_tpu_torch.chaos import runner as PR
from bdls_tpu_torch.chaos import scenarios as PC
from bdls_tpu_torch.chaos.plan import FaultEvent as PEvent
from bdls_tpu_torch.chaos.plan import FaultPlan as PPlan
from bdls_tpu_torch.consensus import rounds
from bdls_tpu_torch.consensus import wire_codec as W
from bdls_tpu_torch.consensus.identity import Signer
from bdls_tpu_torch.utils.metrics import MetricsProvider as PMetrics

_STUBBED = _ecstub.ensure_crypto()

from bdls_tpu.chaos import injectors as JI  # noqa: E402
from bdls_tpu.chaos import runner as JR  # noqa: E402
from bdls_tpu.chaos import scenarios as JC  # noqa: E402
from bdls_tpu.chaos.plan import FaultPlan as JPlan  # noqa: E402
from bdls_tpu.utils.metrics import MetricsProvider as JMetrics  # noqa: E402

if _STUBBED:
    _ecstub.remove_stub()

NAMES = ("churn_storm", "committee_growth", "endorsement_storm",
         "loss_crash", "rolling_restart", "sidecar_flap")
# the scenarios whose whole judged record replays bit for bit (the
# sidecar scenarios' fallback counts depend on wall time)
PARITY = ("loss_crash", "churn_storm", "endorsement_storm",
          "committee_growth")
HOST = {"device": "cpu", "kernel_field": "sw"}


def _run(side: str, name: str, inject_regression: bool = False) -> dict:
    runner, cat = (PR, PC) if side == "port" else (JR, JC)
    spec = cat.get(name)
    if name == "committee_growth":
        return runner.run_growth(spec, inject_regression=inject_regression)
    kw = HOST if side == "port" else {}
    return runner.run_scenario(spec, inject_regression=inject_regression,
                               **kw)


@pytest.fixture(scope="module")
def port_suite():
    return {name: _run("port", name) for name in NAMES}


@pytest.fixture(scope="module")
def ref_runs():
    return {name: _run("reference", name) for name in PARITY}


# ---- plans -----------------------------------------------------------------

@pytest.mark.parametrize("name", NAMES)
def test_catalog_plan_json_is_the_references_bytes(name):
    port, ref = PC.get(name).plan, JC.get(name).plan
    assert port.to_json() == ref.to_json()
    assert PPlan.from_json(port.to_json()) == port
    assert PPlan.from_json(ref.to_json()).to_json() == ref.to_json()
    assert port.windows() == [(a, b, PEvent.from_dict(e.to_dict()))
                              for a, b, e in ref.windows()]
    assert port.horizon() == ref.horizon()


@pytest.mark.parametrize("row", [
    {"kind": "meteor.strike", "at": 1.0},
    {"kind": "net.loss", "at": -0.5, "params": {"p": 0.1}},
    {"kind": "net.loss", "at": 0.5, "duration": -1.0, "params": {"p": 0.1}},
    {"kind": "net.loss", "at": 0.5},
    {"kind": "node.crash", "at": 1.0, "params": {}},
    {"kind": "cache.churn", "at": 1.0, "params": {"interval": 0.5}},
    {"kind": "load.surge", "at": 1.0, "params": {"txs": 10}},
])
def test_broken_plans_fail_with_the_references_errors(row):
    blob = PPlan.from_dict({"seed": 1, "events": [row]}).to_json()
    errs = []
    for plan_cls in (PPlan, JPlan):
        with pytest.raises(ValueError) as exc:
            plan_cls.from_json(blob).validate()
        errs.append(str(exc.value))
    assert errs[0] == errs[1]


# ---- the engine over fake seams --------------------------------------------

class _Net:
    def __init__(self, log):
        self.log = log
        self.loss = self.dup = self.reorder = 0.0
        self.reorder_spread = 0.1
        self.partitioned = set()

    def crash(self, i):
        self.log.append(("crash", i))

    def recover(self, i):
        self.log.append(("recover", i))


class _Sidecar:
    def __init__(self, log):
        self.log = log

    def kill(self, *i):
        self.log.append(("kill", *i))

    def restart(self, *i):
        self.log.append(("restart", *i))


class _Csp:
    chaos_stall_s = 0.0


EVENTS = [
    {"kind": "net.loss", "at": 0.5, "duration": 1.0, "params": {"p": 0.3}},
    {"kind": "net.reorder", "at": 0.25, "duration": 0.5,
     "params": {"p": 0.2, "spread": 0.4}},
    {"kind": "net.dup", "at": 0.5, "duration": 0.25, "params": {"p": 0.1}},
    {"kind": "net.partition", "at": 1.0, "duration": 0.5,
     "params": {"nodes": [1, 2]}},
    {"kind": "node.crash", "at": 1.25, "duration": 1.0,
     "params": {"node": 3}},
    {"kind": "sidecar.kill", "at": 0.75, "duration": 0.5, "params": {}},
    {"kind": "sidecar.kill", "at": 2.0, "duration": 0.5,
     "params": {"replica": 2}},
    {"kind": "cache.churn", "at": 0.5, "duration": 2.25,
     "params": {"keys": 4, "interval": 0.75, "stride": 97}},
    {"kind": "device.stall", "at": 1.5, "duration": 0.7,
     "params": {"stall_s": 0.02}},
    {"kind": "load.surge", "at": 1.0, "duration": 2.0,
     "params": {"blocks": 1, "interval": 1.0}},
    # still open when the run ends: reverted by finish(), truncated
    {"kind": "net.loss", "at": 2.5, "duration": 5.0, "params": {"p": 0.5}},
]


def _drive_engine(side: str):
    injectors, plan_cls, metrics_cls = (
        (PI, PPlan, PMetrics) if side == "port" else (JI, JPlan, JMetrics))
    log: list = []
    net, csp = _Net(log), _Csp()
    seen: list = []

    def hook(kind):
        return lambda params, wave: log.append((kind, wave, dict(params)))

    ctx = injectors.ChaosContext(net=net, sidecar=_Sidecar(log), csp=csp,
                                 churn=hook("churn"), surge=hook("surge"))
    metrics = metrics_cls()
    plan = plan_cls.from_dict({"name": "all", "seed": 3, "events": EVENTS})
    engine = injectors.ChaosEngine(plan, ctx, metrics=metrics)
    for k in range(1, 13):
        now = round(0.25 * k, 6)
        engine.step(now)
        seen.append((now, net.loss, net.dup, net.reorder,
                     net.reorder_spread, sorted(net.partitioned),
                     csp.chaos_stall_s, engine.done))
    engine.finish(3.05)
    seen.append((net.loss, net.reorder_spread, csp.chaos_stall_s,
                 engine.done))
    counter = metrics.find("chaos_faults_engaged_total")
    return engine.records, log, seen, counter.values()


def test_engine_records_and_seams_equal_the_references():
    port, ref = _drive_engine("port"), _drive_engine("reference")
    assert port == ref
    records = port[0]
    assert records[-1].get("truncated") is True
    assert all("t_reverted" in r for r in records)
    assert {r["kind"] for r in records} == {e["kind"] for e in EVENTS}


def test_engine_refuses_a_fault_whose_seam_is_missing():
    plan = PPlan.from_dict({"seed": 1, "events": [
        {"kind": "device.stall", "at": 0.0, "params": {"stall_s": 1}}]})
    engine = PI.ChaosEngine(plan, PI.ChaosContext())
    with pytest.raises(ValueError, match="needs a 'csp' seam"):
        engine.step(0.0)


# ---- the catalog ------------------------------------------------------------

def _spec_fields(spec) -> dict:
    out = dataclasses.asdict(spec)
    out["plan"] = spec.plan.to_dict()
    return out


@pytest.mark.parametrize("name", NAMES)
def test_catalog_specs_equal_the_references(name, monkeypatch):
    assert PC.names() == JC.names() == sorted(NAMES)
    assert _spec_fields(PC.get(name)) == _spec_fields(JC.get(name))
    assert _spec_fields(PC.get(name, seed=99)) == _spec_fields(
        JC.get(name, seed=99))
    monkeypatch.setenv("BDLS_CHAOS_REWARM_KEYS", "3")
    assert _spec_fields(PC.get(name)) == _spec_fields(JC.get(name))


def test_catalog_get_unknown_raises():
    with pytest.raises(ValueError, match="unknown scenario 'meteor'"):
        PC.get("meteor")


def test_chaos_spec_objectives_equal_the_references():
    for name in NAMES:
        port = [dataclasses.asdict(o) for o in PR.chaos_spec(PC.get(name))]
        ref = [dataclasses.asdict(o) for o in JR.chaos_spec(JC.get(name))]
        assert port == ref, name


# ---- the runner --------------------------------------------------------------

def test_runner_uses_the_round_drivers_plumbing():
    """No third copy of the pre-pass: the runner's extraction and cache
    verifier are ``consensus/rounds.py``'s."""
    assert PR.extract_envelopes is rounds.extract_envelopes
    assert PR.CacheVerifier is rounds.CacheVerifier
    assert PR._env_key is rounds._env_key
    assert not hasattr(PR, "_CacheVerifier")


def test_tampered_copy_flips_only_the_last_bit_of_s():
    env = Signer.from_scalar(0x6001).sign_payload(b"payload")
    bad = PR._tampered(env)
    assert bad.sig_s[:-1] == env.sig_s[:-1]
    assert bad.sig_s[-1] == env.sig_s[-1] ^ 1
    assert (bad.payload, bad.pub_x, bad.pub_y, bad.sig_r, bad.version) == (
        env.payload, env.pub_x, env.pub_y, env.sig_r, env.version)
    assert W.encode(env) != W.encode(bad)
    empty = PR._tampered(W.SignedEnvelope())
    assert empty.sig_s == b"\x00" * 31 + b"\x01"


@pytest.mark.parametrize("name", PARITY)
def test_runner_replays_the_references_record(name, port_suite, ref_runs):
    got, want = port_suite[name], ref_runs[name]
    assert got["ok"] and want["ok"], name
    assert got["values"] == want["values"]
    assert got["heights"] == want["heights"]
    assert got.get("incidents", []) == want.get("incidents", [])
    assert got["timeline_digest"] == want["timeline_digest"]


def test_suite_runs_green(port_suite):
    for name, rec in port_suite.items():
        assert rec["ok"] and not rec["timed_out"], name
        assert rec["slo"]["ok"] and rec["values"]["fork_heights"] == 0
        assert min(rec["heights"]) >= PC.get(name).target_heights
        if name == "committee_growth":
            continue
        assert rec["provider"] == {"device": "cpu", "kernel_field": "sw"}
        assert rec["values"]["tamper_accepts"] == 0
        assert rec["tamper_attempts"] >= 1
        assert rec["faults"] and all("t_reverted" in f
                                     for f in rec["faults"])


def test_rolling_restart_zero_lost_requests(port_suite):
    """The reference's acceptance test, on the port's run: all four
    replicas restart one at a time under load, the router fails over
    along the ring and rewarms the moved keys, and not one request is
    lost. (The reference's own run fails it: its daemon's ``stop()``
    leaves accepted connections open.)"""
    rec = port_suite["rolling_restart"]
    assert rec["ok"] and not rec["timed_out"]
    sc = rec["sidecar"]
    assert sc["replicas"] == 4
    assert sc["kills"] == 4 and sc["restarts"] == 4
    assert rec["values"]["requests_lost"] == 0.0
    assert sc["rewarms"] >= 1
    assert sc["handoff_snapshot"] is True
    assert sc["rewarms_sent"] == 0.0
    assert sc["rewarms_skipped"] == sc["rewarms"]
    assert rec["values"]["rewarm_sent_keys"] == 0.0
    assert len(sc["pinned_keys"]) == 4
    # key affinity partitions the pinned pools over the replicas the ring
    # homes the consenters on; the ring hashes the daemons' ports, which
    # the OS picks, and homes all four keys on one replica in about 1.4 %
    # of draws, where the other three hold none
    pinned = sc["pinned_keys"]
    assert max(pinned) < sum(pinned) or sorted(pinned)[:3] == [0, 0, 0]
    passed = {o["name"] for o in rec["slo"]["fleet"]["objectives"]
              if o["status"] == "pass"}
    assert {"no_lost_requests", "rewarm_within_budget"} <= passed


def test_sidecar_flap_degrades_then_recovers(port_suite):
    rec = port_suite["sidecar_flap"]
    assert rec["ok"] and not rec["timed_out"]
    assert rec["sidecar"]["kills"] == 1 and rec["sidecar"]["restarts"] == 1
    assert rec["values"]["requests_lost"] == 0.0
    # degraded mode was real and stayed inside its budget (the count
    # depends on wall time, so only its bounds are held)
    assert 0 < rec["values"]["fallback_batches"] <= 500
    assert rec["values"]["unrecovered_windows"] == 0.0


def test_storm_keeps_votes_sound(port_suite):
    rec = port_suite["endorsement_storm"]
    vals, storm = rec["values"], rec["storm"]
    assert vals["storm_vote_sheds"] == 0.0 and vals["storm_lost"] == 0.0
    assert storm["daemon_sheds"] == storm["client_shed_fallbacks"]
    assert (storm["client_shed_fallbacks"] + storm["brownout_fallbacks"]
            == storm["batches"])
    assert vals["storm_block_bad"] == 0.0
    assert storm["blocks"]["submitted"] == storm["blocks"]["flag_matches"]


@pytest.mark.parametrize("name,flipped", [
    ("loss_crash", {"bounded_fallbacks", "recovery_within_budget"}),
    ("endorsement_storm", {"storm_vote_rtt_within_budget",
                           "storm_votes_never_shed",
                           "storm_blocks_all_valid",
                           "storm_shed_onset_within_budget",
                           "storm_shed_cleared_within_budget"}),
])
def test_inject_regression_flips_the_verdict(name, flipped, port_suite):
    rec = _run("port", name, inject_regression=True)
    assert rec["injected_regression"] and not rec["ok"]
    failed = {o["name"] for o in rec["slo"]["fleet"]["objectives"]
              if o["status"] == "fail"}
    assert flipped <= failed
    assert rec["timeline_digest"] != port_suite[name]["timeline_digest"]


def test_growth_regression_flips_the_verdict():
    rec = PR.run_growth(PC.get("committee_growth"), inject_regression=True)
    assert not rec["ok"]
    assert rec["values"]["agg_over_budget"] > 0


def test_the_default_provider_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in ("loss_crash", "sidecar_flap"):
        with pytest.raises(RuntimeError, match="needs a CUDA device"):
            PR.run_scenario(PC.get(name))


class _FakeServer:
    def __init__(self, port):
        self.port = port or 4242

    def start(self):
        return self

    def stop(self):
        pass


def test_a_restart_waits_only_for_a_replica_the_client_had():
    """A replica the client had no session with at the kill is not
    waited for (nothing can dial it while the drive loop is in the
    restart); one it had is waited for until its channel latches."""
    up = {"v": False}
    ctl = PR.SidecarController(_FakeServer, wait_latch=lambda: up["v"])
    ctl.kill()
    t0 = time.perf_counter()
    ctl.restart()
    assert time.perf_counter() - t0 < 1.0
    up["v"] = True
    ctl.kill()
    calls = {"n": 0}

    def latch():
        calls["n"] += 1
        return calls["n"] > 3

    ctl.wait_latch = latch
    ctl.restart()
    assert calls["n"] == 4 and (ctl.kills, ctl.restarts) == (2, 2)
    assert ctl.port == 4242
