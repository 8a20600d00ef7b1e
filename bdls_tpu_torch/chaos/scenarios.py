"""The canned scenario catalog (the reference's docs/ROBUSTNESS.md
§catalog).

The port's copy of ``bdls_tpu/chaos/scenarios.py``, whole: the same six
scenarios with the same seeds, sizes, budgets and
``BDLS_CHAOS_REWARM_KEYS``. The scenarios cover the fault classes the
sidecar paper's deployment story actually meets — each runs under the
virtual clock in bounded wall time:

- ``loss_crash``: a lossy/duplicating/reordering network window
  followed by a validator crash+recover — the quorum-edge liveness
  case (n=4 tolerates exactly one dead node);
- ``sidecar_flap``: the verifyd daemon dies mid-stream and restarts —
  every verify degrades to local sw (bounded fallback budget), then
  the redialer latches back on;
- ``churn_storm``: membership churn waves evict pinned consenter keys
  from the LRU while a slow-device stall throttles the drainer — the
  cache-eviction-mid-flight case;
- ``rolling_restart``: a 4-replica verifyd fleet restarts one replica
  at a time under load (the production upgrade motion) — lanes homed
  on the dead replica re-hash to the ring's next live one, the
  returning replica is rewarmed before traffic re-routes, and the
  verdict demands zero lost requests;
- ``committee_growth``: the validator-set scale axis — two
  real 4-validator anchor clusters prove both vote modes on the wire
  (per-signature proof bundles vs one-pairing aggregate-BLS commit
  certificates), then the committee grows 4 -> 128 -> 512 -> 1024
  under the deterministic verify cost model; aggregate must be the
  only config inside the round budget at 512+, and its cost must be
  flat. There are no fault events: the "fault" is scale itself;
- ``endorsement_storm``: the overload judgment — a
  committer tenant fans N-of-M endorsement blocks of 500+ txs through
  ``CspBatchVerifier`` into the shared verifyd fleet alongside live
  vote traffic; the daemon's per-tenant watermark sheds the firehose
  batches with SHED verdicts, the storm client's brownout breaker
  demotes to local after ``brownout_threshold`` consecutive sheds,
  and the verdict demands vote RTT inside the round budget, a bounded
  shed ratio, ZERO vote-lane sheds, and no lost batches.

Budgets are deliberately scenario-local: a chaos run is judged against
*its* degraded-mode contract, not the steady-state SLOs.
"""

from __future__ import annotations

import os

from bdls_tpu_torch.chaos.plan import FaultEvent, make_plan
from bdls_tpu_torch.chaos.runner import ScenarioSpec


def loss_crash(seed: int = 7) -> ScenarioSpec:
    plan = make_plan("loss_crash", seed, [
        FaultEvent("net.loss", at=0.5, duration=2.0, params={"p": 0.25}),
        FaultEvent("net.dup", at=0.5, duration=2.0, params={"p": 0.10}),
        FaultEvent("net.reorder", at=1.0, duration=1.5,
                   params={"p": 0.15}),
        FaultEvent("node.crash", at=3.0, duration=2.0,
                   params={"node": 3}),
    ])
    return ScenarioSpec(
        name="loss_crash", plan=plan, clients=4, target_heights=6,
        budgets={"recovery_s": 20.0, "fallback_batches": 0.0,
                 "virtual_s_per_height": 3.0})


def sidecar_flap(seed: int = 11) -> ScenarioSpec:
    plan = make_plan("sidecar_flap", seed, [
        FaultEvent("sidecar.kill", at=1.0, duration=1.5, params={}),
    ])
    return ScenarioSpec(
        name="sidecar_flap", plan=plan, clients=4, target_heights=5,
        sidecar=True,
        budgets={"recovery_s": 20.0, "fallback_batches": 500.0,
                 "virtual_s_per_height": 3.0,
                 "deadline_expirations": 64.0})


def churn_storm(seed: int = 13) -> ScenarioSpec:
    plan = make_plan("churn_storm", seed, [
        FaultEvent("cache.churn", at=0.5, duration=2.25,
                   params={"keys": 4, "interval": 0.75, "stride": 97}),
        FaultEvent("device.stall", at=1.5, duration=0.7,
                   params={"stall_s": 0.02}),
    ])
    return ScenarioSpec(
        name="churn_storm", plan=plan, clients=4, target_heights=5,
        key_cache_size=8,
        budgets={"recovery_s": 20.0, "fallback_batches": 0.0,
                 "virtual_s_per_height": 3.0})


def rolling_restart(seed: int = 17) -> ScenarioSpec:
    """Fleet upgrade motion: kill replica i, let it restart, move to
    i+1 — windows never overlap, so the ring always has 3 live
    replicas and NO request should ever need the sw fallback path
    (failover re-hash answers them); the budget still allows a few
    in-flight casualties per window.

    Warm handoff: each replica carries a pinned-table
    snapshot path, so a restarted daemon restores its predecessor's
    warmth and answers the client's WarmState query with the restored
    key set — the reconnect rewarm re-transmits only the delta. The
    ``rewarm_sent_keys`` budget (env ``BDLS_CHAOS_REWARM_KEYS``) caps
    how many keys the client may have to re-send across the WHOLE
    4-restart motion; with handoff working the measured value is 0."""
    plan = make_plan("rolling_restart", seed, [
        FaultEvent("sidecar.kill", at=0.75 + 1.25 * i, duration=1.0,
                   params={"replica": i})
        for i in range(4)
    ])
    return ScenarioSpec(
        name="rolling_restart", plan=plan, clients=4, target_heights=5,
        sidecar=True, replicas=4, key_cache_size=32,
        budgets={"recovery_s": 20.0, "fallback_batches": 200.0,
                 "virtual_s_per_height": 3.0,
                 "deadline_expirations": 64.0,
                 "rewarm_sent_keys": float(
                     os.environ.get("BDLS_CHAOS_REWARM_KEYS", "8"))})


def committee_growth(seed: int = 23) -> ScenarioSpec:
    """Committee-size growth soak (runner.run_growth — the loadgen
    routes this name past run_scenario). ``target_heights`` is the ANCHOR
    target: each real 4-validator cluster is driven that far; the BLS
    anchor does real host pairings per height, so keep it small."""
    plan = make_plan("committee_growth", seed, [])
    return ScenarioSpec(
        name="committee_growth", plan=plan, clients=4,
        target_heights=2, max_wall_s=150.0,
        budgets={"virtual_s_per_height": 5.0})


def endorsement_storm(seed: int = 29) -> ScenarioSpec:
    """The overload judgment. One ``load.surge`` window
    drives two endorsement waves (wave 0 at engage + one per
    ``interval`` strictly inside the window): each wave fans, per
    block, one committer batch per endorsement slot of the
    ``policy``-of-``endorsers`` policy — 500-tx blocks mean 500-lane
    batches — into the shared daemon while the consensus pre-pass
    keeps verifying live vote traffic through it.

    Determinism: the daemon's ``tenant_watermark`` (256) is below one
    storm batch's lane count, so EVERY storm batch sheds at submit
    time regardless of flusher timing; the storm client's brownout
    hold-down (pinned in the runner, longer than any wall run) means
    exactly ``brownout_threshold`` (3) sheds happen before the breaker
    keeps the rest local — shed counts, the brownout tier walk, and
    every judged storm value replay bit-identically. The shed-ratio
    budget (0.8 on a deterministic 3/4) is the breaker's teeth: a
    client that never demoted would shed ALL its batches remotely
    (ratio 1.0) and fail.

    The incident budgets judge the shed *trajectory* off
    the virtual-clock time series: onset within half a second of the
    surge window opening, and the incident clearing (first quiet
    sample after the second wave at t=2.0) before t=4.0.

    The block lane: a separate committer client pushes one
    whole-block ``VerifyBlockRequest`` per wave through the daemon's
    block lane while the firehose sheds around it — blocks are sized
    under the tenant watermark, so they are admitted, and the
    ``storm_block_bad`` budget (0) demands every per-tx TXFLAG vector
    match the host oracle. ``storm_blocks_per_s`` (flag-correct blocks
    per virtual surge second) is the standing perf-gate cell."""
    plan = make_plan("endorsement_storm", seed, [
        FaultEvent("load.surge", at=1.0, duration=2.0,
                   params={"blocks": 1, "txs": 500, "endorsers": 3,
                           "policy": 2, "interval": 1.0}),
    ])
    return ScenarioSpec(
        name="endorsement_storm", plan=plan, clients=4,
        target_heights=5, sidecar=True, tenant_watermark=256,
        budgets={"recovery_s": 20.0, "fallback_batches": 0.0,
                 "virtual_s_per_height": 3.0,
                 "deadline_expirations": 64.0,
                 "storm_vote_rtt_p99_ms": 195.0,
                 "storm_shed_ratio": 0.8,
                 "storm_block_bad": 0.0,
                 "shed_onset_lag_s": 0.5,
                 "shed_clear_s": 4.0})


CATALOG = {
    "loss_crash": loss_crash,
    "sidecar_flap": sidecar_flap,
    "churn_storm": churn_storm,
    "rolling_restart": rolling_restart,
    "committee_growth": committee_growth,
    "endorsement_storm": endorsement_storm,
}


def names() -> list[str]:
    return sorted(CATALOG)


def get(name: str, seed: int = 0) -> ScenarioSpec:
    """Build a fresh spec (specs are mutable; never share instances).
    ``seed=0`` keeps the scenario's canonical seed."""
    try:
        factory = CATALOG[name]
    except KeyError:
        raise ValueError(
            f"unknown scenario {name!r} (catalog: {', '.join(names())})"
        ) from None
    return factory(seed) if seed else factory()
