"""loadgen: the chaos soak driver on the port.

The port's copy of the reference's ``tools/loadgen.py``: the same flags
and the same record shape. It drives fault-injected consensus traffic
through :mod:`bdls_tpu_torch.chaos.runner` and writes the fleet-judged
verdict as one JSON object. Each scenario is a seeded, deterministic
soak on the virtual clock: N validators ordering a payload mix while a
FaultPlan replays network loss/dup/reorder, validator crashes, sidecar
kill/restart, key-cache churn, and slow-device stalls; pass/fail is
``slo.evaluate_fleet()`` over the chaos objectives (liveness recovery,
safety, degraded-mode budgets).

Usage:
    python -m bdls_tpu_torch.chaos.loadgen --suite
        (every provider on the card; no card, no run)
    python -m bdls_tpu_torch.chaos.loadgen --dryrun --suite
    python -m bdls_tpu_torch.chaos.loadgen --dryrun --scenario sidecar_flap
    python -m bdls_tpu_torch.chaos.loadgen --dryrun --plan my_plan.json
    python -m bdls_tpu_torch.chaos.loadgen --dryrun --suite --inject-regression
        (the provably-flips variant: budgets busted, verdict false)

``--dryrun`` verifies on the host (``TorchCSP(device="cpu",
kernel_field="sw")``, the reference's dryrun shape): no card, no sockets
beyond loopback, bounded wall time. The record goes to ``--out``,
``build/GPU_CHAOS_suite.json`` by default.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

DEFAULT_OUT = os.path.join("build", "GPU_CHAOS_suite.json")


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def _plan_scenario(path: str, clients: int):
    """Wrap a user FaultPlan file in the default traffic shape."""
    from bdls_tpu_torch.chaos.plan import FaultPlan
    from bdls_tpu_torch.chaos.runner import ScenarioSpec

    with open(path) as fh:
        try:
            plan = FaultPlan.from_json(fh.read()).validate()
        except (ValueError, TypeError, KeyError) as exc:
            raise SystemExit(f"bad fault plan {path}: {exc!r}") from exc
    name = plan.name or os.path.splitext(os.path.basename(path))[0]
    return ScenarioSpec(
        name=name, plan=plan, clients=clients, target_heights=5,
        sidecar=any(e.kind == "sidecar.kill" for e in plan.events),
        key_cache_size=(8 if any(e.kind == "cache.churn"
                                 for e in plan.events) else 0),
        budgets={"recovery_s": 30.0, "fallback_batches": 1000.0,
                 "virtual_s_per_height": 5.0})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__.splitlines()[0],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--scenario", action="append", default=[],
                    help="canned scenario name (repeatable); see "
                         "bdls_tpu_torch/chaos/scenarios.py")
    ap.add_argument("--suite", action="store_true",
                    help="run the whole canned catalog")
    ap.add_argument("--plan", default=None,
                    help="run a FaultPlan JSON file instead of the "
                         "catalog")
    ap.add_argument("--seed", type=int, default=0,
                    help="override the scenario seeds (0 = canonical)")
    ap.add_argument("--clients", type=int, default=0,
                    help="override validator/client count (0 = "
                         "scenario default)")
    ap.add_argument("--heights", type=int, default=0,
                    help="override the target decided heights")
    ap.add_argument("--inject-regression", action="store_true",
                    help="bust the degraded-mode budgets after the "
                         "run: the verdict provably flips")
    ap.add_argument("--dryrun", action="store_true",
                    help="no card: every provider verifies on the host "
                         "(device cpu, kernel field sw)")
    ap.add_argument("--max-wall-s", type=float, default=0.0,
                    help="override per-scenario wall budget")
    ap.add_argument("--out", default=DEFAULT_OUT,
                    help="verdict artifact (one JSON object)")
    args = ap.parse_args(argv)

    from bdls_tpu_torch.chaos import scenarios as cat
    from bdls_tpu_torch.chaos.runner import run_growth, run_scenario

    provider = ({"device": "cpu", "kernel_field": "sw"} if args.dryrun
                else {})
    specs = []
    if args.plan:
        specs.append(_plan_scenario(args.plan, args.clients or 4))
    names = list(args.scenario)
    if args.suite or not (names or args.plan):
        names = cat.names()
    for name in names:
        specs.append(cat.get(name, seed=args.seed))

    records: dict[str, dict] = {}
    for spec in specs:
        if args.clients:
            spec.clients = args.clients
        if args.heights:
            spec.target_heights = args.heights
        if args.max_wall_s:
            spec.max_wall_s = args.max_wall_s
        log(f"--- scenario {spec.name}: {spec.clients} validators, "
            f"target {spec.target_heights} heights, "
            f"{len(spec.plan.events)} fault events"
            + (" [inject-regression]" if args.inject_regression else ""))
        if spec.name == "committee_growth":
            # not a FaultPlan replay: the anchor-cluster + scale-model
            # soak has its own runner entry point and verdict shape
            rec = run_growth(spec,
                             inject_regression=args.inject_regression)
            records[spec.name] = rec
            log(f"    {'ok' if rec['ok'] else 'FAIL'}: "
                f"heights={rec['values']['heights_decided']:.0f} "
                f"cert_decides={rec['values']['cert_decides']:.0f} "
                f"agg_flat={rec['values']['agg_flatness_ratio']:.2f} "
                f"virtual={rec['virtual_s']}s wall={rec['wall_s']}s")
            continue
        rec = run_scenario(spec, inject_regression=args.inject_regression,
                           **provider)
        records[spec.name] = rec
        log(f"    {'ok' if rec['ok'] else 'FAIL'}: "
            f"heights={rec['values']['heights_decided']:.0f} "
            f"recovery={rec['values']['recovery_s']:.2f}s "
            f"fallbacks={rec['values']['fallback_batches']:.0f} "
            f"virtual={rec['virtual_s']}s wall={rec['wall_s']}s")

    out = {
        "metric": "chaos_suite",
        "schema": 1,
        "source": "dryrun" if args.dryrun else "live",
        "injected_regression": bool(args.inject_regression),
        "ok": all(r["ok"] for r in records.values()),
        "scenarios": records,
    }
    blob = json.dumps(out)
    if os.path.dirname(args.out):
        os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as fh:
        fh.write(blob + "\n")
    log(f"wrote {args.out} "
        f"({len(records)} scenarios, ok={out['ok']})")
    print(blob[:2000] + ("..." if len(blob) > 2000 else ""))
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
