"""``python -m bdls_tpu_torch.chaos.loadgen``: the port's chaos soak
command line, the counterpart of the reference's ``tools/loadgen.py``.

The same flags and record shape; ``--dryrun`` verifies on the host
(``device="cpu", kernel_field="sw"``) with neither ``force_cpu`` nor
the ECDSA stand-in; the record goes to ``build/GPU_CHAOS_suite.json``
unless ``--out`` says otherwise, never to a ``CHAOS_*.json`` at the
repository's root (the reference's gate globs those as its baselines).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from bdls_tpu_torch.chaos import loadgen

ROOT = Path(__file__).resolve().parents[1]
RECORD_KEYS = {"metric", "schema", "source", "injected_regression", "ok",
               "scenarios"}


def test_dryrun_single_scenario(tmp_path):
    out = tmp_path / "suite.json"
    rc = loadgen.main(["--dryrun", "--scenario", "loss_crash",
                       "--out", str(out)])
    assert rc == 0
    blob = json.loads(out.read_text())
    assert set(blob) == RECORD_KEYS
    assert blob["metric"] == "chaos_suite" and blob["source"] == "dryrun"
    assert blob["ok"] and not blob["injected_regression"]
    assert list(blob["scenarios"]) == ["loss_crash"]
    rec = blob["scenarios"]["loss_crash"]
    assert rec["ok"] and rec["provider"] == {"device": "cpu",
                                             "kernel_field": "sw"}


def test_plan_file_mode(tmp_path):
    """A user FaultPlan JSON runs through the same pipeline."""
    plan = tmp_path / "myplan.json"
    plan.write_text(json.dumps({
        "name": "tiny", "seed": 1, "events": [
            {"kind": "net.loss", "at": 0.2, "duration": 0.5,
             "params": {"p": 0.2}}]}))
    out = tmp_path / "tiny.json"
    rc = loadgen.main(["--dryrun", "--plan", str(plan), "--heights", "3",
                       "--out", str(out)])
    assert rc == 0
    rec = json.loads(out.read_text())["scenarios"]["tiny"]
    assert rec["ok"] and min(rec["heights"]) >= 3


def test_a_broken_plan_file_exits(tmp_path):
    plan = tmp_path / "bad.json"
    plan.write_text(json.dumps({"seed": 1, "events": [
        {"kind": "meteor.strike", "at": 0.2}]}))
    with pytest.raises(SystemExit, match="bad fault plan"):
        loadgen.main(["--dryrun", "--plan", str(plan),
                      "--out", str(tmp_path / "x.json")])


def test_unknown_scenario_raises(tmp_path):
    with pytest.raises(ValueError, match="unknown scenario 'meteor_strike'"):
        loadgen.main(["--dryrun", "--scenario", "meteor_strike",
                      "--out", str(tmp_path / "x.json")])


def test_the_record_goes_under_build_by_default(tmp_path, monkeypatch):
    assert loadgen.DEFAULT_OUT == os.path.join("build",
                                               "GPU_CHAOS_suite.json")
    monkeypatch.chdir(tmp_path)
    rc = loadgen.main(["--dryrun", "--scenario", "loss_crash",
                       "--heights", "2"])
    assert rc == 0
    assert (tmp_path / "build" / "GPU_CHAOS_suite.json").is_file()
    assert sorted(p.name for p in tmp_path.iterdir()) == ["build"]


def test_inject_regression_exits_one(tmp_path):
    out = tmp_path / "reg.json"
    rc = loadgen.main(["--dryrun", "--scenario", "loss_crash",
                       "--inject-regression", "--out", str(out)])
    assert rc == 1
    blob = json.loads(out.read_text())
    assert blob["injected_regression"] and not blob["ok"]


def test_runs_as_a_module(tmp_path):
    out = tmp_path / "m.json"
    proc = subprocess.run(
        [sys.executable, "-m", "bdls_tpu_torch.chaos.loadgen", "--dryrun",
         "--scenario", "loss_crash", "--clients", "4", "--seed", "7",
         "--max-wall-s", "120", "--out", str(out)],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "--- scenario loss_crash: 4 validators" in proc.stderr
    assert json.loads(out.read_text())["ok"]
    assert proc.stdout.startswith('{"metric": "chaos_suite"')
