"""TorchCSP's bounded accumulator and its stall seam, on the CPU.

The counterparts of the reference's accumulator tests
(``tests/test_overload.py:341`` onwards): with ``pending_cap`` set,
``"reject"`` raises :class:`AccumulatorSaturated` at once, ``"block"``
parks the submitter until a flush drains room and raises after
``dispatch_timeout``, an unknown policy is a ``ValueError``. Each
sequence also runs on the reference's ``TpuCSP``, both with a stub
launch whose verdict is r's low bit, and the two give the same outcome
at every step. Then the reference's chaos fault ``device.stall``
(``bdls_tpu/chaos/injectors.py``), engaged on a ``TorchCSP`` through
its ``ChaosEngine``: verdicts unchanged, each launch's verdict read at
least ``stall_s`` late while the flush thread goes on launching, and
the setting restored when the fault reverts.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import pytest
import torch

from bdls_tpu.chaos.injectors import ChaosContext, ChaosEngine
from bdls_tpu.chaos.plan import FaultEvent, FaultPlan
from bdls_tpu.crypto import tpu_provider as jtp
from bdls_tpu.crypto.csp import PublicKey as JPublicKey
from bdls_tpu.crypto.csp import VerifyRequest as JVerifyRequest
from bdls_tpu_torch.crypto.csp import PublicKey, VerifyRequest
from bdls_tpu_torch.crypto.torch_provider import AccumulatorSaturated, \
    TorchCSP

torch.set_num_threads(1)


def _port_launch(self, curve, size, arrs, slots=None, pools=None,
                 reqs=None):
    oks = [bool(r.r & 1) for r in reqs]
    return torch.tensor(oks + [False] * (size - len(oks)))


def _reference_launch(self, curve, size, arrs, reqs, slots=None,
                      pools=None):
    def run():
        oks = [bool(r.r & 1) for r in reqs]
        return np.asarray(oks + [False] * (size - len(oks)))

    return run


# the two providers under one interface: (class, request types, error)
SIDES = {
    "port": (TorchCSP, PublicKey, VerifyRequest, AccumulatorSaturated,
             {"device": "cpu"}),
    "reference": (jtp.TpuCSP, JPublicKey, JVerifyRequest,
                  jtp.AccumulatorSaturated, {}),
}


@pytest.fixture(autouse=True)
def _stub_launches(monkeypatch):
    monkeypatch.setattr(TorchCSP, "_launch_kernel", _port_launch)
    monkeypatch.setattr(jtp.TpuCSP, "_launch_kernel", _reference_launch)


def _make(side, **kw):
    cls, pub, req, err, extra = SIDES[side]

    def mk(seq, want):
        """Verdict rides r's low bit (echoed by the stub launch)."""
        return req(pub("P-256", seq + 10, seq + 11), seq.to_bytes(32, "big"),
                   ((seq << 1) | int(want)) or 2, 1)

    kw.setdefault("flush_interval", 5.0)
    return cls(buckets=(8,), **extra, **kw), mk, err


def _outcome(fn, err):
    try:
        return ("ok", fn())
    except err:
        return ("saturated",)


def _reject_sequence(side) -> list:
    csp, mk, err = _make(side, pending_cap=2, pending_policy="reject")
    steps = []
    try:
        futs = [csp.submit(mk(i, True)) for i in range(2)]
        steps.append(_outcome(lambda: csp.submit(mk(2, True)) and None, err))
        csp.flush()                      # drains the queue...
        steps.append([f.result(5.0) for f in futs])
        fut = csp.submit(mk(3, False))   # ...reopening admission
        csp.flush()
        steps.append(fut.result(5.0))
    finally:
        csp.close()
    return steps


def _block_timeout_sequence(side) -> list:
    csp, mk, err = _make(side, dispatch_timeout=0.2, pending_cap=2,
                         pending_policy="block")
    steps = []
    try:
        for i in range(2):
            csp.submit(mk(i, True))
        t0 = time.monotonic()
        steps.append(_outcome(lambda: csp.submit(mk(2, True)) and None, err))
        steps.append(time.monotonic() - t0 >= 0.2)
    finally:
        csp.close()
    return steps


def _block_unpark_sequence(side) -> list:
    csp, mk, err = _make(side, dispatch_timeout=10.0, pending_cap=2,
                         pending_policy="block")
    steps = []
    try:
        futs = [csp.submit(mk(i, True)) for i in range(2)]
        parked = {}

        def late():
            parked["fut"] = csp.submit(mk(2, False))

        t = threading.Thread(target=late)
        t.start()
        time.sleep(0.1)
        steps.append(t.is_alive())       # parked on the cap
        csp.flush()                      # drain -> notify -> proceeds
        t.join(timeout=5.0)
        steps.append(t.is_alive())
        steps.append([f.result(5.0) for f in futs])
        csp.flush()
        steps.append(parked["fut"].result(5.0))
    finally:
        csp.close()
    return steps


SEQUENCES = {
    "reject": (_reject_sequence, [("saturated",), [True, True], False]),
    "block_times_out": (_block_timeout_sequence, [("saturated",), True]),
    "block_unparks_on_flush": (_block_unpark_sequence,
                               [True, False, [True, True], False]),
}


@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_accumulator_policy_matches_the_reference(name):
    run, want = SEQUENCES[name]
    assert run("port") == want
    assert run("reference") == run("port")


def test_accumulator_rejects_unknown_policy():
    for side in SIDES:
        with pytest.raises(ValueError):
            _make(side, pending_cap=2, pending_policy="drop")


def test_unbounded_by_default():
    csp, mk, _ = _make("port")
    try:
        assert csp.pending_cap == 0 and csp.pending_policy == "block"
        futs = [csp.submit(mk(i, i % 2 == 0)) for i in range(50)]
        csp.flush()
        assert [f.result(5.0) for f in futs] == [i % 2 == 0
                                                 for i in range(50)]
    finally:
        csp.close()


def test_device_stall_fault_delays_verdicts_not_launches():
    """The reference's ``device.stall`` fault on the port: verdicts
    unchanged, each launch's verdict read ``stall_s`` late by the
    drainer, the flush thread back at once so that a second launch is in
    flight beside the first, and the knob restored."""
    stall = 0.4
    csp, mk, _ = _make("port", key_cache_size=0, flush_interval=60.0)
    reqs = [mk(i, i % 3 != 1) for i in range(8)]
    want = [i % 3 != 1 for i in range(8)]
    plan = FaultPlan(seed=1, events=(FaultEvent(
        "device.stall", at=0.0, duration=1.0, params={"stall_s": stall}),))
    engine = ChaosEngine(plan, ChaosContext(csp=csp))
    try:
        assert [f.result(5.0) for f in _round(csp, reqs)[0]] == want
        engine.step(0.0)
        assert csp.chaos_stall_s == stall
        rounds = [_round(csp, reqs) for _ in range(2)]
        # the flush thread only launched; it never slept the stall
        assert all(flush_s < stall / 4 for _, _, flush_s in rounds)
        late = []
        for futs, t_flush, _ in rounds:
            assert [f.result(5.0) for f in futs] == want
            late.append(time.perf_counter() - t_flush)
        assert all(d >= stall for d in late), late
        assert csp.stats["max_inflight"] >= 2
        engine.step(1.0)                 # the window closes: reverted
        assert csp.chaos_stall_s == 0.0 and engine.done
        assert [f.result(5.0) for f in _round(csp, reqs)[0]] == want
    finally:
        csp.close()


def _round(csp, reqs):
    futs = [csp.submit(r) for r in reqs]
    t0 = time.perf_counter()
    csp.flush()
    return futs, t0, time.perf_counter() - t0
