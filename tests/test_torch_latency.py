"""TorchCSP's latency tier on the CPU: vote buckets, the quorum hint and
its speculative flush, tier tags, and the K3 slot ring.

On the CPU a K3 slot has no graph: it stages into its buffer and runs
the plain version, so the ring's rules (a slot is taken under the
provider's lock and given back only by the drainer after its verdict
was read; no ring → a counted cold fallback; every slot busy → an eager
launch, not counted) are exercised here as on the card. The knobs are
held against the reference's (``bdls_tpu/crypto/tpu_provider.py``).
Verdicts are compared exactly.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import pytest
import torch

from bdls_tpu.crypto import tpu_provider as jtp
from bdls_tpu_torch.consensus.verifier import CspBatchVerifier
from bdls_tpu_torch.crypto import marshal, vectors
from bdls_tpu_torch.crypto import torch_provider as tp
from bdls_tpu_torch.crypto.csp import PublicKey, VerifyRequest
from bdls_tpu_torch.crypto.sw import SwCSP
from bdls_tpu_torch.crypto.torch_provider import TorchCSP
from bdls_tpu_torch.ops import ecdsa
from bdls_tpu_torch.ops.curves import CURVES
from bdls_tpu_torch.utils import tracing
from bdls_tpu_torch.utils.metrics import MetricsProvider, audit_exposition

# the plain version runs many ops on tiny tensors: extra intra-op
# threads only contend with the other test workers
torch.set_num_threads(1)

CURVE = "secp256k1"


def _reqs(lanes, curve=CURVE):
    return [VerifyRequest(PublicKey(curve, qx, qy), d, r, s)
            for qx, qy, r, s, d, _ in lanes]


@pytest.fixture(scope="module")
def votes():
    """21 secp256k1 requests: valid, tampered and hostile."""
    rng = np.random.default_rng(71)
    lanes = vectors.mixed_lanes(CURVE, rng, n_valid=2)[:21]
    return _reqs(lanes)


@pytest.fixture
def stub_launch(monkeypatch):
    """The eager K1 launch as an all-True stub; records (curve, B)."""
    calls = []

    def fake(curve, arrs, *, device=None):
        calls.append((curve.name, arrs[0].shape[1]))
        return torch.ones(arrs[0].shape[1], dtype=torch.bool)

    monkeypatch.setattr(ecdsa, "launch_verify", fake)
    return calls


@pytest.mark.parametrize("raw", ["", "0", "off", "no", "1", "on", "default",
                                 "9,33", "85, 9 ,9", "junk", "0,-3",
                                 "171", " ON "])
def test_vote_buckets_env_parses_as_the_reference(monkeypatch, raw):
    monkeypatch.setenv("BDLS_TPU_VOTE_BUCKETS", raw)
    assert tp.default_vote_buckets() == jtp.default_vote_buckets()
    for lanes in ("", "0", "17", "junk", "-5"):
        monkeypatch.setenv("BDLS_TPU_LATENCY_MAX_LANES", lanes)
        assert tp.default_latency_max_lanes() == \
            jtp.default_latency_max_lanes()
    assert tp.VOTE_BUCKETS == jtp.VOTE_BUCKETS == (9, 33, 85, 171)


def test_vote_buckets_merge_into_the_bucket_set(monkeypatch):
    monkeypatch.delenv("BDLS_TPU_VOTE_BUCKETS", raising=False)
    monkeypatch.delenv("BDLS_TPU_LATENCY_MAX_LANES", raising=False)
    a = TorchCSP(device="cpu", key_cache_size=0, buckets=(8,),
                 vote_buckets=(9, 33), latency_max_lanes=16)
    b = TorchCSP(device="cpu", key_cache_size=0)
    monkeypatch.setenv("BDLS_TPU_VOTE_BUCKETS", "1")
    c = TorchCSP(device="cpu", key_cache_size=0, buckets=(8, 128))
    try:
        assert a.buckets == (8, 9, 33) and a.vote_buckets == (9, 33)
        assert a._latency_eligible(9) and not a._latency_eligible(33)
        assert b.buckets == tp.DEFAULT_BUCKETS and b.vote_buckets == ()
        assert b.latency_max_lanes == 256
        assert c.buckets == (8, 9, 33, 85, 128, 171)
        ref = jtp.TpuCSP(buckets=(8, 128), kernel_field="sw",
                         key_cache_size=0)
        assert ref.buckets == c.buckets
        assert set(ref.stats) <= set(c.stats)
        ref.close()
    finally:
        for csp in (a, b, c):
            csp.close()


def test_instruments_keep_reference_names():
    metrics = MetricsProvider()
    csp = TorchCSP(device="cpu", key_cache_size=0, metrics=metrics)
    csp.close()
    for name in ("tpu_dispatch_speculative_flushes_total",
                 "tpu_latency_launches_total",
                 "tpu_latency_cold_fallbacks_total",
                 "tpu_vote_rtt_seconds"):
        assert metrics.find(name) is not None, name
    assert audit_exposition(metrics) == []


def test_slot_stages_like_pad_lanes():
    rng = np.random.default_rng(72)
    arrs = marshal.marshal_requests(
        _reqs(vectors.signed_lanes(CURVE, 5, rng)))
    slot = ecdsa.LatencySlot(CURVES[CURVE], 9, device="cpu")
    slot.stage(arrs)
    want = np.stack(marshal.pad_lanes(arrs, 9)).view(np.int32)
    assert np.array_equal(slot.host.numpy(), want)
    assert slot.graph is None
    assert slot.launch().tolist() == [True] * 9


def test_quorum_hint_arms_the_speculative_flush(stub_launch):
    """With the committee's 2t+1 as the hint, the ninth submit launches
    at once: the futures resolve long before the 60 s window."""
    csp = TorchCSP(device="cpu", key_cache_size=0, buckets=(16,),
                   vote_buckets=(9,), flush_interval=60.0)
    try:
        assert csp.buckets == (9, 16)
        CspBatchVerifier(csp, consenters=[bytes([i + 1]) * 64
                                          for i in range(13)])
        assert csp.quorum_lanes == 9
        rng = np.random.default_rng(73)
        reqs = _reqs(vectors.signed_lanes(CURVE, 9, rng))
        t0 = time.perf_counter()
        futs = [csp.submit(r) for r in reqs]
        assert all(f.result(30.0) for f in futs)
        wall = time.perf_counter() - t0
        st = csp.stats
    finally:
        csp.close()
    assert wall < 10.0, f"votes waited for the window: {wall:.2f} s"
    assert st["speculative_flushes"] >= 1 and st["quorum_lanes"] == 9
    assert stub_launch == [(CURVE, 9)]
    # no ring was warmed: the latency-tier launch was a cold fallback
    assert st["latency_cold_fallbacks"] == 1 and st["latency_launches"] == 0


def test_below_the_quorum_waits_for_the_window(stub_launch):
    csp = TorchCSP(device="cpu", key_cache_size=0, buckets=(16,),
                   flush_interval=0.2)
    try:
        csp.set_quorum_hint(9)
        reqs = _reqs(vectors.signed_lanes(CURVE, 3,
                                          np.random.default_rng(74)))
        futs = [csp.submit(r) for r in reqs]
        assert all(f.result(30.0) for f in futs)
        st = csp.stats
    finally:
        csp.close()
    assert st["speculative_flushes"] == 0


def test_tiers_k3_only_for_unpinned_ecdsa():
    """Tags and routes: a warmed generic bucket takes a K3 slot; a
    pinned group and an Ed25519 group never do (Ed25519 keeps the
    latency tag, as the reference); an unwarmed bucket is a cold
    fallback; a group that finds every slot busy launches eagerly and
    counts nothing."""
    rng = np.random.default_rng(75)
    metrics = MetricsProvider()
    tracer = tracing.Tracer(metrics=metrics)
    csp = TorchCSP(device="cpu", buckets=(8, 32), metrics=metrics,
                   tracer=tracer)
    k1 = vectors.signed_lanes(CURVE, 3, rng)
    pinned_lane = vectors.signed_lanes(CURVE, 1, rng)
    p256 = vectors.signed_lanes("P-256", 2, rng)
    ed = vectors.ed25519_signed_lanes(2, rng)
    sw = SwCSP()
    try:
        csp.warmup([(CURVE, 8)])
        assert csp.stats["donation_allocs"] == tp.RING_SLOTS
        csp.warm_keys([PublicKey(CURVE, *pinned_lane[0][:2])], wait=True)
        assert csp.verify_batch(_reqs(k1)) == [True] * 3
        st = csp.stats
        assert (st["latency_launches"], st["latency_cold_fallbacks"]) == (1, 0)
        assert csp.verify_batch(_reqs(pinned_lane)) == [True]
        assert csp.stats["pinned_lanes"] == 1
        assert csp.verify_batch(_reqs(ed, "ed25519")) == [True, True]
        assert csp.verify_batch(_reqs(p256, "P-256")) == [True, True]
        st = csp.stats
        assert (st["latency_launches"], st["latency_cold_fallbacks"]) == (1, 1)
        # every slot busy: the eager launch, nothing counted
        taken = [csp._take_slot(CURVE, 8) for _ in range(tp.RING_SLOTS)]
        assert all(taken) and csp._take_slot(CURVE, 8) is None
        # (fresh keys: k1's were pinned in the background by now)
        busy = _reqs(vectors.signed_lanes(CURVE, 3, rng))
        busy[0] = VerifyRequest(busy[0].key, busy[0].digest,
                                busy[0].r ^ 1, busy[0].s)
        assert csp.verify_batch(busy) == sw.verify_batch(busy) == \
            [False, True, True]
        for slot in taken:
            csp._give_slot(slot)
        st = csp.stats
        assert (st["latency_launches"], st["latency_cold_fallbacks"]) == (1, 1)
        assert len(csp._ring_free[(CURVE, 8)]) == tp.RING_SLOTS
    finally:
        csp.close()
    spans = [s for t in tracer.completed() for s in t["spans"]
             if s["name"] == "tpu.kernel"]
    tiers = [(s["attrs"]["curve"], s["attrs"]["pinned"], s["attrs"]["tier"])
             for s in spans]
    assert sorted(tiers) == sorted([
        (CURVE, False, "latency"), (CURVE, True, "throughput"),
        ("ed25519", False, "latency"), ("P-256", False, "latency"),
        (CURVE, False, "latency")])
    assert metrics.find("tpu_vote_rtt_seconds").snapshot()["count"] == 4


def test_ring_repro_is_stable_and_right(votes):
    """21 secp256k1 requests at buckets=(8,): three chunks of one
    (curve, bucket), more than its two slots. Three runs give the same
    verdicts, equal to SwCSP's, and every slot comes back."""
    want = SwCSP().verify_batch(votes)
    csp = TorchCSP(device="cpu", key_cache_size=0, buckets=(8,))
    try:
        csp.warmup([(CURVE, 8)])
        runs = [csp.verify_batch(votes) for _ in range(3)]
        st = csp.stats
        free = len(csp._ring_free[(CURVE, 8)])
    finally:
        csp.close()
    assert runs == [want] * 3
    assert any(want) and not all(want)
    assert st["batches"] == 9 and st["fallbacks"] == 0
    assert st["latency_launches"] >= 3 and st["latency_cold_fallbacks"] == 0
    assert free == tp.RING_SLOTS


def test_slot_returns_only_after_the_verdict_was_read(monkeypatch, votes):
    """The drainer gives a slot back after it read the verdict: while a
    launch's result is held back, its slot stays taken. The flusher's
    window is 60 s, so the five submits go out as the one batch of the
    explicit flush: under the 2 ms default a loaded machine can split
    them into two batches, each holding a slot of its own."""
    csp = TorchCSP(device="cpu", key_cache_size=0, buckets=(8,),
                   flush_interval=60.0)
    gate = threading.Event()
    real = tp.TorchCSP._materialize

    def slow(dev):
        gate.wait(30.0)
        return real(dev)

    try:
        csp.warmup([(CURVE, 8)])
        monkeypatch.setattr(csp, "_materialize", slow)
        futs = [csp.submit(r) for r in votes[:5]]
        csp.flush()
        deadline = time.time() + 30.0
        while csp.stats["latency_launches"] < 1 and time.time() < deadline:
            time.sleep(0.01)
        assert len(csp._ring_free[(CURVE, 8)]) == tp.RING_SLOTS - 1
        gate.set()
        got = [f.result(30.0) for f in futs]
        deadline = time.time() + 30.0
        while (len(csp._ring_free[(CURVE, 8)]) < tp.RING_SLOTS
               and time.time() < deadline):
            time.sleep(0.01)
        assert len(csp._ring_free[(CURVE, 8)]) == tp.RING_SLOTS
    finally:
        gate.set()
        csp.close()
    assert got == SwCSP().verify_batch(votes[:5])
