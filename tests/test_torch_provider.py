"""TorchCSP's dispatcher on the CPU: accumulator, screens, buckets,
fallback accounting, instruments and spans.

The verdict parity with the JAX package's ``TpuCSP`` lives in
``test_torch_verify.py`` (it shares that file's compiled reference
programs). Here the provider runs the plain PyTorch version
(``device="cpu"``), or a stub launch where only the dispatch shape is
under test. These tests are about the generic path, so they turn the
key cache off (``key_cache_size=0``); the pinned partition is tested in
``test_torch_key_cache.py``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from bdls_tpu_torch.crypto import factory, vectors
from bdls_tpu_torch.crypto import torch_provider as tp
from bdls_tpu_torch.crypto.csp import PublicKey, VerifyRequest
from bdls_tpu_torch.crypto.marshal import from_wire_fields
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
def lanes():
    return vectors.mixed_lanes(CURVE, np.random.default_rng(31), n_valid=3)


@pytest.fixture
def stub_launch(monkeypatch):
    """Replace the launch with an all-True verdict; records (curve, B)."""
    calls = []

    def fake(curve, arrs, *, device=None):
        calls.append((curve.name, arrs[0].shape[1]))
        return torch.ones(arrs[0].shape[1], dtype=torch.bool)

    monkeypatch.setattr(ecdsa, "launch_verify", fake)
    return calls


def test_submit_flush_resolves_futures(lanes):
    ls = lanes[:8]
    csp = TorchCSP(device="cpu", key_cache_size=0,
                   buckets=(8,), flush_interval=0.01)
    try:
        futs = [csp.submit(r) for r in _reqs(ls)]
        csp.flush()
        got = [f.result(120) for f in futs]
    finally:
        csp.close()
    assert got == vectors.expected(CURVE, ls)
    assert csp.stats["batches"] >= 1 and csp.stats["fallbacks"] == 0
    assert csp.stats["verified"] == len(ls)


def test_deadline_flush_without_explicit_flush(stub_launch):
    csp = TorchCSP(device="cpu", key_cache_size=0,
                   buckets=(8,), flush_interval=0.005)
    try:
        fut = csp.submit(_reqs(vectors.signed_lanes(CURVE, 1,
                                                    np.random.default_rng(2)))[0])
        assert fut.result(30) is True
    finally:
        csp.close()
    assert stub_launch == [(CURVE, 8)]


def test_instruments_and_spans_keep_reference_names(lanes):
    metrics = MetricsProvider()
    tracer = tracing.Tracer(metrics=metrics)
    csp = TorchCSP(device="cpu", key_cache_size=0,
                   buckets=(8,), metrics=metrics,
                   tracer=tracer)
    try:
        got = csp.verify_batch(_reqs(lanes[:3]))
    finally:
        csp.close()
    assert got == vectors.expected(CURVE, lanes[:3])
    for name in ("tpu_verify_batches_total", "tpu_verify_requests_total",
                 "tpu_verify_fallbacks_total", "tpu_verify_padded_lanes_total",
                 "tpu_verify_queue_wait_seconds", "tpu_verify_marshal_seconds",
                 "tpu_dispatch_inflight_batches", "tpu_vote_rtt_seconds",
                 "tpu_compile_seconds", "tpu_compile_programs_total",
                 "tpu_compile_cache_hits_total"):
        assert metrics.find(name) is not None, name
    assert metrics.find("tpu_verify_requests_total").value() == 3
    assert metrics.find("tpu_verify_padded_lanes_total").value() == 5
    assert metrics.find("tpu_vote_rtt_seconds").snapshot()["count"] == 1
    assert audit_exposition(metrics) == []
    names = {s["name"] for t in tracer.completed() for s in t["spans"]}
    assert {"tpu.verify_batch", "tpu.queue_wait", "tpu.marshal", "tpu.kernel",
            "tpu.dispatch_inflight", "tpu.fold"} <= names
    kernel = [s for t in tracer.completed() for s in t["spans"]
              if s["name"] == "tpu.kernel"]
    assert kernel[0]["attrs"]["kernel"] == "fold"
    assert kernel[0]["attrs"]["runs"] == "plain"
    assert kernel[0]["attrs"]["tier"] == "latency"


def test_buckets_chunks_and_tiers(stub_launch):
    metrics = MetricsProvider()
    csp = TorchCSP(device="cpu", key_cache_size=0,
                   buckets=(8, 32), metrics=metrics,
                   latency_max_lanes=8)
    rng = np.random.default_rng(4)
    k1 = _reqs(vectors.signed_lanes(CURVE, 1, rng))[0]
    p256 = _reqs(vectors.signed_lanes("P-256", 1, rng), "P-256")[0]
    try:
        got = csp.verify_batch([k1] * 70 + [p256] * 3)
    finally:
        csp.close()
    assert all(got) and len(got) == 73
    # 70 secp256k1 lanes: two full max-bucket chunks and 6 padded to 8
    assert sorted(stub_launch) == sorted([(CURVE, 32), (CURVE, 32),
                                          (CURVE, 8), ("P-256", 8)])
    assert csp.stats["padded"] == 2 + 5
    assert csp.stats["batches"] == 4
    # only the two 8-lane (latency-tier) launches observe the vote RTT
    assert metrics.find("tpu_vote_rtt_seconds").snapshot()["count"] == 2


def test_host_screen_never_reaches_the_kernel(stub_launch):
    rng = np.random.default_rng(6)
    qx, qy, r, s, d, _ = vectors.signed_lanes("P-256", 1, rng)[0]
    n = CURVES["P-256"].fn.modulus
    bad = [
        VerifyRequest(PublicKey("P-256", qx, qy), d, r, n - s),   # high-S
        VerifyRequest(PublicKey("P-256", qx, qy), d, r + (1 << 256), s),
        VerifyRequest(PublicKey("P-256", qx, qy), d, r, -s),
        VerifyRequest(PublicKey("P-256", qx, qy), b"\1" + d, r, s),
    ]
    csp = TorchCSP(device="cpu", key_cache_size=0, buckets=(8,))
    sw = SwCSP()
    key = sw.key_gen("ed25519", rng)
    msg = b"vote"
    try:
        assert csp.verify_batch(bad) == [False] * 4
        # a curve the port lacks still raises; Ed25519 verifies (K8's
        # plain twin, not the ECDSA launch)
        with pytest.raises(ValueError, match="unsupported curve"):
            csp.verify_batch([VerifyRequest(PublicKey("P-384", 1, 1),
                                            d, 1, 1)])
        r, s_ = sw.sign(key, msg)
        assert csp.verify_batch([
            VerifyRequest(key.public_key(), msg, r, s_),
            VerifyRequest(key.public_key(), msg + b"!", r, s_)]) == [
                True, False]
    finally:
        csp.close()
    assert stub_launch == []


def test_fallback_is_counted_or_raises(monkeypatch, lanes):
    def broken(curve, arrs, *, device=None):
        raise RuntimeError("launch refused")

    monkeypatch.setattr(ecdsa, "launch_verify", broken)
    ls = lanes[:5]
    metrics = MetricsProvider()
    csp = TorchCSP(device="cpu", key_cache_size=0,
                   buckets=(8,), metrics=metrics,
                   use_cpu_fallback=True)
    try:
        got = csp.verify_batch(_reqs(ls))
    finally:
        csp.close()
    assert got == vectors.expected(CURVE, ls)
    assert csp.stats["fallbacks"] == 1
    assert metrics.find("tpu_verify_fallbacks_total").value() == 1

    strict = TorchCSP(device="cpu", key_cache_size=0,
                      buckets=(8,), use_cpu_fallback=False)
    try:
        with pytest.raises(RuntimeError, match="launch refused"):
            strict.verify_batch(_reqs(ls))
    finally:
        strict.close()
    assert strict.stats["fallbacks"] == 0


def test_card_refuses_cpu_fallback_and_warmup_raises(monkeypatch):
    # on the card a failed launch fails its futures: asking for the sw
    # fallback there is refused before anything is built
    monkeypatch.setattr(tp, "resolve_device",
                        lambda device: torch.device("cuda"))
    with pytest.raises(ValueError, match="device='cpu' only"):
        TorchCSP(use_cpu_fallback=True)
    monkeypatch.undo()

    def broken(curve, arrs, *, device=None):
        raise RuntimeError("launch refused")

    monkeypatch.setattr(ecdsa, "launch_verify", broken)
    csp = TorchCSP(device="cpu", key_cache_size=0, buckets=(8,))
    try:
        with pytest.raises(RuntimeError, match="launch refused"):
            csp.warmup([(CURVE, 8)])
        csp.warmup([(CURVE, 8)], strict=False)
    finally:
        csp.close()
    assert csp.stats["warmed"] == 0 and csp.stats["fallbacks"] == 0


def test_warmup_health_and_stats(stub_launch):
    csp = TorchCSP(device="cpu", key_cache_size=0, buckets=(8, 32))
    try:
        csp.warmup([(CURVE, 8), ("P-256", 32)], strict=True)
        csp.warmup([(CURVE, 8)])
        assert csp.healthy()
        st = csp.stats
    finally:
        csp.close()
    assert st["warmed"] == 2 and st["kernel"] == "fold"
    assert st["runs"] == "plain"
    assert st["device"] == "cpu"
    assert sorted(stub_launch) == [("P-256", 32), (CURVE, 8)]
    assert csp.metrics.find("tpu_compile_cache_hits_total").value(
        ("warmed",)) == 1


def test_wire_requests_match_int_requests(lanes):
    ls = lanes[:8]
    csp = TorchCSP(device="cpu", key_cache_size=0,
                   buckets=(8,), use_cpu_fallback=False)
    try:
        ints = csp.verify_batch(_reqs(ls))
        wire = csp.verify_batch([from_wire_fields(
            CURVE, qx.to_bytes(32, "big"), qy.to_bytes(32, "big"),
            r.to_bytes(32, "big"), s.to_bytes(32, "big"), d)
            for qx, qy, r, s, d, _ in ls])
    finally:
        csp.close()
    assert wire == ints == vectors.expected(CURVE, ls)


def test_sw_provider_applies_low_s_policy():
    rng = np.random.default_rng(8)
    sw = SwCSP()
    for curve in ("P-256", "secp256k1"):
        key = sw.key_gen(curve, rng)
        d = sw.hash(b"block")
        r, s = sw.sign(key, d)
        pub = key.public_key()
        n = CURVES[curve].fn.modulus
        assert sw.verify(VerifyRequest(pub, d, r, s))
        assert sw.verify(VerifyRequest(pub, d, r, n - s)) == (
            curve == "secp256k1")
        assert not sw.verify(VerifyRequest(pub, sw.hash(b"other"), r, s))
        assert sw.key_import(curve, pub.x, pub.y) == pub
        with pytest.raises(ValueError):
            sw.key_import(curve, pub.x, pub.y + 1)


def test_factory_names():
    assert isinstance(factory.get_csp(factory.FactoryOpts()), SwCSP)
    csp = factory.get_csp(factory.FactoryOpts(default="TORCH",
                                              torch_device="cpu"))
    try:
        assert isinstance(csp, TorchCSP) and csp.kernel == "plain"
    finally:
        csp.close()
    with pytest.raises(ValueError):
        factory.get_csp(factory.FactoryOpts(default="TPU"))
    assert tp.DEFAULT_BUCKETS == (8, 32, 128, 512, 2048, 8192)
