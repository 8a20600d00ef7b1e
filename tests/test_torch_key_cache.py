"""The port's KeyTableCache and TorchCSP's pinned partition, on the CPU.

Counterparts of the reference's cache tests (``test_pinned_keys.py:
368-500``): LRU eviction under churn, a pool snapshot surviving an
eviction, concurrent misses then hits, the lazy background build and
invalid points rejected quietly. Then the case the copy-on-write pool
exists for: a slot evicted and re-pinned to another key while a launch
that looked it up is still pending must not change that launch's
verdicts. And TorchCSP's partition: hits run the pinned-key program,
misses the generic one, each chunked at the largest bucket, padded
pinned lanes repeat lane 0's slot, pinned groups are throughput-tier.
The provider runs the plain version (``device="cpu"``), or a stub
launch where only the dispatch shape is under test. Exact comparisons.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import pytest
import torch

from bdls_tpu_torch.crypto import vectors
from bdls_tpu_torch.crypto.csp import PublicKey, VerifyRequest
from bdls_tpu_torch.crypto.key_cache import KeyTableCache
from bdls_tpu_torch.crypto.marshal import ints_to_limbs
from bdls_tpu_torch.crypto.sw import SwCSP, _mul_add
from bdls_tpu_torch.crypto.torch_provider import TorchCSP
from bdls_tpu_torch.ops import ecdsa
from bdls_tpu_torch.ops import verify_fold as vf
from bdls_tpu_torch.ops.curves import CURVES
from bdls_tpu_torch.utils import tracing
from bdls_tpu_torch.utils.metrics import MetricsProvider

# the plain version runs many ops on tiny tensors: extra intra-op
# threads only contend with the other test workers
torch.set_num_threads(1)

K1 = "secp256k1"


def _keyset(curve, scalars):
    cv = CURVES[curve]
    return [PublicKey(curve, *_mul_add(cv, d, (cv.gx, cv.gy)))
            for d in scalars]


def _fresh(key):
    return vf.pinned_device_tables(
        key.curve, vf.build_pinned_tables(key.curve, key.x, key.y))


def _signed(curve, scalars, msgs):
    sw = SwCSP()
    out = []
    for d, msg in zip(scalars, msgs):
        h = sw.key_from_scalar(curve, d)
        digest = sw.hash(msg)
        r, s = sw.sign(h, digest)
        out.append(VerifyRequest(h.public_key(), digest, r, s))
    return out


def _wait(pred, timeout=30.0):
    deadline = time.time() + timeout
    while not pred() and time.time() < deadline:
        time.sleep(0.02)
    return pred()


# ---- the cache -------------------------------------------------------------

def test_key_cache_lru_eviction_under_churn():
    cache = KeyTableCache(capacity=3, device="cpu")
    keys = _keyset(K1, range(2, 8))
    for k in keys[:3]:
        cache.pin(k)
    assert len(cache) == 3 and cache.stats["evictions"] == 0
    slots0, _ = cache.lookup_batch(K1, keys[:3])
    assert sorted(slots0) == [0, 1, 2]
    # keys[0] was just touched -> keys[1] is now LRU; a 4th key takes
    # its slot
    cache.lookup_batch(K1, [keys[0]])
    assert cache.pin(keys[3]) == slots0[1]
    assert cache.stats["evictions"] == 1
    assert not cache.contains(keys[1])
    for k in keys * 2:
        cache.pin(k)
    assert len(cache) == 3
    slots, pools = cache.lookup_batch(K1, keys[-3:])
    assert sorted(slots) == [0, 1, 2]
    assert tuple(pools["x"].shape) == (3, vf.pinned_positions(K1), 9, 8)
    # a resolved slot holds exactly a fresh build of its key's tables
    for k, s in zip(keys[-3:], slots):
        for nm, t in _fresh(k).items():
            assert np.array_equal(pools[nm][s].numpy(), t), nm
    assert sorted(cache.skis()[K1]) == sorted(k.ski().hex()
                                              for k in keys[-3:])
    cache.close()


def test_key_cache_snapshot_survives_eviction():
    cache = KeyTableCache(capacity=1, device="cpu")
    k1, k2 = _keyset(K1, [5, 6])
    cache.pin(k1)
    slots, pools = cache.lookup_batch(K1, [k1])
    before = pools["x"][slots[0]].clone()
    cache.pin(k2)                         # evicts k1, reuses slot 0
    assert cache.stats["evictions"] == 1
    assert torch.equal(pools["x"][slots[0]], before)
    slots2, pools2 = cache.lookup_batch(K1, [k2])
    assert slots2[0] == slots[0]
    assert not torch.equal(pools2["x"][slots2[0]], before)
    assert np.array_equal(pools2["x"][0].numpy(), _fresh(k2)["x"])


def test_key_cache_concurrent_miss_then_hit():
    cache = KeyTableCache(capacity=8, device="cpu")
    keys = _keyset(K1, range(20, 26))
    fresh = {k: _fresh(k)["x"] for k in keys}
    errs = []

    def worker(seed):
        try:
            for i in range(10):
                ks = [keys[(seed + i + j) % len(keys)] for j in range(3)]
                slots, pools = cache.lookup_batch(K1, ks)
                for k, s in zip(ks, slots):
                    if s is None:
                        cache.pin(k)
                    elif not np.array_equal(pools["x"][s].numpy(), fresh[k]):
                        errs.append((seed, i, s))
        except Exception as exc:  # noqa: BLE001
            errs.append(repr(exc))

    threads = [threading.Thread(target=worker, args=(t,)) for t in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not errs, errs[:3]
    assert len(cache) == len(keys)
    slots, _ = cache.lookup_batch(K1, keys)
    assert None not in slots
    assert cache.stats["hits"] > 0 and cache.stats["misses"] > 0
    cache.close()


def test_key_cache_lazy_miss_builds_in_background():
    cache = KeyTableCache(capacity=4, device="cpu")
    (key,) = _keyset("P-256", [77])
    slots, pools = cache.lookup_batch("P-256", [key])
    assert slots == [None] and pools is None
    assert _wait(lambda: cache.contains(key))
    slots, pools = cache.lookup_batch("P-256", [key])
    assert slots == [0] and pools is not None
    assert set(pools) == {"x", "y"}
    cache.close()


def test_key_cache_rejects_invalid_points_quietly():
    cache = KeyTableCache(capacity=4, device="cpu")
    bad = PublicKey(K1, 5, 7)
    with pytest.raises(ValueError):
        cache.pin(bad)
    cache.warm([bad], wait=True)
    assert cache.stats["build_errors"] == 1
    assert len(cache) == 0
    # the lazy path swallows it too (the builder thread must not die)
    cache.lookup_batch(K1, [bad])
    assert _wait(lambda: cache.stats["build_errors"] == 2)
    good = _keyset(K1, [9])
    cache.warm(good, wait=False)
    assert _wait(lambda: cache.contains(good[0]))
    cache.close()


def test_key_cache_needs_a_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        KeyTableCache(capacity=4)


# ---- a slot re-pinned while a launch that looked it up is pending --------

def _limbs(reqs):
    return [ints_to_limbs(c) for c in (
        [q.r for q in reqs], [q.s for q in reqs],
        [int.from_bytes(q.digest, "big") for q in reqs])]


def test_inflight_slot_reuse_keeps_verdicts():
    """Key A's signatures looked up slot 0; before their launch runs,
    slot 0 is evicted and re-pinned to key B. The launch reads the pool
    it looked up in, so A's valid lanes stay valid and a lane of B's
    signature under slot 0 stays invalid. Against the pool of the new
    binding, the same lanes flip, as they must."""
    cache = KeyTableCache(capacity=1, device="cpu")
    sigs = _signed(K1, [0xA, 0xB], [b"by A", b"by B"])
    a, b = sigs
    cache.pin(a.key)
    slots, pools = cache.lookup_batch(K1, [a.key, a.key])
    assert slots == [0, 0]
    cache.pin(b.key)                      # evicts A; B takes slot 0
    assert cache.lookup_batch(K1, [b.key])[0] == [0]
    lanes = [a, VerifyRequest(a.key, a.digest, a.r ^ 1, a.s), b]
    slot = [0, 0, 0]
    got = ecdsa.launch_verify_pinned(CURVES[K1], _limbs(lanes), slot, pools,
                                     device="cpu").tolist()
    assert got == [True, False, False]
    _, pools_b = cache.lookup_batch(K1, [b.key])
    got_b = ecdsa.launch_verify_pinned(CURVES[K1], _limbs(lanes), slot,
                                       pools_b, device="cpu").tolist()
    assert got_b == [False, False, True]


def test_provider_inflight_slot_reuse(monkeypatch):
    """The same race through TorchCSP: between the flush's lookup and
    its launch, the slot its lanes resolved to is re-pinned to another
    key. The launch still gets the looked-up pool."""
    sigs = _signed(K1, [0x21, 0x22], [b"vote 21", b"vote 22"])
    a, b = sigs
    csp = TorchCSP(device="cpu", buckets=(8,), key_cache_size=1)
    real = ecdsa.launch_verify_pinned
    seen = []

    def racy(curve, arrs, slot, pools, *, device=None):
        csp.key_cache.pin(b.key)          # evicts A's slot mid-flight
        seen.append(list(np.asarray(slot)))
        return real(curve, arrs, slot, pools, device=device)

    try:
        csp.warm_keys([a.key], wait=True)
        monkeypatch.setattr(ecdsa, "launch_verify_pinned", racy)
        got = csp.verify_batch([a, VerifyRequest(a.key, b.digest, a.r, a.s)])
    finally:
        csp.close()
    assert got == [True, False]
    assert seen == [[0] * 8]
    assert csp.stats["pinned_lanes"] == 2
    assert csp.key_cache.contains(b.key) and not csp.key_cache.contains(a.key)


# ---- TorchCSP's partition --------------------------------------------------

def test_partition_hits_pinned_misses_generic():
    metrics = MetricsProvider()
    csp = TorchCSP(device="cpu", buckets=(8,), key_cache_size=8,
                   metrics=metrics)
    rng = np.random.default_rng(12)
    reqs, want = [], []
    for curve in sorted(CURVES):
        ls = vectors.signed_lanes(curve, 3, rng)
        rs = [VerifyRequest(PublicKey(curve, *ln[:2]), ln[4], ln[2], ln[3])
              for ln in ls]
        csp.warm_keys([r.key for r in rs[:2]], wait=True)
        bad_pinned = VerifyRequest(rs[0].key, rs[0].digest, rs[0].r ^ 2,
                                   rs[0].s)
        bad_generic = VerifyRequest(rs[2].key, rs[2].digest, rs[2].r ^ 2,
                                    rs[2].s)
        reqs += rs + [bad_pinned, bad_generic]
        want += [True] * 3 + [False, False]
    try:
        launches = dict(ecdsa.LAUNCHES), dict(ecdsa.LAUNCHES_PINNED)
        got = csp.verify_batch(reqs)
        st = csp.stats
    finally:
        csp.close()
    assert got == want
    # the plain version counts no kernel launch
    assert (dict(ecdsa.LAUNCHES), dict(ecdsa.LAUNCHES_PINNED)) == launches
    assert st["pinned_lanes"] == 6 and st["batches"] == 4
    assert st["fallbacks"] == 0
    assert st["key_cache"]["hits"] == 6 and st["key_cache"]["misses"] == 4
    assert metrics.find("tpu_verify_pinned_lanes_total").value() == 6
    assert metrics.find("tpu_key_cache_hits_total").value() == 6
    assert metrics.find("tpu_key_cache_lookups_total").value() == 10
    # 4 pinned, plus the misses the background builder has pinned since
    assert 4 <= metrics.find("tpu_key_cache_keys").value() <= 6


@pytest.fixture
def stub_both(monkeypatch):
    """Both launches return all-True and record (kind, curve, B, slots)."""
    calls = []

    def generic(curve, arrs, *, device=None):
        calls.append(("generic", curve.name, arrs[0].shape[1], None))
        return torch.ones(arrs[0].shape[1], dtype=torch.bool)

    def pinned(curve, arrs, slot, pools, *, device=None):
        vf.check_pools(curve.name, pools)
        calls.append(("pinned", curve.name, arrs[0].shape[1],
                      list(np.asarray(slot))))
        return torch.ones(arrs[0].shape[1], dtype=torch.bool)

    monkeypatch.setattr(ecdsa, "launch_verify", generic)
    monkeypatch.setattr(ecdsa, "launch_verify_pinned", pinned)
    return calls


def test_pinned_chunks_padding_and_tier(stub_both):
    tracer = tracing.Tracer()
    csp = TorchCSP(device="cpu", buckets=(8, 32), key_cache_size=4,
                   latency_max_lanes=32, tracer=tracer)
    keys = _keyset(K1, [3, 4])
    fresh = _keyset(K1, [5])[0]
    csp.warm_keys(keys, wait=True)
    req = [VerifyRequest(keys[i % 2], b"\1" * 32, 1, 1) for i in range(35)]
    try:
        got = csp.verify_batch(req + [VerifyRequest(fresh, b"\1" * 32, 1, 1)])
    finally:
        csp.close()
    assert all(got)
    pinned = [c for c in stub_both if c[0] == "pinned"]
    # 35 hits: one 32-lane chunk and 3 lanes padded to 8 with lane 0's
    # slot; the miss runs generic, latency-tier
    assert [c[2] for c in pinned] == [32, 8]
    assert pinned[0][3] == [0, 1] * 16
    assert pinned[1][3] == [0, 1, 0] + [0] * 5
    assert [c for c in stub_both if c[0] == "generic"] == [
        ("generic", K1, 8, None)]
    spans = [s for t in tracer.completed() for s in t["spans"]
             if s["name"] == "tpu.kernel"]
    tiers = sorted((s["attrs"]["pinned"], s["attrs"]["tier"]) for s in spans)
    assert tiers == [(False, "latency"), (True, "throughput"),
                     (True, "throughput")]
    assert csp.stats["pinned_lanes"] == 35 and csp.stats["padded"] == 5 + 7


def test_warmup_launches_both_kernels(stub_both):
    csp = TorchCSP(device="cpu", buckets=(8,), key_cache_size=4)
    try:
        csp.warmup([(K1, 8), ("P-256", 8)],
                   keys=_keyset("P-256", [11, 12]))
        assert _wait(lambda: len(csp.key_cache) == 4)
    finally:
        csp.close()
    assert sorted((c[0], c[1]) for c in stub_both) == [
        ("generic", "P-256"), ("generic", K1), ("pinned", "P-256"),
        ("pinned", K1)]
    cv = CURVES[K1]
    assert csp.key_cache.contains(PublicKey(K1, cv.gx, cv.gy))
    assert csp.stats["warmed"] == 2
