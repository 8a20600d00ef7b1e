"""TorchCSP's kernel generations (``kernel_field``) on the CPU, and the
key-cache default.

The knobs are held against the reference's
(``bdls_tpu/crypto/tpu_provider.py:default_kernel_field``,
``default_key_cache_size``). Per field, every lane kind (a latency-tier
bucket, a throughput bucket, pinned lanes, Ed25519, a block) goes through
``TorchCSP(device="cpu")``; spies on the plain twins record which program
ran and on which limb engine, and the provider's counters
(``tpu_latency_cold_fallbacks_total``, ``tpu_latency_launches_total``,
``tpu_verify_pinned_lanes_total``) which path it took. The verdicts must
equal the reference's ``TpuCSP(kernel_field="sw")`` on the same requests
(the reference's compiled ``mont16`` and ``mxu`` programs take minutes on
XLA:CPU; ``tests/test_torch_mont16.py`` and ``test_torch_mxu.py`` hold
the programs themselves). Comparisons are exact.
"""

from __future__ import annotations

import inspect
import os

import numpy as np
import pytest
import torch

from bdls_tpu.crypto import tpu_provider as jtp
from bdls_tpu.ops import ecdsa as jecdsa
from bdls_tpu_torch.crypto import blocklane, vectors
from bdls_tpu_torch.crypto import torch_provider as tp
from bdls_tpu_torch.crypto.csp import PublicKey, VerifyRequest
from bdls_tpu_torch.crypto.factory import FactoryOpts, get_csp
from bdls_tpu_torch.crypto.sw import SwCSP
from bdls_tpu_torch.crypto.torch_provider import TorchCSP
from bdls_tpu_torch.ops import block_verify as bv
from bdls_tpu_torch.ops import ecdsa, fold
from bdls_tpu_torch.ops import ed25519 as ed
from bdls_tpu_torch.ops.curves import CURVES
from bdls_tpu_torch.utils import tracing
from bdls_tpu_torch.utils.metrics import MetricsProvider

# the plain version runs many ops on tiny tensors: extra intra-op
# threads only contend with the other test workers
torch.set_num_threads(1)

FIELDS = ("fold", "mxu", "mont16", "sw")


@pytest.mark.parametrize("raw", [None, "fold", "mxu", "mont16", "sw",
                                 "bogus", ""])
def test_default_kernel_field_matches_the_reference(monkeypatch, raw):
    if raw is None:
        monkeypatch.delenv("BDLS_TPU_KERNEL", raising=False)
    else:
        monkeypatch.setenv("BDLS_TPU_KERNEL", raw)
    assert tp.default_kernel_field() == jtp.default_kernel_field()
    assert tp.KERNEL_FIELDS == jtp.KERNEL_FIELDS
    csp = TorchCSP(device="cpu", key_cache_size=0)
    try:
        assert csp.kernel_field == jtp.default_kernel_field()
        assert csp.stats["kernel"] == csp.kernel_field
    finally:
        csp.close()


@pytest.mark.parametrize("raw", [None, "0", "-1", "8", "abc"])
def test_default_key_cache_size_matches_the_reference(monkeypatch, raw):
    """Queue C1: ``key_cache_size=None`` (the default) reads
    ``BDLS_TPU_KEY_CACHE_SIZE`` as the reference does."""
    if raw is None:
        monkeypatch.delenv("BDLS_TPU_KEY_CACHE_SIZE", raising=False)
    else:
        monkeypatch.setenv("BDLS_TPU_KEY_CACHE_SIZE", raw)
    want = jtp.default_key_cache_size()
    assert tp.default_key_cache_size() == want
    for csp in (TorchCSP(device="cpu"),
                TorchCSP(device="cpu", key_cache_size=None),
                get_csp(FactoryOpts(default="TORCH", torch_device="cpu"))):
        try:
            cap = 0 if csp.key_cache is None else csp.key_cache.capacity
            assert cap == want
        finally:
            csp.close()


def test_unknown_field_raises_and_factory_passes_the_field():
    with pytest.raises(ValueError, match="unknown kernel field"):
        TorchCSP(device="cpu", kernel_field="gen4")
    csp = get_csp(FactoryOpts(default="TORCH", torch_device="cpu",
                              torch_kernel_field="mont16",
                              torch_key_cache_size=0))
    try:
        assert csp.kernel_field == "mont16" and csp.key_cache is None
    finally:
        csp.close()


def test_ops_default_field_is_fold_a_deliberate_difference():
    """The reference's ops-level default reads ``BDLS_KERNEL_FIELD`` and
    is ``mont16``; the port's stays ``fold``, because every caller
    without a field means K1 (ROADMAP.md, Queue C, deliberate
    differences). The provider always passes its field."""
    assert ecdsa.DEFAULT_FIELD == "fold"
    if "BDLS_KERNEL_FIELD" not in os.environ:
        assert jecdsa.DEFAULT_FIELD == "mont16"
    for fn in (ecdsa.launch_verify, ecdsa.launch_verify_pinned,
               ecdsa.verify_limbs, ecdsa.verify_batch, ecdsa.LatencySlot):
        assert inspect.signature(fn).parameters["field"].default == "fold"
    assert ecdsa.FOLD_FIELDS == jecdsa.FOLD_FIELDS
    assert ecdsa.PINNED_FIELDS == jecdsa.PINNED_FIELDS
    from bdls_tpu.ops import ed25519 as jed
    assert ed.ENGINES == jed.ENGINES
    with pytest.raises(ValueError):
        ecdsa.launch_verify(CURVES["P-256"], [np.zeros((16, 1), np.uint32)]
                            * 5, device="cpu", field="sw")
    with pytest.raises(ValueError):
        ecdsa.LatencySlot(CURVES["P-256"], 8, device="cpu", field="mont16")


@pytest.fixture
def spies(monkeypatch):
    """Record (program, engine) for every plain-twin run."""
    calls = []

    def spy(mod, name, program):
        real = getattr(mod, name)

        def run(*a, **kw):
            calls.append((program, fold.active_backend()))
            return real(*a, **kw)

        monkeypatch.setattr(mod, name, run)

    spy(ecdsa, "verify_fold", "K1")
    spy(ecdsa, "verify_fold_pinned", "K2")
    spy(ecdsa, "verify_kernel", "K4")
    spy(ed, "verify_ed25519", "K8")
    spy(bv, "block_kernel", "K7")
    return calls


def _reqs(curve, lanes):
    return [VerifyRequest(PublicKey(curve, qx, qy), d, r, s)
            for qx, qy, r, s, d, _ in lanes]


@pytest.fixture(scope="module")
def work():
    rng = np.random.default_rng(91)
    sw = SwCSP()
    k1 = vectors.mixed_lanes("secp256k1", rng, n_valid=2)
    votes = _reqs("secp256k1", k1[2:8])                    # latency tier
    p256 = _reqs("P-256", vectors.mixed_lanes("P-256", rng, n_valid=2)[:20])
    pkey = sw.key_gen("secp256k1", rng)
    msg = sw.hash(b"pinned round")
    r, s = sw.sign(pkey, msg)
    pinned = [VerifyRequest(pkey.public_key(), msg, r, s),
              VerifyRequest(pkey.public_key(), sw.hash(b"other"), r, s),
              VerifyRequest(pkey.public_key(), msg, r, (s + 1) % CURVES[
                  "secp256k1"].fn.modulus)]
    ekey = sw.key_gen("ed25519", rng)
    emsg = b"\x07" * 32
    er, es = sw.sign(ekey, emsg)
    eds = [VerifyRequest(ekey.public_key(), emsg, er, es),
           VerifyRequest(ekey.public_key(), b"\x08" * 32, er, es)]
    block = vectors.block_request("P-256", rng, 26, msg_len=(0, 120),
                                  hostile=True)
    ref = jtp.TpuCSP(buckets=(8, 32), kernel_field="sw", key_cache_size=0)
    try:
        want = {name: ref.verify_batch(reqs) for name, reqs in (
            ("votes", votes), ("p256", p256), ("pinned", pinned),
            ("eds", eds))}
    finally:
        ref.close()
    want["block"] = blocklane.verify_block_host(SwCSP().verify_batch,
                                                block).tolist()
    return {"votes": votes, "p256": p256, "pinned": pinned, "eds": eds,
            "block": block, "pkey": pkey.public_key(), "want": want}


# what each lane kind runs per field, (program, engine) in run order
EXPECT = {
    "fold": {"votes": [("K1", "vpu")], "p256": [("K1", "vpu")],
             "pinned": [("K2", "vpu")], "eds": [("K8", "vpu")],
             "block": [("K7", "vpu")]},
    "mxu": {"votes": [("K1", "mxu")], "p256": [("K1", "mxu")],
            "pinned": [("K2", "mxu")], "eds": [("K8", "mxu")],
            "block": [("K7", "mxu")]},
    "mont16": {"votes": [("K4", "vpu")], "p256": [("K4", "vpu")],
               "pinned": [("K2", "vpu")], "eds": [("K8", "vpu")],
               "block": [("K7", "vpu")]},
    "sw": {"votes": [], "p256": [], "pinned": [], "eds": [], "block": []},
}


@pytest.mark.parametrize("field", FIELDS)
def test_each_lane_kind_runs_the_fields_program(field, work, spies):
    metrics, tracer = MetricsProvider(), tracing.Tracer()
    csp = TorchCSP(device="cpu", buckets=(8, 32), latency_max_lanes=8,
                   key_cache_size=64, kernel_field=field, metrics=metrics,
                   tracer=tracer)
    got, ran, lat = {}, {}, {}
    try:
        csp.warmup([("secp256k1", 8)])
        csp.warm_keys([work["pkey"]], wait=True)
        for name in ("votes", "p256", "pinned", "eds"):
            spies.clear()
            before = (csp.stats["latency_launches"],
                      csp.stats["latency_cold_fallbacks"],
                      csp.stats["pinned_lanes"])
            got[name] = csp.verify_batch(work[name])
            after = (csp.stats["latency_launches"],
                     csp.stats["latency_cold_fallbacks"],
                     csp.stats["pinned_lanes"])
            ran[name] = list(spies)
            lat[name] = tuple(a - b for a, b in zip(after, before))
        spies.clear()
        got["block"] = csp.verify_block(work["block"]).tolist()
        ran["block"] = list(spies)
        stats = csp.stats
    finally:
        csp.close()
    assert got == work["want"]
    assert ran == EXPECT[field]
    assert stats["kernel"] == field and stats["fallbacks"] == 0
    # the vote bucket: a K3 slot under fold and mxu, a counted cold
    # fallback and K4 under mont16, the host under sw; the pinned lanes
    # ride K2 except under sw, which never partitions
    assert lat["votes"] == {"fold": (1, 0, 0), "mxu": (1, 0, 0),
                            "mont16": (0, 1, 0), "sw": (0, 0, 0)}[field]
    assert lat["p256"] == (0, 0, 0)
    assert lat["pinned"] == (0, 0, 0 if field == "sw" else 3)
    assert metrics.find("tpu_block_fallbacks_total").value() == 0
    assert metrics.find("tpu_block_blocks_total").value() == 1
    assert metrics.find("tpu_compile_programs_total").value(
        (field, "secp256k1", "8")) == 1
    spans = [s for t in tracer.completed() for s in t["spans"]]
    kern = [s["attrs"] for s in spans if s["name"] == "tpu.kernel"]
    assert kern and all(a["kernel"] == field and a["runs"] == "plain"
                        for a in kern)
    fused = [s["attrs"]["fused"] for s in spans
             if s["name"] == "tpu.verify_block"]
    assert fused == [field != "sw"]
