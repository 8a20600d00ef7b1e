"""The port's batch split across devices (K10) against the JAX package's
mesh (``bdls_tpu/parallel/mesh.py``), on the CPU.

The reference's tests (``tests/test_mesh.py``) run its ``shard_map`` and
pjit programs on 8 virtual CPU devices; the port's mesh is a list of
torch devices that may repeat one device, so here the CPU stands in for
every shard (``mesh_devices`` patched to a list of ``cpu`` devices where a
default mesh is needed). As in the reference, the mechanics tests swap
the verify for an elementwise stand-in (the verdict is the low bit of r's
first limb) so only the split, the masked count and the join are under
test; then:

- the port's ``match_partition_rules`` against the reference's
  ``VERIFY_PARTITION_RULES`` on the reference's own argument names;
- real signatures through the port's 4-shard ``sharded_verify_masked``
  (the plain K1 twin on each shard) against the reference's
  ``get_sharded_verify("P-256", "fold", ndev=4)`` on the same limbs (one
  XLA:CPU compile for the module);
- ``TorchCSP._use_mesh`` against ``TpuCSP._use_mesh``, the knobs against
  the reference's, and ``TorchCSP(device="cpu", mesh_threshold=16)``
  through a stood-in 4-shard mesh, generic and pinned lanes, against
  ``SwCSP``.

Comparisons are exact.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from bdls_tpu.crypto import tpu_provider as jtp
from bdls_tpu.parallel import mesh as jmesh
from bdls_tpu_torch.crypto import torch_provider as tp
from bdls_tpu_torch.crypto import vectors
from bdls_tpu_torch.crypto.csp import PublicKey, VerifyRequest
from bdls_tpu_torch.crypto.factory import FactoryOpts, get_csp
from bdls_tpu_torch.crypto.marshal import ints_to_limbs
from bdls_tpu_torch.crypto.sw import SwCSP
from bdls_tpu_torch.crypto.torch_provider import TorchCSP
from bdls_tpu_torch.ops import ecdsa
from bdls_tpu_torch.ops.curves import CURVES
from bdls_tpu_torch.parallel import mesh as pmesh

torch.set_num_threads(1)

P256, SECP256K1 = CURVES["P-256"], CURVES["secp256k1"]
CPU = torch.device("cpu")


@pytest.fixture
def cpu8(monkeypatch):
    """A default mesh of 8 shards, all on the CPU (the reference's 8
    virtual devices)."""
    monkeypatch.setattr(pmesh, "mesh_devices", lambda: [CPU] * 8)


def _stub(curve, arrs, device, field):
    """Elementwise stand-in: lane verdict rides r's low bit."""
    return (arrs[2][0] & 1).to(torch.bool)


@pytest.fixture
def stub(monkeypatch):
    monkeypatch.setattr(pmesh, "shard_verify", _stub)


def _arrs(rs, total=None):
    b = len(rs)
    base = [ints_to_limbs([i + 2 for i in range(b)]) for _ in range(4)]
    arrs = base[:2] + [ints_to_limbs(rs)] + base[2:]
    if total is not None:
        return pmesh.pad_and_mask(arrs, b, total)
    return tuple(arrs), None


def _rs(want):
    return [(i << 1) | int(w) for i, w in enumerate(want)]


def test_mesh_and_device_count(cpu8):
    assert pmesh.mesh_device_count() == 8
    mesh = pmesh.make_mesh()
    assert mesh.devices == (CPU,) * 8 and mesh.size == 8
    assert mesh.axis_names == (pmesh.BATCH_AXIS,)


def test_default_mesh_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert pmesh.mesh_devices() == [] and pmesh.mesh_device_count() == 1
    with pytest.raises(RuntimeError, match="CUDA"):
        pmesh.make_mesh()
    with pytest.raises(RuntimeError, match="CUDA"):
        pmesh.make_mesh(["cuda"])
    with pytest.raises(ValueError):
        pmesh.make_mesh([])


def test_sharded_verify_exact_lanes_and_count(stub):
    want = [bool(i % 3) for i in range(16)]
    arrs, mask = _arrs(_rs(want), total=16)
    fn = pmesh.sharded_verify_masked(P256, pmesh.make_mesh([CPU] * 8),
                                     field="mont16")
    ok, n_valid = fn(mask, *arrs)
    assert ok.tolist() == want
    assert int(n_valid) == sum(want)


def test_uneven_masked_batch(stub):
    want = [True, False, True, True, False, True, True, True, False,
            True, True]
    arrs, mask = _arrs(_rs(want), total=16)
    assert mask.tolist() == [True] * 11 + [False] * 5
    for a in arrs:
        assert a.shape == (16, 16) and (a[:, 11:] == 0).all()
    fn = pmesh.sharded_verify_masked(P256, pmesh.make_mesh([CPU] * 8),
                                     field="mont16")
    ok, n_valid = fn(mask, *arrs)
    assert ok[:11].tolist() == want
    assert int(n_valid) == sum(want)


def test_uncounted_padded_lanes_that_pass():
    """A padded lane whose verdict is True still counts nothing: the mask,
    not the verdict, keeps it out (the provider pads by repeating lane
    0)."""
    ok = torch.tensor([True, True, False, True])
    mask = torch.tensor([True, False, False, True])
    assert int(pmesh.masked_count(ok, mask)) == 2
    assert int(pmesh.masked_count_plain(ok, torch.ones(4, dtype=torch.bool))
               ) == 3


def test_tamper_lanes_across_shards(stub):
    want = [True] * 16
    for lane in (0, 5, 8, 15):
        want[lane] = False
    arrs, mask = _arrs(_rs(want), total=16)
    ok, n_valid = pmesh.sharded_verify_masked(
        SECP256K1, pmesh.make_mesh([CPU] * 8), field="mont16")(mask, *arrs)
    assert ok.tolist() == want
    assert int(n_valid) == 12


def test_plain_sharded_verify_counts_every_lane(stub):
    want = [bool(i % 2) for i in range(8)]
    arrs, _ = _arrs(_rs(want))
    fn = pmesh.sharded_verify(P256, pmesh.make_mesh([CPU] * 8))
    assert fn.field == ecdsa.DEFAULT_FIELD
    ok, n_valid = fn(*arrs)
    assert ok.tolist() == want
    assert int(n_valid) == sum(want)


def test_pad_and_mask_shapes():
    arrs = tuple(ints_to_limbs([7, 8, 9]) for _ in range(5))
    padded, mask = pmesh.pad_and_mask(arrs, 3, 8)
    assert all(a.shape == (16, 8) for a in padded)
    assert all((a[:, 3:] == 0).all() for a in padded)
    assert mask.tolist() == [True] * 3 + [False] * 5
    ref, rmask = jmesh.pad_and_mask(arrs, 3, 8)
    assert all((a == b).all() for a, b in zip(padded, ref))
    assert mask.tolist() == rmask.tolist()


def test_getter_cache_keys(cpu8):
    """ndev (and the device list) are part of the key; the same key
    returns the same program; each field and curve builds its own."""
    a = pmesh.get_sharded_verify("P-256", "mont16")
    assert pmesh.get_sharded_verify("P-256", "mont16") is a
    b = pmesh.get_sharded_verify("P-256", "mont16", ndev=4)
    assert b is not a and b.mesh.size == 4 and a.mesh.size == 8
    assert pmesh.get_sharded_verify("P-256", "mxu") is not a
    assert pmesh.get_pjit_verify("P-256", "mont16") is not a
    assert pmesh.get_pjit_verify("secp256k1", "mont16") is not \
        pmesh.get_pjit_verify("P-256", "mont16")
    p = pmesh.get_sharded_verify_pinned("P-256")
    assert p is pmesh.get_sharded_verify_pinned("P-256", "fold")
    assert pmesh.get_pjit_verify_pinned("P-256", ndev=2).mesh.size == 2
    with pytest.raises(ValueError):
        pmesh.sharded_verify_masked(P256, a.mesh, field="sw")


def test_shard_batch_placement():
    mesh = pmesh.make_mesh([CPU] * 4)
    arr = ints_to_limbs(list(range(2, 18)))
    parts = pmesh.shard_batch(mesh, arr)
    assert isinstance(parts, pmesh.Sharded) and len(parts) == 4
    for i, t in enumerate(parts):
        assert t.device == CPU and t.dtype == torch.int32
        assert t.is_contiguous() and t.shape == (16, 4)
        assert (t.numpy().view(np.uint32) == arr[:, 4 * i:4 * i + 4]).all()
    assert pmesh.shard_batch(mesh, parts) is parts
    with pytest.raises(ValueError):
        pmesh.shard_batch(mesh, ints_to_limbs(list(range(6))))
    pools = {"x": torch.arange(6), "y": torch.arange(6)}
    rep = pmesh.replicate(mesh, pools)
    assert len(rep) == 4 and all(r["x"] is pools["x"] for r in rep)


def test_match_partition_rules_like_the_reference():
    """For the reference's own argument trees, the port's rules give
    REPLICATE where the reference's give P() and SPLIT where they shard
    the lane axis; an unmatched name raises in both."""
    from jax.sharding import PartitionSpec as P

    consts = {"p": 1, "r2": 2, "mxu_diag": 3}
    trees = (
        (jmesh._name_tree("consts", consts), "mask", "qx", "qy", "sig_r",
         "sig_s", "digest"),
        ({nm: f"pools['{nm}']" for nm in ("x", "y", "psi_x")},
         "mask", "slot", "sig_r", "sig_s", "digest"),
    )
    assert pmesh._name_tree("consts", consts) == \
        jmesh._name_tree("consts", consts)
    for names in trees:
        ref = jmesh.match_partition_rules(jmesh.VERIFY_PARTITION_RULES,
                                          names)
        got = pmesh.match_partition_rules(pmesh.VERIFY_PARTITION_RULES,
                                          names)

        def as_port(spec):
            if isinstance(spec, dict):
                return {k: as_port(v) for k, v in spec.items()}
            if spec == P():
                return pmesh.REPLICATE
            assert spec[-1] == jmesh.BATCH_AXIS
            return pmesh.SPLIT

        assert got == tuple(as_port(s) for s in ref)
    for bad in ("mystery_arg", "qx2", "mask_"):
        with pytest.raises(ValueError, match="no partition rule"):
            jmesh.match_partition_rules(jmesh.VERIFY_PARTITION_RULES, (bad,))
        with pytest.raises(ValueError, match="no partition rule"):
            pmesh.match_partition_rules(pmesh.VERIFY_PARTITION_RULES, (bad,))


def test_pjit_equal_to_shard_map(stub):
    want = [bool(i % 3) for i in range(16)]
    arrs, mask = _arrs(_rs(want), total=16)
    mesh = pmesh.make_mesh([CPU] * 8)
    ok_sm, n_sm = pmesh.sharded_verify_masked(
        P256, mesh, field="mont16")(mask, *arrs)
    ok_pj, n_pj = pmesh.pjit_verify_masked(
        P256, mesh, field="mont16")(mask, *arrs)
    assert ok_pj.tolist() == ok_sm.tolist() == want
    assert int(n_pj) == int(n_sm) == sum(want)


def test_pjit_uneven_masked_batch(stub):
    want = [True, False, True, True, False, True, True, True, False,
            True, True]
    arrs, mask = _arrs(_rs(want), total=16)
    ok, n_valid = pmesh.pjit_verify_masked(
        SECP256K1, pmesh.make_mesh([CPU] * 8), field="mont16")(mask, *arrs)
    assert ok[:11].tolist() == want
    assert int(n_valid) == sum(want)


def test_pjit_output_placement(stub):
    """The verdicts come back joined on the first shard's device, the
    count a 0-d integer there."""
    arrs, mask = _arrs(_rs([True] * 16), total=16)
    ok, n_valid = pmesh.pjit_verify_masked(
        P256, pmesh.make_mesh([CPU] * 8), field="mont16")(mask, *arrs)
    assert ok.device == CPU and ok.shape == (16,) and ok.dtype == torch.bool
    assert n_valid.dim() == 0 and int(n_valid) == 16


@pytest.fixture(scope="module")
def real_lanes():
    """12 real P-256 lanes (10 valid, a tampered digest, a tampered r)
    padded with zero lanes to 16."""
    rng = np.random.default_rng(7107)
    lanes = vectors.signed_lanes("P-256", 12, rng)
    qx, qy, r, s, d, _ = lanes[4]
    lanes[4] = (qx, qy, r, s, bytes(32), "tampered digest")
    qx, qy, r, s, d, _ = lanes[9]
    lanes[9] = (qx, qy, r ^ 2, s, d, "tampered r")
    arrs = [ints_to_limbs(c) for c in vectors.columns(lanes)]
    padded, mask = pmesh.pad_and_mask(arrs, 12, 16)
    return padded, mask, vectors.expected("P-256", lanes)


def test_real_signatures_match_the_reference_mesh(real_lanes):
    padded, mask, want = real_lanes
    assert want == [i not in (4, 9) for i in range(12)]
    fn = pmesh.sharded_verify_masked(P256, pmesh.make_mesh([CPU] * 4),
                                     field="fold")
    ok, n_valid = fn(mask, *padded)
    ref = jmesh.get_sharded_verify("P-256", "fold", ndev=4)
    rok, rn = ref(mask, *padded)
    assert ok.tolist() == np.asarray(rok).tolist()
    assert ok[:12].tolist() == want and ok[12:].tolist() == [False] * 4
    assert int(n_valid) == int(rn) == 10


# ---- the provider ----------------------------------------------------------

USE_MESH_CASES = [((8, 2048), 2048, 8), ((8, 2048), 2048, 2048),
                  ((8, 2048), 0, 2048), ((12,), 4, 12), ((16,), 16, 16),
                  ((8, 16), 16, 8), ((24,), 16, 24), ((4096,), None, 4096),
                  ((1024,), None, 1024)]


@pytest.mark.parametrize("buckets,threshold,size", USE_MESH_CASES)
def test_use_mesh_decides_as_the_reference(monkeypatch, buckets, threshold,
                                           size):
    monkeypatch.delenv("BDLS_TPU_MESH_THRESHOLD", raising=False)
    monkeypatch.setattr(jmesh, "mesh_device_count", lambda: 8)
    monkeypatch.setattr(pmesh, "mesh_device_count", lambda: 8)
    ref = jtp.TpuCSP(buckets=buckets, kernel_field="mont16",
                     mesh_threshold=threshold, key_cache_size=0)
    csp = TorchCSP(buckets=buckets, device="cpu", mesh_threshold=threshold,
                   key_cache_size=0)
    try:
        assert csp.mesh_threshold == ref.mesh_threshold
        assert csp._use_mesh(size) == ref._use_mesh(size)
    finally:
        ref.close()
        csp.close()


def test_use_mesh_needs_more_than_one_device():
    csp = TorchCSP(device="cpu", mesh_threshold=16, key_cache_size=0)
    try:
        assert pmesh.mesh_device_count() == 1
        assert not csp._use_mesh(2048)
    finally:
        csp.close()


@pytest.mark.parametrize("raw", [None, "4096", "0", "-1", "abc", ""])
def test_default_mesh_threshold_matches_the_reference(monkeypatch, raw):
    if raw is None:
        monkeypatch.delenv("BDLS_TPU_MESH_THRESHOLD", raising=False)
    else:
        monkeypatch.setenv("BDLS_TPU_MESH_THRESHOLD", raw)
    assert tp.default_mesh_threshold() == jtp.default_mesh_threshold()
    assert tp.DEFAULT_MESH_THRESHOLD == jtp.DEFAULT_MESH_THRESHOLD


@pytest.mark.parametrize("raw", [None, "pjit", "shard_map", "bogus", ""])
def test_default_shard_mode_matches_the_reference(monkeypatch, raw):
    if raw is None:
        monkeypatch.delenv("BDLS_TPU_SHARD_MODE", raising=False)
    else:
        monkeypatch.setenv("BDLS_TPU_SHARD_MODE", raw)
    assert tp.default_shard_mode() == jtp.default_shard_mode()
    assert tp.SHARD_MODES == jtp.SHARD_MODES
    csp = TorchCSP(device="cpu", key_cache_size=0)
    try:
        assert csp.shard_mode == jtp.default_shard_mode()
    finally:
        csp.close()


def test_unknown_shard_mode_raises_as_the_reference():
    with pytest.raises(ValueError, match="shard mode"):
        jtp.TpuCSP(shard_mode="bogus")
    with pytest.raises(ValueError, match="shard mode"):
        TorchCSP(device="cpu", shard_mode="bogus")


def test_factory_passes_the_mesh_threshold():
    csp = get_csp(FactoryOpts(default="TORCH", torch_device="cpu",
                              torch_key_cache_size=0,
                              torch_mesh_threshold=4096))
    try:
        assert csp.mesh_threshold == 4096
    finally:
        csp.close()


@pytest.fixture(scope="module")
def mesh_requests():
    """12 P-256 requests (2 tampered) for a 16-lane bucket."""
    rng = np.random.default_rng(7108)
    lanes = vectors.signed_lanes("P-256", 12, rng)
    reqs = [VerifyRequest(PublicKey("P-256", qx, qy), d, r, s)
            for qx, qy, r, s, d, _ in lanes]
    reqs[3] = VerifyRequest(reqs[3].key, bytes(32), reqs[3].r, reqs[3].s)
    reqs[10] = VerifyRequest(reqs[10].key, reqs[10].digest, reqs[10].r,
                             reqs[10].s ^ 4)
    return reqs, SwCSP().verify_batch(reqs)


@pytest.mark.parametrize("pinned", [False, True], ids=["generic", "pinned"])
@pytest.mark.parametrize("mode", ["pjit", "shard_map"])
def test_provider_splits_a_bucket_across_a_stood_in_mesh(
        monkeypatch, mesh_requests, mode, pinned):
    """TorchCSP(mesh_threshold=16) on a stood-in 4-shard mesh: the
    16-lane bucket of 12 requests goes through the mesh program of the
    shard mode, 4 shards of 4 lanes and 4 counts, no unsplit launch, and
    SwCSP's verdicts."""
    reqs, want = mesh_requests
    assert want.count(False) == 2
    monkeypatch.setattr(pmesh, "mesh_devices", lambda: [CPU] * 4)
    shards, counts, unsplit = [], [], []
    real_sv, real_svp = pmesh.shard_verify, pmesh.shard_verify_pinned
    real_count = pmesh.masked_count
    real_launch, real_pinned = ecdsa.launch_verify, ecdsa.launch_verify_pinned

    def spy_sv(curve, arrs, device, field):
        shards.append(("generic", arrs[0].shape[-1]))
        return real_sv(curve, arrs, device, field)

    def spy_svp(curve, arrs, slot, pools, device, field):
        shards.append(("pinned", arrs[0].shape[-1]))
        return real_svp(curve, arrs, slot, pools, device, field)

    def spy_count(ok, mask):
        out = real_count(ok, mask)
        counts.append(int(out))
        return out

    def spy_launch(curve, arrs, **kw):
        unsplit.append(np.shape(arrs[0])[-1])
        return real_launch(curve, arrs, **kw)

    def spy_pinned(curve, arrs, slot, pools, **kw):
        unsplit.append(np.shape(arrs[0])[-1])
        return real_pinned(curve, arrs, slot, pools, **kw)

    monkeypatch.setattr(pmesh, "shard_verify", spy_sv)
    monkeypatch.setattr(pmesh, "shard_verify_pinned", spy_svp)
    monkeypatch.setattr(pmesh, "masked_count", spy_count)
    monkeypatch.setattr(ecdsa, "launch_verify", spy_launch)
    monkeypatch.setattr(ecdsa, "launch_verify_pinned", spy_pinned)
    csp = TorchCSP(device="cpu", buckets=(16,), mesh_threshold=16,
                   shard_mode=mode, key_cache_size=16 if pinned else 0,
                   latency_max_lanes=0)
    try:
        if pinned:
            csp.warm_keys([r.key for r in reqs], wait=True)
        assert csp._use_mesh(16) and not csp._use_mesh(8)
        ecdsa.reset_launches()
        assert csp.verify_batch(reqs) == want
        kind = "pinned" if pinned else "generic"
        assert shards == [(kind, 4)] * 4
        # the 4 padded lanes (lane 0 repeated, itself valid) are masked
        assert sum(counts) == want.count(True) and len(counts) == 4
        assert unsplit == [4] * 4
        assert csp.stats["pinned_lanes"] == (12 if pinned else 0)
        assert csp.stats["fallbacks"] == 0
        # nothing launched a kernel: the CPU runs the plain twins
        assert pmesh.LAUNCHES_MESH == {"shards": 0}
        assert not any(ecdsa.LAUNCHES.values())
    finally:
        csp.close()


@pytest.mark.parametrize("program", ["fold", "mxu", "mont16", "pinned"])
def test_card_shard_call_returns_its_count_from_the_shard_entry(
        monkeypatch, program):
    """On the card a shard is one C call: with ``mask`` the launch
    wrappers call the counting entry (``bdls_verify_masked``,
    ``bdls_verify_pinned_masked``, ``bdls_verify_mont16_masked``) and
    return the per-block partials it wrote, and nothing else is called
    (no count of its own). The card is faked on the CPU: ``_build.lib``
    gives entries that write the verdicts and partials into the tensors'
    host memory, as the kernel would into device memory."""
    import ctypes
    from contextlib import nullcontext
    from types import SimpleNamespace

    from bdls_tpu_torch.ops import _build
    from bdls_tpu_torch.ops import verify_fold as vf

    B = 150                                     # the last block ragged
    # lanes a block: every build a thread group a lane, one warp a block
    per = ecdsa.lanes_per_block(ecdsa.FOLD_FIELDS.get(program, "vpu"))
    rng = np.random.default_rng(4321)
    verdicts = rng.integers(0, 2, B).astype(np.uint8)
    mask_np = rng.integers(0, 2, B).astype(bool)
    calls = []

    def masked(*args):
        out, mask, partial, n = args[-7:-3] if program == "pinned" \
            else args[-6:-2]
        calls.append(("masked", n))
        ctypes.memmove(out, verdicts.ctypes.data, n)
        m = np.ctypeslib.as_array((ctypes.c_uint8 * n).from_address(mask))
        blocks = -(-n // per)
        part = np.ctypeslib.as_array(
            (ctypes.c_int32 * blocks).from_address(partial))
        for j in range(blocks):
            lo, hi = j * per, min(n, (j + 1) * per)
            part[j] = int((verdicts[lo:hi] & m[lo:hi]).sum())
        return 0

    def unmasked(*args):
        calls.append(("plain",))
        return 0

    entries = {"fold": "bdls_verify", "mxu": "bdls_verify",
               "mont16": "bdls_verify_mont16",
               "pinned": "bdls_verify_pinned"}[program]
    fake = SimpleNamespace(**{entries: unmasked, entries + "_masked": masked})
    engines = []
    monkeypatch.setattr(_build, "lib",
                        lambda engine="vpu": engines.append(engine) or fake)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: SimpleNamespace(cuda_stream=0))
    limbs = [torch.from_numpy(ints_to_limbs(list(range(1, B + 1)))
                              .view(np.int32)) for _ in range(5)]
    mask = torch.from_numpy(mask_np)
    ecdsa.reset_launches()
    if program == "pinned":
        cap = 2
        pools = {nm: torch.zeros((cap, vf.pinned_positions("P-256"), 9, 8),
                                 dtype=torch.int32)
                 for nm in vf.PINNED_COORDS["P-256"]}
        slot = torch.zeros(B, dtype=torch.int32)
        ok, partial = ecdsa.verify_pinned_cuda(P256, *limbs[2:], slot, pools,
                                               mask=mask)
        launched = ecdsa.LAUNCHES_PINNED
    elif program == "mont16":
        ok, partial = ecdsa.verify_mont16_cuda(P256, *limbs, mask=mask)
        launched = ecdsa.LAUNCHES_MONT16
    else:
        ok, partial = ecdsa.verify_fold_cuda(
            P256, *limbs, engine=ecdsa.FOLD_FIELDS[program], mask=mask)
        launched = {"fold": ecdsa.LAUNCHES, "mxu": ecdsa.LAUNCHES_MXU
                    }[program]
    assert calls == [("masked", B)]
    assert engines == [{"fold": "vpu", "mxu": "mxu"}.get(program, "vpu")]
    assert ok.tolist() == verdicts.astype(bool).tolist()
    assert partial.shape == (-(-B // per),) and partial.dtype == torch.int32
    assert int(partial.sum()) == int(pmesh.masked_count_plain(ok, mask)) \
        == int((verdicts.astype(bool) & mask_np).sum())
    assert launched["P-256"] == 1 and pmesh.LAUNCHES_MESH == {"shards": 0}
    # the counting entry takes a mask of the batch's length only
    with pytest.raises(ValueError, match="mask"):
        ecdsa.verify_fold_cuda(P256, *limbs, mask=mask[:-1])


def test_the_count_runs_on_the_card_or_in_the_plain_twin():
    """On the CPU a shard's count is the plain twin; the counting launch
    is the card's alone (asking a CPU launch for it raises, and a CUDA
    tensor never reaches the plain twin's count)."""
    arrs, _ = _arrs(_rs([True, False]))
    mask = torch.ones(2, dtype=torch.bool)
    with pytest.raises(ValueError, match="card"):
        ecdsa.launch_verify(P256, arrs, device="cpu", mask=mask)
    with pytest.raises(ValueError, match="card"):
        pmesh.shard_verify(P256, arrs, CPU, "fold", mask=mask)
    assert int(pmesh.masked_count(torch.tensor([True, True]), mask)) == 2
