"""The port's pinned-key path vs the JAX package's, on the CPU.

Every call of the JAX package's pinned-key program in the port's tests
lives in this file: XLA:CPU compiles it once per curve (about a minute
for secp256k1, 20 s for P-256), for one bucket of 8 lanes and a pool of
8 keys. The reference's ``TpuCSP`` below reuses those same compiled
programs.

- ``pinned_tables_from_reference(vf.build_pinned_tables(...))`` equals
  the port's builder, for both curves and several keys, and
  ``tables_from_reference(pinned_const_tree(curve), "g32")`` equals
  ``g32_tables``; bad points raise as in the reference;
- the plain ``pinned_ladder`` gives u1·G + u2·Q of the host affine
  oracle (the one the reference's ``test_pinned_keys.py`` holds its own
  ladder to) on edge scalars with mixed slots;
- the plain ``verify_fold_pinned`` equals
  ``bdls_tpu.ops.ecdsa.launch_verify_pinned(..., field="fold")`` lane
  for lane on valid, tampered, hostile, wrong-slot and r + n lanes;
- ``CspBatchVerifier(TorchCSP(device="cpu", key_cache_size=8))`` gives
  the verdicts and the pinned-lane count of ``CspBatchVerifier(TpuCSP(
  kernel_field="fold", key_cache_size=8, buckets=(8,),
  latency_max_lanes=0))`` on the same envelopes.

Verdicts are booleans and tables integers: comparisons are exact.
"""

from __future__ import annotations

import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bdls_tpu.consensus import wire_pb2
from bdls_tpu.consensus.verifier import CspBatchVerifier as JCspBatchVerifier
from bdls_tpu.crypto.tpu_provider import TpuCSP
from bdls_tpu.ops import ecdsa as jecdsa
from bdls_tpu.ops import glv as jglv
from bdls_tpu.ops import verify_fold as jvf
from bdls_tpu.ops.curves import CURVES as JCURVES
from bdls_tpu_torch.consensus.identity import identity_of_key, sign_payload
from bdls_tpu_torch.consensus.verifier import CspBatchVerifier, \
    TorchBatchVerifier, identity_keys
from bdls_tpu_torch.crypto import vectors
from bdls_tpu_torch.crypto.marshal import ints_to_limbs
from bdls_tpu_torch.crypto.sw import SwCSP, _mul_add
from bdls_tpu_torch.crypto.torch_provider import TorchCSP
from bdls_tpu_torch.ops import fold
from bdls_tpu_torch.ops import verify_fold as vf
from bdls_tpu_torch.ops.curves import CURVES
from bdls_tpu_torch.ops.fold import int_to_limbs16

# the plain version runs many ops on tiny tensors: extra intra-op
# threads only contend with the other test workers
torch.set_num_threads(1)

BUCKET = 8
CAP = 8            # pool capacity: the shape the compiled programs share


def _keys(curve: str, scalars) -> list[tuple[int, int]]:
    cv = CURVES[curve]
    return [_mul_add(cv, d, (cv.gx, cv.gy)) for d in scalars]


# ---- tables ----------------------------------------------------------------

@pytest.mark.parametrize("curve", sorted(CURVES))
def test_pinned_tables_equal_reference(curve):
    cv = CURVES[curve]
    for qx, qy in _keys(curve, [0xD00D, 2, cv.fn.modulus - 1]):
        ref = vf.pinned_tables_from_reference(
            jvf.build_pinned_tables(curve, qx, qy))
        own = vf.build_pinned_tables(curve, qx, qy)
        assert set(own) == set(ref) == set(vf.PINNED_COORDS[curve])
        npos = vf.pinned_positions(curve)
        assert npos == jvf.pinned_positions(curve)
        for nm in own:
            assert own[nm].dtype == np.uint32
            assert own[nm].shape == (npos, 9, 8)
            assert np.array_equal(own[nm], ref[nm]), nm
        # entry [1][1] is 16·Q; entry 0 is infinity (0, 1)
        x16, y16 = _mul_add(cv, 16, (qx, qy))
        ints = {nm: vf._u32_to_ints(own[nm][1, 1]) for nm in own}
        assert (ints["x"][0], ints["y"][0]) == (x16, y16)
        assert vf._u32_to_ints(own["x"][5, 0]) == [0]
        assert vf._u32_to_ints(own["y"][5, 0]) == [1]
    assert vf.pinned_pool_bytes(curve) == (
        len(vf.PINNED_COORDS[curve]) * vf.pinned_positions(curve) * 9 * 32)


@pytest.mark.parametrize("curve", sorted(CURVES))
def test_g32_tables_equal_reference(curve):
    tree = {k: np.asarray(v)
            for k, v in jvf.pinned_const_tree(JCURVES[curve]).items()}
    ref = vf.tables_from_reference(tree, kind="g32")
    own = vf.g32_tables(curve)
    assert set(ref) == {curve}
    assert own.shape == ref[curve].shape == (32, 256, 3, 8)
    assert np.array_equal(own, ref[curve])
    assert np.array_equal(own[0], vf.g_table_8bit(curve))
    # the device copy is the same table in Montgomery form
    p = CURVES[curve].fp.modulus
    dev = vf.device_g32_table(curve, torch.device("cpu")).numpy()
    assert vf._u32_to_ints(dev[3, 7]) == [
        v * (1 << 256) % p for v in vf._u32_to_ints(own[3, 7])]


def _bad_points(curve):
    cv = CURVES[curve]
    p = cv.fp.modulus
    qx, qy = _keys(curve, [77])[0]
    return [(5, 7), (0, 0), (p, 1), (1, p), (-1, qy), (qx, p + qy),
            (qx, (qy + 1) % p), (qx + p, qy)]


@pytest.mark.parametrize("curve", sorted(CURVES))
def test_bad_points_raise_as_in_the_reference(curve):
    for qx, qy in _bad_points(curve):
        with pytest.raises(ValueError) as ref:
            jvf.build_pinned_tables(curve, qx, qy)
        with pytest.raises(ValueError) as own:
            vf.build_pinned_tables(curve, qx, qy)
        assert str(own.value) == str(ref.value), (qx, qy)


# ---- the ladder ------------------------------------------------------------

@pytest.mark.parametrize("curve", sorted(CURVES))
def test_pinned_ladder_matches_oracle(curve):
    """The edge lanes of the reference's own ladder test
    (``test_pinned_keys.py:158-166``), two keys in slots 2 and 0."""
    cv = CURVES[curve]
    p, n = cv.fp.modulus, cv.fn.modulus
    q1, q2 = _keys(curve, [0xACE, 0xBEEF])
    pools = {nm: np.zeros((3, vf.pinned_positions(curve), 9, 8), np.int32)
             for nm in vf.PINNED_COORDS[curve]}
    for slot, q in ((2, q1), (0, q2)):
        tabs = vf.pinned_device_tables(curve,
                                       vf.build_pinned_tables(curve, *q))
        for nm in pools:
            pools[nm][slot] = tabs[nm]
    pools = {nm: torch.from_numpy(v) for nm, v in pools.items()}
    lanes = [(5, 7, q1, 2), (9, n - 1, q2, 0), (1, 1, q1, 2),
             (n - 1, 3, q2, 0), (0, 11, q1, 2), (13, 0, q2, 0),
             (0, 0, q1, 2), (n - 1, n - 1, q2, 0)]
    u1c = torch.as_tensor(np.stack([int_to_limbs16(u[0]) for u in lanes], 1))
    u2c = torch.as_tensor(np.stack([int_to_limbs16(u[1]) for u in lanes], 1))
    slot = torch.tensor([u[3] for u in lanes])
    fpc = fold.fold_ctx(p)
    rp = vf.pinned_ladder(cv, fpc, u1c, u2c, slot, pools)
    xs = fold.tensor_to_ints(fold.canon(fpc, rp.x))
    zs = fold.tensor_to_ints(fold.canon(fpc, rp.z))
    for i, (u1, u2, q, _) in enumerate(lanes):
        want = _mul_add(cv, u1, (cv.gx, cv.gy), u2, q)
        if want is None:
            assert zs[i] == 0, f"lane {i}: expected infinity"
        else:
            assert zs[i] != 0, f"lane {i}: unexpected infinity"
            assert xs[i] * pow(zs[i], -1, p) % p == want[0], f"lane {i}"


# ---- the whole program vs the reference's ----------------------------------

def _pinned_lanes(curve):
    """Lanes whose key can be pinned, a pool of their keys and each
    lane's slot; two lanes carry another pinned key's slot."""
    rng = np.random.default_rng(4242)
    lanes = [lane for lane in vectors.mixed_lanes(curve, rng, n_valid=2)
             if _pinnable(curve, lane)]
    keys: dict[tuple[int, int], int] = {}
    for lane in lanes:
        keys.setdefault(lane[:2], len(keys))
    assert len(keys) <= CAP
    slots = [keys[lane[:2]] for lane in lanes]
    valid = [i for i, lane in enumerate(lanes) if lane[5] == "valid"]
    for i in valid:
        lanes.append(lanes[i][:5] + ("wrong slot",))
        slots.append((slots[i] + 1) % len(keys))
    want = vectors.expected(curve, lanes)
    for i, lane in enumerate(lanes):
        if lane[5] == "wrong slot":
            want[i] = False
    k = -len(lanes) % BUCKET
    lanes += lanes[:k]
    slots += slots[:k]
    want += want[:k]
    return lanes, keys, slots, want


def _pinnable(curve, lane) -> bool:
    try:
        vf.build_pinned_tables(curve, lane[0], lane[1])
        return True
    except ValueError:
        return False


@pytest.fixture(scope="module")
def jax_pinned():
    """Reference verdicts, bucket by bucket of 8 lanes, over pools of 8
    keys (one compile per curve, shared with TpuCSP below)."""
    out = {}
    for curve in sorted(CURVES):
        lanes, keys, slots, _ = _pinned_lanes(curve)
        npos = jvf.pinned_positions(curve)
        pools = {nm: np.zeros((CAP, npos, 9, 23), np.uint32)
                 for nm in jvf.PINNED_COORDS[curve]}
        for (qx, qy), i in keys.items():
            tabs = jvf.build_pinned_tables(curve, qx, qy)
            for nm in pools:
                pools[nm][i] = tabs[nm]
        pools = {nm: jnp.asarray(v) for nm, v in pools.items()}
        got = []
        for i in range(0, len(lanes), BUCKET):
            cols = vectors.columns(lanes[i:i + BUCKET])
            arrs = [ints_to_limbs(c) for c in cols[2:]]
            got += np.asarray(jecdsa.launch_verify_pinned(
                JCURVES[curve], arrs, np.array(slots[i:i + BUCKET], np.int32),
                pools, field="fold")).tolist()
        out[curve] = got
    return out


def _port_pools(curve, keys):
    pools = {nm: np.zeros((CAP, vf.pinned_positions(curve), 9, 8), np.int32)
             for nm in vf.PINNED_COORDS[curve]}
    for (qx, qy), i in keys.items():
        tabs = vf.pinned_device_tables(curve,
                                       vf.build_pinned_tables(curve, qx, qy))
        for nm in pools:
            pools[nm][i] = tabs[nm]
    return {nm: torch.from_numpy(v) for nm, v in pools.items()}


@pytest.mark.parametrize("curve", sorted(CURVES))
def test_plain_verify_fold_pinned_matches_reference(curve, jax_pinned):
    lanes, keys, slots, want = _pinned_lanes(curve)
    pools = _port_pools(curve, keys)
    got = []
    for i in range(0, len(lanes), BUCKET):
        cols = vectors.columns(lanes[i:i + BUCKET])
        arrs = [torch.from_numpy(ints_to_limbs(c).view(np.int32))
                for c in cols[2:]]
        got += vf.verify_fold_pinned(
            CURVES[curve], *arrs, torch.tensor(slots[i:i + BUCKET]),
            pools).tolist()
    labels = [lane[5] for lane in lanes]
    ref = jax_pinned[curve]
    assert got == ref, [(lb, g, r) for lb, g, r in zip(labels, got, ref)
                        if g != r]
    assert got == want
    assert got[labels.index("forged r+n")]
    assert not got[labels.index("wrong slot")]
    if curve == "secp256k1":
        # at least one valid lane's u2 has a negative GLV half
        n = CURVES[curve].fn.modulus
        negs = [min(jglv.decompose_host(lane[2] * pow(lane[3], -1, n) % n))
                < 0 for lane, ok in zip(lanes, want) if ok]
        assert any(negs)


# ---- the consensus seam vs the reference's, through both providers --------

def _envelopes():
    rng = np.random.default_rng(909)
    sw = SwCSP()
    consenters = [sw.key_gen("secp256k1", rng) for _ in range(5)]
    outsider = sw.key_gen("secp256k1", rng)
    envs = [sign_payload(k, b"<lock> round 3 #%d" % i)
            for i, k in enumerate(consenters)]
    forged = sign_payload(consenters[1], b"<select> round 3")
    forged.payload = b"<select> round 4"
    envs += [forged, sign_payload(outsider, b"<lock> round 3 #x")]
    bad_out = sign_payload(outsider, b"<decide>")
    bad_out.sig_s = (int.from_bytes(bad_out.sig_s, "big") ^ 4).to_bytes(
        32, "big")
    envs.append(bad_out)
    malformed = sign_payload(consenters[2], b"<decide>")
    malformed.sig_r = b"\1" + malformed.sig_r               # 33 bytes
    envs.append(malformed)
    want = [True] * 5 + [False, True, False, False]
    return [identity_of_key(k) for k in consenters], envs, want


def _wire(env):
    m = wire_pb2.SignedEnvelope()
    for f in ("version", "payload", "pub_x", "pub_y", "sig_r", "sig_s"):
        setattr(m, f, getattr(env, f))
    return m


def _wait_keys(cache, n):
    deadline = time.time() + 60
    while len(cache) < n and time.time() < deadline:
        time.sleep(0.02)
    return len(cache)


def test_csp_batch_verifier_matches_reference(jax_pinned):
    idents, envs, want = _envelopes()
    keys = identity_keys(idents)
    tpu = TpuCSP(kernel_field="fold", key_cache_size=CAP, buckets=(BUCKET,),
                 latency_max_lanes=0, use_cpu_fallback=False)
    port = TorchCSP(device="cpu", key_cache_size=CAP, buckets=(BUCKET,),
                    use_cpu_fallback=False)
    try:
        jver = JCspBatchVerifier(tpu, consenters=idents)
        pver = CspBatchVerifier(port, consenters=idents)
        # the consenters are pinned in the background; make it certain
        tpu.warm_keys(keys, wait=True)
        port.warm_keys(keys, wait=True)
        ref = jver.verify_envelopes([_wire(e) for e in envs])
        got = pver.verify_envelopes(envs)
        assert got == ref == want
        # 6 lanes from consenters rode the pinned kernel; the outsider's
        # 2 lanes missed, and the malformed one never reached a kernel
        assert port.stats["pinned_lanes"] == tpu.stats["pinned_lanes"] == 6
        # the misses are pinned in the background: the next round hits
        assert _wait_keys(port.key_cache, 6) == _wait_keys(tpu.key_cache, 6)
        assert pver.verify_envelopes(envs) == jver.verify_envelopes(
            [_wire(e) for e in envs]) == want
        assert port.stats["pinned_lanes"] == tpu.stats["pinned_lanes"] == 14
        assert port.stats["fallbacks"] == tpu.stats["fallbacks"] == 0
    finally:
        tpu.close()
        port.close()
    assert TorchBatchVerifier(buckets=(BUCKET,),
                              device="cpu").verify_envelopes(envs) == want
