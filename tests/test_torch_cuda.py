"""The CUDA kernels and TorchCSP on the card (``-m cuda``).

Run on a machine with an NVIDIA GPU, nvcc and no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest`` skips ``tests/conftest.py``, which pins the JAX
package to its CPU backend.) The card is detected inside a fixture, so
every pytest worker collects the same tests; without a card each test
skips with the reason. Each kernel (generic verify, pinned-key verify)
is held lane for lane against its plain PyTorch version on the same
card and against the port's integer ECDSA: verdicts are booleans, so
the comparison is exact. The generic and pinned verifies' group bodies
also on the ladder's edge lanes (and, pinned, on u1 with zero bytes),
a ragged last block and their counts' one vote a lane. The SHA-256 kernel is held against hashlib and
its plain version, the fused block kernel against its plain version
(flags and every lane's verdict) and ``TorchCSP.verify_block`` against
the host oracle, all exactly. The Ed25519 kernel (K8, a thread group a
lane) is held against its plain twin and the RFC 8032 oracle, also on
rows with a chosen k and ragged last blocks; a K3 replay (a captured CUDA
graph of staging copy → K1 → verdict copy) against an eager K1 launch,
and a replay after new inputs were staged must give the new verdicts;
the 21-request ring repro must give the same right verdicts each run.
The BLS12-381 kernel (K9, two launches) is held against its plain twin
stage for stage (Miller (n, d), verdicts) and the host oracle's
verdicts, the Miller launch's twisted and dense paths on certificate
lanes, masked lanes, the zero lane and two signatures off the twist's
image (``pt_add(sig, G1)``, y = 0), the final launch's values against
the plain x-chain and as the cubes of K11's, and
``TorchCSP.verify_certificates`` against the oracle backend on valid,
wrong-binding, masked and forged certificates. The gen-1
``mont16`` kernel (K4) is held against its plain twin and the integer
ECDSA over several blocks with hostile lanes; K5's product (the mxu
builds' ``mont_mul``) against the CIOS product and integers bit for bit;
the mxu builds of K1, K2, K7 and K8 against their plain twins; and
``TorchCSP(kernel_field=...)`` for "mont16" and "mxu" launches only the
builds its field names. K10's count, the epilogue of the shard kernels'
counting builds (K1, K1 + K5, K4, K2), is held against its plain twin,
the split over a two-shard mesh of the one card against one unsplit
launch of K1, K1 + K5 and K4 (and K2 for pinned lanes) lane for lane
with the same count and one launch a shard, and ``TorchCSP`` through
that stood-in mesh against ``SwCSP``; K11 (the full-exponent final
exponentiation, the exact x-chain a warp a side) against its plain twin
and the oracle, and ``verify_certificates(backend="kernel")`` launches
one Miller and one K11 launch. The port's verifyd daemon over
``TorchCSP(device="cuda")`` answers a socket client's 128-vote batch
with the integer ECDSA's verdicts from one K1 launch. The BDLS engine
decides heights through the card: the 4-validator round driver
(``consensus.rounds``) through ``CspBatchVerifier(TorchCSP())`` with K2
launched and its first batch equal to the host verify, and engines made
without a verifier verify on the card (``TorchBatchVerifier``, K1).
The transaction flow at 4 validators and 10-tx blocks commits through
the card: one K7 launch a block a peer, the flags of the host path,
the honest writes in both peers' states. The orderer node: the host
AES-256-GCM against the known answers of ``tests/aes_gcm_kat.json``, a
two-node cluster handshake and its frames, and four ``OrdererNode``s
over loopback TCP ordering 30 transactions through ``TorchCSP()``, their
engines verifying on the card. The chaos soak's ``loss_crash`` through
the card's ``TorchCSP()`` gives the host run's judged record (values,
heights, incidents, digest), a verify kernel launched.
"""

from __future__ import annotations

import hashlib

import numpy as np
import pytest
import torch

from bdls_tpu_torch.crypto import blocklane as bl
from bdls_tpu_torch.crypto import vectors
from bdls_tpu_torch.crypto.csp import PublicKey, VerifyRequest
from bdls_tpu_torch.crypto.marshal import ints_to_limbs
from bdls_tpu_torch.crypto.sw import SwCSP
from bdls_tpu_torch.consensus import threshold as th
from bdls_tpu_torch.crypto.torch_provider import TorchCSP
from bdls_tpu_torch.ops import block_verify as bv
from bdls_tpu_torch.ops import bls_host as bh
from bdls_tpu_torch.ops import bls_kernel as bk
from bdls_tpu_torch.ops._build import as_int32
from bdls_tpu_torch.ops import ecdsa
from bdls_tpu_torch.ops import ed25519 as ed
from bdls_tpu_torch.ops import sha256 as sha
from bdls_tpu_torch.ops.curves import CURVES, ED25519
from bdls_tpu_torch.ops import verify_fold as vf
from bdls_tpu_torch.ops.verify_fold import verify_fold

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card with -m cuda)")
    return torch.device("cuda")


def _limbs(lanes, dev):
    return [torch.from_numpy(ints_to_limbs(c).view(np.int32)).to(dev)
            for c in vectors.columns(lanes)]


@pytest.mark.parametrize("curve", sorted(CURVES))
def test_kernel_matches_plain_and_integer_ecdsa(card, curve):
    rng = np.random.default_rng(77)
    lanes = vectors.mixed_lanes(curve, rng)
    lanes += vectors.signed_lanes(curve, 37, rng)     # ragged last block
    args = _limbs(lanes, card)
    before = ecdsa.LAUNCHES[curve]
    got = ecdsa.verify_fold_cuda(CURVES[curve], *args).cpu().numpy()
    assert ecdsa.LAUNCHES[curve] == before + 1
    plain = verify_fold(CURVES[curve], *args).cpu().numpy()
    assert got.tolist() == plain.tolist()
    assert got.tolist() == vectors.expected(curve, lanes)


@pytest.mark.parametrize("curve", sorted(CURVES))
def test_group_kernel_on_ladder_edges_and_ragged_blocks(card, curve):
    """K1's vpu build runs a thread group a lane
    (``csrc/verify_group.cuh``): the ladder's edge lanes
    (``vectors.ladder_lanes``: R at infinity, u1·G = u2·Q, both signs of
    secp256k1's second GLV half) among the mixed ones, 150 lanes so that
    the last block holds filler groups; and its counting build, one vote
    a lane: each block's partial is the count of its own valid, real
    lanes, a block of ``lanes_per_block("vpu")`` lanes."""
    from bdls_tpu_torch.ops import _build

    assert _build.lib().bdls_verify_lane_threads() == _build.VERIFY_GROUP
    rng = np.random.default_rng(153)
    base = vectors.mixed_lanes(curve, rng) + vectors.ladder_lanes(curve, rng)
    lanes = [base[i % len(base)] for i in range(150)]
    cv = CURVES[curve]
    args = _limbs(lanes, card)
    got = ecdsa.verify_fold_cuda(cv, *args).cpu().numpy()
    plain = verify_fold(cv, *args).cpu().numpy()
    assert got.tolist() == plain.tolist() == vectors.expected(curve, lanes)
    mask = rng.integers(0, 2, 150).astype(bool)
    ok, partial = ecdsa.verify_fold_cuda(
        cv, *args, mask=torch.from_numpy(mask).to(card))
    per = ecdsa.lanes_per_block("vpu")
    assert per == ecdsa.GROUP_THREADS // _build.VERIFY_GROUP
    assert ok.cpu().tolist() == got.tolist()
    part = partial.cpu().numpy()
    assert part.shape == (-(-150 // per),)
    for j, n in enumerate(part):
        assert n == int((got & mask)[j * per:(j + 1) * per].sum())


def test_wrapper_refuses_what_the_kernel_does_not_take(card):
    good = [torch.zeros((16, 8), dtype=torch.int32, device=card)] * 5
    with pytest.raises(ValueError):
        ecdsa.verify_fold_cuda(CURVES["P-256"], *good[:4],
                               good[4].to(torch.int64))
    with pytest.raises(ValueError):
        ecdsa.verify_fold_cuda(CURVES["P-256"], *good[:4], good[4].cpu())


def test_torch_csp_on_the_card(card):
    from bdls_tpu_torch.crypto.torch_provider import TorchCSP

    rng = np.random.default_rng(78)
    reqs, want = [], []
    for curve in sorted(CURVES):
        lanes = vectors.mixed_lanes(curve, rng)
        for (qx, qy, r, s, d, label), ok in zip(
                lanes, vectors.expected(curve, lanes)):
            reqs.append(VerifyRequest(PublicKey(curve, qx, qy), d, r, s))
            # the provider adds the low-S policy for P-256
            want.append(ok and (curve != "P-256"
                                or s <= CURVES[curve].fn.modulus // 2))
    csp = TorchCSP(key_cache_size=0, use_cpu_fallback=False)
    before = dict(ecdsa.LAUNCHES)
    try:
        assert csp.kernel == "cuda"
        assert csp.verify_batch(reqs) == want
        futs = [csp.submit(r) for r in reqs]
        csp.flush()
        assert [f.result(60) for f in futs] == want
    finally:
        csp.close()
    assert csp.stats["fallbacks"] == 0
    for curve in CURVES:
        assert ecdsa.LAUNCHES[curve] > before[curve]


def test_failed_launch_on_the_card_fails_futures(card, monkeypatch):
    from bdls_tpu_torch.crypto.torch_provider import TorchCSP

    with pytest.raises(ValueError, match="device='cpu' only"):
        TorchCSP(use_cpu_fallback=True)

    def broken(curve, arrs, *, device=None):
        raise RuntimeError("launch refused")

    lanes = vectors.mixed_lanes("P-256", np.random.default_rng(79))
    reqs = [VerifyRequest(PublicKey("P-256", qx, qy), d, r, s)
            for qx, qy, r, s, d, _ in lanes]
    csp = TorchCSP(key_cache_size=0)
    monkeypatch.setattr(ecdsa, "launch_verify", broken)
    try:
        with pytest.raises(RuntimeError, match="launch refused"):
            csp.verify_batch(reqs)
        with pytest.raises(RuntimeError, match="launch refused"):
            csp.warmup([("P-256", 8)])
    finally:
        csp.close()
    assert csp.stats["fallbacks"] == 0


def _pinned_batch(curve, rng, dev):
    """Mixed lanes with pinnable keys, their pool on ``dev``, and slots:
    one valid lane under another key's slot, one slot off the pool."""
    lanes, keys = [], {}
    for lane in vectors.mixed_lanes(curve, rng) + vectors.signed_lanes(
            curve, 45, rng):
        try:
            vf.build_pinned_tables(curve, lane[0], lane[1])
        except ValueError:
            continue
        keys.setdefault(lane[:2], len(keys))
        lanes.append(lane)
    cap = len(keys)
    slots = [keys[lane[:2]] for lane in lanes]
    lanes += [lanes[0], lanes[0]]
    slots += [(slots[0] + 1) % cap, cap]
    pools = {nm: np.zeros((cap, vf.pinned_positions(curve), 9, 8), np.int32)
             for nm in vf.PINNED_COORDS[curve]}
    for (qx, qy), i in keys.items():
        tabs = vf.pinned_device_tables(
            curve, vf.build_pinned_tables(curve, qx, qy))
        for nm in pools:
            pools[nm][i] = tabs[nm]
    want = vectors.expected(curve, lanes)
    want[-2:] = [False, False]
    pools = {nm: torch.from_numpy(v).to(dev) for nm, v in pools.items()}
    return (lanes, pools,
            torch.tensor(slots, dtype=torch.int32, device=dev), want)


@pytest.mark.parametrize("curve", sorted(CURVES))
def test_pinned_kernel_matches_plain_and_integer_ecdsa(card, curve):
    lanes, pools, slot, want = _pinned_batch(
        curve, np.random.default_rng(80), card)
    args = _limbs(lanes, card)[2:]
    before = ecdsa.LAUNCHES_PINNED[curve]
    got = ecdsa.verify_pinned_cuda(CURVES[curve], *args, slot,
                                   pools).cpu().numpy()
    assert ecdsa.LAUNCHES_PINNED[curve] == before + 1
    plain = vf.verify_fold_pinned(CURVES[curve], *args, slot,
                                  pools).cpu().numpy()
    assert got.tolist() == plain.tolist() == want


@pytest.mark.parametrize("curve", sorted(CURVES))
def test_pinned_group_kernel_on_edges_and_ragged_blocks(card, curve):
    """K2's vpu build runs a thread group a lane
    (``csrc/pinned_group.cuh``): the ladder's edge lanes and lanes whose
    u1 has zero bytes or is 0 among the mixed ones, 150 lanes so that the
    last block holds filler groups; and its counting build, one vote a
    lane, a block of ``lanes_per_block("vpu")`` lanes."""
    from bdls_tpu_torch.ops import _build

    assert _build.lib().bdls_pinned_lane_threads() == _build.VERIFY_GROUP
    rng = np.random.default_rng(154)
    lanes, pools, slot, want = _pinned_batch(curve, rng, card)
    extra = vectors.ladder_lanes(curve, rng) + \
        vectors.zero_byte_lanes(curve, rng)
    keys = {nm: t.cpu().numpy() for nm, t in pools.items()}
    cap = keys["x"].shape[0]
    grown = {nm: np.concatenate([v, np.zeros((len(extra),) + v.shape[1:],
                                             v.dtype)])
             for nm, v in keys.items()}
    for j, ln in enumerate(extra):
        tabs = vf.pinned_device_tables(
            curve, vf.build_pinned_tables(curve, ln[0], ln[1]))
        for nm in grown:
            grown[nm][cap + j] = tabs[nm]
    base = lanes + extra
    slots = slot.cpu().tolist() + list(range(cap, cap + len(extra)))
    truth = want + vectors.expected(curve, extra)
    idx = [i % len(base) for i in range(150)]
    tiled = [base[i] for i in idx]
    sl = torch.tensor([slots[i] for i in idx], dtype=torch.int32,
                      device=card)
    pools = {nm: torch.from_numpy(v).to(card) for nm, v in grown.items()}
    args = _limbs(tiled, card)[2:]
    cv = CURVES[curve]
    got = ecdsa.verify_pinned_cuda(cv, *args, sl, pools).cpu().numpy()
    plain = vf.verify_fold_pinned(cv, *args, sl, pools).cpu().numpy()
    assert got.tolist() == plain.tolist() == [truth[i] for i in idx]
    mask = rng.integers(0, 2, 150).astype(bool)
    ok, partial = ecdsa.verify_pinned_cuda(
        cv, *args, sl, pools, mask=torch.from_numpy(mask).to(card))
    per = ecdsa.lanes_per_block("vpu")
    assert ok.cpu().tolist() == got.tolist()
    part = partial.cpu().numpy()
    assert part.shape == (-(-150 // per),)
    for j, n in enumerate(part):
        assert n == int((got & mask)[j * per:(j + 1) * per].sum())


def test_pinned_wrapper_refuses_what_the_kernel_does_not_take(card):
    lanes, pools, slot, _ = _pinned_batch(
        "P-256", np.random.default_rng(81), card)
    args = _limbs(lanes, card)[2:]
    cv = CURVES["P-256"]
    with pytest.raises(ValueError):
        ecdsa.verify_pinned_cuda(cv, *args, slot.to(torch.int64), pools)
    with pytest.raises(ValueError):
        ecdsa.verify_pinned_cuda(cv, *args, slot,
                                 {nm: t.cpu() for nm, t in pools.items()})
    with pytest.raises(ValueError):
        ecdsa.verify_pinned_cuda(CURVES["secp256k1"], *args, slot, pools)


def test_torch_csp_pinned_on_the_card(card):
    from bdls_tpu_torch.crypto.torch_provider import TorchCSP

    rng = np.random.default_rng(82)
    reqs = []
    for curve in sorted(CURVES):
        for qx, qy, r, s, d, _ in vectors.signed_lanes(curve, 6, rng):
            reqs.append(VerifyRequest(PublicKey(curve, qx, qy), d, r, s))
    bad = VerifyRequest(reqs[0].key, reqs[1].digest, reqs[0].r, reqs[0].s)
    csp = TorchCSP(use_cpu_fallback=False)
    try:
        assert csp.key_cache is not None and csp.key_cache.device == card
        # pin all keys but the last of each curve: one miss per curve
        csp.warm_keys([q.key for i, q in enumerate(reqs) if i % 6 != 5],
                      wait=True)
        before = dict(ecdsa.LAUNCHES), dict(ecdsa.LAUNCHES_PINNED)
        assert csp.verify_batch(reqs + [bad]) == [True] * 12 + [False]
        for curve in CURVES:
            assert ecdsa.LAUNCHES[curve] == before[0][curve] + 1
            assert ecdsa.LAUNCHES_PINNED[curve] == before[1][curve] + 1
        assert csp.stats["pinned_lanes"] == 11
    finally:
        csp.close()
    assert csp.stats["fallbacks"] == 0


def test_inflight_slot_reuse_on_the_card(card, monkeypatch):
    from bdls_tpu_torch.crypto.sw import SwCSP
    from bdls_tpu_torch.crypto.torch_provider import TorchCSP

    sw = SwCSP()
    a, b = (sw.key_from_scalar("secp256k1", d) for d in (0x31, 0x32))
    digest = sw.hash(b"vote")
    r, s = sw.sign(a, digest)
    req = VerifyRequest(a.public_key(), digest, r, s)
    csp = TorchCSP(key_cache_size=1, use_cpu_fallback=False)
    real = ecdsa.launch_verify_pinned

    def racy(curve, arrs, slot, pools, *, device=None):
        csp.key_cache.pin(b.public_key())     # slot 0 now holds key B
        return real(curve, arrs, slot, pools, device=device)

    try:
        csp.warm_keys([req.key], wait=True)
        monkeypatch.setattr(ecdsa, "launch_verify_pinned", racy)
        assert csp.verify_batch([req]) == [True]
    finally:
        csp.close()
    assert csp.stats["pinned_lanes"] == 1


def test_sha256_kernel_matches_hashlib_and_plain(card):
    """K6 (a schedule warp and a rounds warp a CTA of 32 lanes) at 310,
    2049 and 8192 lanes: the padding edges, seeded lengths, a count above
    NB (clipped), filler lanes; at 2049 the last CTA has one live lane."""
    rng = np.random.default_rng(83)
    for B in (310, 2049, 8192):
        lens = [0, 55, 56, 63, 64, 119, 120, 1015] + [
            int(v) for v in rng.integers(0, 1016, B - 11)] + [1015]
        msgs = [rng.bytes(n) for n in lens]
        words, nblocks = sha.pad_messages(msgs[:-1] + [b"", b""]
                                          + msgs[-1:], max_blocks=16)
        nblocks[-3:-1] = 0, -1                    # filler lanes: the IV
        nblocks[7] = 99                           # 1015 bytes: clipped to 16
        w, nb = as_int32(words, card), as_int32(nblocks, card)
        before = sha.LAUNCHES_SHA256["sha256"]
        got = sha.sha256_cuda(w, nb).cpu().numpy()
        assert sha.LAUNCHES_SHA256["sha256"] == before + 1
        assert np.array_equal(got, sha.sha256_words(w, nb).cpu().numpy())
        be = got.view(np.uint32).astype(">u4")
        live = list(range(B - 3)) + [B - 1]
        assert [be[:, i].tobytes() for i in live] == \
            [hashlib.sha256(m).digest() for m in msgs]
        assert (got.view(np.uint32)[:, -3:-1].T == sha.H0).all()
    assert sha.sha256_batch(msgs[:5]) == [hashlib.sha256(m).digest()
                                          for m in msgs[:5]]
    with pytest.raises(ValueError):
        sha.sha256_cuda(w.to(torch.int64), nb)
    with pytest.raises(ValueError):
        sha.sha256_cuda(w, nb[:-1])


@pytest.mark.parametrize("curve", sorted(CURVES))
def test_block_kernel_matches_plain(card, curve):
    req = vectors.block_request(curve, np.random.default_rng(84), 26,
                                msg_len=(0, 300), hostile=True)
    packed = bv.pack_block_request(req, buckets=(
        64, 32) + bv.request_buckets(req)[2:])
    ts = [as_int32(packed[k], card) for k in bv.PACKED_KEYS]
    before = bv.LAUNCHES_BLOCK[curve]
    flags, valid = bv.verify_block_cuda(CURVES[curve], *ts)
    flags, valid = flags.cpu().numpy(), valid.cpu().numpy()
    assert bv.LAUNCHES_BLOCK[curve] == before + 1
    pflags, pvalid = bv.block_kernel(CURVES[curve], *ts)
    assert valid.tolist() == pvalid.cpu().tolist()
    assert flags.tolist() == pflags.cpu().tolist()
    # the kernel applies no low-S policy: the oracle is the integer ECDSA
    def kernel_level(reqs):
        return vectors.expected(curve, [(q.key.x, q.key.y, q.r, q.s,
                                         q.digest, "") for q in reqs])

    host = bl.verify_block_host(kernel_level, req)
    assert flags.tolist()[:req.ntx] == host.tolist()
    with pytest.raises(ValueError):
        bv.verify_block_cuda(CURVES[curve], *ts[:-1], ts[-1][:-1])


def test_torch_csp_verify_block_on_the_card(card):
    from bdls_tpu_torch.crypto.torch_provider import TorchCSP

    req = vectors.block_request("P-256", np.random.default_rng(85), 30,
                                hostile=True)
    csp = TorchCSP(use_cpu_fallback=False)          # key cache on
    before = dict(bv.LAUNCHES_BLOCK), dict(ecdsa.LAUNCHES)
    try:
        got = csp.verify_block(req)
    finally:
        csp.close()
    assert bv.LAUNCHES_BLOCK["P-256"] == before[0]["P-256"] + 1
    assert dict(ecdsa.LAUNCHES) == before[1]
    assert csp._c_block_fallbacks.value() == 0
    assert csp._c_block_blocks.value() == 1
    assert got.tolist() == bl.verify_block_host(SwCSP().verify_batch,
                                                req).tolist()


def _ed_limbs(lanes, dev):
    return [torch.from_numpy(a.view(np.int32)).to(dev)
            for a in ed.lanes_to_limbs(vectors.ed25519_rows(lanes))]


def test_ed25519_kernel_matches_plain_and_oracle(card):
    rng = np.random.default_rng(86)
    lanes = vectors.ed25519_mixed_lanes(rng)
    lanes += vectors.ed25519_signed_lanes(37, rng)   # ragged last block
    args = _ed_limbs(lanes, card)
    before = ed.LAUNCHES_ED25519["ed25519"]
    got = ed.verify_ed25519_cuda(*args).cpu().numpy()
    assert ed.LAUNCHES_ED25519["ed25519"] == before + 1
    plain = ed.verify_ed25519(ED25519, *args).cpu().numpy()
    assert got.tolist() == plain.tolist()
    assert got.tolist() == vectors.ed25519_expected(lanes)
    with pytest.raises(ValueError):
        ed.verify_ed25519_cuda(*args[:5], args[5].to(torch.int64))
    with pytest.raises(ValueError):
        ed.verify_ed25519_cuda(*args[:5], args[5].cpu())


def test_ed25519_group_kernel_on_edges_and_ragged_blocks(card):
    """K8's vpu build runs a thread group a lane
    (``csrc/edwards_group.cuh``): the mixed and hostile lanes and the
    rows with a chosen k (a zero top digit, carry nibble 0 and 1, k =
    2^256 - 1, torsion in A), tiled to 150 lanes and cut to 1 and 5, so
    that the last block holds filler groups; equal to the plain twin
    and the oracles, one launch a call."""
    from bdls_tpu_torch.ops import _build

    assert _build.lib().bdls_ed25519_lane_threads() == _build.VERIFY_GROUP
    assert ecdsa.block_threads("vpu") % _build.VERIFY_GROUP == 0
    rng = np.random.default_rng(155)
    lanes = vectors.ed25519_mixed_lanes(rng)
    krows = vectors.ed25519_k_rows(rng)
    rows = vectors.ed25519_rows(lanes) + [r[:6] for r in krows]
    truth = vectors.ed25519_expected(lanes) + \
        vectors.ed25519_row_expected(krows)
    for n in (150, 1, 5):
        idx = [(7 * i) % len(rows) for i in range(n)]
        args = [torch.from_numpy(a.view(np.int32)).to(card)
                for a in ed.lanes_to_limbs([rows[i] for i in idx])]
        before = ed.LAUNCHES_ED25519["ed25519"]
        got = ed.verify_ed25519_cuda(*args).cpu().numpy()
        assert ed.LAUNCHES_ED25519["ed25519"] == before + 1
        plain = ed.verify_ed25519(ED25519, *args).cpu().numpy()
        assert got.tolist() == plain.tolist() == [truth[i] for i in idx]


def test_torch_csp_ed25519_on_the_card(card):
    from bdls_tpu_torch.crypto.torch_provider import TorchCSP

    lanes = vectors.ed25519_mixed_lanes(np.random.default_rng(87))
    reqs = [VerifyRequest(PublicKey("ed25519", x, y), m, r, s)
            for x, y, r, s, m, _ in lanes]
    # the reference's screen: a message over 32 bytes with a nonzero
    # byte before its last 32 is rejected (ROADMAP.md, Queue C)
    want = [ok and not (len(q.digest) > 32 and any(q.digest[:-32]))
            for q, ok in zip(reqs, SwCSP().verify_batch(reqs))]
    # a window far longer than the submits take: one launch, at flush()
    csp = TorchCSP(buckets=(8, 32, 128), use_cpu_fallback=False,
                   flush_interval=60.0)
    ecdsa.reset_launches()
    try:
        assert csp.verify_batch(reqs) == want
        futs = [csp.submit(r) for r in reqs]
        csp.flush()
        assert [f.result(60) for f in futs] == want
    finally:
        csp.close()
    assert ed.LAUNCHES_ED25519["ed25519"] == 2
    assert not any(ecdsa.LAUNCHES.values())
    assert not any(ecdsa.LAUNCHES_PINNED.values())
    assert csp.stats["fallbacks"] == 0 and csp.stats["pinned_lanes"] == 0


@pytest.mark.parametrize("curve", sorted(CURVES))
def test_latency_replay_matches_eager_k1(card, curve):
    rng = np.random.default_rng(88)
    lanes = (vectors.mixed_lanes(curve, rng)
             + vectors.signed_lanes(curve, 8, rng))[:33]
    cv = CURVES[curve]
    arrs = [ints_to_limbs(c) for c in vectors.columns(lanes)]
    slot = ecdsa.LatencySlot(cv, 33, device=card,
                             stream=torch.cuda.Stream(card))
    assert slot.graph is not None
    before = dict(ecdsa.LAUNCHES), dict(ecdsa.LAUNCHES_LATENCY)
    slot.stage(arrs)
    slot.launch().synchronize()
    got = slot.verdict()
    assert ecdsa.LAUNCHES_LATENCY[curve] == before[1][curve] + 1
    assert dict(ecdsa.LAUNCHES) == before[0]
    eager = ecdsa.verify_fold_cuda(cv, *_limbs(lanes, card)).cpu().numpy()
    want = vectors.expected(curve, lanes)
    assert got.tolist() == eager.tolist() == want
    # new staged inputs, the same graph: the verdicts follow the inputs
    valid = want.index(True)
    flipped = list(lanes)
    qx, qy, r, s, d, _ = lanes[valid]
    flipped[valid] = (qx, qy, r ^ 1, s, d, "tampered")
    slot.stage([ints_to_limbs(c) for c in vectors.columns(flipped[:20])])
    slot.launch().synchronize()
    again = slot.verdict()
    pad = vectors.expected(curve, flipped[:20])
    pad += [pad[0]] * 13                    # lane 0 replicated
    assert again.tolist() == pad
    assert not again[valid] and got[valid]


def test_ring_repro_on_the_card(card):
    """21 secp256k1 requests at buckets=(8,): three chunks of one
    (curve, bucket) against its two K3 slots, three runs; the same
    right verdicts each time."""
    from bdls_tpu_torch.crypto.torch_provider import TorchCSP

    lanes = vectors.mixed_lanes("secp256k1", np.random.default_rng(89),
                                n_valid=2)[:21]
    reqs = [VerifyRequest(PublicKey("secp256k1", qx, qy), d, r, s)
            for qx, qy, r, s, d, _ in lanes]
    want = SwCSP().verify_batch(reqs)
    csp = TorchCSP(key_cache_size=0, buckets=(8,), use_cpu_fallback=False)
    try:
        csp.warmup([("secp256k1", 8)])
        ecdsa.reset_launches()
        runs = [csp.verify_batch(reqs) for _ in range(3)]
        st = csp.stats
    finally:
        csp.close()
    assert runs == [want] * 3
    assert st["fallbacks"] == 0 and st["latency_cold_fallbacks"] == 0
    assert ecdsa.LAUNCHES_LATENCY["secp256k1"] + \
        ecdsa.LAUNCHES["secp256k1"] == 9
    assert ecdsa.LAUNCHES_LATENCY["secp256k1"] >= 3


# ---------------------------------------------------------------- K9

def _bls_lanes():
    """Valid, wrong binding, the y = 0 "signature" and an all-zero
    lane: the oracle says [True, False, False, False]."""
    sk1, pk1 = bh.keygen(0x111)
    sk2, pk2 = bh.keygen(0x222)
    hm = bh.hash_to_g2(b"m1")
    sigs = [bh.sign(sk1, b"m1"), bh.sign(sk2, b"m1"),
            (bh.FQ12.scalar(1), bh.FQ12.zero()),
            (bh.FQ12.zero(), bh.FQ12.zero())]
    pks = [pk1, pk1, pk1, pk1]
    return [bh.G1] * 4, sigs, pks, [hm] * 4


def test_bls_kernel_matches_plain_and_oracle(card):
    g1, sigs, pks, hms = _bls_lanes()
    args = [torch.from_numpy(a.view(np.int32)).to(card)
            for pts in (g1, sigs, pks, hms) for a in bk.pt_batch(pts)]
    before = dict(bk.LAUNCHES_BLS)
    got = bk.verify_bls_cuda(*args).cpu().tolist()
    assert bk.LAUNCHES_BLS == {"miller": before["miller"] + 1,
                               "final": before["final"] + 1,
                               "final_full": before["final_full"]}
    assert got == bk.verify_kernel(*args).cpu().tolist() \
        == [True, False, False, False]
    # the Miller launch alone, against the plain Miller loop
    q = [torch.cat([args[2], args[6]], -1), torch.cat([args[3], args[7]], -1)]
    p = [torch.cat([args[0], args[4]], -1), torch.cat([args[1], args[5]], -1)]
    n, d = bk.miller_cuda(*q, *p)
    pn, pd = bk.miller_nd(*(bk.f12_from_words(t) for t in (*q, *p)))
    assert bk.words_to_ints(n) == bk.f12_to_ints(pn)
    assert bk.words_to_ints(d) == bk.f12_to_ints(pd)


def _bls_certificate_lanes():
    """Phase 3d's kinds of lane, on a 4-validator committee: valid, wrong
    binding, three masked, a byzantine ``pt_add(sig, G1)``, packed by
    ``certificate_lanes``; a 1024-validator quorum's certificate (key
    and signature as aggregates of (i + 1)·G1 keys); then the y = 0
    "signature" and the zero lane fed directly. The eight word arrays
    and the masks of ``certificate_lanes``, and the oracle's verdicts."""
    signers = [th.VoteSigner.from_seed(0x9C0D + i) for i in range(4)]
    agg = th.ThresholdAggregator([s.pk for s in signers], quorum=3)
    digest = b"decide:h9:r9"
    sig = bh.aggregate([signers[i].sign_vote(digest) for i in (0, 1, 3)])
    QC = th.QuorumCertificate
    certs = [QC(digest, (0, 1, 3), sig), QC(b"other", (0, 1, 3), sig),
             QC(digest, (0, 1, 3), None), QC(digest, (0, 1), sig),
             QC(digest, (0, 1, 9), sig),
             QC(digest, (0, 1, 3), bh.pt_add(sig, bh.G1))]
    want = [agg.verify_certificate(c) for c in certs]
    lanes, mask = th.certificate_lanes(certs, [agg] * len(certs))
    sk = 683 * 684 // 2
    hm = bh.hash_to_g2(b"bdls committee 1024 round 0")
    zero = (bh.FQ12.zero(), bh.FQ12.zero())
    direct = (bk.pt_batch([bh.G1] * 3),
              bk.pt_batch([bh.pt_mul(sk, hm),
                           (bh.FQ12.scalar(1), bh.FQ12.zero()), zero]),
              bk.pt_batch([bh.pt_mul(sk, bh.G1), bh.G1, zero]),
              bk.pt_batch([hm, hm, zero]))
    arrs = [np.ascontiguousarray(np.concatenate([a, b], -1).view(np.int32))
            for pl, pd in zip(lanes, direct) for a, b in zip(pl, pd)]
    return arrs, mask + [True] * 3, want + [True, False, False]


def test_bls_launches_match_plain_on_every_kind_of_lane(card):
    """The Miller launch's (n, d) against the plain ``miller_nd``, word
    for word, on twisted, masked, zero and dense lanes in one launch; the
    final launch's values against the plain x-chain and as the cubes of
    K11's; the verdicts the oracle's."""
    host, mask, want = _bls_certificate_lanes()
    assert want == [True] + [False] * 5 + [True, False, False]
    args = [torch.from_numpy(a).to(card) for a in host]
    B = len(want)
    q = [torch.cat([args[a], args[b]], -1)
         for a, b in ((2, 6), (3, 7), (0, 4), (1, 5))]
    n, d = bk.miller_cuda(*q)
    pn, pd = bk.miller_nd(*(bk.f12_from_words(t) for t in q))
    assert bk.words_to_ints(n) == bk.f12_to_ints(pn)
    assert bk.words_to_ints(d) == bk.f12_to_ints(pd)
    ok, fe = bk.final_cuda(n, d)
    ok_full, full = bk.final_full_cuda(n, d)
    raw = ok.cpu().tolist()
    assert raw == ok_full.cpu().tolist()
    assert [m and r for m, r in zip(mask, raw)] == want
    # the kernel's column 2b is lane b's n1·d2, 2b + 1 its n2·d1
    order = torch.tensor([i // 2 + (B if i % 2 else 0)
                          for i in range(2 * B)], device=card)
    swap = torch.tensor([(i + B) % (2 * B) for i in range(2 * B)],
                        device=card)
    sides = bk.f12_mul(bk.f12_from_words(n.index_select(-1, order)),
                       bk.f12_from_words(d.index_select(-1, swap)
                                         .index_select(-1, order)))
    cube = bk.words_to_ints(fe)
    assert cube == bk.f12_to_ints(bk.final_exp_fast(sides))
    root = bk.words_to_ints(full)
    for col in range(2 * B):
        v = bh.FQ12([root[c][col] for c in range(12)])
        assert bh.FQ12([cube[c][col] for c in range(12)]) == v * v * v, col


def test_bls_wrapper_refuses_what_the_kernel_does_not_take(card):
    good = [torch.zeros((12, 12, 2), dtype=torch.int32, device=card)] * 8
    with pytest.raises(ValueError):
        bk.verify_bls_cuda(*good[:7], good[7].to(torch.int64))
    with pytest.raises(ValueError):
        bk.verify_bls_cuda(*good[:7], good[7].cpu())
    with pytest.raises(ValueError):
        bk.final_cuda(good[0][..., :1].contiguous(),
                      good[1][..., :1].contiguous())


def test_torch_csp_verify_certificates_on_the_card(card, monkeypatch):
    monkeypatch.delenv("BDLS_CERT_BACKEND", raising=False)
    signers = [th.VoteSigner.from_seed(0xC0DE + i) for i in range(4)]
    agg = th.ThresholdAggregator([s.pk for s in signers], quorum=3)
    digest = b"decide:h9:r1"
    sig = bh.aggregate([signers[i].sign_vote(digest) for i in (0, 2, 3)])
    QC = th.QuorumCertificate
    certs = [QC(digest, (0, 2, 3), sig), QC(b"other", (0, 2, 3), sig),
             QC(digest, (0, 2, 3), None), QC(digest, (0, 2), sig),
             QC(digest, (0, 2, 9), sig),
             QC(digest, (0, 2, 3), bh.pt_add(sig, bh.G1))]
    aggs = [agg] * len(certs)
    want = [agg.verify_certificate(c) for c in certs]
    assert want == [True, False, False, False, False, False]
    csp = TorchCSP(key_cache_size=0)
    try:
        bk.reset_launches()
        assert csp.verify_certificates(certs, aggs) == want
        assert bk.LAUNCHES_BLS == {"miller": 1, "final": 1, "final_full": 0}
        assert csp._c_cert_host.value() == 0
        assert csp.verify_certificates(certs, aggs, backend="kernel-fast") \
            == want
        assert bk.LAUNCHES_BLS == {"miller": 2, "final": 2, "final_full": 0}
        # the full exponent: one Miller launch and one K11 launch
        assert csp.verify_certificates(certs, aggs, backend="kernel") \
            == want
        assert bk.LAUNCHES_BLS == {"miller": 3, "final": 2, "final_full": 1}
        assert csp._c_cert_host.value() == 0
    finally:
        csp.close()


# ------------------------------------------------------------- K4 and K5

# K4 also runs at B = 5 and 127: part groups and part warps
K4_B = [None, 5, 127]


@pytest.mark.parametrize("n", K4_B)
@pytest.mark.parametrize("curve", sorted(CURVES))
def test_mont16_kernel_matches_plain_and_integer_ecdsa(card, curve, n):
    """K4 a thread group a lane (``csrc/mont16_group.cuh``): the hostile
    lanes and those that take each of its ladder's exceptional selects,
    lane for lane against the plain twin and the integer ECDSA."""
    from bdls_tpu_torch.ops import _build

    assert _build.lib().bdls_mont16_lane_threads() == _build.VERIFY_GROUP
    rng = np.random.default_rng(141)
    lanes = vectors.mixed_lanes(curve, rng) + vectors.select_lanes(curve,
                                                                   rng)
    lanes += vectors.signed_lanes(curve, 70, rng)      # a ragged last warp
    lanes = _tile(lanes, n)
    args = _limbs(lanes, card)
    before = ecdsa.LAUNCHES_MONT16[curve]
    got = ecdsa.verify_mont16_cuda(CURVES[curve], *args).cpu().numpy()
    assert ecdsa.LAUNCHES_MONT16[curve] == before + 1
    plain = ecdsa.verify_kernel(CURVES[curve], *args).cpu().numpy()
    assert got.tolist() == plain.tolist() == vectors.expected(curve, lanes)


def _tile(rows: list, n):
    """rows repeated and cut to n (n None: rows as they are)."""
    return rows if n is None else (rows * -(-n // len(rows)))[:n]


# the mxu cases also run at B = 5 and 127: part groups and part warps
MXU_B = [None, 5, 127]


@pytest.mark.parametrize("n", MXU_B)
def test_mxu_product_matches_cios_bit_for_bit(card, n):
    from bdls_tpu_torch.ops import _build
    from bdls_tpu_torch.ops.curves import EDWARDS_CURVES

    mods = [CURVES["P-256"].fp, CURVES["P-256"].fn, CURVES["secp256k1"].fp,
            CURVES["secp256k1"].fn, EDWARDS_CURVES["ed25519"].fp]
    rng = np.random.default_rng(143)
    R = 1 << 256
    for i, ctx in enumerate(mods):
        m = ctx.modulus
        xs = [0, 1, m - 1, m, R - 1] + [int.from_bytes(rng.bytes(32), "big")
                                        for _ in range(300)]
        ys = [m - 1, 1, m - 1, 2, 0] + [int.from_bytes(rng.bytes(32), "big")
                                        % m for _ in range(300)]
        xs, ys = _tile(xs, n), _tile(ys, n)
        w = [torch.from_numpy(np.array(
            [[(x >> (32 * k)) & 0xFFFFFFFF for k in range(8)] for x in v],
            np.uint32).view(np.int32)).to(card) for v in (xs, ys)]
        outs = []
        for eng in ("vpu", "mxu"):
            out = torch.empty_like(w[0])
            _build.check(_build.lib(eng).bdls_field_mul(
                i, w[0].data_ptr(), w[1].data_ptr(), out.data_ptr(), len(xs),
                torch.cuda.current_stream().cuda_stream), "bdls_field_mul")
            outs.append(out.cpu().numpy().view(np.uint32))
        assert np.array_equal(outs[0], outs[1])
        got = [sum(int(r[k]) << (32 * k) for k in range(8)) for r in outs[1]]
        assert got == [x * y * pow(R, -1, m) % m for x, y in zip(xs, ys)]


@pytest.mark.parametrize("n", MXU_B)
@pytest.mark.parametrize("curve", sorted(CURVES))
def test_mxu_builds_match_plain(card, curve, n):
    from bdls_tpu_torch.ops import fold

    rng = np.random.default_rng(145)
    lanes = vectors.mixed_lanes(curve, rng)
    lanes += vectors.signed_lanes(curve, 9, rng)        # a ragged warp
    lanes = _tile(lanes, n)
    args = _limbs(lanes, card)
    want = vectors.expected(curve, lanes)
    before = ecdsa.LAUNCHES_MXU[curve], ecdsa.LAUNCHES[curve]
    got = ecdsa.verify_fold_cuda(CURVES[curve], *args, engine="mxu")
    with fold.mul_backend("mxu"):
        plain = verify_fold(CURVES[curve], *args)
    assert got.cpu().tolist() == plain.cpu().tolist() == want
    assert (ecdsa.LAUNCHES_MXU[curve], ecdsa.LAUNCHES[curve]) == \
        (before[0] + 1, before[1])
    # K7's mxu build, flags and lanes against its plain twin
    req = vectors.block_request(curve, rng, 26, msg_len=(0, 200),
                                hostile=True)
    packed = bv.pack_block_request(req)
    flags, valid = bv.launch_block(CURVES[curve], packed, device=card,
                                   field="mxu")
    pflags, pvalid = bv.launch_block(CURVES[curve], packed, device="cpu",
                                     field="mxu")
    assert flags.cpu().tolist() == pflags.tolist()
    assert valid.cpu().tolist() == pvalid.tolist()


@pytest.mark.parametrize("n", MXU_B)
def test_mxu_pinned_and_ed25519_builds_match_plain(card, n):
    from bdls_tpu_torch.crypto.key_cache import KeyTableCache

    rng = np.random.default_rng(147)
    sw = SwCSP()
    keys = [sw.key_gen("secp256k1", rng) for _ in range(3)]
    cache = KeyTableCache(4, card)
    cache.warm([k.public_key() for k in keys], wait=True)
    lanes, slots = [], []
    for i in range(40):
        key = keys[i % 3]
        d = sw.hash(b"m%d" % i)
        r, s = sw.sign(key, d)
        if i % 7 == 3:
            d = sw.hash(b"tampered")
        pub = key.public_key()
        lanes.append((pub.x, pub.y, r, s, d, "pinned"))
    lanes = _tile(lanes, n)
    slots, pools = cache.lookup_batch("secp256k1",
                                      [PublicKey("secp256k1", x, y)
                                       for x, y, *_ in lanes])
    args = _limbs(lanes, card)[2:]
    slot = torch.tensor(slots, dtype=torch.int32, device=card)
    got = ecdsa.launch_verify_pinned(CURVES["secp256k1"], args, slot, pools,
                                     device=card, field="mxu")
    plain = ecdsa.launch_verify_pinned(
        CURVES["secp256k1"], [a.cpu() for a in args], slot.cpu(),
        {k: v.cpu() for k, v in pools.items()}, device="cpu", field="mxu")
    assert got.cpu().tolist() == plain.tolist() == \
        vectors.expected("secp256k1", lanes)
    cache.close()
    elanes = _tile(vectors.ed25519_mixed_lanes(rng), n)
    arrs = ed.lanes_to_limbs(vectors.ed25519_rows(elanes))
    got = ed.launch_verify(arrs, device=card, field="mxu").cpu().tolist()
    plain = ed.launch_verify(arrs, device="cpu", field="mxu").tolist()
    assert got == plain == vectors.ed25519_expected(elanes)


@pytest.mark.parametrize("field,n", [("mont16", None), ("mxu", None),
                                     ("mxu", 5), ("mxu", 127)])
def test_torch_csp_kernel_field_on_the_card(card, field, n):
    from bdls_tpu_torch.crypto.torch_provider import TorchCSP

    rng = np.random.default_rng(149)
    lanes = _tile(vectors.mixed_lanes("secp256k1", rng), n)
    reqs = [VerifyRequest(PublicKey("secp256k1", qx, qy), d, r, s)
            for qx, qy, r, s, d, _ in lanes]
    bucket = 32 if len(lanes) <= 32 else 128
    csp = TorchCSP(key_cache_size=0, kernel_field=field, buckets=(bucket,))
    try:
        csp.warmup([("secp256k1", bucket)])
        ecdsa.reset_launches()
        assert csp.verify_batch(reqs) == vectors.expected("secp256k1",
                                                          lanes)
        stats = csp.stats
    finally:
        csp.close()
    assert stats["kernel"] == field and stats["fallbacks"] == 0
    if field == "mont16":
        assert stats["latency_cold_fallbacks"] == 1
        assert ecdsa.LAUNCHES_MONT16["secp256k1"] == 1
        assert not any(ecdsa.LAUNCHES.values())
    else:
        # one K1 + K5 launch: the warmed slot's replay, or (a bucket the
        # warmup did not fill, n = 5) K1 + K5 eagerly
        mxu = (ecdsa.LAUNCHES_LATENCY_MXU["secp256k1"],
               ecdsa.LAUNCHES_MXU["secp256k1"])
        assert mxu == (1, 0) if n is None else sum(mxu) == 1
        assert not any(ecdsa.LAUNCHES.values()) and \
            not any(ecdsa.LAUNCHES_LATENCY.values())


# ------------------------------------------------------------- K10 and K11

@pytest.mark.parametrize("program", ["fold", "mxu", "mont16", "pinned"])
def test_fused_count_matches_plain(card, program):
    """K10's count in the shard kernel's epilogue: the counting build's
    verdicts equal the plain build's, and its per-block partials sum to
    the plain twin's count, at 2048, 8192 and 2000 lanes, masks all-on,
    all-off and random."""
    from bdls_tpu_torch.parallel import mesh as pmesh

    rng = np.random.default_rng(151)
    cv = CURVES["P-256"]
    if program == "pinned":
        lanes, pools, slot, _ = _pinned_batch("P-256", rng, card)
    else:
        lanes = vectors.mixed_lanes("P-256", rng)
        lanes += vectors.signed_lanes("P-256", 64, rng)
    base = _limbs(lanes, card)
    for n in (2048, 8192, 2000):
        idx = torch.tensor([i % len(lanes) for i in range(n)], device=card)
        args = [a.index_select(1, idx).contiguous() for a in base]
        if program == "pinned":
            sl = slot.index_select(0, idx).contiguous()

            def run(**kw):
                return ecdsa.verify_pinned_cuda(cv, *args[2:], sl, pools,
                                                **kw)
        elif program == "mont16":
            def run(**kw):
                return ecdsa.verify_mont16_cuda(cv, *args, **kw)
        else:
            engine = ecdsa.FOLD_FIELDS[program]

            def run(**kw):
                return ecdsa.verify_fold_cuda(cv, *args, engine=engine, **kw)

        whole = run()
        for mask in (torch.ones(n, dtype=torch.bool),
                     torch.zeros(n, dtype=torch.bool),
                     torch.from_numpy(rng.integers(0, 2, n).astype(bool))):
            mask = mask.to(card)
            ok, partial = run(mask=mask)
            per = ecdsa.lanes_per_block(ecdsa.FOLD_FIELDS.get(program,
                                                              "vpu"))
            assert partial.shape == (-(-n // per),)
            assert ok.cpu().tolist() == whole.cpu().tolist()
            assert int(partial.to(torch.int64).sum()) == \
                int(pmesh.masked_count_plain(whole.cpu(), mask.cpu()))
        with pytest.raises(ValueError):
            run(mask=mask[:-1])


@pytest.mark.parametrize("field", ["fold", "mxu", "mont16"])
def test_two_shard_split_matches_unsplit(card, field):
    from bdls_tpu_torch.parallel import mesh as pmesh

    rng = np.random.default_rng(152)
    lanes = vectors.mixed_lanes("P-256", rng)
    lanes += vectors.signed_lanes("P-256", 100 - len(lanes), rng)
    arrs = [ints_to_limbs(c) for c in vectors.columns(lanes)]
    padded, mask = pmesh.pad_and_mask(arrs, 100, 128)
    cv = CURVES["P-256"]
    whole = ecdsa.launch_verify(cv, padded, device=card,
                                field=field).cpu().tolist()
    want = vectors.expected("P-256", lanes)
    assert whole[:100] == want
    mesh = pmesh.make_mesh([card, card])
    for make in (pmesh.sharded_verify_masked, pmesh.pjit_verify_masked):
        ecdsa.reset_launches()
        ok, n_valid = make(cv, mesh, field=field)(mask, *padded)
        assert ok.cpu().tolist() == whole
        assert int(n_valid) == sum(want)
        assert pmesh.LAUNCHES_MESH == {"shards": 2}
        launched = {"fold": ecdsa.LAUNCHES, "mxu": ecdsa.LAUNCHES_MXU,
                    "mont16": ecdsa.LAUNCHES_MONT16}[field]
        assert launched["P-256"] == 2


def test_two_shard_pinned_split_matches_unsplit(card):
    from bdls_tpu_torch.parallel import mesh as pmesh

    rng = np.random.default_rng(153)
    lanes, pools, slot, want = _pinned_batch("P-256", rng, card)
    n = len(lanes) - len(lanes) % 2
    args = [a[:, :n].contiguous() for a in _limbs(lanes, card)[2:]]
    slot = slot[:n].contiguous()
    cv = CURVES["P-256"]
    whole = ecdsa.verify_pinned_cuda(cv, *args, slot, pools).cpu().tolist()
    assert whole == want[:n]
    mask = np.ones(n, dtype=bool)
    mesh = pmesh.make_mesh([card, card])
    for make in (pmesh.sharded_verify_pinned, pmesh.pjit_verify_pinned):
        ecdsa.reset_launches()
        ok, n_valid = make(cv, mesh)(pools, mask, slot.cpu().numpy(),
                                     *(a.cpu() for a in args))
        assert ok.cpu().tolist() == whole
        assert int(n_valid) == sum(whole)
        assert ecdsa.LAUNCHES_PINNED["P-256"] == 2
        assert pmesh.LAUNCHES_MESH == {"shards": 2}


def test_torch_csp_through_a_stood_in_mesh(card, monkeypatch):
    """A two-shard mesh of the one card stood in for the device list:
    both dispatch points split, no unsplit launch, SwCSP's verdicts."""
    from bdls_tpu_torch.parallel import mesh as pmesh

    rng = np.random.default_rng(154)
    lanes = vectors.signed_lanes("P-256", 250, rng)
    reqs = [VerifyRequest(PublicKey("P-256", qx, qy),
                          bytes(32) if i % 50 == 7 else d, r, s)
            for i, (qx, qy, r, s, d, _) in enumerate(lanes)]
    want = SwCSP().verify_batch(reqs)
    kw = dict(buckets=(8, 256), mesh_threshold=256, latency_max_lanes=0)
    csp = TorchCSP(key_cache_size=0, **kw)
    pinned = TorchCSP(key_cache_size=256, **kw)
    try:
        ecdsa.reset_launches()
        assert csp.verify_batch(reqs) == want       # one card: no split
        assert ecdsa.LAUNCHES["P-256"] == 1
        assert pmesh.LAUNCHES_MESH == {"shards": 0}
        pinned.warm_keys([r.key for r in reqs], wait=True)
        monkeypatch.setattr(pmesh, "mesh_devices", lambda: [card, card])
        for mode in ("pjit", "shard_map"):
            csp.shard_mode = pinned.shard_mode = mode
            ecdsa.reset_launches()
            assert csp.verify_batch(reqs) == want   # generic: K1 a shard
            assert ecdsa.LAUNCHES["P-256"] == 2
            assert pmesh.LAUNCHES_MESH == {"shards": 2}
            ecdsa.reset_launches()
            assert pinned.verify_batch(reqs) == want   # K2 a shard
            assert ecdsa.LAUNCHES_PINNED["P-256"] == 2
            assert not any(ecdsa.LAUNCHES.values())
            assert pmesh.LAUNCHES_MESH == {"shards": 2}
        assert csp.stats["fallbacks"] == pinned.stats["fallbacks"] == 0
    finally:
        csp.close()
        pinned.close()


def test_final_full_kernel_matches_plain_and_oracle(card):
    g1, sigs, pks, hms = _bls_lanes()
    args = [torch.from_numpy(a.view(np.int32)).to(card)
            for pts in (g1, sigs, pks, hms) for a in bk.pt_batch(pts)]
    before = dict(bk.LAUNCHES_BLS)
    got = bk.verify_bls_full_cuda(*args).cpu().tolist()
    assert bk.LAUNCHES_BLS == {"miller": before["miller"] + 1,
                               "final": before["final"],
                               "final_full": before["final_full"] + 1}
    assert got == [True, False, False, False]
    q = [torch.cat([args[2], args[6]], -1), torch.cat([args[3], args[7]], -1)]
    p = [torch.cat([args[0], args[4]], -1), torch.cat([args[1], args[5]], -1)]
    n, d = bk.miller_cuda(*q, *p)
    _, fe = bk.final_full_cuda(n, d)
    _, fast = bk.final_cuda(n, d)
    full, cube = bk.words_to_ints(fe), bk.words_to_ints(fast)
    # every side: the x-chain's value is the full exponent's cube
    for col in range(8):
        v = bh.FQ12([full[c][col] for c in range(12)])
        assert bh.FQ12([cube[c][col] for c in range(12)]) == v * v * v
    # lane 0's two sides (columns 0 and 1): the plain twin on the card
    # and the oracle's pow of n1·d2 and n2·d1
    sides = bk.f12_mul(
        bk.f12_from_words(torch.stack([n[..., 0], n[..., 4]], -1)),
        bk.f12_from_words(torch.stack([d[..., 4], d[..., 0]], -1)))
    plain = bk.f12_to_ints(bk.final_exp(sides))
    prod = bk.f12_to_ints(sides)
    e = (bh.P ** 12 - 1) // bh.R
    for col in (0, 1):
        got = [full[c][col] for c in range(12)]
        assert got == [plain[c][col] for c in range(12)]
        assert bh.FQ12(got) == bh.FQ12([prod[c][col]
                                        for c in range(12)]).pow(e)


def test_verifyd_vote_batch_on_the_card(card):
    """An in-process port daemon over ``TorchCSP(device="cuda")`` (the
    latency tier off, so the round is K1's eager launch), one socket
    client with the quorum hint: a 128-lane secp256k1 vote batch comes
    back with the integer ECDSA's verdicts, from one K1 launch, with no
    client fallback and no flush error."""
    from bdls_tpu_torch.sidecar.remote_csp import RemoteCSP
    from bdls_tpu_torch.sidecar.verifyd import VerifydServer

    sw = SwCSP()
    rng = np.random.default_rng(1717)
    digest = sw.hash(b"verifyd round on the card")
    votes, want = [], []
    for v in range(128):
        key = sw.key_gen("secp256k1", rng)
        forged = v % 43 == 5
        r, s = sw.sign(key, sw.hash(b"other") if forged else digest)
        votes.append(VerifyRequest(key.public_key(), digest, r, s))
        want.append(not forged)
    csp = TorchCSP(device="cuda", key_cache_size=0, latency_max_lanes=0)
    csp.warmup([("secp256k1", 128)])
    srv = VerifydServer(csp=csp, transport="socket",
                        flush_interval=0.05).start()
    client = RemoteCSP(f"127.0.0.1:{srv.port}", transport="socket",
                       tenant="card", request_timeout=60.0)
    try:
        client.set_quorum_hint(128)
        ecdsa.reset_launches()
        got = client.verify_batch(votes)
        launches = dict(ecdsa.LAUNCHES)
        assert got == want
        assert launches["secp256k1"] == 1 and launches["P-256"] == 0
        assert client._c_fallbacks.value() == 0
        assert srv.coalescer.counts["verify_errors"] == 0
        assert srv.coalescer.counts["quorum_flushes"] == 1
    finally:
        client.close()
        srv.stop()
        srv.close_csp()


def test_consensus_rounds_decide_through_the_card(card):
    """The round driver at 4 validators decides 2 heights with every
    envelope verified on the card: the pre-pass sidecar and each node's
    misses go to ``CspBatchVerifier(TorchCSP())`` over the pinned
    consenters (K2); its first batch equals the host verify."""
    from bdls_tpu_torch.consensus import rounds as R
    from bdls_tpu_torch.consensus.identity import Signer, \
        cpu_verify_envelope
    from bdls_tpu_torch.consensus.verifier import (CspBatchVerifier,
                                                   identity_keys)

    csp = TorchCSP()
    try:
        participants = [Signer.from_scalar(R.SIGNER_BASE + i).identity
                        for i in range(4)]
        card_v = CspBatchVerifier(csp, consenters=participants)
        csp.warm_keys(identity_keys(participants), wait=True)
        first = []

        class Sidecar:
            def verify_envelopes(self, envs):
                oks = card_v.verify_envelopes(envs)
                first.append((list(envs), oks))
                return oks

        cache, cvs = {}, []

        def factory():
            cvs.append(R.CacheVerifier(cache, card_v))
            return cvs[-1]

        net = R.build_net(4, factory)
        ecdsa.reset_launches()
        stats = R.run_rounds(net, 2, sidecar=Sidecar(), cache=cache,
                             max_virtual_s=60.0)
        assert stats["heights"] >= 2
        assert len({n.latest_state for n in net.nodes
                    if n.latest_height == 2}) == 1
        assert ecdsa.LAUNCHES_PINNED["secp256k1"] > 0
        envs, oks = first[0]
        assert oks == [cpu_verify_envelope(e) for e in envs] and all(oks)
        assert sum(c.misses for c in cvs) > 0
    finally:
        csp.close()


def test_engine_without_a_verifier_verifies_on_the_card(card):
    from bdls_tpu_torch.consensus import (Config, Consensus, Signer,
                                          TorchBatchVerifier)
    from bdls_tpu_torch.consensus.ipc import VirtualNetwork

    signers = [Signer.from_scalar(0x5100 + i) for i in range(4)]
    net = VirtualNetwork(seed=1, latency=0.01)
    for s in signers:
        net.add_node(Consensus(Config(
            epoch=0.0, signer=s, participants=[x.identity for x in signers],
            state_compare=lambda a, b: (a > b) - (a < b),
            state_validate=lambda s_, h_: True, latency=0.05)))
    net.connect_all()
    assert all(isinstance(n.verifier, TorchBatchVerifier)
               and n.verifier.device.type == "cuda" for n in net.nodes)
    ecdsa.reset_launches()
    for node in net.nodes:
        node.propose(b"on the card")
    net.run_until(5.0)
    assert net.heights() == [1, 1, 1, 1]
    assert {n.latest_state for n in net.nodes} == {b"on the card"}
    assert ecdsa.LAUNCHES["secp256k1"] > 0


def test_transaction_flow_commits_through_the_card(card):
    """The transaction flow at 4 validators and 10-tx blocks: a gateway
    endorses on two peers, the chains order through
    ``CspBatchVerifier(TorchCSP())`` and each peer commits both blocks
    through one K7 launch a block, with the hostile transactions flagged
    as the host path flags them and the honest writes in both states."""
    import hashlib

    from bdls_tpu_torch.consensus.identity import Signer
    from bdls_tpu_torch.consensus.verifier import CspBatchVerifier
    from bdls_tpu_torch.models import txflow as F
    from bdls_tpu_torch.peer.committer import KVState
    import _txflow_workload as W
    from bdls_tpu_torch.peer.validator import EndorsementPolicy, TxValidator

    csp = TorchCSP()
    try:
        participants = [Signer.from_scalar(F.SIGNER_BASE + i).identity
                        for i in range(4)]
        stack = F.build_stack(csp, CspBatchVerifier(csp,
                                                    consenters=participants),
                              validators=4, max_message_count=10,
                              batch_timeout=5.0)
        ecdsa.reset_launches()
        blocks0 = csp._c_block_blocks.value()
        sub = W.submit_plan(stack, W.plan(20, 10, hostile_every=5,
                                          offset=2))
        assert F.drive_until(stack, 3, 60.0)
        assert bv.LAUNCHES_BLOCK["P-256"] == 4
        assert csp._c_block_blocks.value() - blocks0 == 4
        assert csp.stats["fallbacks"] == 0
        host = TxValidator(SwCSP(), EndorsementPolicy(required=2),
                           msp=stack.msp, state_get=KVState().get)
        for h in (1, 2):
            blk = stack.peers[0].block_store.get(h)
            want = [int(sub.expected[hashlib.sha256(t).digest()])
                    for t in blk.data.transactions]
            assert [int(f) for f in host.validate_block(blk)] == want
            for peer in stack.peers:
                assert list(peer.block_store.get(h).metadata.entries[0]) \
                    == want
        assert dict(stack.peers[0].state.range_query()) == sub.writes
        assert stack.peers[1].state.range_query() == \
            stack.peers[0].state.range_query()
    finally:
        csp.close()


# ---- the orderer node: its AEAD, its cluster and four nodes on the card ----

def test_aes_gcm_known_answers_on_the_cards_machine(card):
    """``tests/aes_gcm_kat.json`` (made with ``cryptography``, which this
    machine lacks) against the host AES-256-GCM built here."""
    import json
    from pathlib import Path

    from bdls_tpu_torch.comm.aead import AESGCM, InvalidTag

    vectors = json.loads((Path(__file__).resolve().parent
                          / "aes_gcm_kat.json").read_text())
    assert len(vectors) == 56
    for v in vectors:
        aad = None if v["aad"] is None else bytes.fromhex(v["aad"])
        g = AESGCM(bytes.fromhex(v["key"]))
        nonce = bytes.fromhex(v["nonce"])
        sealed = bytes.fromhex(v["sealed"])
        assert g.encrypt(nonce, bytes.fromhex(v["plaintext"]), aad) == sealed
        assert g.decrypt(nonce, sealed, aad).hex() == v["plaintext"]
        bad = bytearray(sealed)
        bad[-1] ^= 1
        with pytest.raises(InvalidTag):
            g.decrypt(nonce, bytes(bad), aad)


def test_two_node_cluster_handshake_on_the_cards_machine(card):
    import time

    from bdls_tpu_torch.comm.cluster import ClusterNode
    from bdls_tpu_torch.consensus.identity import Signer

    inbox = []
    nodes = [ClusterNode(Signer.from_scalar(0x1E00 + i),
                         router=lambda ch, p, frm: inbox.append((ch, p, frm)),
                         membership=lambda ident: True) for i in range(2)]
    a, b = nodes
    try:
        a.connect(b.identity, b.host, b.port, timeout=5.0)
        end = time.time() + 10.0
        while time.time() < end and a.identity not in b.connected_peers():
            time.sleep(0.01)
        payload = bytes(range(256)) * 4096
        assert a.send(b.identity, "ch", payload)
        assert b.send(a.identity, "ch", b"back")
        while time.time() < end and len(inbox) < 2:
            time.sleep(0.01)
        assert sorted(inbox, key=lambda m: len(m[1])) == [
            ("ch", b"back", b.identity), ("ch", payload, a.identity)]
        assert a.stats["auth_fail"] == b.stats["auth_fail"] == 0
    finally:
        a.close()
        b.close()


def _orderer_tx(i: int, channel: str) -> bytes:
    from bdls_tpu_torch.ordering import fabric_codec as pb
    from bdls_tpu_torch.ordering.block import tx_digest

    sw = SwCSP()
    key = sw.key_from_scalar("P-256", 0xC11E47)
    env = pb.TxEnvelope()
    env.header.channel_id = channel
    env.header.tx_id = f"tx-{i}"
    pub = key.public_key()
    env.header.creator_x = pub.x.to_bytes(32, "big")
    env.header.creator_y = pub.y.to_bytes(32, "big")
    env.header.creator_org = "org1"
    env.payload = b"payload-%d" % i
    r, s = sw.sign(key, tx_digest(env))
    env.sig_r = r.to_bytes(32, "big")
    env.sig_s = s.to_bytes(32, "big")
    return env.SerializeToString()


def test_four_orderer_nodes_order_through_the_card(card, tmp_path):
    """Four ``OrdererNode``s, each with its own ``TorchCSP()`` and no
    verifier (their engines verify on the card), over the cluster on
    loopback TCP, order 30 transactions in 10-tx blocks: byte-equal
    ledgers, every transaction once, K1 or K2 launched, no fallback."""
    import time

    from bdls_tpu_torch.consensus.identity import Signer
    from bdls_tpu_torch.models.orderer import OrdererNode
    from bdls_tpu_torch.ordering import fabric_codec as pb
    from bdls_tpu_torch.ordering.registrar import (make_channel_config,
                                                   make_genesis)

    signers = [Signer.from_scalar(0x1F00 + i) for i in range(4)]
    csps = [TorchCSP() for _ in signers]
    nodes = []
    try:
        for i, s in enumerate(signers):
            nodes.append(OrdererNode(s, base_dir=str(tmp_path / f"n{i}"),
                                     csp=csps[i]))
        for a in nodes:
            for b in nodes:
                if a is not b:
                    a.set_endpoint(b.identity, *b.address)
        genesis = make_genesis(make_channel_config(
            "cardchan", [s.identity for s in signers], max_message_count=10,
            batch_timeout_s=0.5, writer_orgs=("org1",)))
        for node in nodes:
            node.join_channel(genesis)
            node.start()
        end = time.time() + 30.0
        while time.time() < end and not all(
                len(n.cluster.connected_peers()) == 3 for n in nodes):
            time.sleep(0.2)
        time.sleep(1.0)
        ecdsa.reset_launches()
        for i in range(30):
            nodes[i % 4].broadcast(_orderer_tx(i, "cardchan"))
        def ordered(node):
            return sum(len(b.data.transactions)
                       for b in node.deliver("cardchan", 1))

        end = time.time() + 60.0
        while time.time() < end:
            hs = [n.channel_height("cardchan") for n in nodes]
            if len(set(hs)) == 1 and ordered(nodes[0]) == 30:
                break
            time.sleep(0.1)
        assert len(set(hs)) == 1 and hs[0] >= 4, hs
        raws = [[b.SerializeToString() for b in n.deliver("cardchan")]
                for n in nodes]
        assert all(r == raws[0] for r in raws)
        ids = [pb.TxEnvelope.FromString(t).header.tx_id
               for raw in raws[0][1:]
               for t in pb.Block.FromString(raw).data.transactions]
        assert sorted(ids) == sorted(f"tx-{i}" for i in range(30))
        assert ecdsa.LAUNCHES["P-256"] + ecdsa.LAUNCHES_PINNED["P-256"] > 0
        assert ecdsa.LAUNCHES["secp256k1"] > 0
        assert all(c.stats["fallbacks"] == 0 for c in csps)
    finally:
        for node in nodes:
            node.stop()
        for c in csps:
            c.close()


def test_chaos_loss_crash_on_the_card_equals_the_host(card):
    from bdls_tpu_torch.chaos import scenarios
    from bdls_tpu_torch.chaos.runner import run_scenario

    ecdsa.reset_launches()
    on_card = run_scenario(scenarios.get("loss_crash"))
    launched = (sum(ecdsa.LAUNCHES.values())
                + sum(ecdsa.LAUNCHES_PINNED.values())
                + sum(ecdsa.LAUNCHES_LATENCY.values()))
    host = run_scenario(scenarios.get("loss_crash"), device="cpu",
                        kernel_field="sw")
    assert on_card["provider"]["device"].startswith("cuda")
    assert on_card["ok"] and not on_card["timed_out"]
    assert launched > 0
    for key in ("values", "heights", "incidents", "timeline_digest"):
        assert on_card[key] == host[key], key
