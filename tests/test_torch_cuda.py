"""The CUDA kernels and TorchCSP on the card (``-m cuda``).

Run on a machine with an NVIDIA GPU, nvcc and no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest`` skips ``tests/conftest.py``, which pins the JAX
package to its CPU backend.) The card is detected inside a fixture, so
every pytest worker collects the same tests; without a card each test
skips with the reason. Each kernel (generic verify, pinned-key verify)
is held lane for lane against its plain PyTorch version on the same
card and against the port's integer ECDSA: verdicts are booleans, so
the comparison is exact. The SHA-256 kernel is held against hashlib and
its plain version, the fused block kernel against its plain version
(flags and every lane's verdict) and ``TorchCSP.verify_block`` against
the host oracle, all exactly. The Ed25519 kernel (K8) is held against
its plain twin and the RFC 8032 oracle; a K3 replay (a captured CUDA
graph of staging copy → K1 → verdict copy) against an eager K1 launch,
and a replay after new inputs were staged must give the new verdicts;
the 21-request ring repro must give the same right verdicts each run.
The BLS12-381 kernel (K9, two launches) is held against its plain twin
stage for stage (Miller (n, d), verdicts) and the host oracle's
verdicts, and ``TorchCSP.verify_certificates`` against the oracle
backend on valid, wrong-binding and masked certificates. The gen-1
``mont16`` kernel (K4) is held against its plain twin and the integer
ECDSA over several blocks with hostile lanes; K5's product (the mxu
builds' ``mont_mul``) against the CIOS product and integers bit for bit;
the mxu builds of K1, K2, K7 and K8 against their plain twins; and
``TorchCSP(kernel_field=...)`` for "mont16" and "mxu" launches only the
builds its field names.
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
    rng = np.random.default_rng(83)
    lens = [0, 55, 56, 63, 64, 119, 120, 1015] + [
        int(v) for v in rng.integers(0, 1016, 300)]
    msgs = [rng.bytes(n) for n in lens]
    words, nblocks = sha.pad_messages(msgs + [b"", b""], max_blocks=16)
    nblocks[-2:] = 0                              # filler lanes: the IV
    w, nb = as_int32(words, card), as_int32(nblocks, card)
    before = sha.LAUNCHES_SHA256["sha256"]
    got = sha.sha256_cuda(w, nb).cpu().numpy()
    assert sha.LAUNCHES_SHA256["sha256"] == before + 1
    assert np.array_equal(got, sha.sha256_words(w, nb).cpu().numpy())
    be = got.view(np.uint32).astype(">u4")
    assert [be[:, i].tobytes() for i in range(len(msgs))] == \
        [hashlib.sha256(m).digest() for m in msgs]
    assert got.view(np.uint32)[:, -1].tolist() == sha.H0.tolist()
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
    assert bk.LAUNCHES_BLS == {k: v + 1 for k, v in before.items()}
    assert got == bk.verify_kernel(*args).cpu().tolist() \
        == [True, False, False, False]
    # the Miller launch alone, against the plain Miller loop
    q = [torch.cat([args[2], args[6]], -1), torch.cat([args[3], args[7]], -1)]
    p = [torch.cat([args[0], args[4]], -1), torch.cat([args[1], args[5]], -1)]
    n, d = bk.miller_cuda(*q, *p)
    pn, pd = bk.miller_nd(*(bk.f12_from_words(t) for t in (*q, *p)))
    assert bk.words_to_ints(n) == bk.f12_to_ints(pn)
    assert bk.words_to_ints(d) == bk.f12_to_ints(pd)


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
             QC(digest, (0, 2, 9), sig)]
    aggs = [agg] * len(certs)
    want = [agg.verify_certificate(c) for c in certs]
    assert want == [True, False, False, False, False]
    csp = TorchCSP(key_cache_size=0)
    try:
        bk.reset_launches()
        assert csp.verify_certificates(certs, aggs) == want
        assert bk.LAUNCHES_BLS == {"miller": 1, "final": 1}
        assert csp._c_cert_host.value() == 0
        assert csp.verify_certificates(certs, aggs, backend="kernel-fast") \
            == want
        assert bk.LAUNCHES_BLS == {"miller": 2, "final": 2}
    finally:
        csp.close()


# ------------------------------------------------------------- K4 and K5

@pytest.mark.parametrize("curve", sorted(CURVES))
def test_mont16_kernel_matches_plain_and_integer_ecdsa(card, curve):
    rng = np.random.default_rng(141)
    lanes = vectors.mixed_lanes(curve, rng)
    lanes += vectors.signed_lanes(curve, 70, rng)      # three blocks, ragged
    args = _limbs(lanes, card)
    before = ecdsa.LAUNCHES_MONT16[curve]
    got = ecdsa.verify_mont16_cuda(CURVES[curve], *args).cpu().numpy()
    assert ecdsa.LAUNCHES_MONT16[curve] == before + 1
    plain = ecdsa.verify_kernel(CURVES[curve], *args).cpu().numpy()
    assert got.tolist() == plain.tolist() == vectors.expected(curve, lanes)


def test_mxu_product_matches_cios_bit_for_bit(card):
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


@pytest.mark.parametrize("curve", sorted(CURVES))
def test_mxu_builds_match_plain(card, curve):
    from bdls_tpu_torch.ops import fold

    rng = np.random.default_rng(145)
    lanes = vectors.mixed_lanes(curve, rng)
    lanes += vectors.signed_lanes(curve, 9, rng)        # a ragged warp
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


def test_mxu_pinned_and_ed25519_builds_match_plain(card):
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
    elanes = vectors.ed25519_mixed_lanes(rng)
    arrs = ed.lanes_to_limbs(vectors.ed25519_rows(elanes))
    got = ed.launch_verify(arrs, device=card, field="mxu").cpu().tolist()
    plain = ed.launch_verify(arrs, device="cpu", field="mxu").tolist()
    assert got == plain == vectors.ed25519_expected(elanes)


@pytest.mark.parametrize("field", ["mont16", "mxu"])
def test_torch_csp_kernel_field_on_the_card(card, field):
    from bdls_tpu_torch.crypto.torch_provider import TorchCSP

    rng = np.random.default_rng(149)
    lanes = vectors.mixed_lanes("secp256k1", rng)
    reqs = [VerifyRequest(PublicKey("secp256k1", qx, qy), d, r, s)
            for qx, qy, r, s, d, _ in lanes]
    csp = TorchCSP(key_cache_size=0, kernel_field=field, buckets=(32,))
    try:
        csp.warmup([("secp256k1", 32)])
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
        assert ecdsa.LAUNCHES_LATENCY_MXU["secp256k1"] == 1
        assert not any(ecdsa.LAUNCHES.values()) and \
            not any(ecdsa.LAUNCHES_LATENCY.values())
