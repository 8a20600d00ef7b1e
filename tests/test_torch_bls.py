"""The port's BLS12-381 certificate path vs the JAX package, on the CPU.

- the plain 381-bit field (``ops/fp381.py``) against Python integers;
- ``f12_mul``/``f12_sqr``/``f12_frob`` (k = 1, 2, 6) against the
  reference's ``f12_mul``/``f12_frob`` run eagerly and the host oracle's
  ``FQ12``; the per-lane inverse against the oracle, a zero lane
  included; ``from_reference_lanes`` against the port's own packing;
- the stages of the check against the reference's pieces on one shared
  batch of two lanes (a valid signature and the degenerate y = 0
  "signature", ``tests/test_bls.py:115``): ``miller_nd`` against
  ``_jitted_miller``, the x-chain against ``final_exp_fast`` (= the
  oracle's final exponentiation cubed), the verdicts against
  ``_compare_tail``; and ``_compare_tail`` alone on equal, unequal and
  zero values;
- the whole slice: ``TorchCSP(device="cpu").verify_certificates``
  against the reference's ``verify_certificates(backend="host")`` on
  valid, wrong-binding and masked certificates (no signature, under
  quorum, a signer out of range, an off-curve signature), with the
  port's objects and with the reference's own ``ThresholdAggregator``
  and ``QuorumCertificate``, as the reference's verifyd passes them;
- a byzantine certificate whose signature is ``pt_add(sig, G1)``: on
  E(FQ12) (``valid_point`` accepts it) but off the twist's image, so the
  card's Miller launch takes its dense path. Its Miller (n, d) and
  verdict equal the reference's composed pieces (the module's compiled
  two-lane programs, run again), and ``verify_certificates`` gives the
  oracle's verdict.

The reference's pairing programs compile and run slowly on XLA:CPU:
they run once a module at two lanes, composed from their pieces
(``_jitted_miller`` twice, ``f12_mul``, ``final_exp_fast`` twice,
``_compare_tail``), never ``verify_pipeline`` or a jitted stage at three
lanes or more. Every comparison is exact.
"""

from __future__ import annotations

import random
import sys

import numpy as np
import pytest
import torch

from bdls_tpu.ops import bls_host as JB
from bdls_tpu.ops import bls_kernel as JK
from bdls_tpu_torch.crypto.torch_provider import TorchCSP
from bdls_tpu_torch.consensus import threshold as TH
from bdls_tpu_torch.ops import bls_host as B
from bdls_tpu_torch.ops import bls_kernel as K
from bdls_tpu_torch.ops import fp381 as F

torch.set_num_threads(1)


def _reference_threshold():
    """The reference's ``consensus.threshold`` under the ``_ecstub``
    window, as ``tests/test_bls.py`` imports it."""
    import _ecstub

    before = set(sys.modules)
    stubbed = _ecstub.ensure_crypto()
    try:
        from bdls_tpu.consensus import threshold
    finally:
        if stubbed:
            _ecstub.remove_stub()
            for name in set(sys.modules) - before:
                if name.startswith("bdls_tpu"):
                    sys.modules.pop(name, None)
    return threshold


def _rand12(rng):
    return B.FQ12([rng.randrange(B.P) for _ in range(12)])


def _ints(vals):
    return [[v.c[d] for v in vals] for d in range(12)]


def _ref_ints(we) -> list[list[int]]:
    return JK.f12_to_ints(we)


# ---- the field and FQ12 ---------------------------------------------------

def test_plain_field_matches_python_ints():
    rng = random.Random(71)
    p = B.P
    xs = [0, 1, 2, p - 1, p - 2, (1 << 384) - 1 - 9 * p] + [
        rng.randrange(p) for _ in range(40)]
    ys = [rng.randrange(p) for _ in xs]
    x, y = F.from_ints(xs), F.from_ints(ys)
    assert F.to_ints(F.mul(x, y)) == [a * b % p for a, b in zip(xs, ys)]
    assert F.to_ints(F.sqr(x)) == [a * a % p for a in xs]
    assert F.to_ints(F.add(x, y)) == [(a + b) % p for a, b in zip(xs, ys)]
    assert F.to_ints(F.sub(x, y)) == [(a - b) % p for a, b in zip(xs, ys)]
    assert F.to_ints(F.mul_small(x, 12)) == [12 * a % p for a in xs]
    # a long chain of lazy sums and differences, then one canon
    z, w = x, list(xs)
    for _ in range(25):
        z = F.mul(F.sub(F.mul_small(z, 7), y), F.add(z, y))
        w = [((7 * a - b) * (a + b)) % p for a, b in zip(w, ys)]
    assert F.to_ints(z) == w
    assert F.eq_mod(z, F.from_ints(w)).all()
    assert F.to_ints(F.inv(F.from_ints(xs[:6]))) == \
        [pow(a, p - 2, p) for a in xs[:6]]
    # the kernel's words: any value below 2^384 reads mod p
    words = torch.full((12, 2), -1, dtype=torch.int32)
    assert F.to_ints(F.from_words(words)) == [((1 << 384) - 1) % p] * 2
    assert F.to_ints(F.from_words(F.to_words(x))) == [a % p for a in xs]


def test_f12_ops_match_reference_and_oracle():
    rng = random.Random(72)
    a = [_rand12(rng) for _ in range(3)]
    b = [_rand12(rng) for _ in range(2)] + [B.FQ12.zero()]
    pa = K.f12_from_ints(_ints(a))
    pb = K.f12_from_ints(_ints(b))
    ja = JK.f12_from_ints(_ints(a))
    jb = JK.f12_from_ints(_ints(b))
    assert K.f12_to_ints(K.f12_mul(pa, pb)) == _ref_ints(JK.f12_mul(ja, jb)) \
        == _ints([x * y for x, y in zip(a, b)])
    assert K.f12_to_ints(K.f12_sqr(pa)) == _ref_ints(JK.f12_sqr(ja)) \
        == _ints([x * x for x in a])
    for k in (1, 2, 6):
        assert K.f12_to_ints(K.f12_frob(pa, k)) == \
            _ref_ints(JK.f12_frob(ja, k)) == \
            _ints([x.pow(B.P ** k) for x in a]), k
    # Frobenius tables of the kernel: Montgomery form of the same matrix
    tab = K.frob_table_host()
    for n, k in enumerate(K.FROB_KS):
        ref = np.asarray(JK._frob_matrix(k))              # (12, 12, 34)
        for i in (0, 5, 11):
            for j in (0, 6, 11):
                want = sum(int(v) << (12 * t) for t, v in enumerate(ref[i, j]))
                got = sum(int(w) << (32 * t) for t, w in enumerate(tab[n, i, j]))
                assert got == want * (1 << 384) % B.P


def test_per_lane_inverse_and_zero_lane():
    rng = random.Random(73)
    vals = [_rand12(rng), B.FQ12.zero(), _rand12(rng)]
    inv = K.f12_to_ints(K.f12_inv(K.f12_from_ints(_ints(vals))))
    for i in (0, 2):
        assert B.FQ12([inv[d][i] for d in range(12)]) == vals[i].inv()
    assert all(inv[d][1] == 0 for d in range(12))


def test_reference_lanes_convert_to_the_port_layout():
    rng = random.Random(74)
    pts = [B.G1, B.G2, (_rand12(rng), B.FQ12.zero())]
    jx, jy = JK.pt_batch([tuple(JB.FQ12(c.c) for c in pt) for pt in pts])
    px, py = K.pt_batch(pts)
    assert np.array_equal(K.from_reference_lanes(np.asarray(jx)), px)
    assert np.array_equal(K.from_reference_lanes(np.asarray(jy)), py)
    with pytest.raises(ValueError):
        K.from_reference_lanes(np.zeros((33, 12, 1), np.uint32))


def test_compare_tail_matches_reference():
    rng = random.Random(75)
    vals = [_rand12(rng) for _ in range(3)]
    other = [vals[0], _rand12(rng), B.FQ12.zero()]
    zeros = [B.FQ12.zero()] * 3

    def both(xs, ys):
        port = K._compare_tail(K.f12_from_ints(_ints(xs)),
                               K.f12_from_ints(_ints(ys))).tolist()
        ref = np.asarray(JK._compare_tail(
            JK.f12_norm(JK.f12_from_ints(_ints(xs))),
            JK.f12_norm(JK.f12_from_ints(_ints(ys))))).tolist()
        assert port == ref
        return port

    assert both(vals, vals) == [True] * 3
    assert both(vals, other) == [True, False, False]
    assert both(zeros, zeros) == [False] * 3


# ---- the check, stage for stage, against the reference's pieces ----------

def _reference_run(pts):
    """Two lanes of points (``pts``: g1, sig, pk, hm, two points each)
    through the reference's composed pieces, ``_jitted_miller`` twice,
    ``f12_mul``, ``final_exp_fast`` twice and ``_compare_tail``: the
    lanes as the reference packs them and its results. Every call has
    the same shapes, so the programs compile once a module."""

    def jpts(ps):
        return [tuple(JB.FQ12(c.c) for c in pt) for pt in ps]

    ref_lanes = {k: JK.pt_batch(jpts(v)) for k, v in pts.items()}
    miller = JK._jitted_miller()
    n1, d1 = miller(*ref_lanes["sig"], *ref_lanes["g1"])
    n2, d2 = miller(*ref_lanes["hm"], *ref_lanes["pk"])
    bound = 1 << (12 * JK.FP)
    n1, d1, n2, d2 = (JK.WE(v, JK.W.LB_N, bound) for v in (n1, d1, n2, d2))
    lhs = JK.final_exp_fast(JK.f12_norm(JK.f12_mul(n1, d2)))
    rhs = JK.final_exp_fast(JK.f12_norm(JK.f12_mul(n2, d1)))
    verdict = np.asarray(JK._compare_tail(lhs, rhs)).tolist()
    return {
        "pts": pts,
        "ref_lanes": ref_lanes,
        "ref": {"n1": _ref_ints(n1), "d1": _ref_ints(d1),
                "n2": _ref_ints(n2), "d2": _ref_ints(d2),
                "lhs_in": _ref_ints(JK.f12_norm(JK.f12_mul(n1, d2))),
                "lhs": _ref_ints(lhs), "rhs": _ref_ints(rhs),
                "verdict": verdict},
    }


@pytest.fixture(scope="module")
def two_lanes():
    """A valid signature and the y = 0 "signature" (both sides of its
    pairing collapse to zero), packed for both packages, and the
    reference's results for them: Miller (n, d) of both pairs, the two
    final exponentiations and the verdicts."""
    sk, pk = B.keygen(0x111)
    hm = B.hash_to_g2(b"m1")
    sig = B.sign(sk, b"m1")
    forged = (B.FQ12.scalar(1), B.FQ12.zero())
    return _reference_run({"g1": [B.G1, B.G1], "sig": [sig, forged],
                           "pk": [pk, pk], "hm": [hm, hm]})


def _port_arrays(two_lanes):
    """The port's eight word arrays, converted from the reference's."""
    return {k: [torch.from_numpy(K.from_reference_lanes(np.asarray(a))
                                 .view(np.int32)) for a in v]
            for k, v in two_lanes["ref_lanes"].items()}


def test_miller_and_x_chain_match_reference(two_lanes):
    arrs = _port_arrays(two_lanes)
    ref = two_lanes["ref"]
    q = [K.f12_from_words(torch.cat([a, b], -1))
         for a, b in zip(arrs["sig"], arrs["hm"])]
    p = [K.f12_from_words(torch.cat([a, b], -1))
         for a, b in zip(arrs["g1"], arrs["pk"])]
    n, d = K.miller_nd(*q, *p)
    n_i, d_i = K.f12_to_ints(n), K.f12_to_ints(d)
    assert [r[:2] for r in n_i] == ref["n1"]
    assert [r[2:] for r in n_i] == ref["n2"]
    assert [r[:2] for r in d_i] == ref["d1"]
    assert [r[2:] for r in d_i] == ref["d2"]
    # the x-chain at one lane: the valid lane's lhs (= the oracle's
    # final exponentiation of the same value, cubed)
    lhs_in = K.f12_from_ints([r[:1] for r in ref["lhs_in"]])
    fe = K.f12_to_ints(K.final_exp_fast(lhs_in))
    assert fe == [r[:1] for r in ref["lhs"]]
    want = B.FQ12([r[0] for r in ref["lhs_in"]]).pow((B.P ** 12 - 1) // B.R)
    assert fe == _ints([want * want * want])


def test_whole_check_matches_reference(two_lanes):
    arrs = _port_arrays(two_lanes)
    args = [*arrs["g1"], *arrs["sig"], *arrs["pk"], *arrs["hm"]]
    got = K.verify_limbs(args, device="cpu").tolist()
    assert got == two_lanes["ref"]["verdict"] == [True, False]
    # packed by the port from the same points: the same verdicts
    pts = two_lanes["pts"]
    own = [a for k in ("g1", "sig", "pk", "hm") for a in K.pt_batch(pts[k])]
    assert K.verify_limbs(own, device="cpu").tolist() == got


def test_forged_signature_off_the_twist_matches_reference(two_lanes,
                                                         monkeypatch):
    """A byzantine certificate whose signature is ``pt_add(sig, G1)``
    (on E(FQ12), so ``valid_point`` accepts it; off the twist's image,
    so the card's Miller launch runs it densely) beside a valid one:
    Miller (n, d) and the verdicts equal the reference's composed
    pieces (the module's compiled two-lane programs) and
    ``verify_certificates(device="cpu")`` gives the oracle's verdicts."""
    del two_lanes                       # the reference programs compiled
    signers = [TH.VoteSigner.from_seed(0xF09 + i) for i in range(4)]
    agg = TH.ThresholdAggregator([s.pk for s in signers], quorum=3)
    digest = b"decide:h7:r2"
    sig = B.aggregate([signers[i].sign_vote(digest) for i in (0, 2, 3)])
    forged = B.pt_add(sig, B.G1)
    assert TH.valid_point(forged)
    certs = [TH.QuorumCertificate(digest, (0, 2, 3), s) for s in (sig,
                                                                forged)]
    want = [agg.verify_certificate(c) for c in certs]
    assert want == [True, False]
    pk, hm = agg._agg_pubkey((0, 2, 3)), agg._hm(digest)
    run = _reference_run({"g1": [B.G1, B.G1], "sig": [sig, forged],
                          "pk": [pk, pk], "hm": [hm, hm]})
    ref = run["ref"]
    assert ref["verdict"] == want
    arrs = _port_arrays(run)
    q = [K.f12_from_words(torch.cat([a, b], -1))
         for a, b in zip(arrs["sig"], arrs["hm"])]
    p = [K.f12_from_words(torch.cat([a, b], -1))
         for a, b in zip(arrs["g1"], arrs["pk"])]
    n, d = K.miller_nd(*q, *p)
    n_i, d_i = K.f12_to_ints(n), K.f12_to_ints(d)
    assert [r[:2] for r in n_i] == ref["n1"]
    assert [r[:2] for r in d_i] == ref["d1"]
    monkeypatch.delenv("BDLS_CERT_BACKEND", raising=False)
    csp = TorchCSP(device="cpu", key_cache_size=0)
    try:
        assert csp.verify_certificates(certs, [agg] * 2) == want
    finally:
        csp.close()


# ---- the whole slice --------------------------------------------------------

def _certificates(th, b):
    """Six certificates for one 4-validator committee (quorum 3): valid,
    wrong binding (another digest), no signature, under quorum, a signer
    out of range, an off-curve signature (y = 0)."""
    signers = [th.VoteSigner.from_seed(0xB150 + i) for i in range(4)]
    agg = th.ThresholdAggregator([s.pk for s in signers], quorum=3)
    digest = b"decide:h5:r0"
    sig = b.aggregate([signers[i].sign_vote(digest) for i in (0, 1, 3)])
    QC = th.QuorumCertificate
    certs = [
        QC(digest, (0, 1, 3), sig),
        QC(b"decide:h6:r0", (0, 1, 3), sig),
        QC(digest, (0, 1, 3), None),
        QC(digest, (0, 1), sig),
        QC(digest, (0, 1, 7), sig),
        QC(digest, (0, 1, 3), (b.FQ12.scalar(1), b.FQ12.zero())),
    ]
    return certs, [agg] * len(certs)


@pytest.fixture(scope="module")
def reference_certs():
    """The reference's certificates and its host backend's verdicts."""
    th = _reference_threshold()
    jcerts, jaggs = _certificates(th, JB)
    want = JK.verify_certificates(jcerts, jaggs, backend="host")
    assert want == [True] + [False] * 5
    return jcerts, jaggs, want


def test_provider_matches_reference_host_backend(reference_certs,
                                                monkeypatch):
    monkeypatch.delenv("BDLS_CERT_BACKEND", raising=False)
    certs, aggs = _certificates(TH, B)
    want = reference_certs[2]
    csp = TorchCSP(device="cpu", key_cache_size=0)
    try:
        assert csp.verify_certificates(certs, aggs) == want
        # the host backend, asked for by the caller (the masked lanes and
        # the wrong binding: one pairing equation)
        assert csp.verify_certificates(certs[1:], aggs[1:],
                                       backend="host") == want[1:]
        assert csp.verify_certificates([], []) == []
        assert csp._c_certs.value() == 2 * len(certs) - 1
        assert csp._c_cert_host.value() == len(certs) - 1
        with pytest.raises(ValueError):
            csp.verify_certificates(certs, aggs, backend="pipeline")
    finally:
        csp.close()
    lanes, mask = TH.certificate_lanes(certs, aggs)
    assert mask == [True, True, False, False, False, False]
    for xs, ys in lanes:
        assert xs.shape == ys.shape == (12, 12, len(certs))


def test_provider_takes_the_reference_objects(reference_certs,
                                              monkeypatch):
    """verifyd passes the reference's aggregators and certificates: the
    port reads their FQ12 points by duck typing, lane for lane as the
    reference's host backend, masked lanes included."""
    jcerts, jaggs, want = reference_certs
    monkeypatch.delenv("BDLS_CERT_BACKEND", raising=False)
    csp = TorchCSP(device="cpu", key_cache_size=0)
    try:
        assert csp.verify_certificates(jcerts, jaggs) == want
        # BDLS_CERT_BACKEND=host: the oracle, counted
        monkeypatch.setenv("BDLS_CERT_BACKEND", "host")
        assert csp.verify_certificates(jcerts[2:], jaggs[2:]) == want[2:]
        assert csp._c_cert_host.value() == len(jcerts) - 2
    finally:
        csp.close()
    assert TH.valid_point(jcerts[0].agg_sig)
    assert not TH.valid_point((1, 2))
    assert not TH.valid_point((JB.FQ12.one(), JB.FQ12.zero()))
