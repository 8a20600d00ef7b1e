"""K9's warp bodies (``csrc/bls12.cuh``), built for the host with g++.

The Miller launch runs a warp a (Q, P) pair: a pair of the twisted form
(Qx at flat coefficients {4, 10}, Qy at {3, 9}, Px and Py at {0}) runs
the loop in the Fp2 tower with the known zeros left out; any other pair
runs the dense formulas with tower products. The final launch runs K9's
x-chain a warp a side, on K11's code. This test builds a small C shim
over the header into ``build/`` (``_build.host_shim``; a warp's 32
shares run in turn, as ``test_torch_host_kernel.py`` runs K11's), loads
it with ctypes and checks:

- the pair class on each input pattern: a certificate lane, the zero
  lane, a twisted-form lane off the curve, a coefficient equal to p
  (read as zero), and the dense ones (the y = 0 "signature", a
  signature off the twist's image, one stray coefficient of each input);
- the twisted Miller body against the dense one-thread formulas
  (``miller_nd``), the warp's dense path on the same pairs and the plain
  ``miller_nd``, word for word, on the lanes of certificates of the 128-
  and 1024-validator committees, on random values of the twisted form
  off the curve (the weighting argument checked, not assumed) and on the
  zero lane;
- the dense body on the y = 0 lane and on ``pt_add(sig, G1)``, a
  byzantine signature that lies on E(FQ12) but off the twist's image;
- the warp x-chain (the final launch's body) against the plain
  ``final_exp_fast`` and as the cube of K11's value, side for side, and
  the launch pair's verdicts against the oracle's.

Every comparison is exact. The test skips, from a fixture, where g++ is
absent.
"""

from __future__ import annotations

import ctypes
import hashlib
import shutil

import numpy as np
import pytest
import torch

from bdls_tpu_torch.consensus import threshold as TH
from bdls_tpu_torch.ops import _build
from bdls_tpu_torch.ops import bls_host as bh
from bdls_tpu_torch.ops import bls_kernel as bk

torch.set_num_threads(1)

SHIM = r"""
#include "bls12.cuh"
using namespace bdls;

static void load_pair(fq12* in, const int32_t* qx, const int32_t* qy,
                      const int32_t* px, const int32_t* py, int t, int N) {
  f12_load(in[0], qx, t, N);
  f12_load(in[1], qy, t, N);
  f12_load(in[2], px, t, N);
  f12_load(in[3], py, t, N);
}

// the class of each of N pairs: 1 twisted, 0 dense
extern "C" void host_pair_class(const int32_t* qx, const int32_t* qy,
                                const int32_t* px, const int32_t* py,
                                uint8_t* out, int N) {
  for (int t = 0; t < N; ++t) {
    fq12 in[4];
    load_pair(in, qx, qy, px, py, t, N);
    out[t] = pair_twisted(in) ? 1 : 0;
  }
}

// K9's Miller body, a warp's shares in turn; dense runs the warp's dense
// path on every pair, whatever its class
extern "C" void host_miller_warp(const int32_t* qx, const int32_t* qy,
                                 const int32_t* px, const int32_t* py,
                                 int32_t* n, int32_t* d, int N, int dense) {
  miller_warp* w = new miller_warp;
  for (int t = 0; t < N; ++t) {
    if (!dense) {
      miller_pair(*w, 0, qx, qy, px, py, t, N, n, d);
      continue;
    }
    dense_state& s = w->u.dn;
    load_pair(w->in, qx, qy, px, py, t, N);
    miller_dense(warp_ops{w->prod, 0}, s.fn, s.fd, w->in[0], w->in[1],
                 w->in[2], w->in[3], s.s);
    f12_store(n, s.fn, t, N);
    f12_store(d, s.fd, t, N);
  }
  delete w;
}

// the dense formulas on one thread
extern "C" void host_miller_thread(const int32_t* qx, const int32_t* qy,
                                   const int32_t* px, const int32_t* py,
                                   int32_t* n, int32_t* d, int N) {
  for (int t = 0; t < N; ++t) {
    fq12 in[4], fn, fd;
    load_pair(in, qx, qy, px, py, t, N);
    miller_nd(fn, fd, in[0], in[1], in[2], in[3]);
    f12_store(n, fn, t, N);
    f12_store(d, fd, t, N);
  }
}

// the final launches' body on B lanes: cube runs K9's x-chain, else
// K11's full exponent
extern "C" void host_final(int cube, const int32_t* n, const int32_t* d,
                           const uint32_t* frob, int32_t* fe, uint8_t* out,
                           int B) {
  fe_warp* ws = new fe_warp[2];
  const int N = 2 * B;
  for (int b = 0; b < B; ++b) {
    for (int side = 0; side < 2; ++side) {
      if (cube)
        final_side<true>(ws[side], 0, n, side ? B + b : b, d,
                         side ? b : B + b, N, frob, fe, 2 * b + side);
      else
        final_side<false>(ws[side], 0, n, side ? B + b : b, d,
                          side ? b : B + b, N, frob, fe, 2 * b + side);
    }
    out[b] = compare_tail(ws[0].v[FW_OUT], ws[1].v[FW_OUT]) ? 1 : 0;
  }
  delete[] ws;
}
"""


@pytest.fixture(scope="module")
def shim():
    if shutil.which("g++") is None:
        pytest.skip("g++ not found: the host build of the kernel is skipped")
    return _build.host_shim(SHIM, "host_bls_warp")


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def _arr(elts) -> np.ndarray:
    return np.ascontiguousarray(bk.f12_words(elts).view(np.int32))


def _pairs(qs, ps):
    """[N] Q points and [N] P points -> the (Qx, Qy, Px, Py) arrays."""
    return [_arr([pt[i] for pt in pts]) for pts in (qs, ps) for i in (0, 1)]


def _rand_fp(rng) -> int:
    return int.from_bytes(rng.bytes(48), "little") % bh.P


def _at(coeffs: dict) -> bh.FQ12:
    """An FQ12 value with the given flat coefficients, zero elsewhere."""
    return bh.FQ12([coeffs.get(k, 0) for k in range(12)])


def _twisted_off_curve(rng):
    """A pair of the twisted form whose points lie on no curve: Qx at
    {4, 10}, Qy at {3, 9}, Px and Py at {0}, every value random."""
    q = (_at({4: _rand_fp(rng), 10: _rand_fp(rng)}),
         _at({3: _rand_fp(rng), 9: _rand_fp(rng)}))
    p = (_at({0: _rand_fp(rng)}), _at({0: _rand_fp(rng)}))
    return q, p


def _committee_pairs():
    """The four pairs of two certificates, as ``certificate_lanes`` packs
    them: one of the 128-validator committee (validator i's key
    (i + 1)·G1, quorum 85) and one of the 1024-validator committee
    (quorum 683, the aggregated key (q(q + 1)/2)·G1, as ``chip_smoke.py``
    makes them): (sig, g1) and (H(d), pk) of each."""
    pks, pk = [], None
    for _ in range(128):
        pk = bh.pt_add(pk, bh.G1)
        pks.append(pk)
    agg = TH.ThresholdAggregator(pks, 85)
    digest = hashlib.sha256(b"bdls committee 128 round 0").digest()
    sk = 85 * 86 // 2
    cert = TH.QuorumCertificate(digest, tuple(range(85)),
                                bh.pt_mul(sk, agg._hm(digest)))
    assert agg.verify_certificate(cert)
    qs, ps = [cert.agg_sig, agg._hm(digest)], [bh.G1,
                                                agg._agg_pubkey(cert.signers)]
    sk = 683 * 684 // 2
    hm = bh.hash_to_g2(hashlib.sha256(b"bdls committee 1024 round 0").digest())
    qs += [bh.pt_mul(sk, hm), hm]
    ps += [bh.G1, bh.pt_mul(sk, bh.G1)]
    return qs, ps


def _run_miller(shim, arrs, how):
    n, d = np.zeros_like(arrs[0]), np.zeros_like(arrs[0])
    N = arrs[0].shape[-1]
    if how == "thread":
        shim.host_miller_thread(*(_ptr(a) for a in (*arrs, n, d)), N)
    else:
        shim.host_miller_warp(*(_ptr(a) for a in (*arrs, n, d)), N,
                              int(how == "dense"))
    return bk.words_to_ints(n), bk.words_to_ints(d)


def _plain_miller(arrs):
    n, d = bk.miller_nd(*(bk.f12_from_words(torch.from_numpy(a))
                          for a in arrs))
    return bk.f12_to_ints(n), bk.f12_to_ints(d)


def _classes(shim, arrs):
    out = np.zeros(arrs[0].shape[-1], np.uint8)
    shim.host_pair_class(*(_ptr(a) for a in arrs), _ptr(out), len(out))
    return out.tolist()


def test_pair_class_reads_the_zero_pattern(shim):
    rng = np.random.default_rng(9101)
    sk, pk = bh.keygen(0x9101)
    sig = bh.sign(sk, b"class")
    zero = (bh.FQ12.zero(), bh.FQ12.zero())
    tq, tp = _twisted_off_curve(rng)
    # a coefficient equal to p reads as zero: still twisted
    p_qx = bh.FQ12([bh.P if k == 0 else c for k, c in enumerate(sig[0].c)])
    stray = {name: _at({k: 5}) for name, k in (("qx", 5), ("qy", 4),
                                              ("px", 6), ("py", 1))}
    cases = [
        ("certificate (sig, g1)", sig, bh.G1, 1),
        ("certificate (H(m), pk)", bh.hash_to_g2(b"class"), pk, 1),
        ("zero", zero, zero, 1),
        ("twisted off the curve", tq, tp, 1),
        ("Qx coefficient 0 at p", (p_qx, sig[1]), bh.G1, 1),
        ("y = 0", (bh.FQ12.scalar(1), bh.FQ12.zero()), bh.G1, 0),
        ("pt_add(sig, G1)", bh.pt_add(sig, bh.G1), bh.G1, 0),
        ("stray Qx", (sig[0] + stray["qx"], sig[1]), bh.G1, 0),
        ("stray Qy", (sig[0], sig[1] + stray["qy"]), bh.G1, 0),
        ("stray Px", sig, (bh.G1[0] + stray["px"], bh.G1[1]), 0),
        ("stray Py", sig, (bh.G1[0], bh.G1[1] + stray["py"]), 0),
    ]
    arrs = _pairs([c[1] for c in cases], [c[2] for c in cases])
    got = _classes(shim, arrs)
    assert {c[0]: g for c, g in zip(cases, got)} == \
        {c[0]: c[3] for c in cases}


def test_twisted_miller_matches_dense_formulas_and_plain(shim):
    """Committee lanes, twisted-form values off the curve and the zero
    lane: the twisted body's (n, d) equal the one-thread dense formulas',
    the warp's dense path's and the plain ``miller_nd``'s."""
    rng = np.random.default_rng(9102)
    qs, ps = _committee_pairs()
    for _ in range(3):
        q, p = _twisted_off_curve(rng)
        qs.append(q)
        ps.append(p)
    zero = (bh.FQ12.zero(), bh.FQ12.zero())
    qs.append(zero)
    ps.append(zero)
    arrs = _pairs(qs, ps)
    assert _classes(shim, arrs) == [1] * len(qs)
    twisted = _run_miller(shim, arrs, "twisted")
    assert twisted == _run_miller(shim, arrs, "thread")
    assert twisted == _run_miller(shim, arrs, "dense")
    assert twisted == _plain_miller(arrs)
    n, d = twisted
    # d is one tower coefficient: at most two nonzero flat coefficients
    for t in range(len(qs) - 1):
        assert sum(1 for c in range(12) if d[c][t]) == 2, t
        assert any(n[c][t] for c in range(12)), t
    assert all(n[c][-1] == d[c][-1] == 0 for c in range(12))


def test_dense_miller_on_hostile_lanes(shim):
    """The y = 0 "signature" and ``pt_add(sig, G1)`` (on E(FQ12),
    accepted by ``valid_point``, off the twist's image) take the dense
    path and give the dense formulas' and the plain twin's (n, d)."""
    sk, pk = bh.keygen(0x9103)
    sig = bh.sign(sk, b"hostile")
    forged = bh.pt_add(sig, bh.G1)
    assert TH.valid_point(forged)
    assert all(forged[0].c) and all(forged[1].c)
    qs = [(bh.FQ12.scalar(1), bh.FQ12.zero()), forged]
    ps = [bh.G1, bh.G1]
    arrs = _pairs(qs, ps)
    assert _classes(shim, arrs) == [0, 0]
    warp = _run_miller(shim, arrs, "twisted")
    assert warp == _run_miller(shim, arrs, "thread") == _plain_miller(arrs)


def test_warp_x_chain_matches_plain_and_k11_cubed(shim):
    """Four lanes through the launch pair's bodies (the warp Miller body,
    then the x-chain's final body): a valid certificate, one whose
    signature is ``pt_add(sig, G1)``, a wrong binding and the zero lane.
    Each side equals the plain ``final_exp_fast`` and K11's value cubed;
    the verdicts equal the oracle's."""
    signers = [TH.VoteSigner.from_seed(0x9104 + i) for i in range(4)]
    agg = TH.ThresholdAggregator([s.pk for s in signers], quorum=3)
    digest = b"decide:h9:r4"
    sig = bh.aggregate([signers[i].sign_vote(digest) for i in (0, 1, 3)])
    QC = TH.QuorumCertificate
    certs = [QC(digest, (0, 1, 3), sig),
             QC(digest, (0, 1, 3), bh.pt_add(sig, bh.G1)),
             QC(b"decide:h9:r5", (0, 1, 3), sig)]
    want = [agg.verify_certificate(c) for c in certs] + [False]
    assert want == [True, False, False, False]
    lanes, mask = TH.certificate_lanes(certs, [agg] * 3)
    assert mask == [True] * 3
    zero = (bh.FQ12.zero(), bh.FQ12.zero())
    zl = bk.pt_batch([zero])
    g1, sigs, pks, hms = (tuple(np.concatenate([a, b], -1) for a, b in
                                zip(pt, zl)) for pt in lanes)
    B = 4
    arrs = [np.ascontiguousarray(np.concatenate(p, -1).view(np.int32))
            for p in ((sigs[0], hms[0]), (sigs[1], hms[1]),
                      (g1[0], pks[0]), (g1[1], pks[1]))]
    n, d = np.zeros_like(arrs[0]), np.zeros_like(arrs[0])
    shim.host_miller_warp(*(_ptr(a) for a in (*arrs, n, d)), 2 * B, 0)
    frob = bk.frob_sparse_host()
    fe = {}
    out = {}
    for cube in (1, 0):
        fe[cube] = np.zeros_like(n)
        out[cube] = np.zeros(B, np.uint8)
        shim.host_final(cube, _ptr(n), _ptr(d), _ptr(frob), _ptr(fe[cube]),
                        _ptr(out[cube]), B)
    assert out[1].astype(bool).tolist() == want
    assert out[0].tolist() == out[1].tolist()
    # the kernel's column 2b is lane b's n1·d2, 2b + 1 its n2·d1
    order = [i // 2 + (B if i % 2 else 0) for i in range(2 * B)]
    nv, dv = bk.words_to_ints(n), bk.words_to_ints(d)
    sides = [bh.FQ12([nv[c][t] for c in range(12)])
             * bh.FQ12([dv[c][(t + B) % (2 * B)] for c in range(12)])
             for t in order]
    plain = bk.f12_to_ints(bk.final_exp_fast(bk.f12_from_words(
        torch.from_numpy(bk.f12_words(sides).view(np.int32)))))
    cube, full = bk.words_to_ints(fe[1]), bk.words_to_ints(fe[0])
    assert cube == plain
    for t in range(2 * B):
        v = bh.FQ12([full[c][t] for c in range(12)])
        assert bh.FQ12([cube[c][t] for c in range(12)]) == v * v * v, t
    assert all(cube[c][t] == 0 for c in range(12) for t in (6, 7))
