"""The port's verify path vs the JAX package, lane for lane, on the CPU.

Every JAX ``verify_fold`` call of the port's tests lives in this file:
the reference compiles one program per (curve, bucket) on XLA:CPU (about
30 s a curve), so all of them share one bucket of 8 lanes per curve
through the module-scoped ``jax_verify`` fixture, and ``TpuCSP`` below
reuses those same compiled programs.

- the plain ``verify_fold`` of the port equals
  ``bdls_tpu.ops.ecdsa.verify_batch(curve, …, field="fold")`` on valid,
  tampered and hostile lanes (r, s out of range, Q off the curve or out
  of range, Q = (0, 0), the r + n branch), for P-256 and secp256k1;
- both equal OpenSSL (``cryptography``, test-only) on every lane with a
  canonical key encoding, and the port's pure-Python ECDSA on all;
- ``TorchCSP(device="cpu", key_cache_size=0)`` gives the verdicts of
  ``TpuCSP(kernel_field="fold", key_cache_size=0, buckets=(8,))`` on one
  mixed request list, low-S rejection and host screens included.

Verdicts are booleans: the comparisons are exact.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
from cryptography.hazmat.primitives import hashes
from cryptography.hazmat.primitives.asymmetric import ec
from cryptography.hazmat.primitives.asymmetric.utils import (
    Prehashed, encode_dss_signature)

from bdls_tpu.crypto.csp import PublicKey as JPublicKey
from bdls_tpu.crypto.csp import VerifyRequest as JVerifyRequest
from bdls_tpu.crypto.tpu_provider import TpuCSP
from bdls_tpu.ops import ecdsa as jecdsa
from bdls_tpu.ops.curves import CURVES as JCURVES
from bdls_tpu_torch.crypto import vectors
from bdls_tpu_torch.crypto.csp import PublicKey, VerifyRequest
from bdls_tpu_torch.crypto.sw import SwCSP
from bdls_tpu_torch.crypto.torch_provider import TorchCSP
from bdls_tpu_torch.ops import ecdsa
from bdls_tpu_torch.ops.curves import CURVES

# the plain version runs many ops on tiny tensors: extra intra-op
# threads only contend with the other test workers
torch.set_num_threads(1)

BUCKET = 8
_EC = {"P-256": ec.SECP256R1, "secp256k1": ec.SECP256K1}


def _openssl(curve, qx, qy, r, s, digest) -> bool:
    try:
        pub = ec.EllipticCurvePublicNumbers(qx, qy, _EC[curve]()).public_key()
        pub.verify(encode_dss_signature(r, s), digest,
                   ec.ECDSA(Prehashed(hashes.SHA256())))
        return True
    except Exception:
        return False


@pytest.fixture(scope="module")
def lanes():
    rng = np.random.default_rng(2024)
    return {c: vectors.pad_to(vectors.mixed_lanes(c, rng), BUCKET)
            for c in CURVES}


@pytest.fixture(scope="module")
def jax_verify(lanes):
    """Reference verdicts, bucket by bucket of 8 lanes (one compile per
    curve, shared with TpuCSP below)."""
    out = {}
    for curve, ls in lanes.items():
        got = []
        for i in range(0, len(ls), BUCKET):
            cols = vectors.columns(ls[i:i + BUCKET])
            got += jecdsa.verify_batch(JCURVES[curve], *cols,
                                       field="fold").tolist()
        out[curve] = got
    return out


@pytest.mark.parametrize("curve", sorted(CURVES))
def test_plain_verify_fold_matches_reference(curve, lanes, jax_verify):
    ls = lanes[curve]
    port = []
    for i in range(0, len(ls), BUCKET):
        port += ecdsa.verify_batch(CURVES[curve],
                                   *vectors.columns(ls[i:i + BUCKET]),
                                   device="cpu").tolist()
    ref = jax_verify[curve]
    labels = [lane[5] for lane in ls]
    assert port == ref, [(lb, p, r) for lb, p, r in zip(labels, port, ref)
                         if p != r]
    # the hostile lanes really are hostile, the valid ones valid
    assert port == vectors.expected(curve, ls)
    assert any(port) and not all(port)
    forged = labels.index("forged r+n")
    assert port[forged] and not port[labels.index("forged, r + n given")]


@pytest.mark.parametrize("curve", sorted(CURVES))
def test_verdicts_match_openssl(curve, lanes, jax_verify):
    """OpenSSL reduces a coordinate >= p instead of refusing it; both
    packages screen such keys out (verify_fold.py:876), so the lanes
    are compared with OpenSSL where the key encoding is canonical."""
    p = CURVES[curve].fp.modulus
    ls = lanes[curve]
    canonical = [i for i, lane in enumerate(ls) if max(lane[:2]) < p]
    assert len(canonical) < len(ls)
    assert not any(jax_verify[curve][i] for i in range(len(ls))
                   if i not in canonical)
    ssl = [_openssl(curve, *ls[i][:2], *ls[i][2:5]) for i in canonical]
    assert [jax_verify[curve][i] for i in canonical] == ssl
    expected = vectors.expected(curve, ls)
    assert [expected[i] for i in canonical] == ssl


def _mixed_requests(rng):
    """One mixed request list over both curves, with the provider-level
    cases: low-S policy, 256-bit range, oversized and short digests,
    wire-backed lanes."""
    port, ref, labels = [], [], []

    def add(curve, qx, qy, r, s, digest, label=""):
        port.append(VerifyRequest(PublicKey(curve, qx, qy), digest, r, s))
        ref.append(JVerifyRequest(JPublicKey(curve, qx, qy), digest, r, s))
        labels.append((curve, label))

    for curve in sorted(CURVES):
        n = CURVES[curve].fn.modulus
        ls = vectors.mixed_lanes(curve, rng, n_valid=2)
        for qx, qy, r, s, d, label in ls[:6] + ls[-8:]:
            add(curve, qx, qy, r, s, d)
        qx, qy, r, s, d, _ = ls[0]
        add(curve, qx, qy, r, s, d, "valid")
        add(curve, qx, qy, r, n - s, d, "high-S twin")
        add(curve, qx, qy, r, s, b"\0" + d)          # 33-byte digest, zero top
        add(curve, qx, qy, r, s, b"\1" + d)          # digest >= 2^256
        add(curve, qx, qy, r + (1 << 256), s, d)     # r out of 256 bits
        add(curve, qx, qy, r, -s, d)                 # negative s
        key = SwCSP().key_gen(curve, rng)
        short = b"\0" + bytes(rng.bytes(31))
        rr, ss = SwCSP().sign(key, short)
        pub = key.public_key()
        add(curve, pub.x, pub.y, rr, ss, short[1:], "short digest")
    return port, ref, labels


def test_torch_csp_matches_tpu_csp(jax_verify):
    port_reqs, ref_reqs, labels = _mixed_requests(np.random.default_rng(99))
    tpu = TpuCSP(kernel_field="fold", key_cache_size=0, buckets=(BUCKET,),
                 use_cpu_fallback=False)
    torch_csp = TorchCSP(device="cpu", key_cache_size=0, buckets=(BUCKET,),
                         use_cpu_fallback=False)
    # one bucket per curve per call: TpuCSP's latency-tier staging ring
    # is reused by the next chunk of the same (curve, bucket) while the
    # previous launch may still read it on XLA:CPU (ROADMAP.md Queue C),
    # so a call carrying two chunks of one curve gives unstable verdicts
    want, got = [], []
    try:
        for i in range(0, len(ref_reqs), BUCKET):
            want += tpu.verify_batch(ref_reqs[i:i + BUCKET])
            got += torch_csp.verify_batch(port_reqs[i:i + BUCKET])
    finally:
        tpu.close()
        torch_csp.close()
    assert got == want
    assert any(got) and not all(got)
    assert torch_csp.stats["fallbacks"] == 0 == tpu.stats["fallbacks"]
    assert torch_csp.stats["batches"] == tpu.stats["batches"]
    # the low-S policy rejects the P-256 twin and admits secp256k1's
    verdict = dict(zip(labels, got))
    assert verdict[("P-256", "valid")] and verdict[("secp256k1", "valid")]
    assert not verdict[("P-256", "high-S twin")]
    assert verdict[("secp256k1", "high-S twin")]
    assert verdict[("P-256", "short digest")]
