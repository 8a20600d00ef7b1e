"""The port's host ECDSA from fixed-base tables, against its oracle and
OpenSSL.

``bdls_tpu_torch.crypto.sw`` computes k·G from a fixed-base table of G
and u2·Q by a width-4 NAF. Held here exactly:

- k·P from a table and by the NAF equals ``_mul_add`` (Shamir's
  double-and-add, the tests' plain oracle), on both curves, for edge
  scalars and random ones;
- ``ecdsa_verify`` and ``vectors.expected`` give ``cryptography``'s
  verdict on valid, tampered and high-S signatures;
- ``cpu_verify_envelope`` equals the reference's (OpenSSL) on valid,
  tampered, high-S and oversized envelopes.
"""

from __future__ import annotations

import random

import pytest
from cryptography.hazmat.primitives import hashes
from cryptography.hazmat.primitives.asymmetric import ec
from cryptography.hazmat.primitives.asymmetric.utils import (
    Prehashed, encode_dss_signature)

from bdls_tpu.consensus import identity as jidentity
from bdls_tpu.consensus import wire_pb2
from bdls_tpu_torch.consensus.identity import Signer, cpu_verify_envelope
from bdls_tpu_torch.crypto import sw, vectors
from bdls_tpu_torch.ops.curves import CURVES

OPENSSL_CURVES = {"P-256": ec.SECP256R1(), "secp256k1": ec.SECP256K1()}


def _openssl_verify(curve, x, y, digest, r, s) -> bool:
    try:
        ec.EllipticCurvePublicNumbers(x, y, OPENSSL_CURVES[curve]) \
            .public_key().verify(encode_dss_signature(r, s), digest,
                                 ec.ECDSA(Prehashed(hashes.SHA256())))
        return True
    except Exception:  # noqa: BLE001 - InvalidSignature
        return False


@pytest.mark.parametrize("curve", sorted(CURVES))
def test_tables_and_naf_equal_the_oracle(curve):
    cv = CURVES[curve]
    n = cv.fn.modulus
    rng = random.Random(curve)
    g = (cv.gx, cv.gy)
    q = sw._mul_add(cv, rng.randrange(1, n), g)
    qtab = sw._comb(cv, q)
    scalars = [0, 1, 2, 7, 8, 9, 15, 16, 17, 255, 256, n - 1, n - 2, n // 2,
               (1 << 255) % n] + [rng.randrange(n) for _ in range(40)]
    for k in scalars:
        assert sw._affine(cv, sw._mul_comb(cv, sw._g_comb(cv), k)) == \
            sw._mul_add(cv, k, g)
        want = sw._mul_add(cv, k, q)
        assert sw._affine(cv, sw._mul_comb(cv, qtab, k)) == want
        assert sw._affine(cv, sw._mul_wnaf(cv, k, q)) == want


@pytest.mark.parametrize("curve", sorted(CURVES))
def test_verify_equals_openssl(curve):
    cv = CURVES[curve]
    n = cv.fn.modulus
    rng = random.Random(18 + len(curve))
    d = rng.randrange(1, n)
    x, y = sw._mul_add(cv, d, (cv.gx, cv.gy))
    cases = []
    for _ in range(6):
        e = rng.randrange(n)
        k = rng.randrange(1, n)
        r = sw._mul_add(cv, k, (cv.gx, cv.gy))[0] % n
        s = pow(k, -1, n) * (e + r * d) % n
        digest = e.to_bytes(32, "big")
        cases += [(digest, r, s), (digest, r, n - s),
                  ((e ^ 1).to_bytes(32, "big"), r, s), (digest, r ^ 2, s)]
    want = [_openssl_verify(curve, x, y, digest, r, s)
            for digest, r, s in cases]
    assert [sw.ecdsa_verify(curve, x, y, digest, r, s)
            for digest, r, s in cases] == want
    assert vectors.expected(curve, [(x, y, r, s, digest, "")
                                    for digest, r, s in cases]) == want
    assert want[:4] == [True, True, False, False]


def _pb(env) -> wire_pb2.SignedEnvelope:
    return wire_pb2.SignedEnvelope(
        version=env.version, payload=env.payload, pub_x=env.pub_x,
        pub_y=env.pub_y, sig_r=env.sig_r, sig_s=env.sig_s)


def test_cpu_verify_envelope_equals_the_reference():
    n = CURVES["secp256k1"].fn.modulus
    envs = []
    for i in range(4):
        signer = Signer.from_scalar(0x6100 + i)
        good = signer.sign_payload(b"<commit> %d" % i)
        high = signer.sign_payload(b"<commit> %d" % i)
        high.sig_s = (n - int.from_bytes(high.sig_s, "big")).to_bytes(
            32, "big")
        forged = signer.sign_payload(b"<commit> %d" % i)
        forged.payload += b"!"
        long_r = signer.sign_payload(b"x")
        long_r.sig_r = b"\0" + long_r.sig_r
        wide = signer.sign_payload(b"x")
        wide.pub_y = wide.pub_y + b"\0\0"
        envs += [good, high, forged, long_r, wide]
    got = [cpu_verify_envelope(e) for e in envs * 2]
    want = [jidentity.cpu_verify_envelope(_pb(e)) for e in envs * 2]
    assert got == want
    assert got[:3] == [True, True, False]
