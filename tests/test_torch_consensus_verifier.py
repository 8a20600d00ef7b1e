"""The port's consensus batch-verify seam, on the CPU.

- ``envelope_digest`` and ``identity_keys`` equal the JAX package's;
  ``SignedEnvelope`` carries exactly the wire message's fields, and an
  envelope from ``sign_payload`` verifies under the reference's OpenSSL
  check (``cryptography``, test-only);
- ``CspBatchVerifier(TorchCSP(device="cpu"))`` and
  ``TorchBatchVerifier(device="cpu")`` give the verdicts of the port's
  pure-Python ECDSA, malformed and re-versioned envelopes included;
- consenter identities warm the provider's key cache, and a provider
  without one takes them as a no-op.

The comparison with the reference's ``CspBatchVerifier(TpuCSP(...))``
lives in ``test_torch_pinned.py``, beside the compiled JAX pinned-key
programs it shares. Verdicts are booleans: comparisons are exact.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from bdls_tpu.consensus import identity as jidentity
from bdls_tpu.consensus import wire_pb2
from bdls_tpu.consensus.verifier import identity_keys as jidentity_keys
from bdls_tpu_torch.consensus import identity
from bdls_tpu_torch.consensus.identity import SignedEnvelope, \
    envelope_digest, identity_of_key, sign_payload
from bdls_tpu_torch.consensus.verifier import CspBatchVerifier, \
    TorchBatchVerifier, identity_keys
from bdls_tpu_torch.crypto.sw import SwCSP, ecdsa_verify
from bdls_tpu_torch.crypto.torch_provider import TorchCSP

# the plain version runs many ops on tiny tensors: extra intra-op
# threads only contend with the other test workers
torch.set_num_threads(1)

FIELDS = ("version", "payload", "pub_x", "pub_y", "sig_r", "sig_s")


def _wire(env):
    m = wire_pb2.SignedEnvelope()
    for f in FIELDS:
        setattr(m, f, getattr(env, f))
    return m


def _keys(n, seed):
    rng = np.random.default_rng(seed)
    return [SwCSP().key_gen("secp256k1", rng) for _ in range(n)]


def test_digest_and_constants_equal_reference():
    rng = np.random.default_rng(5)
    assert identity.PROTOCOL_VERSION == jidentity.PROTOCOL_VERSION
    assert identity.SIGNATURE_PREFIX == jidentity.SIGNATURE_PREFIX
    for version, size in ((1, 0), (1, 100), (2, 31), (0xFFFFFFFF, 1000)):
        x, y, payload = rng.bytes(32), rng.bytes(32), rng.bytes(size)
        assert envelope_digest(version, x, y, payload) == \
            jidentity.envelope_digest(version, x, y, payload)


def test_identity_keys_equal_reference():
    idents = [identity_of_key(k) for k in _keys(4, 6)]
    idents += [b"short", b"\0" * 65, b""]
    got = [(k.curve, k.x, k.y) for k in identity_keys(idents)]
    ref = [(k.curve, k.x, k.y) for k in jidentity_keys(idents)]
    assert got == ref and len(got) == 4


def test_envelope_is_the_wire_message():
    names = [f.name for f in wire_pb2.SignedEnvelope.DESCRIPTOR.fields]
    assert tuple(names) == FIELDS
    assert tuple(SignedEnvelope.__dataclass_fields__) == FIELDS
    (key,) = _keys(1, 7)
    env = sign_payload(key, b"<lock> height 9")
    assert jidentity.cpu_verify_envelope(_wire(env))
    env.payload = b"<lock> height 10"
    assert not jidentity.cpu_verify_envelope(_wire(env))


def _envelopes():
    keys = _keys(5, 8)
    envs = [sign_payload(k, b"<select> round %d" % i)
            for i, k in enumerate(keys)]
    envs[1].payload += b"!"                          # forged
    odd = sign_payload(keys[2], b"v2")
    odd.version = 2                    # the digest covers it: invalid
    long_x = sign_payload(keys[3], b"x")
    long_x.pub_x = b"\1" + long_x.pub_x             # 33 bytes: screened
    short_s = sign_payload(keys[4], b"s")
    short_s.sig_s = short_s.sig_s.lstrip(b"\0")[:31]  # wrong, short
    envs += [odd, long_x, short_s]
    want = []
    for e in envs:
        ok = all(len(f) <= 32 for f in (e.pub_x, e.pub_y, e.sig_r, e.sig_s))
        digest = envelope_digest(e.version, e.pub_x, e.pub_y, e.payload)
        want.append(ok and ecdsa_verify(
            "secp256k1", int.from_bytes(e.pub_x, "big"),
            int.from_bytes(e.pub_y, "big"), digest,
            int.from_bytes(e.sig_r, "big"), int.from_bytes(e.sig_s, "big")))
    assert want == [True, False, True, True, True, False, False, False]
    return [identity_of_key(k) for k in keys], envs, want


def test_verifiers_match_integer_ecdsa():
    idents, envs, want = _envelopes()
    csp = TorchCSP(device="cpu", buckets=(8,), key_cache_size=8)
    try:
        ver = CspBatchVerifier(csp, consenters=idents)
        assert ver.verify_envelopes([]) == []
        assert ver.verify_envelopes(envs) == want
    finally:
        csp.close()
    assert csp.stats["fallbacks"] == 0
    torch_ver = TorchBatchVerifier(buckets=(8,), device="cpu")
    assert torch_ver.verify_envelopes(envs) == want
    assert torch_ver.verify_envelopes([]) == []


def test_torch_batch_verifier_splits_oversized_batches(monkeypatch):
    from bdls_tpu_torch.ops import ecdsa

    sizes = []

    def stub(curve, arrs, *, device=None):
        sizes.append(arrs[0].shape[1])
        return np.ones(arrs[0].shape[1], bool)

    monkeypatch.setattr(ecdsa, "verify_limbs", stub)
    _, envs, _ = _envelopes()
    got = TorchBatchVerifier(buckets=(4,), device="cpu").verify_envelopes(envs)
    assert sizes == [4, 4]
    # the screened lane stays False whatever the kernel says
    assert got == [True] * 6 + [False, True]


def test_consenters_warm_the_key_cache():
    idents, _, _ = _envelopes()
    csp = TorchCSP(device="cpu", buckets=(8,), key_cache_size=8)
    try:
        CspBatchVerifier(csp, consenters=idents + [b"malformed"])
        deadline = time.time() + 30
        while len(csp.key_cache) < 5 and time.time() < deadline:
            time.sleep(0.02)
        assert len(csp.key_cache) == 5
    finally:
        csp.close()
    # no key cache, no quorum hint: a no-op
    CspBatchVerifier(SwCSP(), consenters=idents)

    class Hinted:
        def __init__(self):
            self.hint, self.warmed = None, []

        def set_quorum_hint(self, lanes):
            self.hint = lanes

        def warm_keys(self, keys, wait=False):
            self.warmed += keys

    h = Hinted()
    CspBatchVerifier(h, consenters=idents)
    assert h.hint == 2 * ((5 - 1) // 3) + 1 and len(h.warmed) == 5
