"""The port's Ed25519 path vs the JAX package, lane for lane, on the CPU.

- the host oracle (``ops/ed25519.py``) reproduces the RFC 8032 §7.1
  vectors, and ``pt_mul`` equals the reference's on edge scalars;
- ``b_tables_positioned()`` holds the reference's
  ``_b_tables_positioned`` integers;
- ``marshal_ed25519`` is bit-identical to the reference's, for int
  requests and wire requests;
- the plain twin ``verify_ed25519`` equals the reference's
  ``ops.ed25519.verify_limbs(..., field="fold")`` on XLA:CPU lane for
  lane, hostile and torsion lanes included, and the RFC 8032 oracle;
- ``TorchCSP(device="cpu")`` equals ``TpuCSP(buckets=(8,),
  kernel_field="fold", key_cache_size=0)`` on a mixed Ed25519 batch,
  the long-message lanes of the reference's digest screen included, and
  the port's ``SwCSP`` signs and verifies as the reference's does.

All of the reference's Ed25519 programs of this file share one compiled
bucket of 8 lanes. Verdicts and limbs are compared exactly.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from bdls_tpu.crypto import marshal as jmarshal
from bdls_tpu.crypto.csp import PublicKey as JPublicKey
from bdls_tpu.crypto.csp import VerifyRequest as JVerifyRequest
from bdls_tpu.crypto.sw import SwCSP as JSwCSP
from bdls_tpu.crypto.tpu_provider import TpuCSP
from bdls_tpu.ops import ed25519 as jed
from bdls_tpu_torch.crypto import marshal, vectors
from bdls_tpu_torch.crypto.csp import PublicKey, VerifyRequest
from bdls_tpu_torch.crypto.marshal import from_wire_fields
from bdls_tpu_torch.crypto.sw import SwCSP
from bdls_tpu_torch.crypto.torch_provider import TorchCSP
from bdls_tpu_torch.ops import ed25519 as ed
from bdls_tpu_torch.ops.curves import ED25519
from bdls_tpu_torch.ops.verify_fold import _from_radix12

# the plain version runs many ops on tiny tensors: extra intra-op
# threads only contend with the other test workers
torch.set_num_threads(1)

BUCKET = 8


@pytest.fixture(scope="module")
def lanes():
    return vectors.ed25519_mixed_lanes(np.random.default_rng(41))


def _chunks(rows, size=BUCKET):
    """Rows in chunks of ``size``, the last padded by repeating row 0."""
    for i in range(0, len(rows), size):
        part = rows[i:i + size]
        yield part + [rows[0]] * (size - len(part)), len(part)


def test_host_oracle_reproduces_rfc8032_vectors():
    for seed, pk, msg, sig in vectors.RFC8032_VECTORS:
        seed, pk, msg, sig = (bytes.fromhex(x)
                              for x in (seed, pk, msg, sig))
        assert ed.public_key(seed) == pk
        assert ed.sign(seed, msg) == sig
        assert ed.verify_host(pk, msg, sig)
        assert not ed.verify_host(pk, msg + b"x", sig)
        assert ed.decompress(pk) == jed.decompress(pk)
    base = (ed.GX, ed.GY)
    for k in (0, 1, 2, 8, ed.L - 1, ed.L, ed.L + 5, (1 << 256) - 1):
        assert ed.pt_mul(k, base) == jed.pt_mul(k, base), k


def test_b_tables_equal_the_reference():
    bx, by, bt = jed._b_tables_positioned()
    ref = np.stack([_from_radix12(a) for a in (bx, by, bt)], axis=2)
    assert np.array_equal(ed.b_tables_positioned(), ref)
    dev = ed.device_b_table(torch.device("cpu")).numpy()
    assert dev.shape == (32, 256, 3, 8)


def test_marshal_ed25519_is_bit_identical(lanes):
    port = [VerifyRequest(PublicKey("ed25519", x, y), m, r, s)
            for x, y, r, s, m, _ in lanes if s < (1 << 256)]
    ref = [JVerifyRequest(JPublicKey("ed25519", x, y), m, r, s)
           for x, y, r, s, m, _ in lanes if s < (1 << 256)]
    got = marshal.marshal_requests(port)
    want = jmarshal.marshal_requests(ref)
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    wire = [from_wire_fields("ed25519", x.to_bytes(32, "big"),
                             y.to_bytes(32, "big"), r.to_bytes(32, "big"),
                             s.to_bytes(32, "big"), m[-32:])
            for x, y, r, s, m, _ in lanes if x < (1 << 256)]
    for g, w in zip(marshal.marshal_ed25519(wire),
                    jmarshal.marshal_ed25519(wire)):
        assert np.array_equal(g, w)


def test_plain_twin_matches_jax_program_and_oracle(lanes):
    rows = vectors.ed25519_rows(lanes)
    got, want = [], []
    for part, n in _chunks(rows):
        arrs = ed.lanes_to_limbs(part)
        plain = ed.verify_ed25519(
            ED25519, *(torch.from_numpy(a.view(np.int32)) for a in arrs))
        ref = jed.verify_limbs(jed.lanes_to_limbs(part), field="fold")
        got += plain.tolist()[:n]
        want += [bool(v) for v in ref][:n]
    assert got == want
    assert got == vectors.ed25519_expected(lanes)
    verdict = dict(zip((ln[5] for ln in lanes), got))
    assert verdict["torsion in A, 8 | k"] and verdict["A of order 8, 8 | k"]
    assert not verdict["torsion in R"]
    assert verdict["A = R = identity, S = 0"]
    assert not verdict["S = L"] and not verdict["R x = 0 with sign bit 1"]


def test_verify_batch_on_the_cpu_matches_the_oracle():
    rng = np.random.default_rng(42)
    seeds = [rng.bytes(32) for _ in range(3)]
    msgs = [rng.bytes(int(n)) for n in (0, 40, 7)]
    pubs = [ed.public_key(sd) for sd in seeds]
    sigs = [ed.sign(sd, m) for sd, m in zip(seeds, msgs)]
    pubs.append(pubs[0])
    sigs.append(sigs[1])                      # another key's signature
    msgs.append(msgs[0])
    got = ed.verify_batch(pubs, sigs, msgs, device="cpu").tolist()
    assert got == [ed.verify_host(p, m, s)
                   for p, s, m in zip(pubs, sigs, msgs)]
    assert got == [True, True, True, False]


def test_sw_provider_signs_as_the_reference():
    port, ref = SwCSP(), JSwCSP()
    for d in (7, 1 << 200):
        kp, kr = port.key_from_scalar("ed25519", d), \
            ref.key_from_scalar("ed25519", d)
        pub = kp.public_key()
        assert (pub.x, pub.y) == (kr.public_key().x, kr.public_key().y)
        for msg in (b"", b"vote", b"b" * 64):
            sig = port.sign(kp, msg)
            assert sig == ref.sign(kr, msg)
            assert port.verify(VerifyRequest(pub, msg, *sig))
            assert not port.verify(VerifyRequest(pub, msg + b"!", *sig))
    assert port.key_import("ed25519", pub.x, pub.y) == pub
    with pytest.raises(ValueError):
        port.key_import("ed25519", pub.x, (pub.y + 1) % ed.P)
    rng = np.random.default_rng(43)
    assert port.key_gen("ed25519", rng).public_key() == \
        port.key_gen("ed25519", np.random.default_rng(43)).public_key()


def test_torch_csp_matches_tpu_csp_on_ed25519(lanes):
    """One mixed batch: valid, tampered and hostile lanes and the three
    long-message lanes of the reference's digest screen."""
    sel = [ln for ln in lanes if ln[3] < (1 << 256)]
    port = [VerifyRequest(PublicKey("ed25519", x, y), m, r, s)
            for x, y, r, s, m, _ in sel]
    ref = [JVerifyRequest(JPublicKey("ed25519", x, y), m, r, s)
           for x, y, r, s, m, _ in sel]
    tpu = TpuCSP(buckets=(BUCKET,), kernel_field="fold", key_cache_size=0,
                 use_cpu_fallback=False)
    torch_csp = TorchCSP(device="cpu", buckets=(BUCKET,),
                         use_cpu_fallback=False)
    # one bucket per call: TpuCSP's staging ring is refilled by the next
    # chunk of a call while the previous launch may still read it
    # (ROADMAP.md, Queue C)
    want, got = [], []
    try:
        for i in range(0, len(ref), BUCKET):
            want += tpu.verify_batch(ref[i:i + BUCKET])
            got += torch_csp.verify_batch(port[i:i + BUCKET])
        stats = torch_csp.stats
    finally:
        tpu.close()
        torch_csp.close()
    assert got == want
    assert stats["fallbacks"] == 0 and stats["pinned_lanes"] == 0
    # Ed25519 skips the key cache
    assert stats["key_cache"]["keys"] == {}
    assert stats["key_cache"]["hits"] + stats["key_cache"]["misses"] == 0
    assert stats["latency_launches"] == 0        # and never takes K3
    verdict = dict(zip((ln[5] for ln in sel), got))
    sw = dict(zip((ln[5] for ln in sel),
                  SwCSP().verify_batch(port)))
    # the reference's digest screen rejects a valid signature over a
    # 64-byte message; the port gives the reference's verdict
    assert sw["64-byte message"] and not verdict["64-byte message"]
    assert verdict["32-byte message"] and verdict["48-byte message"]
    assert [verdict[k] for k in verdict if k != "64-byte message"] == \
        [sw[k] for k in verdict if k != "64-byte message"]
