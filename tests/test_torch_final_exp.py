"""The full-exponent final exponentiation (K11's plain twin) and the
certificate backends, against the JAX package and its oracle, on the CPU.

- ``fe_bits()`` are the bits of (p^12 - 1)/r, as the reference's
  ``_fe_bits``;
- the plain ``final_exp`` equals the oracle's ``FQ12.pow((p^12 - 1)//r)``
  on two random FQ12 values and zero, the value the reference's
  ``final_exp`` is defined to compute (its own ``tests/test_bls.py``
  anchors its final exponentiation to the oracle the same way);
- the plain ``verify_pipeline`` gives ``[True, False, False]`` on the
  lanes of the reference's ``test_pairing_kernel_end_to_end`` (a valid
  signature, a wrong binding, the degenerate y = 0 "signature"), and the
  values it compares are the cube roots of the x-chain's;
- ``resolve_backend`` maps ``None``, ``"kernel"``, ``"kernel-fast"``,
  ``BDLS_BLS_FE=fast`` and ``"host"`` as the reference chooses its
  pipelines, with the port's default ``"kernel-fast"`` where the
  reference's is ``"host"``.

The full exponent takes some 6,400 FQ12 operations a call on the plain
twin, so each module-scoped fixture runs it once, on three lanes (six
sides for the pipeline). Comparisons are exact.
"""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

from bdls_tpu.ops import bls_kernel as JK
from bdls_tpu_torch.crypto.torch_provider import TorchCSP
from bdls_tpu_torch.ops import bls_host as B
from bdls_tpu_torch.ops import bls_kernel as K

torch.set_num_threads(1)

E = (B.P ** 12 - 1) // B.R


def _f12(vals):
    return K.f12_from_words(torch.from_numpy(K.f12_words(vals).view(np.int32)))


def _oracle(x, lane):
    ints = K.f12_to_ints(x)
    return B.FQ12([ints[d][lane] for d in range(12)])


def test_fe_bits_are_the_exponent():
    bits = K.fe_bits()
    assert bits.dtype == np.uint8 and bits[0] == 1
    assert bits.tolist() == [int(c) for c in bin(E)[2:]]
    assert bits.tolist() == JK._fe_bits().tolist()
    assert (len(bits), int(bits.sum())) == (4314, 2124)


@pytest.fixture(scope="module")
def full_exp():
    rng = np.random.default_rng(4314)

    def rand():
        return B.FQ12([int.from_bytes(rng.bytes(48), "little") % B.P
                       for _ in range(12)])

    vals = [rand(), rand(), B.FQ12.zero()]
    return vals, K.final_exp(_f12(vals))


def test_final_exp_is_the_oracle_full_exponent(full_exp):
    vals, got = full_exp
    for i, v in enumerate(vals):
        assert _oracle(got, i) == v.pow(E), i
    assert _oracle(got, 2) == B.FQ12.zero()


def test_final_exp_fast_is_the_cube(full_exp):
    vals, got = full_exp
    fast = K.final_exp_fast(_f12(vals[:2]))
    for i in range(2):
        assert _oracle(fast, i) == _oracle(got, i).pow(3)


def _pipeline_lanes():
    """The lanes of the reference's test_pairing_kernel_end_to_end."""
    sk1, pk1 = B.keygen(0x111)
    sk2, pk2 = B.keygen(0x222)
    sig1 = B.sign(sk1, b"m1")
    sig2 = B.sign(sk2, b"m1")
    forged = (B.FQ12.scalar(1), B.FQ12.zero())
    hm = B.hash_to_g2(b"m1")
    pts = ([B.G1] * 3, [sig1, sig2, forged], [pk1, pk2, pk1],
           [hm, B.hash_to_g2(b"m2"), hm])
    return [torch.from_numpy(a.view(np.int32)) for p in pts
            for a in K.pt_batch(p)]


@pytest.fixture(scope="module")
def pipeline_run():
    """``verify_pipeline`` on the CPU, once, with the full final
    exponentiation it runs recorded (its input and output)."""
    args = _pipeline_lanes()
    seen = []
    real = K.final_exp

    def spy(x):
        out = real(x)
        seen.append((x, out))
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(K, "final_exp", spy)
        ok = K.verify_pipeline(*args)
    return args, ok, seen


def test_verify_pipeline_runs_the_full_exponent(pipeline_run):
    args, ok, seen = pipeline_run
    assert ok.tolist() == [True, False, False]
    assert len(seen) == 1
    x, fe = seen[0]
    assert fe.v.shape[-1] == 6                     # lhs and rhs of 3 lanes
    # its input is the Miller products, its verdicts the compare's
    prod = K.miller_products(*args)
    assert K.f12_to_ints(x) == K.f12_to_ints(prod)
    assert K._compare_sides(fe).tolist() == [True, False, False]


def test_verify_pipeline_sides_are_the_x_chain_cube_roots(pipeline_run):
    args, ok, seen = pipeline_run
    x, fe = seen[0]
    fast = K.final_exp_fast(x)
    for lane in range(6):
        assert _oracle(fast, lane) == _oracle(fe, lane).pow(3), lane
    # the degenerate lane collapses both sides to zero, in both forms
    assert _oracle(fe, 2) == _oracle(fe, 5) == B.FQ12.zero()
    assert K.verify_pipeline_fast(*args).tolist() == ok.tolist()


@pytest.mark.parametrize("backend,env,fe,want", [
    (None, None, None, "kernel-fast"),
    (None, "", None, "kernel-fast"),
    (None, "kernel", None, "kernel"),
    (None, "kernel", "fast", "kernel-fast"),
    (None, "host", None, "host"),
    ("kernel", None, None, "kernel"),
    ("kernel", "host", "fast", "kernel-fast"),
    ("kernel-fast", None, None, "kernel-fast"),
    ("host", None, "fast", "host"),
])
def test_resolve_backend(monkeypatch, backend, env, fe, want):
    for name, val in (("BDLS_CERT_BACKEND", env), ("BDLS_BLS_FE", fe)):
        if val is None:
            monkeypatch.delenv(name, raising=False)
        else:
            monkeypatch.setenv(name, val)
    assert K.resolve_backend(backend) == want
    if backend is not None and want != "host":
        # the reference's pipeline choice for a kernel backend
        # (bdls_tpu/ops/bls_kernel.py:verify_certificates)
        fast = (backend == "kernel-fast"
                or os.environ.get("BDLS_BLS_FE") == "fast")
        assert (want == "kernel-fast") == fast


def test_resolve_backend_refuses_unknown_names():
    with pytest.raises(ValueError):
        K.resolve_backend("pipeline")


def test_the_default_certificate_path_stays_the_x_chain(monkeypatch):
    """verify_certificates reaches the pipeline its backend names: the
    default the x-chain, ``"kernel"`` the full exponent (spied, not run:
    the fixtures above run both)."""
    from bdls_tpu_torch.consensus import threshold as TH

    monkeypatch.delenv("BDLS_CERT_BACKEND", raising=False)
    monkeypatch.delenv("BDLS_BLS_FE", raising=False)
    called = []
    for name in ("kernel", "kernel-fast"):
        monkeypatch.setitem(K.PIPELINES, name,
                            lambda *a, _n=name: called.append(_n)
                            or torch.ones(a[0].shape[-1], dtype=torch.bool))
    sk, pk = B.keygen(0x333)
    agg = TH.ThresholdAggregator([pk], quorum=1)
    cert = TH.QuorumCertificate(b"d", (0,), B.sign(sk, b"d"))
    csp = TorchCSP(device="cpu", key_cache_size=0)
    try:
        assert csp.verify_certificates([cert], [agg]) == [True]
        assert csp.verify_certificates([cert], [agg], backend="kernel") \
            == [True]
        monkeypatch.setenv("BDLS_BLS_FE", "fast")
        assert csp.verify_certificates([cert], [agg], backend="kernel") \
            == [True]
        assert csp._c_cert_host.value() == 0
    finally:
        csp.close()
    assert called == ["kernel-fast", "kernel", "kernel-fast"]
