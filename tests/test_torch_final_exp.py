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
- K11's route to the same value (``csrc/bls12.cuh:final_exp_exact``),
  in Python integers over the oracle's FQ12: the exact x-chain
  (p^4 - p^2 + 1)/r = (x-1)^2/3·(x+p)·(x^2+p^2-1) + 1 after the easy
  part, its inverse through the norm, Granger-Scott's cyclotomic square
  over the tower the flat basis already is, conjugation as frob^6 and the
  sparse frob^1 and frob^2 tables (``frob_sparse_host``) as the dense
  matrices; the chain equals ``pow(v, (p^12 - 1)//r)`` on seeded values
  and on zero;
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


# ---- K11's exact chain, in Python integers ----------------------------------

def _sparse_frob(v, k):
    """frob^k through K11's sparse table (its Montgomery constants read
    back as integers)."""
    tab = K.frob_sparse_host()
    rows = tab[:K.FROB_NNZ[1]] if k == 1 else tab[K.FROB_NNZ[1]:]
    rinv = pow(2 ** 384, -1, B.P)
    out = [0] * 12
    for row in rows:
        c = int.from_bytes(row[2:].astype("<u4").tobytes(), "little")
        out[int(row[1])] += v.c[int(row[0])] * c * rinv
    return B.FQ12(out)


def _conj(v):
    """frob^6: the odd coefficients negated."""
    return B.FQ12([-c if i % 2 else c for i, c in enumerate(v.c)])


def _tower(v):
    """flat -> the six Fp2 coefficients (re, im) of Fp2[w]/(w^6 - (1+i))"""
    return [((v.c[k] + v.c[k + 6]) % B.P, v.c[k + 6]) for k in range(6)]


def _flat(t):
    return B.FQ12([re - im for re, im in t] + [im for _, im in t])


def _cyclo_sqr(v):
    """Granger-Scott's square, as ``cyclo_task``/``cyclo_combine`` run it."""
    P = B.P
    c = _tower(v)

    def sq(a):
        return ((a[0] + a[1]) * (a[0] - a[1]) % P, 2 * a[0] * a[1] % P)

    def fp4(a, b):                   # ((1+i)·b² + a², (a+b)² - a² - b²)
        t0, t1 = sq(a), sq(b)
        t2 = sq((a[0] + b[0], a[1] + b[1]))
        return (((t1[0] - t1[1] + t0[0]) % P, (t1[0] + t1[1] + t0[1]) % P),
                ((t2[0] - t0[0] - t1[0]) % P, (t2[1] - t0[1] - t1[1]) % P))

    out = [None] * 6
    for k in range(6):
        if k % 2 == 0:
            T = fp4(c[k // 2], c[k // 2 + 3])[0]
            sign = -1
        else:
            g = (k + 3) % 6 // 2
            T = fp4(c[g], c[g + 3])[1]
            if k == 1:
                T = (T[0] - T[1], T[0] + T[1])
            sign = 1
        out[k] = ((3 * T[0] + sign * 2 * c[k][0]) % P,
                  (3 * T[1] + sign * 2 * c[k][1]) % P)
    return _flat(out)


def _exact_chain(f):
    """f^((p^12 - 1)/r) by ``final_exp_exact``'s sequence."""
    X = B.ATE_LOOP

    def pow_cyclo(base, e):
        acc = base
        for bit in bin(e)[3:]:
            acc = _cyclo_sqr(acc)
            if bit == "1":
                acc = acc * base
        return acc

    cf = _conj(f)
    u = f * cf
    up = _sparse_frob(u, 2) * _sparse_frob(_sparse_frob(u, 2), 2)
    u2 = u * up
    z = _sparse_frob(u2, 1)
    norm = u2 * z
    assert norm.c[1:] == [0] * 11                    # N(f) lies in Fp
    finv = cf * up * z * pow(norm.c[0], B.P - 2, B.P)
    m1 = cf * finv
    m = _sparse_frob(m1, 2) * m1
    a = _conj(pow_cyclo(m, (X + 1) // 3))            # m^((x-1)/3)
    b = _conj(pow_cyclo(a, X) * a)                   # a^(x-1)
    t3 = _conj(pow_cyclo(b, X)) * _sparse_frob(b, 1)     # b^(x+p)
    t1 = pow_cyclo(pow_cyclo(t3, X), X)              # t3^(x^2)
    return t1 * _sparse_frob(t3, 2) * _conj(t3) * m


def test_the_exact_chain_identity():
    x = -B.ATE_LOOP
    assert (x - 1) % 3 == 0
    assert ((B.ATE_LOOP + 1) // 3).bit_length() == 63
    assert bin((B.ATE_LOOP + 1) // 3).count("1") == 28
    h, rem = divmod(B.P ** 4 - B.P ** 2 + 1, B.R)
    assert rem == 0
    assert h == (x - 1) ** 2 // 3 * (x + B.P) * (x * x + B.P ** 2 - 1) + 1


def test_conjugation_and_sparse_frobenius_are_the_maps():
    """conj is frob^6 (its matrix diagonal, +1 even, -1 odd); the sparse
    tables hold the nonzero entries of the dense frob^1 and frob^2
    matrices, 19 and 12 of 144, and apply as the oracle's p-th powers."""
    m6 = K.frob_matrix(6)
    assert [[m6[i][j] for j in range(12)] for i in range(12)] == \
        [[0 if i != j else (1 if i % 2 == 0 else B.P - 1)
          for j in range(12)] for i in range(12)]
    tab = K.frob_sparse_host()
    assert tab.shape == (K.FROB_NNZ[1] + K.FROB_NNZ[2], 14)
    for k, rows in ((1, tab[:K.FROB_NNZ[1]]), (2, tab[K.FROB_NNZ[1]:])):
        m = K.frob_matrix(k)
        assert sorted((int(r[0]), int(r[1])) for r in rows) == sorted(
            (i, j) for i in range(12) for j in range(12) if m[i][j])
    rng = np.random.default_rng(4319)
    v = B.FQ12([int.from_bytes(rng.bytes(48), "little") % B.P
                for _ in range(12)])
    assert _conj(v) == v.pow(B.P ** 6)
    for k in (1, 2):
        assert _sparse_frob(v, k) == v.pow(B.P ** k), k


def test_the_exact_chain_is_the_full_exponent():
    """K11's sequence equals pow(v, (p^12 - 1)//r) on seeded values and
    on zero (the cyclotomic square maps 0 to 0); the cyclotomic square
    equals the dense one after the easy part."""
    rng = np.random.default_rng(4320)
    vals = [B.FQ12([int.from_bytes(rng.bytes(48), "little") % B.P
                    for _ in range(12)]) for _ in range(2)]
    for v in vals:
        assert _exact_chain(v) == v.pow(E)
        m1 = _conj(v) * v.inv()
        m = m1.pow(B.P ** 2) * m1
        assert _cyclo_sqr(m) == m * m
    assert _exact_chain(B.FQ12.zero()) == B.FQ12.zero()


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
