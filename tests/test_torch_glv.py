"""The port's GLV split equals the JAX package's, as integers.

``bdls_tpu_torch.ops.glv.decompose`` (plain PyTorch, 16-bit limbs) must
give, for every scalar k < n, the same signed halves (k1, k2) as the
reference's integer oracle ``bdls_tpu.ops.glv.decompose_host`` and its
batched ``glv.decompose`` (run eagerly on the CPU, radix-12 limbs). The
scalars: 0, 1, n - 1, λ, seeded ones, and scalars next to the lattice
boundaries, where c1 or c2 = (k·g) >> 384 steps by one (an off-by-one
there moves |k_i| past 2^132). Comparisons are exact.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from bdls_tpu.ops import glv as jglv
from bdls_tpu.ops import verify_fold as jvf
from bdls_tpu_torch.crypto.sw import _mul_add
from bdls_tpu_torch.ops import glv
from bdls_tpu_torch.ops.curves import SECP256K1
from bdls_tpu_torch.ops.fold import int_to_limbs16, limbs16_to_int


def _boundary_scalars() -> list[int]:
    """k next to a step of c1 or c2: k·g crosses a multiple of 2^384."""
    out = []
    for g in (glv.G1C, glv.G2C):
        for m in (1, 2, 3, 1 << 40, (glv.N * g >> glv.SHIFT) - 1):
            k = -((-m << glv.SHIFT) // g)            # ceil(m·2^384 / g)
            out += [k + d for d in (-1, 0, 1) if 0 <= k + d < glv.N]
    return out


def _scalars() -> list[int]:
    rng = np.random.default_rng(1312)
    n = glv.N
    return ([0, 1, 2, n - 1, n - 2, n // 2, glv.LAMBDA, n - glv.LAMBDA,
             glv.A1, glv.A2, -glv.B1, (1 << 255) % n]
            + _boundary_scalars()
            + [int.from_bytes(rng.bytes(32), "big") % n for _ in range(200)])


def _signed(mag: np.ndarray, neg) -> list[int]:
    return [(-1 if bool(neg[b]) else 1) * limbs16_to_int(mag[:, b])
            for b in range(mag.shape[1])]


def test_constants_are_the_references():
    for name in ("P", "N", "LAMBDA", "BETA", "A1", "B1", "A2", "B2",
                 "SHIFT", "G1C", "G2C", "KMAX_BITS"):
        assert getattr(glv, name) == getattr(jglv, name), name
    assert glv.P == SECP256K1.fp.modulus and glv.N == SECP256K1.fn.modulus


def test_psi_is_lambda_times_the_point():
    cv = SECP256K1
    q = _mul_add(cv, 0x1234, (cv.gx, cv.gy))
    assert glv.psi_host(*q) == _mul_add(cv, glv.LAMBDA, q)
    assert glv.psi_host(*q) == jglv.psi_host(*q)


def test_decompose_equals_decompose_host():
    ks = _scalars()
    kc = torch.as_tensor(np.stack([int_to_limbs16(k) for k in ks], axis=1))
    k1m, k1n, k2m, k2n = glv.decompose(kc)
    assert k1m.shape == k2m.shape == (glv.NLIMB_OUT, len(ks))
    got = list(zip(_signed(k1m.numpy(), k1n), _signed(k2m.numpy(), k2n)))
    assert got == [glv.decompose_host(k) for k in ks]
    assert got == [jglv.decompose_host(k) for k in ks]
    for k, (k1, k2) in zip(ks, got):
        assert (k1 + k2 * glv.LAMBDA) % glv.N == k
        assert max(abs(k1), abs(k2)) < 1 << glv.KMAX_BITS


def test_decompose_equals_the_references_batched_split():
    ks = _scalars()
    kc12 = jvf._np_limbs12(ks).T
    jk1m, jk1n, jk2m, jk2n = (np.asarray(a) for a in jglv.decompose(kc12))

    def ints12(mag, neg):
        return [(-1 if neg[b] else 1) * sum(int(v) << (12 * j)
                                            for j, v in enumerate(mag[:, b]))
                for b in range(mag.shape[1])]

    kc = torch.as_tensor(np.stack([int_to_limbs16(k) for k in ks], axis=1))
    k1m, k1n, k2m, k2n = glv.decompose(kc)
    assert _signed(k1m.numpy(), k1n) == ints12(jk1m, jk1n)
    assert _signed(k2m.numpy(), k2n) == ints12(jk2m, jk2n)


@pytest.mark.parametrize("k", [0, 1, glv.N - 1, glv.LAMBDA])
def test_decompose_edges(k):
    kc = torch.as_tensor(int_to_limbs16(k)[:, None])
    k1m, k1n, k2m, k2n = glv.decompose(kc)
    assert (_signed(k1m.numpy(), k1n)[0],
            _signed(k2m.numpy(), k2n)[0]) == glv.decompose_host(k)
