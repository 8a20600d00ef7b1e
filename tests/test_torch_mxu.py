"""The "mxu" limb engine (the plain twin of K5) on the CPU.

``bdls_tpu_torch/ops/mxu.py`` forms the fold field's limb product as the
reference's gen-3 engine does (``bdls_tpu/ops/mxu.py:mul_cols``): digit
split, per-lane outer product, one constant 0/1 anti-diagonal
contraction, recombination. Held here, exactly:

- ``fold.mul`` under ``mul_backend("mxu")`` equals ``x·y mod m`` and the
  "vpu" engine on all five moduli (P-256 p and n, secp256k1 p and n,
  2^255 - 19), at edge values and seeded ones;
- the selector's structure, the engine's registration and binding;
- the exactness assert trips on an operand over its bound;
- the verify program's plain twin gives the same verdicts on either
  engine, hostile lanes included.
"""

from __future__ import annotations

import threading

import numpy as np
import pytest
import torch

from bdls_tpu.ops import mxu as jmxu
from bdls_tpu_torch.crypto import vectors
from bdls_tpu_torch.crypto.marshal import ints_to_limbs
from bdls_tpu_torch.ops import fold, mxu
from bdls_tpu_torch.ops.curves import CURVES, EDWARDS_CURVES
from bdls_tpu_torch.ops.fold import FE
from bdls_tpu_torch.ops.verify_fold import verify_fold

torch.set_num_threads(1)

MODULI = {"P-256:p": CURVES["P-256"].fp.modulus,
          "P-256:n": CURVES["P-256"].fn.modulus,
          "secp256k1:p": CURVES["secp256k1"].fp.modulus,
          "secp256k1:n": CURVES["secp256k1"].fn.modulus,
          "ed25519:p": EDWARDS_CURVES["ed25519"].fp.modulus}


def _fe(xs) -> FE:
    return fold.from_limbs16(torch.from_numpy(
        np.array([fold.int_to_limbs16(x) for x in xs]).T.copy()))


@pytest.mark.parametrize("name", sorted(MODULI))
def test_products_equal_integers_and_the_vpu_engine(name):
    m = MODULI[name]
    ctx = fold.fold_ctx(m)
    rng = np.random.default_rng(sorted(MODULI).index(name))
    edge = [0, 1, 2, m - 1, m - 2, m, m + 1, (1 << 256) - 1, 1 << 255,
            (1 << 224) - 1]
    xs = edge + [int.from_bytes(rng.bytes(32), "big") for _ in range(40)]
    ys = edge[::-1] + [int.from_bytes(rng.bytes(32), "big")
                       for _ in range(40)]
    x, y = _fe(xs), _fe(ys)
    with fold.mul_backend("mxu"):
        assert fold.active_backend() == "mxu"
        p = fold.mul(ctx, x, y)
        # an unreduced operand (a sum) is normed first, as on "vpu"
        q = fold.sqr(ctx, fold.add(p, x))
    assert fold.active_backend() == "vpu"
    pv = fold.mul(ctx, x, y)
    qv = fold.sqr(ctx, fold.add(pv, x))
    want = [a * b % m for a, b in zip(xs, ys)]
    assert fold.tensor_to_ints(fold.canon(ctx, p)) == want
    assert fold.tensor_to_ints(fold.canon(ctx, pv)) == want
    assert fold.tensor_to_ints(fold.canon(ctx, q)) == \
        fold.tensor_to_ints(fold.canon(ctx, qv)) == \
        [(w + a) ** 2 % m for w, a in zip(want, xs)]


def test_diag_selector_structure():
    d = mxu.diag_host()
    assert d.shape == (mxu.NCOLS, mxu.S * mxu.S) == (71, 1296)
    assert set(np.unique(d)) == {0.0, 1.0}
    # every digit pair (t, u) lands in exactly one row, row t + u
    assert (d.sum(0) == 1).all()
    rows = d.argmax(0).reshape(mxu.S, mxu.S)
    t, u = np.meshgrid(np.arange(mxu.S), np.arange(mxu.S), indexing="ij")
    assert (rows == t + u).all()
    assert d.sum(1).tolist() == [min(k + 1, 2 * mxu.S - 1 - k)
                                 for k in range(mxu.NCOLS)]
    # the reference's selector has the same structure at its own width
    jd = jmxu._diag_host()
    js = jmxu.S
    assert jd.shape == (2 * js - 1, js * js)
    assert (jd.reshape(-1, js, js).argmax(0) == np.add.outer(
        np.arange(js), np.arange(js))).all()


def test_engine_registration_and_thread_binding():
    assert fold.MUL_BACKENDS["mxu"] is mxu.mul_cols
    assert set(fold.MUL_BACKENDS) == {"vpu", "mxu"}
    with pytest.raises(ValueError, match="unknown mul backend"):
        with fold.mul_backend("gen4"):
            pass
    seen = []
    with fold.mul_backend("mxu"):
        t = threading.Thread(target=lambda: seen.append(
            fold.active_backend()))
        t.start()
        t.join()
        seen.append(fold.active_backend())
    assert seen == ["vpu", "mxu"]


def test_exactness_assert_trips_over_budget():
    ctx = fold.fold_ctx(MODULI["P-256:p"])
    x = _fe([3, 5])
    ok_cols, lb = mxu.mul_cols(ctx, x, x)
    assert lb < 1 << 62
    # limbs near 2^46: a digit column of 36 products passes 2^53
    big = FE(x.v, 1 << 46)
    with pytest.raises(AssertionError):
        mxu.mul_cols(ctx, big, big)


@pytest.mark.parametrize("curve", sorted(CURVES))
def test_verify_program_equal_on_either_engine(curve):
    rng = np.random.default_rng(93)
    lanes = vectors.mixed_lanes(curve, rng, n_valid=2)
    args = [torch.from_numpy(ints_to_limbs(c).view(np.int32))
            for c in vectors.columns(lanes)]
    with fold.mul_backend("mxu"):
        got = verify_fold(CURVES[curve], *args).tolist()
    assert got == verify_fold(CURVES[curve], *args).tolist()
    assert got == vectors.expected(curve, lanes)
