"""Plain field arithmetic of the port vs the JAX package's fold field.

``bdls_tpu_torch.ops.fold`` (16-bit int64 limbs) and ``bdls_tpu.ops.fold``
(radix-12 uint32 limbs, eager on XLA:CPU) take the same integers and must
give the same canonical integers: exactly, since these are integers. Both
are also held against Python's own modular arithmetic. Inputs: edge
values (0, 1, m-1, 2^256-1) plus values drawn from a seeded numpy rng.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bdls_tpu.ops import fold as jfold
from bdls_tpu.ops.curves import CURVES as JCURVES
from bdls_tpu_torch.crypto.marshal import ints_to_limbs
from bdls_tpu_torch.ops import fold
from bdls_tpu_torch.ops.curves import CURVES

# the plain version runs many ops on tiny tensors: extra intra-op
# threads only contend with the other test workers
torch.set_num_threads(1)

MODULI = {f"{c}:{k}": getattr(CURVES[c], k).modulus
          for c in ("P-256", "secp256k1") for k in ("fp", "fn")}


def _values(m: int, seed: int) -> tuple[list[int], list[int]]:
    rng = np.random.default_rng(seed)
    rand = [int.from_bytes(rng.bytes(32), "big") for _ in range(8)]
    a = [0, 1, m - 1, (1 << 256) - 1, m - 1, 1 << 255] + rand
    b = [5, m - 1, m - 1, (1 << 256) - 1, 0, m - 2] + rand[::-1]
    return a, b


def _port(vals):
    return fold.from_limbs16(torch.from_numpy(ints_to_limbs(vals).astype(np.int64)))


def _ref(vals):
    return jfold.from_limbs16(jnp.asarray(ints_to_limbs(vals)))


def _port_ints(ctx, x) -> list[int]:
    return fold.tensor_to_ints(fold.canon(ctx, x))


def _ref_ints(ctx, x) -> list[int]:
    c = np.asarray(jfold.canon(ctx, x))
    return [jfold.limbs12_to_int(c[:, i]) for i in range(c.shape[1])]


@pytest.mark.parametrize("name", sorted(MODULI))
def test_mul_sqr_sub_canon_match_reference(name):
    m = MODULI[name]
    pc, jc = fold.fold_ctx(m), jfold.fold_ctx(m)
    a, b = _values(m, seed=len(name))
    pa, pb, ja, jb = _port(a), _port(b), _ref(a), _ref(b)

    cases = {
        "canon": (_port_ints(pc, pa), _ref_ints(jc, ja),
                  [x % m for x in a]),
        "mul": (_port_ints(pc, fold.mul(pc, pa, pb)),
                _ref_ints(jc, jfold.mul(jc, ja, jb)),
                [x * y % m for x, y in zip(a, b)]),
        "sqr": (_port_ints(pc, fold.sqr(pc, pa)),
                _ref_ints(jc, jfold.sqr(jc, ja)),
                [x * x % m for x in a]),
        "sub": (_port_ints(pc, fold.sub(pc, pa, pb)),
                _ref_ints(jc, jfold.sub(jc, ja, jb)),
                [(x - y) % m for x, y in zip(a, b)]),
    }
    for op, (port, ref, exact) in cases.items():
        assert port == exact, op
        assert ref == exact, op


@pytest.mark.parametrize("name", sorted(MODULI))
def test_fermat_inv_matches_reference(name):
    m = MODULI[name]
    pc, jc = fold.fold_ctx(m), jfold.fold_ctx(m)
    a, _ = _values(m, seed=7 + len(name))
    a = a[:8]
    port = _port_ints(pc, fold.fermat_inv(pc, _port(a)))
    ref = _ref_ints(jc, jfold.fermat_inv(jc, _ref(a)))
    exact = [pow(x, m - 2, m) for x in a]
    assert port == exact
    assert ref == exact


@pytest.mark.parametrize("name", sorted(MODULI))
def test_redundant_chains_stay_exact(name):
    """Long add/sub/mul chains without intermediate canon (the way the
    point formulas use the field) keep the exact value mod m."""
    m = MODULI[name]
    pc = fold.fold_ctx(m)
    a, b = _values(m, seed=3)
    x, y = _port(a), _port(b)
    ix, iy = list(a), list(b)
    for _ in range(6):
        x, y = (fold.mul(pc, fold.add(x, y), fold.sub(pc, x, y)),
                fold.sub(pc, fold.mul_small(fold.add(x, x), 3), y))
        ix, iy = ([(p + q) * (p - q) % m for p, q in zip(ix, iy)],
                  [(6 * p - q) % m for p, q in zip(ix, iy)])
    assert _port_ints(pc, x) == ix
    assert _port_ints(pc, y) == iy


def test_raw_comparisons():
    vals = [0, 1, (1 << 256) - 1, MODULI["P-256:fn"], MODULI["P-256:fn"] - 1]
    t = torch.from_numpy(ints_to_limbs(vals).astype(np.int64))
    c = MODULI["P-256:fn"]
    assert fold.lt_const(t, c).tolist() == [v < c for v in vals]
    assert fold.is_zero16(t).tolist() == [v == 0 for v in vals]
    s, carry = fold.add_const_carry(t, c)
    assert fold.tensor_to_ints(s) == [(v + c) % (1 << 256) for v in vals]
    assert carry.tolist() == [int(v + c >= 1 << 256) for v in vals]
    assert JCURVES["P-256"].fn.modulus == c
