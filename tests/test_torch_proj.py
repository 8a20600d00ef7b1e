"""Plain RCB point formulas of the port vs the JAX package's int oracle.

``bdls_tpu_torch.ops.proj`` over the batched plain field must give the
same projective coordinates, as integers mod p, as
``bdls_tpu/ops/proj.py`` run on its host ``IntField`` backend (the way
``tests/test_proj.py`` uses it): for random points, infinity, P = Q and
P = -Q. The formula sequences are deterministic, so X, Y and Z agree
exactly, not only up to scale.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from bdls_tpu.ops import proj as jproj
from bdls_tpu.ops.curves import CURVES as JCURVES
from bdls_tpu_torch.crypto.marshal import ints_to_limbs
from bdls_tpu_torch.crypto.sw import SwCSP
from bdls_tpu_torch.ops import fold, proj
from bdls_tpu_torch.ops.curves import CURVES

# the plain version runs many ops on tiny tensors: extra intra-op
# threads only contend with the other test workers
torch.set_num_threads(1)


def _points(name: str, rng) -> list[tuple[int, int, int]]:
    sw = SwCSP()
    p = CURVES[name].fp.modulus
    pts = []
    for _ in range(4):
        pub = sw.key_gen(name, rng).public_key()
        x, y = pub.x, pub.y
        z = int.from_bytes(rng.bytes(32), "big") % (p - 1) + 1
        pts.append((x * z % p, y * z % p, z))      # scaled projective
    return pts


def _batch(coords) -> list[fold.FE]:
    return [fold.from_limbs16(torch.from_numpy(
        ints_to_limbs([c[i] for c in coords]).astype(np.int64)))
        for i in range(3)]


@pytest.mark.parametrize("name", sorted(CURVES))
def test_add_and_dbl_match_int_oracle(name):
    curve, jcurve = CURVES[name], JCURVES[name]
    p = curve.fp.modulus
    rng = np.random.default_rng(11)
    pts = _points(name, rng)
    inf = (0, 1, 0)
    neg0 = (pts[0][0], (-pts[0][1]) % p, pts[0][2])
    pairs = [(a, b) for a in pts for b in pts]        # includes P = Q
    pairs += [(pts[0], neg0), (inf, pts[1]), (pts[1], inf), (inf, inf)]
    lhs, rhs = _batch([a for a, _ in pairs]), _batch([b for _, b in pairs])
    fpc = fold.fold_ctx(p)
    f = proj.TorchField(fpc, lhs[0].v)
    oracle = jproj.IntField(p)

    got = proj.point_add(f, curve, proj.Proj(*lhs), proj.Proj(*rhs))
    got = [fold.tensor_to_ints(fold.canon(fpc, c)) for c in got]
    want = [jproj.point_add(oracle, jcurve, jproj.Proj(*a), jproj.Proj(*b))
            for a, b in pairs]
    for i, w in enumerate(want):
        assert (got[0][i], got[1][i], got[2][i]) == tuple(w), pairs[i]

    singles = pts + [inf, neg0]
    sb = _batch(singles)
    got = proj.point_dbl(proj.TorchField(fpc, sb[0].v), curve, proj.Proj(*sb))
    got = [fold.tensor_to_ints(fold.canon(fpc, c)) for c in got]
    for i, a in enumerate(singles):
        w = jproj.point_dbl(oracle, jcurve, jproj.Proj(*a))
        assert (got[0][i], got[1][i], got[2][i]) == tuple(w), a
