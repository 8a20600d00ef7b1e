"""Complete projective point arithmetic (Renes–Costello–Batina 2015)
over the plain PyTorch field — the CUDA kernel's twin (csrc/point.cuh).

The formula sequences are those of ``bdls_tpu/ops/proj.py`` (add_a3/
dbl_a3 for P-256, add_a0/dbl_a0 for secp256k1), copied operation for
operation: one unconditional sequence that is right for every input on a
prime-order short-Weierstrass curve, with infinity = (0 : 1 : 0).

They are written over the reference's tiny field-ops protocol (``mul/
sqr/add/sub/mul_small/const``); :class:`TorchField` is the batched plain
backend over :mod:`bdls_tpu_torch.ops.fold`. The tests run the same
sequences against the reference's host ``IntField``.
"""

from __future__ import annotations

from typing import NamedTuple

from bdls_tpu_torch.ops import fold
from bdls_tpu_torch.ops.fold import FoldCtx


class Proj(NamedTuple):
    """Homogeneous projective point; infinity = (0 : 1 : 0)."""

    x: object
    y: object
    z: object


class TorchField:
    """Batched plain PyTorch backend over one FoldCtx; ``like`` (any
    ``(L, B)`` tensor) gives constants their batch width and device."""

    def __init__(self, ctx: FoldCtx, like):
        self.ctx = ctx
        self.like = like

    def mul(self, a, b):
        return fold.mul(self.ctx, a, b)

    def sqr(self, a):
        return fold.sqr(self.ctx, a)

    def add(self, a, b):
        return fold.add(a, b)

    def sub(self, a, b):
        return fold.sub(self.ctx, a, b)

    def mul_small(self, a, k):
        return fold.mul_small(a, k)

    def const(self, x, like=None):
        return fold.fe_const(self.ctx, x, self.like)


def add_a3(f, b: int, P: Proj, Q: Proj) -> Proj:
    """Complete addition, a = -3 (RCB Algorithm 4). 12M + 29a."""
    X1, Y1, Z1 = P
    X2, Y2, Z2 = Q
    t0 = f.mul(X1, X2)
    t1 = f.mul(Y1, Y2)
    t2 = f.mul(Z1, Z2)
    t3 = f.add(X1, Y1)
    t4 = f.add(X2, Y2)
    t3 = f.mul(t3, t4)
    t4 = f.add(t0, t1)
    t3 = f.sub(t3, t4)
    t4 = f.add(Y1, Z1)
    t5 = f.add(Y2, Z2)
    t4 = f.mul(t4, t5)
    t5 = f.add(t1, t2)
    t4 = f.sub(t4, t5)
    X3 = f.add(X1, Z1)
    Y3 = f.add(X2, Z2)
    X3 = f.mul(X3, Y3)
    Y3 = f.add(t0, t2)
    Y3 = f.sub(X3, Y3)
    bc = f.const(b)
    Z3 = f.mul(bc, t2)
    X3 = f.sub(Y3, Z3)
    Z3 = f.add(X3, X3)
    X3 = f.add(X3, Z3)
    Z3 = f.sub(t1, X3)
    X3 = f.add(t1, X3)
    Y3 = f.mul(bc, Y3)
    t1 = f.add(t2, t2)
    t2 = f.add(t1, t2)
    Y3 = f.sub(Y3, t2)
    Y3 = f.sub(Y3, t0)
    t1 = f.add(Y3, Y3)
    Y3 = f.add(t1, Y3)
    t1 = f.add(t0, t0)
    t0 = f.add(t1, t0)
    t0 = f.sub(t0, t2)
    t1 = f.mul(t4, Y3)
    t2 = f.mul(t0, Y3)
    Y3 = f.mul(X3, Z3)
    Y3 = f.add(Y3, t2)
    X3 = f.mul(t3, X3)
    X3 = f.sub(X3, t1)
    Z3 = f.mul(t4, Z3)
    t1 = f.mul(t3, t0)
    Z3 = f.add(Z3, t1)
    return Proj(X3, Y3, Z3)


def dbl_a3(f, b: int, P: Proj) -> Proj:
    """Complete doubling, a = -3 (RCB Algorithm 6). 8M + 3S + 21a."""
    X, Y, Z = P
    t0 = f.sqr(X)
    t1 = f.sqr(Y)
    t2 = f.sqr(Z)
    t3 = f.mul(X, Y)
    t3 = f.add(t3, t3)
    Z3 = f.mul(X, Z)
    Z3 = f.add(Z3, Z3)
    bc = f.const(b)
    Y3 = f.mul(bc, t2)
    Y3 = f.sub(Y3, Z3)
    X3 = f.add(Y3, Y3)
    Y3 = f.add(X3, Y3)
    X3 = f.sub(t1, Y3)
    Y3 = f.add(t1, Y3)
    Y3 = f.mul(X3, Y3)
    X3 = f.mul(X3, t3)
    t3 = f.add(t2, t2)
    t2 = f.add(t2, t3)
    Z3 = f.mul(bc, Z3)
    Z3 = f.sub(Z3, t2)
    Z3 = f.sub(Z3, t0)
    t3 = f.add(Z3, Z3)
    Z3 = f.add(Z3, t3)
    t3 = f.add(t0, t0)
    t0 = f.add(t3, t0)
    t0 = f.sub(t0, t2)
    t0 = f.mul(t0, Z3)
    Y3 = f.add(Y3, t0)
    t0 = f.mul(Y, Z)
    t0 = f.add(t0, t0)
    Z3 = f.mul(t0, Z3)
    X3 = f.sub(X3, Z3)
    Z3 = f.mul(t0, t1)
    Z3 = f.add(Z3, Z3)
    Z3 = f.add(Z3, Z3)
    return Proj(X3, Y3, Z3)


def add_a0(f, b: int, P: Proj, Q: Proj) -> Proj:
    """Complete addition, a = 0 (RCB Algorithm 7). 12M + 19a, b3 = 3b."""
    X1, Y1, Z1 = P
    X2, Y2, Z2 = Q
    b3 = f.const(3 * b)
    t0 = f.mul(X1, X2)
    t1 = f.mul(Y1, Y2)
    t2 = f.mul(Z1, Z2)
    t3 = f.add(X1, Y1)
    t4 = f.add(X2, Y2)
    t3 = f.mul(t3, t4)
    t4 = f.add(t0, t1)
    t3 = f.sub(t3, t4)
    t4 = f.add(Y1, Z1)
    X3 = f.add(Y2, Z2)
    t4 = f.mul(t4, X3)
    X3 = f.add(t1, t2)
    t4 = f.sub(t4, X3)
    X3 = f.add(X1, Z1)
    Y3 = f.add(X2, Z2)
    X3 = f.mul(X3, Y3)
    Y3 = f.add(t0, t2)
    Y3 = f.sub(X3, Y3)
    X3 = f.add(t0, t0)
    t0 = f.add(X3, t0)
    t2 = f.mul(b3, t2)
    Z3 = f.add(t1, t2)
    t1 = f.sub(t1, t2)
    Y3 = f.mul(b3, Y3)
    X3 = f.mul(t4, Y3)
    t2 = f.mul(t3, t1)
    X3 = f.sub(t2, X3)
    Y3 = f.mul(Y3, t0)
    t1 = f.mul(t1, Z3)
    Y3 = f.add(t1, Y3)
    t0 = f.mul(t0, t3)
    Z3 = f.mul(Z3, t4)
    Z3 = f.add(Z3, t0)
    return Proj(X3, Y3, Z3)


def dbl_a0(f, b: int, P: Proj) -> Proj:
    """Complete doubling, a = 0 (RCB Algorithm 9). 6M + 2S + 9a."""
    X, Y, Z = P
    b3 = f.const(3 * b)
    t0 = f.sqr(Y)
    Z3 = f.add(t0, t0)
    Z3 = f.add(Z3, Z3)
    Z3 = f.add(Z3, Z3)
    t1 = f.mul(Y, Z)
    t2 = f.sqr(Z)
    t2 = f.mul(b3, t2)
    X3 = f.mul(t2, Z3)
    Y3 = f.add(t0, t2)
    Z3 = f.mul(t1, Z3)
    t1 = f.add(t2, t2)
    t2 = f.add(t1, t2)
    t0 = f.sub(t0, t2)
    Y3 = f.mul(t0, Y3)
    Y3 = f.add(X3, Y3)
    t1 = f.mul(X, Y)
    X3 = f.mul(t0, t1)
    X3 = f.add(X3, X3)
    return Proj(X3, Y3, Z3)


def point_add(f, curve, P: Proj, Q: Proj) -> Proj:
    if curve.a_kind == "minus3":
        return add_a3(f, curve.b, P, Q)
    if curve.a_kind == "zero":
        return add_a0(f, curve.b, P, Q)
    raise NotImplementedError(f"a kind {curve.a_kind}")


def point_dbl(f, curve, P: Proj) -> Proj:
    if curve.a_kind == "minus3":
        return dbl_a3(f, curve.b, P)
    if curve.a_kind == "zero":
        return dbl_a0(f, curve.b, P)
    raise NotImplementedError(f"a kind {curve.a_kind}")
