"""Gen-1 Montgomery field on 16-bit limbs — the plain twin of K4's field.

The port's counterpart of ``bdls_tpu/ops/mont.py`` (``mont_mul``
``:67``, ``mont_sqr`` ``:92``, ``mont_pow_fermat`` ``:133``,
``batch_inv`` ``:153``), the field of the reference's first kernel
generation (``kernel_field="mont16"``). The functions compute what the
reference's compute, value for value:

- **Representation**: limbs-first ``(16, B)`` int64 tensors of exact
  16-bit limbs (the wire layout of :mod:`bdls_tpu_torch.crypto.marshal`),
  values below the modulus unless a function says otherwise. int64 is the
  carrier because torch's ``uint32`` lacks ``+``, ``>>`` and comparisons
  on the CPU.
- **Montgomery form** ``a·R mod m`` with R = 2^256, the R of
  ``csrc/field.cuh``: the same words feed K4 (``csrc/mont16_group.cuh``).
- ``mont_mul`` is CIOS with lazy carries: each of the 16 rounds adds
  ``a_i·b`` and ``q·m`` to an int64 accumulator and shifts one limb out;
  the carries resolve once, at the end.
- Carries and borrows resolve without a serial ripple: parallel passes
  bring every limb to at most 2^16, then a carry-lookahead
  (:func:`_lookahead`) gives each limb its carry in from the last limb
  below it that does not propagate.

The constants come from :func:`bdls_tpu_torch.ops.fields.field_ctx`.
Plain tensor code: the tests hold it against the reference on the CPU,
``chip_smoke.py`` holds K4 against it on the card. It repeats the
arithmetic with many small tensor ops and is no yardstick of speed.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from bdls_tpu_torch.ops.fields import LIMB_BITS, NLIMBS, FieldCtx

MASK = (1 << LIMB_BITS) - 1
_I64 = torch.int64


@functools.lru_cache(maxsize=None)
def _col(limbs: tuple, device: torch.device) -> torch.Tensor:
    return torch.tensor(limbs, dtype=_I64, device=device)[:, None]


def bcast_const(limbs_np, like: torch.Tensor) -> torch.Tensor:
    """Host limb vector (n,) -> (n, 1) int64 column on ``like``'s device,
    broadcastable over B."""
    return _col(tuple(int(v) for v in limbs_np), like.device)


def _lookahead(gen: torch.Tensor, prop: torch.Tensor) -> torch.Tensor:
    """Carry (or borrow) into each of L + 1 positions, given per-limb
    generate and propagate flags ``(L, B)``: the carry into limb j is the
    generate flag of the last limb below j that does not propagate."""
    L = gen.shape[0]
    ar = torch.arange(L, device=gen.device)[:, None].expand_as(gen)
    last = torch.cummax(torch.where(prop, -1, ar), dim=0).values
    last = torch.cat([torch.full_like(last[:1], -1), last])   # below j
    picked = gen.gather(0, last[1:].clamp(min=0))
    carry = torch.where(last[1:] >= 0, picked, torch.zeros_like(picked))
    return torch.cat([torch.zeros_like(carry[:1]), carry]).to(_I64)


def _exact(v: torch.Tensor, lb: int, n_out: int) -> torch.Tensor:
    """Non-negative limbs ``(L, B)``, each below ``lb``, -> the same
    value as ``n_out`` exact 16-bit limbs (the value must fit)."""
    while lb > MASK + 2:
        v = torch.cat([v & MASK, torch.zeros_like(v[:1])]) + \
            torch.cat([torch.zeros_like(v[:1]), v >> LIMB_BITS])
        lb = MASK + 1 + ((lb - 1) >> LIMB_BITS)
    if v.shape[0] < n_out:
        v = torch.cat([v, v.new_zeros((n_out - v.shape[0],) + v.shape[1:])])
    v = v[:n_out]                       # limbs in [0, 2^16]
    carry = _lookahead(v > MASK, v == MASK)
    return (v + carry[:-1]) & MASK


def _sub_exact(a: torch.Tensor, b: torch.Tensor):
    """Exact limbs a - b (same length): (limbs mod 2^(16L), borrow out)."""
    d = a - b
    borrow = _lookahead(d < 0, d == 0)
    return (d - borrow[:-1]) & MASK, borrow[-1]


def _sub_if_geq(v: torch.Tensor, m_limbs) -> torch.Tensor:
    """Exact limbs (L >= 16, value < 2m) -> ``(16, B)``, m subtracted
    once when the value is at least m."""
    m = bcast_const(np.concatenate(
        [np.asarray(m_limbs), np.zeros(v.shape[0] - NLIMBS, np.uint32)]), v)
    diff, borrow = _sub_exact(v, m)
    return torch.where(borrow.bool()[None], v, diff)[:NLIMBS]


def mont_mul(ctx: FieldCtx, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """CIOS Montgomery product ``a·b·R^-1 mod m``, exact limbs. Needs
    a·b < m·R: any a < 2^256 with b < m (the reference's contract)."""
    a, b = torch.broadcast_tensors(a, b)
    m = bcast_const(ctx.m_limbs, a)
    n0 = int(ctx.n0)
    t = torch.zeros((NLIMBS + 1,) + a.shape[1:], dtype=_I64, device=a.device)
    for i in range(NLIMBS):
        t = t + torch.cat([a[i][None] * b, torch.zeros_like(t[:1])])
        q = ((t[0] & MASK) * n0) & MASK
        t = t + torch.cat([q[None] * m, torch.zeros_like(t[:1])])
        # t[0] is now 0 mod 2^16: shift one limb out
        t = torch.cat([(t[1] + (t[0] >> LIMB_BITS))[None], t[2:],
                       torch.zeros_like(t[:1])])
    # every limb of t is below 16 rounds of 2·2^32 plus shifted carries
    v = _exact(t, 1 << 38, NLIMBS + 1)
    return _sub_if_geq(v, ctx.m_limbs)


def mont_sqr(ctx: FieldCtx, a: torch.Tensor) -> torch.Tensor:
    return mont_mul(ctx, a, a)


def to_mont(ctx: FieldCtx, a: torch.Tensor) -> torch.Tensor:
    return mont_mul(ctx, a, bcast_const(ctx.r2_limbs, a))


def from_mont(ctx: FieldCtx, a: torch.Tensor) -> torch.Tensor:
    one = torch.zeros_like(a)
    one[0] = 1
    return mont_mul(ctx, a, one)


def mod_add(ctx: FieldCtx, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _sub_if_geq(_exact(a + b, 2 * MASK + 1, NLIMBS + 1), ctx.m_limbs)


def mod_sub(ctx: FieldCtx, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = torch.broadcast_tensors(a, b)
    diff, borrow = _sub_exact(a, b)
    # a borrow: add m back (mod 2^256 the carry cancels the borrow)
    back = diff + borrow[None] * bcast_const(ctx.m_limbs, a)
    return _exact(back, 2 * MASK + 1, NLIMBS)


def mont_pow_fermat(ctx: FieldCtx, a: torch.Tensor) -> torch.Tensor:
    """``a^(m-2)`` in Montgomery form: square-and-multiply over the 256
    bits of the public exponent, most significant first; ``a = 0`` maps
    to 0 ("no inverse")."""
    acc = bcast_const(ctx.one_mont, a).expand_as(a)
    for bit in ctx.inv_exp_bits:
        acc = mont_sqr(ctx, acc)
        if bit:
            acc = mont_mul(ctx, acc, a)
    return acc


mont_inv = mont_pow_fermat


def _scan(ctx: FieldCtx, v: torch.Tensor, one: torch.Tensor,
          reverse: bool = False) -> torch.Tensor:
    """Inclusive prefix (or suffix) products along the batch axis, log
    depth: lane i takes lane i - k's running product for k = 1, 2, 4 …"""
    if reverse:
        return _scan(ctx, v.flip(1), one).flip(1)
    k = 1
    while k < v.shape[1]:
        shifted = torch.cat([one.expand(-1, k), v[:, :-k]], dim=1)
        v = mont_mul(ctx, v, shifted)
        k *= 2
    return v


def batch_inv(ctx: FieldCtx, a: torch.Tensor) -> torch.Tensor:
    """Montgomery's batch inversion along the batch axis (the reference's
    ``mont.batch_inv``): prefix and suffix products, ONE Fermat inverse
    of the total, two products a lane. Montgomery form in and out; zero
    lanes map to zero, and are replaced by one in the products so they
    cannot spoil the other lanes."""
    one = bcast_const(ctx.one_mont, a)
    zero = is_zero(a)
    safe = select(zero, one.expand_as(a), a)
    pre = _scan(ctx, safe, one)
    suf = _scan(ctx, safe, one, reverse=True)
    inv_total = mont_pow_fermat(ctx, pre[:, -1:])
    pre_ex = torch.cat([one, pre[:, :-1]], dim=1)
    suf_ex = torch.cat([suf[:, 1:], one], dim=1)
    inv = mont_mul(ctx, mont_mul(ctx, pre_ex, suf_ex), inv_total)
    return select(zero, torch.zeros_like(a), inv)


def add_const_carry(a: torch.Tensor, c_limbs):
    """``a + const`` over 16 limbs: (sum mod 2^256, carry out (B,))."""
    v = _exact(a + bcast_const(c_limbs, a), 2 * MASK + 1, NLIMBS + 1)
    return v[:NLIMBS], v[NLIMBS]


def is_zero(a: torch.Tensor) -> torch.Tensor:
    """(16, B) -> (B,) bool."""
    return (a == 0).all(0)


def eq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a == b).all(0)


def select(mask: torch.Tensor, a: torch.Tensor, b: torch.Tensor):
    """Per-lane select: mask (B,) bool -> a else b."""
    return torch.where(mask[None], a, b)


def geq_const(a: torch.Tensor, m_limbs) -> torch.Tensor:
    """value(a) >= the constant? -> (B,) bool (a borrow chain)."""
    _, borrow = _sub_exact(a, bcast_const(m_limbs, a).expand_as(a))
    return borrow == 0


def reduce_once(ctx: FieldCtx, a: torch.Tensor) -> torch.Tensor:
    """A value < 2m (16 exact limbs) -> [0, m)."""
    return _sub_if_geq(a, ctx.m_limbs)
