"""The limb product as an exact matrix product — the plain twin of K5.

The port's counterpart of ``bdls_tpu/ops/mxu.py:mul_cols`` (the gen-3
engine: ``_split6`` ``:90``, ``_diag_host`` ``:68``, the exactness
asserts ``:105-108``) on the port's limb layout (:mod:`bdls_tpu_torch.ops.
fold`: up to 18 limbs of nominally 16 bits, each below 2^17 after
``mul``'s norm):

- **digits**: each limb splits into a low byte and a high part
  (``lo = v & 255``, ``hi = v >> 8``) at uniform 8-bit positions: 36
  digits an operand (``_split8``);
- **outer product**: one per-lane rank-1 product ``(B, 36, 1) x
  (B, 1, 36)``;
- **anti-diagonal contraction**: the digit columns ``scols[k] =
  sum_{t+u=k} sa[t]·sb[u]`` as ONE product with the constant 0/1
  selector ``(71, 1296)·(1296, B)`` (:func:`diag_matrix`), in float64;
- **recombination**: ``cols[k] = scols[2k] + 256·scols[2k+1]``, the
  16-bit-positioned columns that ``fold.mul`` reduces as it reduces the
  "vpu" engine's.

Exactness: a digit column sums at most 36 products of digits below
2^9 (lo < 2^8, hi < 2^9 for limbs < 2^17), below 2^24; float64 holds
integers to 2^53, and :func:`mul_cols` asserts both budgets from the
operands' bounds, as the reference does for f32.

The engine registers as ``fold.MUL_BACKENDS["mxu"]``; bound with
``fold.mul_backend("mxu")``, the plain twins of K1, K2, K7 and K8 run on
it unchanged. On the card K5 is ``csrc/mxu.cuh`` (8-bit digits of the
32-bit Montgomery words, the contraction as ``mma.sync`` tiles); both
give the exact product, so the field values, and the verdicts, agree.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from bdls_tpu_torch.ops import fold
from bdls_tpu_torch.ops.fold import FE, L_NORM, FoldCtx

S = 2 * L_NORM             # digits an operand (8-bit positions)
NCOLS = 2 * S - 1          # digit columns of the product
LO_MAX = (1 << 8) - 1      # a low digit is always 8 bits
# float64 holds every integer below 2^53 exactly
EXACT = 1 << 53


@functools.lru_cache(maxsize=None)
def diag_host() -> np.ndarray:
    """The ``(NCOLS, S·S)`` 0/1 anti-diagonal selector: row k picks every
    digit product (t, u) with t + u == k."""
    d = np.zeros((NCOLS, S, S), dtype=np.float64)
    for t in range(S):
        for u in range(S):
            d[t + u, t, u] = 1.0
    return d.reshape(NCOLS, S * S)


@functools.lru_cache(maxsize=None)
def diag_matrix(device: torch.device) -> torch.Tensor:
    return torch.as_tensor(diag_host(), device=device)


def _split8(v: torch.Tensor) -> torch.Tensor:
    """(L, B) limbs (L <= 18) -> (S, B) float64 digits at 8-bit positions
    (s[2j] = lo_j, s[2j+1] = hi_j), zero above the operand's limbs."""
    v = fold._pad_to(v, L_NORM)
    return torch.stack([v & LO_MAX, v >> 8], dim=1).reshape(
        (S,) + v.shape[1:]).to(torch.float64)


def digit_operands(x: FE, y: FE):
    """The contraction's two operands for normal ``x``, ``y``: the
    per-lane outer products ``(S·S, B)`` and the selector
    ``(NCOLS, S·S)`` (chip_smoke.py times one library product over
    them)."""
    sa, sb = _split8(x.v), _split8(y.v)
    outer = torch.bmm(sa.T[:, :, None], sb.T[:, None, :])     # (B, S, S)
    return diag_matrix(x.v.device), outer.reshape(-1, S * S).T


def mul_cols(ctx: FoldCtx, x: FE, y: FE):
    """``fold.MUL_BACKENDS`` engine: normal operands -> the product's
    16-bit-positioned columns ``(S, B)`` int64 and their exclusive limb
    bound."""
    dig_a = max(LO_MAX, (x.lb - 1) >> 8)
    dig_b = max(LO_MAX, (y.lb - 1) >> 8)
    # exactness budget: every digit column inside float64's integers, the
    # recombination lo + 256·hi inside int64
    lb_scols = S * dig_a * dig_b
    lb_cols = lb_scols * (LO_MAX + 2)
    assert lb_scols < EXACT, (x.lb, y.lb, lb_scols)
    assert lb_cols < 1 << 62, (x.lb, y.lb, lb_cols)
    assert x.v.shape[0] <= L_NORM and y.v.shape[0] <= L_NORM
    diag, outer = digit_operands(x, y)
    scols = (diag @ outer).to(torch.int64)                   # (NCOLS, B)
    pairs = torch.nn.functional.pad(scols, (0, 0, 0, 1)).reshape(
        (S, 2) + scols.shape[1:])
    return pairs[:, 0] + (pairs[:, 1] << 8), lb_cols + 1


fold.MUL_BACKENDS.setdefault("mxu", mul_cols)
