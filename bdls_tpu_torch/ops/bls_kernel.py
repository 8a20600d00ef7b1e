"""Batched BLS12-381 certificate check: K9's and K11's launch wrappers
and their plain PyTorch twins — the port of ``bdls_tpu/ops/bls_kernel.py``.

The check is the reference's: e(g1, sig) == e(pk, H(m)) as
FE(n1·d2) == FE(n2·d1) with FE(n1·d2) != 0, where (n, d) is the
inversion-free Miller loop ``miller_nd``. FE is one of two final
exponentiations, as in the reference:

- the full exponent (p^12 - 1)/r by square-and-multiply
  (:func:`final_exp`, the reference's ``final_exp``), composed by
  :func:`verify_pipeline` (the reference's ``verify_pipeline``, the
  ``"kernel"`` backend);
- the x-chain ``_compose_fe_fast`` (:func:`final_exp_fast`), whose value
  is the cube of the full exponent's (same verdict, gcd(3, r) = 1),
  composed by :func:`verify_pipeline_fast` (the reference's
  ``verify_pipeline_fast``, the ``"kernel-fast"`` backend and the
  port's default).

Every value equals the reference's after canonicalisation, stage for
stage; the one change is the inverse in the x-chain's easy part, taken a
lane at a time through the norm (:func:`f12_inv`) where the reference
inverts across lanes. K11 reaches the full exponent's value by another
route than its twin's square-and-multiply: the exact x-chain
((p^4 - p^2 + 1)/r = (x-1)²/3·(x+p)·(x²+p²-1) + 1) with cyclotomic
squares, a warp a side; only its values, not its stages, are the
reference's.

- **Layout.** Every FQ12 array at the boundary is ``(12, 12, B)``:
  12 little-endian 32-bit words (canonical, or any value below 2^384,
  read mod p), 12 coefficients of the reference's basis
  Fp[w]/(w^12 - 2w^6 + 2), B lanes. :func:`pt_batch` packs host points,
  :func:`from_reference_lanes` the reference's ``(34, 12, B)`` 12-bit
  limb arrays.
- **The twins** run the same sequence over :mod:`bdls_tpu_torch.ops.
  fp381`: an FQ12 product takes the limb products of the 144
  coefficient pairs in one batch, the convolution and the reduction by
  w^12 = 2w^6 - 2 on unreduced columns, then one reduction mod p a
  coefficient; Frobenius is a constant 12 × 12 matrix; the point
  formulas are :mod:`bdls_tpu_torch.ops.proj`'s ``add_a0``/``dbl_a0``
  over an FQ12 field.
- **The kernels** (``csrc/bls.cu``): K9 is ``bdls_bls_miller`` over the
  2B (Q, P) pairs, a warp a pair (the twisted form in the Fp2 tower,
  any other pair by the dense formulas, in the same launch), and
  ``bdls_bls_final`` (the x-chain) over the B lanes; K11 is
  ``bdls_bls_final_full`` (the full exponent by the exact x-chain),
  launched after the same Miller launch. Both final launches run a warp
  a side over one body, their Frobenius maps the sparse entries of
  :func:`frob_sparse_host`. :data:`LAUNCHES_BLS` counts the three. The
  wrappers take CUDA tensors and launch, or raise; the plain twins run
  only for tensors on the CPU.
- :func:`verify_certificates` is the certificate path: ``"kernel"`` and
  ``"kernel-fast"`` (the default, see :func:`resolve_backend`) pack the
  certificates with :func:`bdls_tpu_torch.consensus.threshold.
  certificate_lanes` and run their pipeline; ``"host"`` runs the copied
  oracle.
"""

from __future__ import annotations

import functools
import os

import numpy as np
import torch

from bdls_tpu_torch.ops import _build
from bdls_tpu_torch.ops import bls_host as H
from bdls_tpu_torch.ops import fp381 as F
from bdls_tpu_torch.ops.fp381 import FP
from bdls_tpu_torch.ops.proj import Proj, add_a0, dbl_a0
from bdls_tpu_torch.utils.device import DeviceLike, resolve_device

DEG = 12
BACKENDS = ("kernel", "kernel-fast", "host")
LAUNCHES_BLS = {"miller": 0, "final": 0, "final_full": 0}
_I64 = torch.int64


def reset_launches() -> None:
    """Set K9's and K11's launch counts to 0."""
    with _build.count_lock:
        for k in LAUNCHES_BLS:
            LAUNCHES_BLS[k] = 0


# ---- host constants -------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _reduce_maps() -> tuple[np.ndarray, np.ndarray]:
    """(23 -> 12) integer map reducing a convolution by
    w^12 = 2w^6 - 2, split into its positive and negative parts (the
    reference's ``_poly_reduce_maps`` before its pair placement)."""
    red = np.zeros((2 * DEG - 1, DEG), dtype=np.int64)
    for d in range(2 * DEG - 1):
        vec = np.zeros(2 * DEG - 1, dtype=np.int64)
        vec[d] = 1
        for k in range(2 * DEG - 2, DEG - 1, -1):
            if vec[k]:
                c = vec[k]
                vec[k] = 0
                vec[k - 6] += 2 * c
                vec[k - 12] -= 2 * c
        red[d] = vec[:DEG]
    return np.maximum(red, 0), np.maximum(-red, 0)


@functools.lru_cache(maxsize=None)
def fe_bits() -> np.ndarray:
    """The bits of the full final exponent (p^12 - 1)/r, most significant
    first (the first is the leading one), one uint8 each: the
    reference's ``_fe_bits``."""
    e = (H.P ** 12 - 1) // H.R
    return np.frombuffer(bin(e)[2:].encode(), dtype=np.uint8) - ord("0")


@functools.lru_cache(maxsize=None)
def miller_bits() -> tuple[int, ...]:
    """|x|'s bits below the leading one, most significant first."""
    return tuple(int(c) for c in bin(H.ATE_LOOP)[3:])


@functools.lru_cache(maxsize=None)
def frob_matrix(k: int) -> tuple[tuple[int, ...], ...]:
    """M with frob^k(Σ c_i w^i) = Σ_j (Σ_i c_i·M[i][j]) w^j: row i holds
    the coefficients of (w^(p^k))^i (the reference's ``_frob_matrix``,
    as integers)."""
    wpk = H.FQ12([0, 1] + [0] * 10).pow(H.P ** k)
    rows, acc = [], H.FQ12.one()
    for _ in range(DEG):
        rows.append(tuple(acc.c))
        acc = acc * wpk
    return tuple(rows)


FROB_KS = (1, 2, 6)


@functools.lru_cache(maxsize=None)
def frob_table_host() -> np.ndarray:
    """The dense Frobenius tables of ``csrc/bls12.cuh``'s one-thread
    operations (the host tests' yardstick): (3, 12, 12, 12) uint32,
    k = 1, 2, 6, each entry M[i][j]·2^384 mod p (Montgomery form) as 12
    words."""
    out = np.zeros((len(FROB_KS), DEG, DEG, 12), dtype=np.uint32)
    for n, k in enumerate(FROB_KS):
        for i, row in enumerate(frob_matrix(k)):
            for j, c in enumerate(row):
                out[n, i, j] = int_to_words((c << 384) % H.P)
    return out


# the final launches' sparse Frobenius maps, k: the nonzero entries of
# frob^k (``csrc/bls12.cuh``: FROB1_NNZ, FROB2_NNZ)
FROB_NNZ = {1: 19, 2: 12}


@functools.lru_cache(maxsize=None)
def frob_sparse_host() -> np.ndarray:
    """The final launches' Frobenius table: the nonzero entries of
    frob^1, then of frob^2, by column, as (31, 14) uint32 rows (i, j,
    then M[i][j]·2^384 mod p as 12 words)."""
    rows = []
    for k, nnz in FROB_NNZ.items():
        m = frob_matrix(k)
        ents = [(i, j) for j in range(DEG) for i in range(DEG) if m[i][j]]
        if len(ents) != nnz:
            raise AssertionError(f"frob^{k} has {len(ents)} nonzero "
                                 f"entries, the kernel takes {nnz}")
        rows += [np.concatenate([[i, j], int_to_words(
            (m[i][j] << 384) % H.P)]).astype(np.uint32) for i, j in ents]
    return np.stack(rows)


@functools.lru_cache(maxsize=None)
def frob_sparse(device: torch.device) -> torch.Tensor:
    return _build.as_int32(frob_sparse_host(), device)


# ---- layouts --------------------------------------------------------------

def int_to_words(x: int) -> np.ndarray:
    return np.frombuffer(int(x).to_bytes(48, "little"), dtype="<u4").copy()


def f12_words(elts) -> np.ndarray:
    """[B] FQ12 values (anything whose ``.c`` is 12 ints in
    [0, 2^384)) -> (12, 12, B) uint32 words."""
    buf = b"".join(int(c).to_bytes(48, "little") for e in elts for c in e.c)
    arr = np.frombuffer(buf, dtype="<u4").reshape(len(elts), DEG, 12)
    return np.ascontiguousarray(arr.transpose(2, 1, 0))


def pt_batch(points) -> tuple[np.ndarray, np.ndarray]:
    """[B] affine points (pairs of FQ12 values) -> (x, y) words."""
    return (f12_words([p[0] for p in points]),
            f12_words([p[1] for p in points]))


def from_reference_lanes(arr) -> np.ndarray:
    """The reference's (34, 12, B) 12-bit limb array (``pt_batch``,
    ``certificate_lanes``) -> the port's (12, 12, B) uint32 words."""
    a = np.asarray(arr).astype(np.uint64)
    if a.ndim != 3 or a.shape[:2] != (34, DEG):
        raise ValueError(f"want (34, 12, B) limbs, got {a.shape}")
    bits = (a[:, None] >> np.arange(12, dtype=np.uint64)[None, :, None, None]
            ) & np.uint64(1)
    bits = bits.reshape((34 * 12,) + a.shape[1:])
    if bits[384:].any():
        raise ValueError("a coefficient at or above 2^384")
    words = (bits[:384].reshape((12, 32) + a.shape[1:])
             << np.arange(32, dtype=np.uint64)[None, :, None, None]).sum(1)
    return words.astype(np.uint32)


def words_to_ints(w) -> list[list[int]]:
    """(12, 12, B) words -> [12][B] ints."""
    a = np.asarray(w.cpu() if isinstance(w, torch.Tensor) else w)
    a = a.astype(np.int64) & 0xFFFFFFFF
    return [[sum(int(a[k, d, b]) << (32 * k) for k in range(12))
             for b in range(a.shape[2])] for d in range(DEG)]


# ---- FQ12, plain: an FP whose limbs are (L, 12, B) -------------------------

f12_from_words = F.from_words         # (12, 12, B) words -> (24, 12, B)
f12_to_words = F.to_words             # -> (12, 12, B) canonical words


def f12_from_ints(coeff_batches, device=None) -> FP:
    """[12][B] python ints -> (24, 12, B) limbs."""
    arr = np.stack([np.stack([F.int_to_limbs(int(x) % H.P) for x in row],
                             axis=1) for row in coeff_batches], axis=1)
    return FP(torch.as_tensor(arr, dtype=_I64, device=device),
              1 << F.RADIX)


def f12_to_ints(x: FP) -> list[list[int]]:
    """-> [12][B] ints (canonical)."""
    return words_to_ints(f12_to_words(x))


def f12_batch_from_oracle(elts) -> list[list[int]]:
    """[B] oracle FQ12 -> coefficient lists for :func:`f12_from_ints`."""
    return [[e.c[d] for e in elts] for d in range(DEG)]


def f12_scalar(x: int, like: torch.Tensor) -> FP:
    """x in coefficient 0, broadcast to ``like``'s (L, 12, *batch)."""
    col = np.zeros((F.N16, DEG), dtype=np.int64)
    col[:, 0] = F.int_to_limbs(x % H.P)
    v = torch.as_tensor(col, device=like.device)
    v = v.reshape((F.N16, DEG) + (1,) * (like.dim() - 2))
    return FP(v.expand((F.N16, DEG) + tuple(like.shape[2:])), 1 << F.RADIX)


def f12_one(like: torch.Tensor) -> FP:
    return f12_scalar(1, like)


f12_add = F.add
f12_sub = F.sub
f12_norm = F.norm


@functools.lru_cache(maxsize=None)
def _conv_consts(device: torch.device):
    idx = torch.as_tensor([i + j for i in range(DEG) for j in range(DEG)],
                          dtype=_I64, device=device)
    sp, sn = (torch.as_tensor(m, device=device) for m in _reduce_maps())
    return idx, sp, sn, int(_reduce_maps()[0].sum(0).max()), \
        int(_reduce_maps()[1].sum(0).max())


def _pairs(x: FP, y: FP):
    """The 144 coefficient pairs (i, j) -> i·12 + j, as two (L, 144, *B)
    operands."""
    bshape = tuple(x.v.shape[2:])
    a = x.v[:, :, None].expand((x.v.shape[0], DEG, DEG) + bshape)
    b = y.v[:, None, :].expand((y.v.shape[0], DEG, DEG) + bshape)
    return (FP(a.reshape((x.v.shape[0], DEG * DEG) + bshape), x.lb),
            FP(b.reshape((y.v.shape[0], DEG * DEG) + bshape), y.lb))


def f12_mul(x: FP, y: FP) -> FP:
    """The limb products of the 144 coefficient pairs in one batch, the
    convolution over the coefficients and the reduction by
    w^12 = 2w^6 - 2, all on unreduced columns; then one reduction mod p
    a coefficient."""
    x, y = F.norm(x), F.norm(y)
    prod = F.mul_cols(*_pairs(x, y))                # (2L - 1, 144, *B)
    idx, sp, sn, wpos, wneg = _conv_consts(prod.v.device)
    v = prod.v
    conv = v.new_zeros((v.shape[0], 2 * DEG - 1) + tuple(v.shape[2:]))
    conv.index_add_(1, idx, v)
    lb = DEG * (prod.lb - 1) + 1
    ext = (1,) * (v.dim() - 2)
    c = conv[:, :, None]
    pos = (c * sp.reshape((1,) + sp.shape + ext)).sum(1)
    neg = (c * sn.reshape((1,) + sn.shape + ext)).sum(1)
    return F.sub(FP(pos, (lb - 1) * wpos + 1), FP(neg, (lb - 1) * wneg + 1))


def f12_sqr(x: FP) -> FP:
    return f12_mul(x, x)


@functools.lru_cache(maxsize=None)
def _frob_limbs(k: int, device: torch.device) -> torch.Tensor:
    """(24, 144) limbs of M[i][j] at pair i·12 + j."""
    cols = [F.int_to_limbs(c) for row in frob_matrix(k) for c in row]
    return torch.as_tensor(np.stack(cols, axis=1), dtype=_I64,
                           device=device)


def f12_frob(x: FP, k: int) -> FP:
    """Frobenius^k: the limb products against the constant matrix, a
    sum over the input coefficients, one reduction a coefficient."""
    x = F.norm(x)
    bshape = tuple(x.v.shape[2:])
    a = x.v[:, :, None].expand((x.v.shape[0], DEG, DEG) + bshape)
    m = _frob_limbs(k, x.v.device)
    m = m.reshape(m.shape + (1,) * len(bshape)).expand(m.shape + bshape)
    prod = F.mul_cols(
        FP(a.reshape((x.v.shape[0], DEG * DEG) + bshape), x.lb),
        FP(m, 1 << F.RADIX))
    v = prod.v.reshape((prod.v.shape[0], DEG, DEG) + bshape).sum(1)
    return F.norm(FP(v, DEG * (prod.lb - 1) + 1))


def f12_conj(x: FP) -> FP:
    """The inverse of a unitary element (after the easy part): frob^6."""
    return f12_frob(x, 6)


def f12_inv(x: FP) -> FP:
    """a^-1 = (a^p · ... · a^(p^11)) · N(a)^-1, N(a) = a·a^p·...·a^(p^11)
    in Fp, a lane at a time (zero -> zero): 11 Frobenius maps, 11
    products and one Fp inverse."""
    t = f12_frob(x, 1)
    prod = t
    for _ in range(10):
        t = f12_frob(t, 1)
        prod = f12_mul(prod, t)
    nrm = f12_mul(x, prod)
    ninv = F.inv(FP(nrm.v[:, 0], nrm.lb))          # (L, *B)
    prod = F.norm(prod)
    ninv = FP(ninv.v[:, None].expand((ninv.v.shape[0],) + prod.v.shape[1:]),
              ninv.lb)
    return F.mul(prod, ninv)


class F12Field:
    """:mod:`bdls_tpu_torch.ops.proj`'s field-ops protocol over batched
    FQ12."""

    def __init__(self, like: torch.Tensor):
        self.like = like

    def mul(self, a, b):
        return f12_mul(a, b)

    def sqr(self, a):
        return f12_sqr(a)

    def add(self, a, b):
        return f12_add(a, b)

    def sub(self, a, b):
        return f12_sub(a, b)

    def mul_small(self, a, k):
        return F.mul_small(a, k)

    def const(self, x, like=None):
        return f12_scalar(x, self.like)


BLS_B = 4                     # E: y^2 = x^3 + 4 (G1 and the untwisted G2)


# ---- Miller loop (inversion-free, num/den) ---------------------------------

def miller_nd(Qx: FP, Qy: FP, Px: FP, Py: FP) -> tuple[FP, FP]:
    """f_{|x|,Q}(P) as (numerator, denominator), Q and P affine FQ12
    batched: the reference's step, with the chord and the add taken only
    where the (public) bit is set."""
    like = Qx.v
    f = F12Field(like)
    one = f12_one(like)
    T = Proj(Qx, Qy, one)
    fn, fd = one, one
    for bit in miller_bits():
        X, Y, Z = T
        A = f.mul_small(f.sqr(X), 3)                  # 3X²
        C = f.mul_small(f.mul(Y, Z), 2)               # 2YZ
        l_num = f12_sub(f12_mul(A, f12_sub(f12_mul(Px, Z), X)),
                        f12_mul(C, f12_sub(f12_mul(Py, Z), Y)))
        l_den = f12_mul(C, Z)
        fn = f12_mul(f12_sqr(fn), l_num)
        fd = f12_mul(f12_sqr(fd), l_den)
        T = dbl_a0(f, BLS_B, T)
        if bit:
            X2, Y2, Z2 = T
            t1 = f12_sub(f12_mul(Qy, Z2), Y2)
            t2 = f12_sub(f12_mul(Qx, Z2), X2)
            a_num = f12_sub(f12_mul(t1, f12_sub(Px, Qx)),
                            f12_mul(t2, f12_sub(Py, Qy)))
            fn = f12_mul(fn, a_num)
            fd = f12_mul(fd, t2)
            T = add_a0(f, BLS_B, T, Proj(Qx, Qy, one))
        T = Proj(*(f12_norm(c) for c in T))
        fn, fd = f12_norm(fn), f12_norm(fd)
    return fn, fd


# ---- the x-chain final exponentiation --------------------------------------

def _pow_abs_x(m: FP) -> FP:
    """m^|x| by square-and-multiply over the loop bits."""
    acc = m
    for bit in miller_bits():
        acc = f12_sqr(acc)
        if bit:
            acc = f12_mul(acc, m)
    return acc


def _stage_easy(f: FP, inv: FP) -> FP:
    m1 = f12_mul(f12_frob(f, 6), inv)
    return f12_mul(f12_frob(m1, 2), m1)               # unitary


def _stage_pow_x_conj_mul(m: FP, e: FP) -> FP:
    """conj(m^|x| · e): m^(x-1) when e = m; m^x when e = 1."""
    return f12_conj(f12_mul(_pow_abs_x(m), e))


def _stage_x_plus_p(a: FP) -> FP:
    """conj(a^|x|) · frob¹(a) = a^(x+p)."""
    return f12_mul(f12_conj(_pow_abs_x(a)), f12_frob(a, 1))


def _stage_hard_tail(t3x: FP, t3: FP, m: FP) -> FP:
    """t3^(x²+p²-1) · m³ from t3^(x²), t3 and m."""
    t4 = f12_mul(f12_mul(t3x, f12_frob(t3, 2)), f12_conj(t3))
    return f12_mul(t4, f12_mul(f12_sqr(m), m))


def final_exp_fast(f: FP) -> FP:
    """f^(3(p^12-1)/r) by the BLS12 x-chain of ``_compose_fe_fast``:
    3H = (x-1)²·(x+p)·(x²+p²-1) + 3 after the easy part."""
    one = f12_one(f.v)
    m = _stage_easy(f, f12_inv(f))
    t1 = _stage_pow_x_conj_mul(m, m)                  # m^(x-1)
    t2 = _stage_pow_x_conj_mul(t1, t1)                # m^((x-1)^2)
    t3 = _stage_x_plus_p(t2)                          # ^(x+p)
    t3x1 = _stage_pow_x_conj_mul(t3, one)             # t3^x
    t3x2 = _stage_pow_x_conj_mul(t3x1, one)           # t3^(x^2)
    return f12_norm(_stage_hard_tail(t3x2, t3, m))


def final_exp(x: FP) -> FP:
    """x^((p^12-1)/r) by square-and-multiply over :func:`fe_bits`,
    starting from x for the leading one: the reference's ``final_exp``
    (its value is :func:`final_exp_fast`'s cube root). The product is
    taken only where a bit is set (the bits are public)."""
    x = f12_norm(x)
    acc = x
    for bit in fe_bits()[1:]:
        acc = f12_sqr(acc)
        if bit:
            acc = f12_mul(acc, x)
    return f12_norm(acc)


def _compare_tail(lhs: FP, rhs: FP) -> torch.Tensor:
    """diff == 0 AND lhs != 0 (the zero-collapse guard), with one
    canonicalisation of both."""
    diff = F.norm(f12_sub(lhs, rhs))
    lhs = F.norm(lhs)
    n = max(diff.v.shape[0], lhs.v.shape[0])
    both = torch.cat([F._pad_to(diff.v, n), F._pad_to(lhs.v, n)], dim=1)
    can = F.canon(FP(both, max(diff.lb, lhs.lb)))    # (24, 24, *B)
    equal = (can[:, :DEG] == 0).all(0).all(0)
    lhs_nonzero = ~(can[:, DEG:] == 0).all(0).all(0)
    return equal & lhs_nonzero


def miller_products(g1x, g1y, sigx, sigy, pkx, pky, hmx, hmy) -> FP:
    """Both Miller loops of B lanes as one 2B-lane batch, then the
    products the final exponentiation takes: n1·d2 in lanes 0..B-1,
    n2·d1 in lanes B..2B-1 (the reference's ``fe_prod`` inputs)."""
    B = sigx.shape[-1]
    pair = [f12_from_words(torch.cat([a, b], dim=-1))
            for a, b in ((sigx, hmx), (sigy, hmy), (g1x, pkx), (g1y, pky))]
    n, d = miller_nd(*pair)
    return f12_mul(
        FP(n.v, n.lb),
        FP(torch.cat([d.v[..., B:], d.v[..., :B]], dim=-1), d.lb))


def _compare_sides(fe: FP) -> torch.Tensor:
    """The verdicts from the 2B final exponentiations (lhs first)."""
    B = fe.v.shape[-1] // 2
    return _compare_tail(FP(fe.v[..., :B], fe.lb), FP(fe.v[..., B:], fe.lb))


def verify_kernel(g1x, g1y, sigx, sigy, pkx, pky, hmx, hmy) -> torch.Tensor:
    """The plain twin of K9: eight (12, 12, B) word tensors -> (B,) bool,
    through the x-chain. Both Miller loops run as one 2B-lane batch, both
    final exponentiations as another."""
    return _compare_sides(final_exp_fast(miller_products(
        g1x, g1y, sigx, sigy, pkx, pky, hmx, hmy)))


def verify_kernel_full(g1x, g1y, sigx, sigy, pkx, pky, hmx, hmy
                       ) -> torch.Tensor:
    """The plain twin of K9's Miller launch + K11: as
    :func:`verify_kernel`, through the full exponent
    (:func:`final_exp`)."""
    return _compare_sides(final_exp(miller_products(
        g1x, g1y, sigx, sigy, pkx, pky, hmx, hmy)))


# ---- K9 launches ------------------------------------------------------------

def _check_f12(arrs, n: int, what: str) -> None:
    dev = arrs[0].device
    for a in arrs:
        if (a.device != dev or a.dtype != torch.int32
                or tuple(a.shape) != (12, DEG, n) or not a.is_contiguous()):
            raise ValueError(f"{what} takes contiguous (12, 12, {n}) int32 "
                             "tensors on one CUDA device")
    if dev.type != "cuda":
        raise ValueError(f"{what} launches K9: its tensors must be on a "
                         "CUDA device")


def miller_cuda(qx, qy, px, py) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch ``bdls_bls_miller`` over N (Q, P) pairs, four contiguous
    (12, 12, N) int32 CUDA tensors, a block of one warp a pair; returns
    (n, d), canonical words, not yet synchronised."""
    N = qx.shape[-1]
    _check_f12((qx, qy, px, py), N, "miller_cuda")
    dev = qx.device
    n = torch.empty((12, DEG, N), dtype=torch.int32, device=dev)
    d = torch.empty_like(n)
    lib = _build.lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.bdls_bls_miller(qx.data_ptr(), qy.data_ptr(), px.data_ptr(),
                                 py.data_ptr(), n.data_ptr(), d.data_ptr(),
                                 N, stream)
    _build.check(rc, f"bdls_bls_miller(N={N})")
    with _build.count_lock:
        LAUNCHES_BLS["miller"] += 1
    return n, d


def _final_launch(n, d, kernel: str) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch ``bdls_bls_<kernel>`` (``"final"`` or ``"final_full"``)
    over the 2B Miller outputs and count it."""
    N = n.shape[-1]
    if N % 2:
        raise ValueError(f"{kernel}_cuda takes the 2B Miller outputs")
    _check_f12((n, d), N, f"{kernel}_cuda")
    dev = n.device
    B = N // 2
    frob = frob_sparse(dev)
    fe = torch.empty_like(n)
    out = torch.empty(B, dtype=torch.uint8, device=dev)
    entry = f"bdls_bls_{kernel}"
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = getattr(_build.lib(), entry)(
            n.data_ptr(), d.data_ptr(), frob.data_ptr(), fe.data_ptr(),
            out.data_ptr(), B, stream)
    _build.check(rc, f"{entry}(B={B})")
    with _build.count_lock:
        LAUNCHES_BLS[kernel] += 1
    return out.view(torch.bool), fe


def final_cuda(n, d) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch ``bdls_bls_final`` over the 2B Miller outputs (lanes
    0..B-1 the (sig, g1) pairs, B..2B-1 the (H(m), pk) pairs; a block of
    two warps a lane, the x-chain); returns the (B,) bool verdict and the
    (12, 12, 2B) final exponentiations (FE(n1·d2) at column 2b,
    FE(n2·d1) at 2b + 1), not yet synchronised."""
    return _final_launch(n, d, "final")


def final_full_cuda(n, d) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch K11, ``bdls_bls_final_full``, over the 2B Miller outputs
    (as :func:`final_cuda`, the full exponent): the (B,) bool verdict and
    the (12, 12, 2B) full final exponentiations, not yet
    synchronised."""
    return _final_launch(n, d, "final_full")


def _miller_launch(args) -> tuple[torch.Tensor, torch.Tensor]:
    g1x, g1y, sigx, sigy, pkx, pky, hmx, hmy = args
    q = [torch.cat([a, b], dim=-1) for a, b in ((sigx, hmx), (sigy, hmy))]
    p = [torch.cat([a, b], dim=-1) for a, b in ((g1x, pkx), (g1y, pky))]
    return miller_cuda(*q, *p)


def verify_bls_cuda(g1x, g1y, sigx, sigy, pkx, pky, hmx, hmy) -> torch.Tensor:
    """K9 over eight (12, 12, B) int32 CUDA tensors: one Miller launch
    over the 2B pairs, one x-chain final launch; the (B,) bool verdict,
    not yet synchronised."""
    args = (g1x, g1y, sigx, sigy, pkx, pky, hmx, hmy)
    _check_f12(args, sigx.shape[-1], "verify_bls_cuda")
    return final_cuda(*_miller_launch(args))[0]


def verify_bls_full_cuda(g1x, g1y, sigx, sigy, pkx, pky, hmx, hmy
                         ) -> torch.Tensor:
    """K9's Miller launch and K11 over eight (12, 12, B) int32 CUDA
    tensors; the (B,) bool verdict, not yet synchronised."""
    args = (g1x, g1y, sigx, sigy, pkx, pky, hmx, hmy)
    _check_f12(args, sigx.shape[-1], "verify_bls_full_cuda")
    return final_full_cuda(*_miller_launch(args))[0]


def verify_pipeline(g1x, g1y, sigx, sigy, pkx, pky, hmx, hmy
                    ) -> torch.Tensor:
    """The full-exponent check, the reference's ``verify_pipeline``
    (Miller, product, full final exponentiation, compare), over eight
    (12, 12, B) int32 tensors on one device: on the card K9's Miller
    launch and K11, on the CPU the plain twin. (B,) bool."""
    args = (g1x, g1y, sigx, sigy, pkx, pky, hmx, hmy)
    if g1x.device.type == "cuda":
        return verify_bls_full_cuda(*args)
    return verify_kernel_full(*args)


def verify_pipeline_fast(g1x, g1y, sigx, sigy, pkx, pky, hmx, hmy
                         ) -> torch.Tensor:
    """The x-chain check, the reference's ``verify_pipeline_fast``: on the
    card K9's two launches, on the CPU its plain twin. (B,) bool."""
    args = (g1x, g1y, sigx, sigy, pkx, pky, hmx, hmy)
    if g1x.device.type == "cuda":
        return verify_bls_cuda(*args)
    return verify_kernel(*args)


PIPELINES = {"kernel": verify_pipeline, "kernel-fast": verify_pipeline_fast}


def launch_verify(arrs, *, device: DeviceLike = None,
                  backend: str = "kernel-fast") -> torch.Tensor:
    """One check over the eight (12, 12, B) word arrays ``(g1x, g1y,
    sigx, sigy, pkx, pky, hmx, hmy)`` (numpy ``uint32`` or tensors) on
    ``device`` (default ``cuda``) by ``backend``'s pipeline
    (:data:`PIPELINES`): on the card K9's Miller launch and then K9's
    x-chain final launch (``"kernel-fast"``) or K11 (``"kernel"``); the
    plain twins on the CPU. The (B,) bool tensor; on the card not yet
    synchronised."""
    pipeline = PIPELINES[backend]
    dev = resolve_device(device)
    return pipeline(*(_build.as_int32(a, dev) for a in arrs))


def verify_limbs(arrs, *, device: DeviceLike = None,
                 backend: str = "kernel-fast") -> np.ndarray:
    """Synchronous :func:`launch_verify`."""
    return launch_verify(arrs, device=device,
                         backend=backend).cpu().numpy()


# ---- the certificate path ---------------------------------------------------

def resolve_backend(backend=None) -> str:
    """The backend a call runs: ``None`` reads ``BDLS_CERT_BACKEND`` and
    gives ``"kernel-fast"`` when it is unset or empty (the reference
    gives ``"host"``: a deliberate difference, ROADMAP.md Queue C);
    ``"kernel"`` gives ``"kernel-fast"`` when ``BDLS_BLS_FE=fast``, as in
    the reference; an unknown name raises."""
    if backend is None:
        backend = os.environ.get("BDLS_CERT_BACKEND") or "kernel-fast"
    if backend not in BACKENDS:
        raise ValueError(f"unknown certificate backend {backend!r} "
                         f"(one of {BACKENDS})")
    if backend == "kernel" and os.environ.get("BDLS_BLS_FE") == "fast":
        return "kernel-fast"
    return backend


def verify_certificates(certs, aggregators, backend=None, *,
                        device: DeviceLike = None) -> list[bool]:
    """A cross-round batch of quorum certificates -> per-certificate
    verdicts, by :func:`resolve_backend`'s backend. ``"host"``: the
    oracle through each aggregator's ``verify_certificate``, one pairing
    equation a certificate. Otherwise the certificates are packed by
    ``certificate_lanes`` (structurally invalid ones masked False) and
    checked as one batch on ``device`` (default ``cuda``) by the
    backend's pipeline: ``"kernel"`` K9's Miller launch and K11,
    ``"kernel-fast"`` K9's two launches (``"cpu"``: their plain
    twins)."""
    backend = resolve_backend(backend)
    if backend == "host":
        return [bool(agg.verify_certificate(c))
                for c, agg in zip(certs, aggregators)]
    from bdls_tpu_torch.consensus.threshold import certificate_lanes

    lanes, mask = certificate_lanes(certs, aggregators)
    ok = verify_limbs([a for pt in lanes for a in pt], device=device,
                      backend=backend)
    return [bool(m) and bool(o) for m, o in zip(mask, ok)]
