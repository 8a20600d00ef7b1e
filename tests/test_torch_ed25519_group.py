"""K8's thread-group body (``csrc/edwards_group.cuh``), built for the host
with g++.

On the card GROUP threads carry one Ed25519 lane, a step's tasks split
over them and a ``__syncwarp`` between steps; on the host the shares of
a step run one after another. This test builds a small C shim over the
headers into ``build/`` (``_build.host_shim``) as the kernel is built
(8 threads a lane, plain form, the product reduced through 2^256 = 38).
It checks, every comparison exact:

- the verdicts, lane for lane, with the shares of every step forward
  and reversed, against the plain twin ``ops/ed25519.py:verify_ed25519``,
  the reference's ``bdls_tpu/ops/ed25519.py:verify_limbs`` on XLA:CPU
  (one compiled bucket of 8 lanes) and the RFC 8032 oracle: the RFC 8032
  §7.1 vectors, ``vectors.ed25519_mixed_lanes`` (S >= L, a coordinate
  >= p, undecodable points as (0, 0), points off the curve, torsion,
  tampered and forged lanes), seeded signatures, and rows with a chosen
  k (``vectors.ed25519_k_rows``: k = 0, a zero top digit, carry nibble
  0 and 1, k = 2^256 - 1), 63 lanes in all (a ragged last warp of 4
  lanes);
- each level-split formula (a doubling, an addition of a cached addend,
  negated or not, after ``CONV`` puts it in that form, a mixed addition
  of a B entry) against the affine oracle and, in affine form, against
  ``edwards.cuh``'s one-thread ``ed_dbl``, ``ed_add`` and ``ed_madd``,
  on the identity, P + P, P + (-P), the identity as the addend and B
  entries of byte 0 (the identity) and of other bytes;
- the B table K8 reads (``b_tables_cached``, ``device_b_table``) against
  ``b_tables_positioned`` (the reference's integers);
- the ×38 product and reduction against Python integers.

The test skips, from a fixture, where g++ is absent.
"""

from __future__ import annotations

import ctypes
import shutil

import numpy as np
import pytest
import torch

from bdls_tpu.ops import ed25519 as jed
from bdls_tpu_torch.crypto import vectors
from bdls_tpu_torch.ops import _build
from bdls_tpu_torch.ops import ed25519 as ed
from bdls_tpu_torch.ops.curves import ED25519
from bdls_tpu_torch.ops.verify_fold import _ints_to_u32, _u32_to_ints

torch.set_num_threads(1)

SHIM = r"""
#include <string.h>

#include "edwards_group.cuh"
using namespace bdls;

// K8's group body on B lanes, the shares of each step in order or in
// reverse; U gets each lane's [k](-A) + [S]B (X, Y, Z words, the
// field's form)
extern "C" void host_ed25519_group(const int32_t* ax, const int32_t* ay,
                                   const int32_t* rx, const int32_t* ry,
                                   const int32_t* s, const int32_t* k,
                                   const uint32_t* btab, uint8_t* out,
                                   uint32_t* U, int B, int reverse) {
  grp::host_reverse() = reverse != 0;
  grp::ed_state* st = new grp::ed_state;
  const grp::gctx g{0, 0};
  for (int b = 0; b < B; ++b) {
    out[b] = grp::verify_ed25519_group<grp::ed_field>(
        g, *st, ax, ay, rx, ry, s, k, btab, b, B) ? 1 : 0;
    memcpy(U + (size_t)b * 24, &st->acc[0], 96);
  }
  delete st;
  grp::host_reverse() = false;
}

// One op through the group's levels, out[0..32) (X, Y, Z, T), and the
// one-thread formula, out[32..64). p, q: extended points (32 words);
// kind 0 doubling of p; 1 p + q, q put in the addend form by CONV; 2
// p + (-q) the same way (the op's neg); 3 p + the B entry q[0..24)
// (y - x, y + x, 2d·xy). The one-thread formulas take Montgomery form:
// they read a plain extended point as the point divided by R in that
// form, the same projective point; ed_madd reads the B entry in plain
// form as the kernel does; their result is the sum, projectively.
extern "C" void host_ed_formula(int kind, const uint32_t* p,
                                const uint32_t* q, uint32_t* out,
                                int reverse) {
  grp::host_reverse() = reverse != 0;
  grp::ed_state* st = new grp::ed_state;
  const grp::gctx g{0, 0};
  ept P, Q, ref;
  memcpy(&P, p, 128);
  memcpy(&Q, q, 128);
  st->acc[0] = P;
  ept* acc = &st->acc[0];
  fe k2d;
  ed_load_2d(k2d);
  grp::ed_op o = grp::ed_make(grp::ED_DBL, acc, &st->bq, acc, st->sl[0],
                              true);
  if (kind == 0) {
    ed_dbl(ref, P);
  } else if (kind < 3) {
    st->acc[1] = Q;
    const grp::ed_op c = grp::ed_make(grp::ED_CONV, &st->acc[1], nullptr,
                                      &st->bq, nullptr, false);
    grp::ed_step<grp::ed_field>(g, grp::ed_at(c, 0),
                                grp::ed_at(c, 0, false));
    o.kind = grp::ED_ADD;
    o.neg = kind == 2;
    if (o.neg) {
      fe zero;
      grp::set_small(zero, 0u);
      sub_mod<P25519>(Q.x, zero, Q.x);
      sub_mod<P25519>(Q.t, zero, Q.t);
    }
    ed_add(ref, P, Q, k2d);
  } else {
    memcpy(&st->bq.x, q, 32);
    memcpy(&st->bq.y, q + 8, 32);
    memcpy(&st->bq.t, q + 16, 32);
    o.kind = grp::ED_MADD;
    ed_madd(ref, P, st->bq.x, st->bq.y, st->bq.t);
  }
  grp::ed_ops<grp::ed_field>(g, o, o, false);
  memcpy(out, acc, 128);
  memcpy(out + 32, &ref, 128);
  delete st;
  grp::host_reverse() = false;
}

// mul_25519(a, b) and reduce_25519(a), n pairs of 8 words
extern "C" void host_mul_25519(const uint32_t* a, const uint32_t* b,
                               uint32_t* prod, uint32_t* red, int n) {
  for (int i = 0; i < n; ++i) {
    fe x, y, z;
    memcpy(&x, a + 8 * i, 32);
    memcpy(&y, b + 8 * i, 32);
    grp::mul_25519(z, x, y);
    memcpy(prod + 8 * i, &z, 32);
    grp::reduce_25519(z, x);
    memcpy(red + 8 * i, &z, 32);
  }
}

extern "C" int host_ed_group_size() { return grp::GROUP; }
extern "C" int host_ed_state_bytes() { return (int)sizeof(grp::ed_state); }
"""

P, R = ed.P, 1 << 256
BUCKET = 8


@pytest.fixture(scope="module")
def shim():
    if shutil.which("g++") is None:
        pytest.skip("g++ not found: the host build of the kernel is skipped")
    return _build.host_shim(SHIM, "host_ed25519_group")


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def _words(vals) -> np.ndarray:
    return _ints_to_u32(list(vals))


@pytest.fixture(scope="module")
def batch():
    """63 rows and labels: the RFC 8032 vectors, the mixed and hostile
    lanes, seeded signatures, the chosen-k rows; the oracle's verdicts
    and the reference's on XLA:CPU, one bucket of 8 lanes at a time."""
    rng = np.random.default_rng(612)
    lanes = vectors.ed25519_mixed_lanes(rng)
    krows = vectors.ed25519_k_rows(rng)
    n_signed = 63 - len(lanes) - len(krows)
    lanes += vectors.ed25519_signed_lanes(n_signed, rng)
    rows = vectors.ed25519_rows(lanes) + [r[:6] for r in krows]
    labels = [ln[5] for ln in lanes] + [r[6] for r in krows]
    oracle = vectors.ed25519_expected(lanes) + \
        vectors.ed25519_row_expected(krows)
    ref = []
    for i in range(0, len(rows), BUCKET):
        part = rows[i:i + BUCKET]
        n = len(part)
        part = part + [rows[0]] * (BUCKET - n)
        got = jed.verify_limbs(jed.lanes_to_limbs(part), field="fold")
        ref += [bool(v) for v in got][:n]
    arrs = [np.ascontiguousarray(a.view(np.int32))
            for a in ed.lanes_to_limbs(rows)]
    plain = ed.verify_ed25519(
        ED25519, *(torch.from_numpy(a) for a in arrs)).tolist()
    return {"rows": rows, "labels": labels, "arrs": arrs, "oracle": oracle,
            "ref": ref, "plain": plain}


def test_batch_covers_the_edges(batch):
    """The lanes the verdict test needs: 63 (not a multiple of a warp's
    4 or 8 lanes), valid and invalid, carry nibble 0 and 1, a zero top
    digit, S >= L, undecodable points as (0, 0); the three references
    agree."""
    rows, labels = batch["rows"], batch["labels"]
    assert len(rows) == 63 and len(rows) % 4 == 3
    assert batch["oracle"] == batch["ref"] == batch["plain"]
    assert any(batch["oracle"]) and not all(batch["oracle"])
    w0 = sum(8 << (4 * i) for i in range(64))
    carries = {(k + w0) >> 256 for *_, k in rows}
    assert carries == {0, 1}
    assert any(((k + w0) >> 252) & 0xF == 8 for *_, k in rows)
    assert any(s >= ed.L for _, _, _, _, s, _ in rows)
    assert any(r[:4] == (0, 0, 0, 0) for r in rows)
    assert "R does not decompress" in labels


@pytest.mark.parametrize("reverse", [False, True])
def test_group_verdicts_match_plain_reference_and_oracle(shim, batch,
                                                         reverse):
    """Every lane's verdict from the group body, in both share orders,
    equals the plain twin's, the reference's and the oracle's; on the
    valid lanes [k](-A) + [S]B is R, projectively."""
    assert shim.host_ed_group_size() == _build.VERIFY_GROUP
    # 4 lanes' states in one warp's block stay far below 48 KB
    assert shim.host_ed_state_bytes() * 32 // shim.host_ed_group_size() \
        <= 48 * 1024
    rows = batch["rows"]
    btab = ed.device_b_table(torch.device("cpu")).numpy()
    out = np.zeros(len(rows), np.uint8)
    U = np.zeros((len(rows), 24), np.uint32)
    shim.host_ed25519_group(*(_ptr(a) for a in (*batch["arrs"], btab, out,
                                                 U)),
                            len(rows), int(reverse))
    got = out.astype(bool).tolist()
    assert got == batch["plain"], [
        lab for lab, a, b in zip(batch["labels"], got, batch["plain"])
        if a != b]
    for (_, _, rx, ry, _, _), ok, u in zip(rows, got, U):
        if ok:
            X, Y, Z = _u32_to_ints(u)
            assert Z != 0 and X == rx * Z % P and Y == ry * Z % P


def _ext(pt, scale: int) -> np.ndarray:
    """An affine point as extended words, scaled by Z."""
    x, y = pt
    coords = (x * scale, y * scale, scale, x * y % P * scale)
    return _words(c % P for c in coords).reshape(-1)


def _mul(k: int, pt):
    return ed.pt_mul(k, pt) if k else (0, 1)


@pytest.mark.parametrize("case", [
    "2P", "2O", "P + Q", "P + P", "P + (-P)", "O + P", "P + O",
    "P - Q", "P - P", "P + B[0][0]", "P + B[3][77]", "O + B[31][255]"])
@pytest.mark.parametrize("reverse", [False, True])
def test_group_formulas_match_one_thread(shim, case, reverse):
    """One doubling or addition through the group's two levels gives the
    affine oracle's point with T = XY/Z, and so does the one-thread
    formula of ``edwards.cuh``."""
    B = (ed.GX, ed.GY)
    Pt, Qt = _mul(0x1234567, B), _mul(0xABCDEF0123, B)
    O = (0, 1)
    lhs, rhs, kind = {
        "2P": (Pt, O, 0), "2O": (O, O, 0), "P + Q": (Pt, Qt, 1),
        "P + P": (Pt, Pt, 1), "P + (-P)": (Pt, ((P - Pt[0]) % P, Pt[1]), 1),
        "O + P": (O, Pt, 1), "P + O": (Pt, O, 1), "P - Q": (Pt, Qt, 2),
        "P - P": (Pt, Pt, 2), "P + B[0][0]": (Pt, None, 3),
        "P + B[3][77]": (Pt, None, 3), "O + B[31][255]": (O, None, 3)}[case]
    p = _ext(lhs, 5)
    if kind == 3:
        j, d = (int(v) for v in case.split("[", 1)[1].replace("]", " ")
                .replace("[", "").split())
        q = np.ascontiguousarray(ed.b_tables_cached()[j, d]).reshape(-1)
        x, y, _ = _u32_to_ints(ed.b_tables_positioned()[j, d])
        addend = (x, y)
        q = np.concatenate([q, np.zeros(8, np.uint32)])
    else:
        q = _ext(rhs, 3)
        addend = rhs if kind != 2 else ((P - rhs[0]) % P, rhs[1])
    out = np.zeros(64, np.uint32)
    shim.host_ed_formula(kind, _ptr(p), _ptr(q), _ptr(out), int(reverse))
    want = ed.pt_add(lhs, lhs) if kind == 0 else ed.pt_add(lhs, addend)
    for words in (out[:32], out[32:]):
        X, Y, Z, T = _u32_to_ints(words)
        zi = pow(Z, -1, P)
        assert (X * zi % P, Y * zi % P) == want
        assert X * Y % P == Z * T % P


def test_b_table_forms_match_the_positioned_tables():
    """K8's table is the positioned tables' (x, y, t) as (y - x, y + x,
    2d·t), in plain form on the card; entry 0 is the identity's (1, 1,
    0)."""
    pos = ed.b_tables_positioned()
    cached = ed.b_tables_cached()
    dev = ed.device_b_table(torch.device("cpu")).numpy().view(np.uint32)
    assert cached.shape == dev.shape == pos.shape == (32, 256, 3, 8)
    x, y, t = (_u32_to_ints(np.ascontiguousarray(pos[:, :, c]))
               for c in range(3))
    ymx, ypx, t2d = (_u32_to_ints(np.ascontiguousarray(cached[:, :, c]))
                     for c in range(3))
    assert ymx == [(b - a) % P for a, b in zip(x, y)]
    assert ypx == [(a + b) % P for a, b in zip(x, y)]
    assert t2d == [2 * ed.D * v % P for v in t]
    assert np.array_equal(dev, cached)
    assert (ymx[0], ypx[0], t2d[0]) == (1, 1, 0)


def test_mul_25519_matches_integers(shim):
    """The ×38 product of any a < 2^256 and b < p, and x mod p for any
    x < 2^256, fully reduced."""
    rng = np.random.default_rng(613)
    a = [0, 1, P - 1, P, P + 18, R - 1, R - 1, 2 ** 255]
    b = [P - 1, P - 1, P - 1, 5, P - 1, P - 1, 0, 2]
    for _ in range(56):
        a.append(int.from_bytes(rng.bytes(32), "little"))
        b.append(int.from_bytes(rng.bytes(32), "little") % P)
    prod = np.zeros((len(a), 8), np.uint32)
    red = np.zeros_like(prod)
    shim.host_mul_25519(_ptr(_words(a)), _ptr(_words(b)), _ptr(prod),
                        _ptr(red), len(a))
    assert _u32_to_ints(prod) == [x * y % P for x, y in zip(a, b)]
    assert _u32_to_ints(red) == [x % P for x in a]
