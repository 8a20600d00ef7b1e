"""K1's and K7's thread-group body (``csrc/verify_group.cuh``), built for
the host with g++.

On the card GROUP threads carry one ECDSA lane, a step's tasks split
over them and a ``__syncwarp`` between steps; on the host the shares of a
step run one after another. This test builds a small C shim over the
headers into ``build/`` (``_build.host_shim``), loads it with ctypes,
and checks, every comparison exact:

- the verdicts of K1's group body (``verify_lane_group``) against the
  plain ``verify_fold`` and the port's integer ECDSA, lane for lane, on
  both curves: valid lanes, tampered digest, r and s, r and s equal to
  0 and n, Q off the curve, Q = (0, 0), Qx or Qy >= p, the r + n
  branch, a lane whose R is infinity (e = -r·d, so u1·G = -u2·Q), a
  valid lane whose two chains meet in a doubling (e = r·d, u1·G =
  u2·Q), and secp256k1 lanes whose second GLV half is negative and
  positive;
- the same with the shares of every step run in reverse order: no share
  reads what another writes in the same step;
- R itself, X/Z and Y/Z of the lane's point against the integer oracle
  u1·G + u2·Q on the valid lanes;
- the binary inverse and the carry-save Montgomery product
  (``mont_mul_cs``, every product of the body) against Python integers
  for both orders n and both fields p;
- the formulas' level split (``op_operands``, ``op_finish``) against
  the one-thread RCB formulas of ``csrc/point.cuh``, value for value,
  infinity and P = Q included;
- K7's group lane body and tally (``block_lane_group``, ``tally_tx``,
  run as ``csrc/block.cu`` runs them) against the plain
  ``block_kernel``, lane for lane and tx for tx, on a hostile block of
  each curve, in both share orders;
- K10's count epilogue on the group body: one vote a lane
  (``grp::votes``), the per-block partials of a ragged batch summing to
  the masked count;
- the plain twin's GLV ladder (``ops/verify_fold.py:dual_ladder_glv``)
  against the reference's ``dual_ladder_glv`` on XLA:CPU, one compiled
  bucket of 8 lanes: the same point, cross-multiplied.

The test skips, from a fixture, where g++ is absent.
"""

from __future__ import annotations

import ctypes
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bdls_tpu.ops import fold as jfold
from bdls_tpu.ops import verify_fold as jvf
from bdls_tpu.ops.curves import CURVES as JCURVES
from bdls_tpu_torch.crypto import vectors
from bdls_tpu_torch.crypto.marshal import ints_to_limbs
from bdls_tpu_torch.crypto.sw import _mul_add
from bdls_tpu_torch.ops import _build
from bdls_tpu_torch.ops import block_verify as bv
from bdls_tpu_torch.ops import fold
from bdls_tpu_torch.ops import verify_fold as vf
from bdls_tpu_torch.ops.curves import CURVES
from bdls_tpu_torch.ops.ecdsa import CURVE_IDS
from bdls_tpu_torch.parallel import mesh as pmesh

torch.set_num_threads(1)

SHIM = r"""
#include <string.h>

#include "block.cuh"
#include "mesh.cuh"
using namespace bdls;

// K1's group body on B lanes, the shares of each step in order or in
// reverse; R gets each lane's point (x, y, z words, Montgomery form)
extern "C" void host_verify_group(int curve, const int32_t* qx,
                                  const int32_t* qy, const int32_t* r,
                                  const int32_t* s, const int32_t* e,
                                  const uint32_t* g32, uint8_t* out,
                                  uint32_t* R, int B, int reverse) {
  grp::host_reverse() = reverse != 0;
  grp::lane_state* st = new grp::lane_state;
  const grp::gctx g{0, 0};
  for (int b = 0; b < B; ++b) {
    const bool ok = curve == 0
        ? grp::verify_lane_group<CurveP256>(g, *st, qx, qy, r, s, e, g32, b,
                                            B)
        : grp::verify_lane_group<CurveK256>(g, *st, qx, qy, r, s, e, g32, b,
                                            B);
    out[b] = ok ? 1 : 0;
    memcpy(R + (size_t)b * 24, &st->acc[0], 96);
  }
  delete st;
  grp::host_reverse() = false;
}

// op 0: the binary inverse of a; op 1: the carry-save product a·b·R^-1
template <class M>
static void field_op(int op, const fe& x, const fe& y, fe& z) {
  if (op == 0) grp::inv_binary<M>(z, x);
  else grp::mont_mul_cs<M>(z, x, y);
}

extern "C" void host_field_group(int mod, int op, const uint32_t* a,
                                 const uint32_t* b, uint32_t* out) {
  fe x, y, z;
  for (int i = 0; i < 8; ++i) { x.v[i] = a[i]; y.v[i] = b[i]; }
  switch (mod) {
    case 0: field_op<P256P>(op, x, y, z); break;
    case 1: field_op<P256N>(op, x, y, z); break;
    case 2: field_op<K256P>(op, x, y, z); break;
    default: field_op<K256N>(op, x, y, z); break;
  }
  for (int i = 0; i < 8; ++i) out[i] = z.v[i];
}

// one complete doubling (kind 1) or addition (kind 2) through the level
// split, and through csrc/point.cuh's one-thread formulas
template <class C>
static void op_both(int kind, const uint32_t* in, uint32_t* out) {
  grp::lane_state* st = new grp::lane_state;
  memcpy(&st->tab[0], in, 192);
  const grp::op o = grp::make_op(kind, &st->tab[0], &st->tab[1],
                                 &st->tab[2], st->sl[0]);
  grp::run_ops<C>(grp::gctx{0, 0}, &o, 1);
  memcpy(out, &st->tab[2], 96);
  pt p1, p2, r;
  memcpy(&p1, in, 96);
  memcpy(&p2, in + 24, 96);
  if (kind == grp::OP_DBL) point_dbl<C>(r, p1);
  else point_add<C>(r, p1, p2);
  memcpy(out + 24, &r, 96);
  delete st;
}

extern "C" void host_op(int curve, int kind, const uint32_t* in,
                        uint32_t* out) {
  if (curve == 0) op_both<CurveP256>(kind, in, out);
  else op_both<CurveK256>(kind, in, out);
}

// csrc/block.cu's lane kernel and tally on the group body
extern "C" void host_block_group(int curve, const uint32_t* words,
                                 const int32_t* nblocks, const int32_t* qx,
                                 const int32_t* qy, const int32_t* r,
                                 const int32_t* s, const int32_t* lane_tx,
                                 const int32_t* lane_org,
                                 const uint32_t* org_mask,
                                 const int32_t* required,
                                 const uint32_t* g32, uint8_t* hit,
                                 uint8_t* valid, int32_t* flags, int NB,
                                 int L, int T, int O, int reverse) {
  grp::host_reverse() = reverse != 0;
  grp::lane_state* st = new grp::lane_state;
  const grp::gctx g{0, 0};
  memset(hit, 0, (size_t)T * O);
  for (int b = 0; b < L; ++b) {
    const bool ok = curve == 0
        ? block_lane_group<CurveP256>(g, *st, words, nblocks[b], NB, qx, qy,
                                      r, s, g32, b, L)
        : block_lane_group<CurveK256>(g, *st, words, nblocks[b], NB, qx, qy,
                                      r, s, g32, b, L);
    valid[b] = ok ? 1 : 0;
    if (ok && lane_tx[b] >= 0 && lane_tx[b] < T && lane_org[b] >= 0 &&
        lane_org[b] < O)
      hit[(size_t)lane_tx[b] * O + lane_org[b]] = 1;
  }
  for (int t = 0; t < T; ++t)
    flags[t] = tally_tx(hit, org_mask, required, t, O);
  delete st;
  grp::host_reverse() = false;
}

// K10's epilogue on the group body: every thread of a block of
// `threads` threads votes grp::votes(share, live) && lane_valid, as
// __syncthreads_count sums it; one partial a block
extern "C" int host_group_partials(const uint8_t* ok, const uint8_t* mask,
                                   uint32_t* partial, int B, int threads) {
  const int lanes = threads / grp::GROUP;
  const int blocks = (B + lanes - 1) / lanes;
  for (int blk = 0; blk < blocks; ++blk) {
    uint32_t n = 0;
    for (int t = 0; t < threads; ++t) {
      const int b = blk * lanes + t / grp::GROUP;
      const bool live = b < B;
      n += (grp::votes(t % grp::GROUP, live) && lane_valid(ok, mask, b))
          ? 1u : 0u;
    }
    partial[blk] = n;
  }
  return blocks;
}

extern "C" int host_group() { return grp::GROUP; }
"""

MODS = [("P-256", "fp"), ("P-256", "fn"), ("secp256k1", "fp"),
        ("secp256k1", "fn")]
R256 = 1 << 256


@pytest.fixture(scope="module")
def shim():
    if shutil.which("g++") is None:
        pytest.skip("g++ not found: the host build of the kernel is skipped")
    return _build.host_shim(SHIM, "host_verify_group")


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def _u32(vals) -> np.ndarray:
    return np.array([[(v >> (32 * i)) & 0xFFFFFFFF for i in range(8)]
                     for v in vals], dtype=np.uint32)


def _ints(a: np.ndarray) -> list[int]:
    a = a.reshape(-1, 8).astype(object)
    return [sum(int(w) << (32 * i) for i, w in enumerate(row)) for row in a]


def _key(curve: str, rng) -> tuple[int, tuple[int, int]]:
    cv = CURVES[curve]
    d = int.from_bytes(rng.bytes(32), "big") % (cv.fn.modulus - 1) + 1
    return d, _mul_add(cv, d, (cv.gx, cv.gy))


def _lanes(curve: str) -> list[tuple]:
    rng = np.random.default_rng(61)
    return vectors.mixed_lanes(curve, rng) + vectors.ladder_lanes(curve, rng)


def _run_group(shim, curve, lanes, reverse):
    cols = [np.ascontiguousarray(ints_to_limbs(c).view(np.int32))
            for c in vectors.columns(lanes)]
    g32 = vf.device_g32_table(curve, torch.device("cpu")).numpy()
    B = len(lanes)
    out = np.zeros(B, np.uint8)
    R = np.zeros((B, 3, 8), np.uint32)
    shim.host_verify_group(CURVE_IDS[curve], *(_ptr(a) for a in cols),
                           _ptr(g32), _ptr(out), _ptr(R), B, int(reverse))
    return out.astype(bool).tolist(), R, cols


@pytest.mark.parametrize("curve", sorted(CURVES))
def test_group_body_matches_plain_and_integer_ecdsa(shim, curve):
    lanes = _lanes(curve)
    labels = [lane[5] for lane in lanes]
    fwd, R, cols = _run_group(shim, curve, lanes, reverse=False)
    rev, R_rev, _ = _run_group(shim, curve, lanes, reverse=True)
    plain = vf.verify_fold(CURVES[curve],
                           *(torch.from_numpy(a) for a in cols)).tolist()
    want = vectors.expected(curve, lanes)
    assert fwd == want, [lb for lb, a, b in zip(labels, fwd, want) if a != b]
    assert fwd == plain
    # the shares in reverse: the same verdicts and the same words
    assert rev == fwd
    assert np.array_equal(R, R_rev)
    assert not fwd[labels.index("R at infinity")]
    assert fwd[labels.index("u1·G = u2·Q, valid")]
    assert fwd[labels.index("forged r+n")]
    # R itself on the valid lanes: x(R) = X/Z, y(R) = Y/Z
    cv = CURVES[curve]
    p, n = cv.fp.modulus, cv.fn.modulus
    rinv = pow(R256, -1, p)
    coords = np.array(_ints(R), dtype=object).reshape(-1, 3) * rinv % p
    for i, (qx, qy, r, s, dg, label) in enumerate(lanes):
        if not want[i]:
            continue
        w = pow(s, -1, n)
        e = int.from_bytes(dg, "big")
        x, y = _mul_add(cv, e * w % n, (cv.gx, cv.gy), r * w % n, (qx, qy))
        X, Y, Z = (int(c) for c in coords[i])
        assert X == x * Z % p and Y == y * Z % p, label


def _field(shim, mod, op, a, b=0) -> int:
    out = np.zeros(8, np.uint32)
    shim.host_field_group(mod, op, _ptr(_u32([a])), _ptr(_u32([b])),
                          _ptr(out))
    return _ints(out)[0]


@pytest.mark.parametrize("mod", range(len(MODS)),
                         ids=[f"{c}:{k}" for c, k in MODS])
def test_binary_inverse_matches_pow(shim, mod):
    curve, kind = MODS[mod]
    m = getattr(CURVES[curve], kind).modulus
    rng = np.random.default_rng(62 + mod)
    vals = [1, 2, 3, m - 1, m - 2, (m + 1) // 2, 1 << 255 if (1 << 255) < m
            else 5] + [int.from_bytes(rng.bytes(32), "big") % (m - 1) + 1
                       for _ in range(200)]
    for v in vals:
        assert _field(shim, mod, 0, v) == pow(v, -1, m), hex(v)
    assert _field(shim, mod, 0, 0) == 0


@pytest.mark.parametrize("mod", range(len(MODS)),
                         ids=[f"{c}:{k}" for c, k in MODS])
def test_carry_save_product_matches_python_ints(shim, mod):
    curve, kind = MODS[mod]
    m = getattr(CURVES[curve], kind).modulus
    rng = np.random.default_rng(67 + mod)
    rinv = pow(R256, -1, m)
    # a any value below 2^256 (the inputs of to_mont, e·s^-1), b < m
    edges = [0, 1, m - 1, R256 - 1, (1 << 224) - 1]
    pairs = [(a, b % m) for a in edges for b in edges]
    pairs += [(int.from_bytes(rng.bytes(32), "big"),
               int.from_bytes(rng.bytes(32), "big") % m)
              for _ in range(2000)]
    for a, b in pairs:
        assert _field(shim, mod, 1, a, b) == a * b * rinv % m, (hex(a),
                                                                hex(b))


@pytest.mark.parametrize("curve", sorted(CURVES))
def test_level_split_matches_one_thread_formulas(shim, curve):
    cv = CURVES[curve]
    p = cv.fp.modulus
    rng = np.random.default_rng(63)

    def mont(v):
        return v * R256 % p

    def proj(P):
        if P is None:
            return (0, mont(1), 0)
        z = int.from_bytes(rng.bytes(32), "big") % (p - 1) + 1
        return (mont(P[0] * z % p), mont(P[1] * z % p), mont(z))

    pts = [_key(curve, rng)[1] for _ in range(6)]
    pairs = [(a, b) for a in pts[:3] for b in pts[3:]]
    pairs += [(pts[0], pts[0]), (pts[1], (pts[1][0], p - pts[1][1])),
              (None, pts[2]), (pts[2], None), (None, None)]
    # values off the curve: the same formulas, value for value
    pairs += [((int.from_bytes(rng.bytes(32), "big") % p,
                int.from_bytes(rng.bytes(32), "big") % p),) * 2]
    out = np.zeros((2, 3, 8), np.uint32)
    for a, b in pairs:
        for kind in (1, 2):
            inp = _u32(proj(a) + proj(b))
            shim.host_op(CURVE_IDS[curve], kind, _ptr(inp), _ptr(out))
            assert np.array_equal(out[0], out[1]), (kind, a, b)


@pytest.mark.parametrize("curve", sorted(CURVES))
def test_block_group_and_tally_match_plain(shim, curve):
    req = vectors.block_request(curve, np.random.default_rng(64), 26,
                                msg_len=(0, 200), hostile=True)
    packed = bv.pack_block_request(req)
    arrs = [np.ascontiguousarray(packed[k]) for k in bv.PACKED_KEYS]
    NB, _, L = packed["words"].shape
    T, O = packed["org_mask"].shape
    g32 = vf.device_g32_table(curve, torch.device("cpu")).numpy()
    pflags, pvalid = bv.launch_block(CURVES[curve], packed, device="cpu")
    for reverse in (0, 1):
        hit = np.zeros((T, O), np.uint8)
        valid = np.zeros(L, np.uint8)
        flags = np.zeros(T, np.int32)
        shim.host_block_group(CURVE_IDS[curve], *(_ptr(a) for a in arrs),
                              _ptr(g32), _ptr(hit), _ptr(valid), _ptr(flags),
                              NB, L, T, O, reverse)
        assert valid.astype(bool).tolist() == pvalid.tolist()
        assert flags.tolist() == pflags.tolist()
    assert pvalid.any() and not pvalid.all()


def test_count_epilogue_votes_once_a_lane(shim):
    group = shim.host_group()
    assert group == _build.VERIFY_GROUP
    rng = np.random.default_rng(65)
    for B in (1, 3, 150, 2048):
        ok = rng.integers(0, 2, B).astype(np.uint8)
        mask = rng.integers(0, 2, B).astype(np.uint8)
        lanes = 32 // group
        partial = np.zeros(-(-B // lanes), np.uint32)
        blocks = shim.host_group_partials(_ptr(ok), _ptr(mask),
                                          _ptr(partial), B, 32)
        assert blocks == len(partial)
        for j in range(blocks):
            lo, hi = j * lanes, min(B, (j + 1) * lanes)
            assert partial[j] == int((ok[lo:hi] & mask[lo:hi]).sum())
        assert int(partial.sum()) == int(pmesh.masked_count_plain(
            torch.from_numpy(ok.astype(bool)),
            torch.from_numpy(mask.astype(bool))))


def test_plain_glv_ladder_matches_reference_point():
    curve = "secp256k1"
    cv, jcv = CURVES[curve], JCURVES[curve]
    p, n = cv.fp.modulus, cv.fn.modulus
    rng = np.random.default_rng(66)
    lanes = vectors.signed_lanes(curve, 4, rng) + \
        vectors.ladder_lanes(curve, rng)
    u1 = [int.from_bytes(d, "big") * pow(s, -1, n) % n
          for _, _, _, s, d, _ in lanes]
    u2 = [r * pow(s, -1, n) % n for _, _, r, s, _, _ in lanes]
    qx = [lane[0] for lane in lanes]
    qy = [lane[1] for lane in lanes]
    l16 = [ints_to_limbs(c) for c in (u1, u2, qx, qy)]

    fpc, fnc = jfold.fold_ctx(p), jfold.fold_ctx(n)

    @jax.jit
    def ref(u1_16, u2_16, qx16, qy16):
        pt = jvf.dual_ladder_glv(
            jcv, fpc, jfold.canon(fnc, jfold.from_limbs16(u1_16)),
            jfold.canon(fnc, jfold.from_limbs16(u2_16)),
            jfold.from_limbs16(qx16), jfold.from_limbs16(qy16))
        return [jfold.canon(fpc, c) for c in pt]

    want = [vf._from_radix12(np.asarray(c).T).reshape(-1, 8)
            for c in ref(*(jnp.asarray(a) for a in l16))]
    tpc, tnc = fold.fold_ctx(p), fold.fold_ctx(n)
    t16 = [torch.from_numpy(a.astype(np.int64)) for a in l16]
    got = vf.dual_ladder_glv(
        cv, tpc, fold.canon(tnc, fold.from_limbs16(t16[0])),
        fold.canon(tnc, fold.from_limbs16(t16[1])),
        fold.from_limbs16(t16[2]), fold.from_limbs16(t16[3]))
    got = [fold.tensor_to_ints(fold.canon(tpc, c)) for c in got]
    want = [_ints(w) for w in want]
    for i, lane in enumerate(lanes):
        X, Y, Z = (c[i] for c in got)
        Xr, Yr, Zr = (c[i] for c in want)
        assert X * Zr % p == Xr * Z % p and Y * Zr % p == Yr * Z % p, \
            lane[5]
        assert (Z == 0) == (Zr == 0) == (lane[5] == "R at infinity")
