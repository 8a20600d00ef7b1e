"""K2's thread-group body (``csrc/pinned_group.cuh``), built for the host
with g++.

On the card GROUP threads carry one pinned-key ECDSA lane, a step's
tasks split over them and a ``__syncwarp`` between steps; on the host
the shares of a step run one after another. This test builds a small C
shim over the headers into ``build/`` (``_build.host_shim``) and checks,
every comparison exact:

- the verdicts against the plain ``verify_fold_pinned`` and the port's
  integer ECDSA, lane for lane, on both curves, with the keys pinned in
  a pool: valid lanes, tampered digest, r, s and key, r and s equal to
  0, n and 2^256 - 1, the high-S twin, the forged lanes and the forged
  r + n lane, R at infinity (u1·G = -u2·Q), u1·G = u2·Q, both signs of
  secp256k1's second GLV half, u1 with zero bytes and u1 = 0 (their G
  entries at infinity), a valid signature under another key's slot and
  slots -1 and cap;
- the same with the shares of every step run in reverse order: no share
  reads what another writes in the same step;
- R itself, X/Z and Y/Z of the lane's sum against the integer oracle
  u1·G + u2·Q on the valid lanes;
- the join of the two chains' partial sums (``join_chains``, one complete
  RCB addition through the group's level split) against ``point.cuh``'s
  one-thread ``point_add``, word for word, and the integer sum, on O + P,
  P + O, O + O, P + P and P + (-P);
- ``addend_put`` on a pool entry (x from the pool's x or psi(Q)'s x, y
  negated or not, z from the digit, the digit 0 included) and on a G
  entry, against the pool and the G table as the plain twin lays them
  out;
- the counting build's partials: one vote a lane (``grp::votes``) over
  this body's verdicts, a block of 32 threads, summing per block and in
  all to ``parallel/mesh.py:masked_count_plain``.

The test skips, from a fixture, where g++ is absent.
"""

from __future__ import annotations

import ctypes
import shutil

import numpy as np
import pytest
import torch

from bdls_tpu_torch.crypto import vectors
from bdls_tpu_torch.crypto.marshal import ints_to_limbs
from bdls_tpu_torch.crypto.sw import _mul_add
from bdls_tpu_torch.ops import _build
from bdls_tpu_torch.ops import verify_fold as vf
from bdls_tpu_torch.ops.curves import CURVES
from bdls_tpu_torch.ops.ecdsa import CURVE_IDS
from bdls_tpu_torch.parallel import mesh as pmesh

torch.set_num_threads(1)

SHIM = r"""
#include <string.h>

#include "mesh.cuh"
#include "pinned_group.cuh"
using namespace bdls;

// K2's group body on B lanes, the shares of each step in order or in
// reverse; R gets each lane's sum (x, y, z words, Montgomery form)
extern "C" void host_pinned_group(int curve, const int32_t* r,
                                  const int32_t* s, const int32_t* e,
                                  const int32_t* slot, const uint32_t* px,
                                  const uint32_t* py, const uint32_t* ppsi,
                                  const uint32_t* g32, uint8_t* out,
                                  uint32_t* R, int B, int cap, int reverse) {
  grp::host_reverse() = reverse != 0;
  grp::pin_state* st = new grp::pin_state;
  const grp::gctx g{0, 0};
  const grp::pin_tabs T{px, py, curve == 0 ? px : ppsi, g32, cap};
  for (int b = 0; b < B; ++b) {
    const bool ok = curve == 0
        ? grp::verify_pinned_group<CurveP256>(g, *st, r, s, e, slot, T, b, B)
        : grp::verify_pinned_group<CurveK256>(g, *st, r, s, e, slot, T, b,
                                              B);
    out[b] = ok ? 1 : 0;
    memcpy(R + (size_t)b * 24, &st->acc[0], 96);
  }
  delete st;
  grp::host_reverse() = false;
}

// the join of two partial sums (in: 2 points of 24 words) as the body
// runs it, out[0..24); and as point.cuh's point_add, out[24..48)
template <class C>
static void join_both(const uint32_t* in, uint32_t* out, int reverse) {
  grp::host_reverse() = reverse != 0;
  grp::pin_state* st = new grp::pin_state;
  memcpy(&st->acc[0], in, 192);
  grp::join_chains<C>(grp::gctx{0, 0}, *st);
  memcpy(out, &st->acc[0], 96);
  pt acc[2];
  memcpy(acc, in, 192);
  point_add<C>(acc[0], acc[0], acc[1]);
  memcpy(out + 24, &acc[0], 96);
  delete st;
  grp::host_reverse() = false;
}

extern "C" void host_pinned_join(int curve, const uint32_t* in,
                                 uint32_t* out, int reverse) {
  if (curve == 0) join_both<CurveP256>(in, out, reverse);
  else join_both<CurveK256>(in, out, reverse);
}

// addend_put's three light tasks on one entry, out[0..24): a pool entry
// (x words at xs, y words at ys, z from mag, y negated with neg), or with
// xs == nullptr the G entry g32[pos][byte]
template <class C>
static void addend(const uint32_t* xs, const uint32_t* ys,
                   const uint32_t* g32, uint32_t mag, int neg, int pos,
                   uint32_t byte, uint32_t* out) {
  pt got;
  grp::addsrc a = grp::no_addend();
  a.dst = &got;
  if (xs) {
    a.g = xs;
    a.gy = ys;
    a.nz = mag != 0;
    a.neg = neg != 0;
  } else {
    a.g = g32 + ((size_t)pos * 256 + byte) * 24;
  }
  for (int c = 0; c < 3; ++c) grp::addend_put<C>(a, c);
  memcpy(out, &got, 96);
}

extern "C" void host_addend(int curve, const uint32_t* xs, const uint32_t* ys,
                            const uint32_t* g32, uint32_t mag, int neg,
                            int pos, uint32_t byte, uint32_t* out) {
  if (curve == 0) addend<CurveP256>(xs, ys, g32, mag, neg, pos, byte, out);
  else addend<CurveK256>(xs, ys, g32, mag, neg, pos, byte, out);
}

// K10's epilogue on this body: every thread of a block of `threads`
// threads votes grp::votes(share, live) && lane_valid, as
// __syncthreads_count sums it; one partial a block
extern "C" int host_pinned_partials(const uint8_t* ok, const uint8_t* mask,
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

extern "C" int host_pinned_group_size() { return grp::GROUP; }
extern "C" int host_pinned_state_bytes() {
  return (int)sizeof(grp::pin_state);
}
"""

R256 = 1 << 256
_shims: dict = {}


@pytest.fixture(scope="module")
def shim():
    if shutil.which("g++") is None:
        pytest.skip("g++ not found: the host build of the kernel is skipped")
    if "lib" not in _shims:
        _shims["lib"] = _build.host_shim(SHIM, "host_pinned_group")
    return _shims["lib"]


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def _u32(vals) -> np.ndarray:
    return np.array([[(v >> (32 * i)) & 0xFFFFFFFF for i in range(8)]
                     for v in vals], dtype=np.uint32)


def _ints(a: np.ndarray) -> list[int]:
    a = a.reshape(-1, 8).astype(object)
    return [sum(int(w) << (32 * i) for i, w in enumerate(row)) for row in a]


def _pinnable(curve: str, lane) -> bool:
    try:
        vf.build_pinned_tables(curve, lane[0], lane[1])
    except ValueError:
        return False
    return True


def _batch(curve: str):
    """Lanes with pinnable keys, their pool and slots, and the verdicts
    the integer ECDSA gives: the last three lanes are a valid signature
    under another key's slot and under slots -1 and cap."""
    rng = np.random.default_rng(91)
    lanes = [ln for ln in vectors.mixed_lanes(curve, rng)
             + vectors.ladder_lanes(curve, rng)
             + vectors.zero_byte_lanes(curve, rng) if _pinnable(curve, ln)]
    keys: dict = {}
    for ln in lanes:
        keys.setdefault(ln[:2], len(keys))
    cap = len(keys)
    slots = [keys[ln[:2]] for ln in lanes]
    valid = next(i for i, ln in enumerate(lanes) if ln[5] == "valid")
    lanes += [lanes[valid]] * 3
    slots += [(slots[valid] + 1) % cap, -1, cap]
    pools = {nm: np.zeros((cap, vf.pinned_positions(curve), 9, 8), np.int32)
             for nm in vf.PINNED_COORDS[curve]}
    for (qx, qy), i in keys.items():
        tabs = vf.pinned_device_tables(
            curve, vf.build_pinned_tables(curve, qx, qy))
        for nm in pools:
            pools[nm][i] = tabs[nm]
    want = vectors.expected(curve, lanes)
    want[-3:] = [False] * 3
    return lanes, np.array(slots, np.int32), pools, cap, want


_plain: dict = {}


def _plain_verdicts(curve, cols, slot, pools):
    if curve not in _plain:
        _plain[curve] = vf.verify_fold_pinned(
            CURVES[curve], *(torch.from_numpy(a) for a in cols),
            torch.from_numpy(slot),
            {nm: torch.from_numpy(v) for nm, v in pools.items()}).tolist()
    return _plain[curve]


def _run(lib, curve, cols, slot, pools, cap, reverse):
    B = len(slot)
    g32 = vf.device_g32_table(curve, torch.device("cpu")).numpy()
    out = np.zeros(B, np.uint8)
    R = np.zeros((B, 3, 8), np.uint32)
    psi = pools.get("psi_x", pools["x"])
    lib.host_pinned_group(CURVE_IDS[curve], *(_ptr(a) for a in cols),
                          _ptr(slot), _ptr(pools["x"]), _ptr(pools["y"]),
                          _ptr(psi), _ptr(g32), _ptr(out), _ptr(R), B, cap,
                          int(reverse))
    return out.astype(bool).tolist(), R


@pytest.mark.parametrize("curve", sorted(CURVES))
def test_pinned_group_body_matches_plain_and_integer_ecdsa(curve, shim):
    lib = shim
    assert lib.host_pinned_group_size() == _build.VERIFY_GROUP
    # the lane state stays within K1's (3,120 bytes a lane)
    assert lib.host_pinned_state_bytes() <= 3120
    lanes, slot, pools, cap, want = _batch(curve)
    labels = [ln[5] for ln in lanes]
    cols = [np.ascontiguousarray(ints_to_limbs(c).view(np.int32))
            for c in vectors.columns(lanes)[2:]]
    fwd, R = _run(lib, curve, cols, slot, pools, cap, reverse=False)
    rev, R_rev = _run(lib, curve, cols, slot, pools, cap, reverse=True)
    assert fwd == want, [lb for lb, a, b in zip(labels, fwd, want) if a != b]
    assert fwd == _plain_verdicts(curve, cols, slot, pools)
    assert rev == fwd and np.array_equal(R, R_rev)
    for label in ("u1 with zero bytes", "u1 = 0", "u1·G = u2·Q, valid",
                  "forged r+n"):
        assert fwd[labels.index(label)], label
    assert not fwd[labels.index("R at infinity")]
    # R on the valid lanes: x(R) = X/Z, y(R) = Y/Z
    cv = CURVES[curve]
    p, n = cv.fp.modulus, cv.fn.modulus
    coords = np.array(_ints(R), dtype=object).reshape(-1, 3) \
        * pow(R256, -1, p) % p
    for i, (qx, qy, r, s, dg, label) in enumerate(lanes):
        if not want[i]:
            continue
        w = pow(s, -1, n)
        e = int.from_bytes(dg, "big")
        x, y = _mul_add(cv, e * w % n, (cv.gx, cv.gy), r * w % n, (qx, qy))
        X, Y, Z = (int(c) for c in coords[i])
        assert X == x * Z % p and Y == y * Z % p, label
    if curve == "secp256k1":
        from bdls_tpu_torch.ops import glv
        signs = {glv.decompose_host(r * pow(s, -1, n) % n)[1] < 0
                 for (_, _, r, s, _, _), ok in zip(lanes, want) if ok}
        assert signs == {False, True}


@pytest.mark.parametrize("curve", sorted(CURVES))
def test_join_matches_point_add_on_infinity_and_equal_points(curve, shim):
    lib = shim
    cv = CURVES[curve]
    p = cv.fp.modulus
    rng = np.random.default_rng(92)

    def scalar():
        return int.from_bytes(rng.bytes(32), "big") % (cv.fn.modulus - 1) + 1

    def proj(P):
        if P is None:
            return (0, R256 % p, 0)
        z = int.from_bytes(rng.bytes(32), "big") % (p - 1) + 1
        return tuple(v * R256 % p for v in (P[0] * z, P[1] * z, z))

    P = _mul_add(cv, scalar(), (cv.gx, cv.gy))
    Q = _mul_add(cv, scalar(), (cv.gx, cv.gy))
    neg = (P[0], p - P[1])
    pairs = [(None, P), (P, None), (None, None), (P, P), (P, neg), (P, Q)]
    out = np.zeros((2, 3, 8), np.uint32)
    for a, b in pairs:
        inp = _u32([v for pt in (a, b) for v in proj(pt)])
        for reverse in (0, 1):
            lib.host_pinned_join(CURVE_IDS[curve], _ptr(inp), _ptr(out),
                                 reverse)
            assert np.array_equal(out[0], out[1]), (a, b, reverse)
        X, Y, Z = (v * pow(R256, -1, p) % p for v in _ints(out[0]))
        want = _mul_add(cv, 1, a, 1, b) if a and b else (a or b)
        if want is None:
            assert Z == 0 and X == 0 and Y != 0, (a, b)
        else:
            assert Z and X == want[0] * Z % p and Y == want[1] * Z % p, (a, b)


# (curve, the entry's x, y negated): pool entries from the pool's x and
# psi(Q)'s x, and G entries
ADDEND_CASES = [("P-256", "x", False), ("P-256", "x", True),
                ("P-256", "g", False), ("secp256k1", "x", False),
                ("secp256k1", "x", True), ("secp256k1", "psi_x", False),
                ("secp256k1", "psi_x", True), ("secp256k1", "g", False)]


@pytest.mark.parametrize(
    "curve,source,neg", ADDEND_CASES,
    ids=[f"{c}-{x}{'-neg' if n else ''}" for c, x, n in ADDEND_CASES])
def test_addend_put_reads_pool_and_g_entries(curve, source, neg, shim):
    cv = CURVES[curve]
    p = cv.fp.modulus
    rng = np.random.default_rng(94)
    out = np.zeros((3, 8), np.uint32)
    if source == "g":
        g32 = vf.device_g32_table(curve, torch.device("cpu")).numpy()
        g32 = np.ascontiguousarray(g32).view(np.uint32)
        for pos, byte in ((0, 0), (0, 1), (17, int(rng.integers(256))),
                          (31, 255)):
            shim.host_addend(CURVE_IDS[curve], None, None, _ptr(g32), 0, 0,
                             pos, byte, _ptr(out))
            assert np.array_equal(out, g32[pos, byte]), (pos, byte)
        return
    k = int.from_bytes(rng.bytes(32), "big") % (cv.fn.modulus - 1) + 1
    tabs = vf.pinned_device_tables(
        curve, vf.build_pinned_tables(curve, *_mul_add(cv, k, (cv.gx,
                                                               cv.gy))))
    xs = np.ascontiguousarray(tabs[source]).view(np.uint32)
    ys = np.ascontiguousarray(tabs["y"]).view(np.uint32)
    npos = vf.pinned_positions(curve)
    for pos in (0, npos // 2, npos - 1):
        for mag in range(9):
            shim.host_addend(CURVE_IDS[curve], _ptr(xs[pos, mag]),
                             _ptr(ys[pos, mag]), None, mag, int(neg), 0, 0,
                             _ptr(out))
            x, y, z = _ints(out)
            y_want = _ints(ys[pos, mag])[0]
            assert x == _ints(xs[pos, mag])[0], (pos, mag)
            assert y == ((p - y_want) % p if neg else y_want), (pos, mag)
            assert z == (R256 % p if mag else 0), (pos, mag)


def test_count_epilogue_votes_once_a_lane_of_the_pinned_body(shim):
    group = shim.host_pinned_group_size()
    assert group == _build.LANE_THREADS["vpu"]
    curve = "P-256"
    lanes, slot, pools, cap, want = _batch(curve)
    cols = [np.ascontiguousarray(ints_to_limbs(c).view(np.int32))
            for c in vectors.columns(lanes)[2:]]
    got, _ = _run(shim, curve, cols, slot, pools, cap, reverse=False)
    ok = np.array(got, np.uint8)
    rng = np.random.default_rng(93)
    for B in (1, 3, len(ok)):
        mask = rng.integers(0, 2, B).astype(np.uint8)
        lanes_a_block = 32 // group
        partial = np.zeros(-(-B // lanes_a_block), np.uint32)
        blocks = shim.host_pinned_partials(_ptr(ok[:B].copy()), _ptr(mask),
                                           _ptr(partial), B, 32)
        assert blocks == len(partial)
        for j in range(blocks):
            lo, hi = j * lanes_a_block, min(B, (j + 1) * lanes_a_block)
            assert partial[j] == int((ok[lo:hi] & mask[lo:hi]).sum())
        plain = _plain_verdicts(curve, cols, slot, pools)[:B]
        assert int(partial.sum()) == int(pmesh.masked_count_plain(
            torch.tensor(plain), torch.from_numpy(mask.astype(bool))))
