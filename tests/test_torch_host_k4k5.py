"""K4 (``csrc/mont16_group.cuh``) and K5 (``csrc/mxu.cuh``) built for the
host with g++.

The headers compile without ``__CUDACC__``, so this test builds two C
shims into ``build/``: one as the vpu kernels are built, one with
``-DBDLS_MUL_MXU`` as the mxu builds are (every product of the group
bodies is then K5's warp call: the same staging, fragment slots, column
stores and carries as on the card, for the 32 threads of a warp, with the
``mma.sync`` tile emulated from the fragments by the PTX layout; a
round's operands are gathered from every share first, then the warp runs
once). It checks, exactly:

- K5's ``mont_mul`` against the CIOS ``mont_mul_cios`` bit for bit, and
  against Python integers, on the five moduli at edge and seeded values;
- one warp call on 32 distinct operand pairs (and on a part of them, the
  others left out of ``active``) against Python integers, on the five
  moduli (Montgomery, and the fold through 2^256 = 38 mod 2^255 - 19);
- K4's s^-1·R mod n (a binary extended Euclid a lane) against integers,
  with s = 0, s = n and s >= n among the others, in both share orders;
- K4's group body as ``csrc/mont16.cu`` runs it, in both share orders,
  against the plain ``verify_kernel`` and the integer ECDSA, with s = 0,
  s = n, s >= n and r = 0 next to valid lanes in the first block, the
  other hostile lanes and the lanes that take each exceptional select
  (``vectors.select_lanes``);
- the group bodies of K1, K7, K2 and K8 built with ``-DBDLS_MUL_MXU``
  (grp::mxu_prod, grp::ed_field_mxu; GROUP 8), with the shares of each
  step forward and reversed, against their plain twins under
  ``fold.mul_backend("mxu")`` and the integer oracles, hostile lanes
  included: r or s of 0 or n, Q off the curve, Q = (0, 0), the r + n
  branch, R at infinity, wrong and out-of-range slots, Ed25519's
  undecodable points and S >= L.

Test-only: on the CPU the port runs the plain versions. The test skips,
from a fixture, where g++ is absent.
"""

from __future__ import annotations

import ctypes
import shutil

import numpy as np
import pytest
import torch

from bdls_tpu_torch.crypto import vectors
from bdls_tpu_torch.crypto.marshal import ints_to_limbs
from bdls_tpu_torch.ops import _build, ecdsa
from bdls_tpu_torch.ops import ed25519 as ed_ops
from bdls_tpu_torch.ops import verify_fold as vf
from bdls_tpu_torch.ops.curves import CURVES, ED25519, EDWARDS_CURVES
from bdls_tpu_torch.ops.ecdsa import CURVE_IDS

torch.set_num_threads(1)

SHIM = r"""
#include <string.h>

#include "block.cuh"
#include "edwards_group.cuh"
#include "mont16_group.cuh"
#include "pinned_group.cuh"
using namespace bdls;

template <class M>
static void fmul(const uint32_t* a, const uint32_t* b, uint32_t* cios,
                 uint32_t* mma, int n) {
  for (int k = 0; k < n; ++k) {
    fe x, y, z;
    for (int i = 0; i < 8; ++i) { x.v[i] = a[8 * k + i]; y.v[i] = b[8 * k + i]; }
    mont_mul_cios<M>(z, x, y);
    for (int i = 0; i < 8; ++i) cios[8 * k + i] = z.v[i];
    mxu::mont_mul<M>(z, x, y);
    for (int i = 0; i < 8; ++i) mma[8 * k + i] = z.v[i];
  }
}

extern "C" void host_field_mul(int mod, const uint32_t* a, const uint32_t* b,
                               uint32_t* cios, uint32_t* mma, int n) {
  if (mod == 0) fmul<P256P>(a, b, cios, mma, n);
  else if (mod == 1) fmul<P256N>(a, b, cios, mma, n);
  else if (mod == 2) fmul<K256P>(a, b, cios, mma, n);
  else if (mod == 3) fmul<K256N>(a, b, cios, mma, n);
  else fmul<P25519>(a, b, cios, mma, n);
}

// K4's group body on B lanes, as csrc/mont16.cu runs it (a lane a thread
// group), the shares of each step forward or reversed: the verdicts and
// each lane's s^-1·R mod n
template <class C>
static void mont16_run(const int32_t* qx, const int32_t* qy, const int32_t* r,
                       const int32_t* s, const int32_t* e,
                       const uint32_t* gtab, uint8_t* out, uint32_t* sm,
                       int B) {
  grp::m16_state* st = new grp::m16_state();
  const grp::gctx g{0, 0};
  for (int b = 0; b < B; ++b) {
    out[b] = grp::verify_lane_mont16_group<C>(g, *st, qx, qy, r, s, e, gtab,
                                              b, B) ? 1 : 0;
    for (int i = 0; i < 8; ++i) sm[8 * b + i] = st->sm.v[i];
  }
  delete st;
}

extern "C" void host_mont16(int curve, const int32_t* qx, const int32_t* qy,
                            const int32_t* r, const int32_t* s,
                            const int32_t* e, const uint32_t* gtab,
                            uint8_t* out, uint32_t* sm, int B, int reverse) {
  grp::host_reverse() = reverse != 0;
  if (curve == 0) mont16_run<CurveP256>(qx, qy, r, s, e, gtab, out, sm, B);
  else mont16_run<CurveK256>(qx, qy, r, s, e, gtab, out, sm, B);
  grp::host_reverse() = false;
}

// one K5 warp call: thread k's a[k]·b[k] (mod 0-3 Montgomery, mod 4 the
// plain product mod 2^255 - 19), the threads of `active` kept
template <class M>
static void warp_mont(fe out[32], const fe a[32], const fe b[32],
                      unsigned active) {
  const int s[32] = {};
  grp::mxu_prod<M>{0}.host(out, a, b, active, s);
}

extern "C" void host_warp_call(int mod, const uint32_t* a, const uint32_t* b,
                               uint32_t* out, unsigned active) {
  fe x[32], y[32], z[32] = {};
  for (int k = 0; k < 32; ++k)
    for (int i = 0; i < 8; ++i) {
      x[k].v[i] = a[8 * k + i];
      y[k].v[i] = b[8 * k + i];
    }
  switch (mod) {
    case 0: warp_mont<P256P>(z, x, y, active); break;
    case 1: warp_mont<P256N>(z, x, y, active); break;
    case 2: warp_mont<K256P>(z, x, y, active); break;
    case 3: warp_mont<K256N>(z, x, y, active); break;
    default: {
      const int s[32] = {};
      grp::ed_field_mxu{}.host(z, x, y, active, s);
    }
  }
  for (int k = 0; k < 32; ++k)
    for (int i = 0; i < 8; ++i) out[8 * k + i] = z[k].v[i];
}

// whether the build's group bodies make their products collectively
extern "C" int host_collective() {
  return grp::field_prod<P256P>::collective &&
         grp::ed_engine::collective ? 1 : 0;
}

// K1's group body on B lanes, the shares of each step in order or reversed
extern "C" void host_verify(int curve, const int32_t* qx, const int32_t* qy,
                            const int32_t* r, const int32_t* s,
                            const int32_t* e, const uint32_t* g32,
                            uint8_t* out, int B, int reverse) {
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
  }
  delete st;
  grp::host_reverse() = false;
}

// K7's group lane body and tally, as csrc/block.cu runs them
extern "C" void host_block(int curve, const uint32_t* words,
                           const int32_t* nblocks, const int32_t* qx,
                           const int32_t* qy, const int32_t* r,
                           const int32_t* s, const int32_t* lane_tx,
                           const int32_t* lane_org, const uint32_t* org_mask,
                           const int32_t* required, const uint32_t* g32,
                           uint8_t* hit, uint8_t* valid, int32_t* flags,
                           int NB, int L, int T, int O, int reverse) {
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

// K2's group body
extern "C" void host_verify_pinned(int curve, const int32_t* r,
                                   const int32_t* s, const int32_t* e,
                                   const int32_t* slot, const uint32_t* px,
                                   const uint32_t* py, const uint32_t* ppsi,
                                   const uint32_t* g32, uint8_t* out, int B,
                                   int cap, int reverse) {
  grp::host_reverse() = reverse != 0;
  grp::pin_state* st = new grp::pin_state;
  const grp::gctx g{0, 0};
  const grp::pin_tabs tabs{px, py, curve == 1 ? ppsi : px, g32, cap};
  for (int b = 0; b < B; ++b) {
    const bool ok = curve == 0
        ? grp::verify_pinned_group<CurveP256>(g, *st, r, s, e, slot, tabs, b,
                                              B)
        : grp::verify_pinned_group<CurveK256>(g, *st, r, s, e, slot, tabs, b,
                                              B);
    out[b] = ok ? 1 : 0;
  }
  delete st;
  grp::host_reverse() = false;
}

// K8's group body over the build's field (ed_field_mxu with the flag)
extern "C" void host_verify_ed25519(const int32_t* ax, const int32_t* ay,
                                    const int32_t* rx, const int32_t* ry,
                                    const int32_t* s, const int32_t* k,
                                    const uint32_t* btab, uint8_t* out,
                                    int B, int reverse) {
  grp::host_reverse() = reverse != 0;
  grp::ed_state* st = new grp::ed_state;
  const grp::gctx g{0, 0};
  for (int b = 0; b < B; ++b)
    out[b] = grp::verify_ed25519_group<grp::ed_engine>(
        g, *st, ax, ay, rx, ry, s, k, btab, b, B) ? 1 : 0;
  delete st;
  grp::host_reverse() = false;
}
"""

MODULI = [CURVES["P-256"].fp, CURVES["P-256"].fn, CURVES["secp256k1"].fp,
          CURVES["secp256k1"].fn, EDWARDS_CURVES["ed25519"].fp]
R = 1 << 256


def _compile(flags: tuple) -> ctypes.CDLL:
    if shutil.which("g++") is None:
        pytest.skip("g++ not found: the host build of the kernel is skipped")
    return _build.host_shim(SHIM, "host_k4k5", flags)


@pytest.fixture(scope="module")
def vpu():
    return _compile(())


@pytest.fixture(scope="module")
def mxu():
    return _compile(("-DBDLS_MUL_MXU",))


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def _words(xs) -> np.ndarray:
    return np.array([[(x >> (32 * i)) & 0xFFFFFFFF for i in range(8)]
                     for x in xs], dtype=np.uint32)


def _ints(w: np.ndarray) -> list[int]:
    return [sum(int(row[i]) << (32 * i) for i in range(8)) for row in w]


@pytest.mark.parametrize("mod", range(len(MODULI)))
def test_mxu_product_equals_cios_bit_for_bit(mxu, mod):
    m = MODULI[mod].modulus
    rng = np.random.default_rng(130 + mod)
    xs = [0, 1, 2, m - 1, m - 2, m, m + 1, R - 1, R - 2, 1 << 255] + [
        int.from_bytes(rng.bytes(32), "big") for _ in range(150)]
    ys = [0, 1, m - 1, m - 2, 2, (1 << 224) % m, m - 1, m - 1, 1, 3] + [
        int.from_bytes(rng.bytes(32), "big") % m for _ in range(150)]
    a, b = _words(xs), _words(ys)
    cios, mma = np.zeros_like(a), np.zeros_like(a)
    mxu.host_field_mul(mod, _ptr(a), _ptr(b), _ptr(cios), _ptr(mma), len(xs))
    assert np.array_equal(cios, mma)
    assert _ints(mma) == [x * y * pow(R, -1, m) % m for x, y in zip(xs, ys)]


def _host_mont16(vpu, curve, lanes, reverse):
    cols = [np.ascontiguousarray(ints_to_limbs(c).view(np.int32))
            for c in vectors.columns(lanes)]
    gtab = ecdsa.device_mont16_table(curve, torch.device("cpu")).numpy()
    out = np.zeros(len(lanes), np.uint8)
    sm = np.zeros((len(lanes), 8), np.uint32)
    vpu.host_mont16(CURVE_IDS[curve], *(_ptr(a) for a in (*cols, gtab, out,
                                                         sm)),
                    len(lanes), reverse)
    return cols, out.astype(bool).tolist(), _ints(sm)


@pytest.mark.parametrize("curve", sorted(CURVES))
def test_block_inverse_with_zero_lanes(vpu, curve):
    # K4's s^-1 (a binary extended Euclid of s mod n a lane, then times R)
    # beside zero lanes: s = 0 and s = n give 0, s >= n inverts s mod n
    n = CURVES[curve].fn.modulus
    rng = np.random.default_rng(131)
    qx, qy, r, _, d, _ = vectors.signed_lanes(curve, 1, rng)[0]
    vals = [0, 3, n - 1, 0, n, n + 5] + [
        int.from_bytes(rng.bytes(32), "big") % n for _ in range(31)]
    lanes = [(qx, qy, r, v, d, "s") for v in vals]
    for reverse in (0, 1):
        _, _, sm = _host_mont16(vpu, curve, lanes, reverse)
        assert sm == [pow(v, -1, n) * R % n if v % n else 0 for v in vals]


@pytest.mark.parametrize("curve", sorted(CURVES))
def test_mont16_blocks_match_plain_and_integer_ecdsa(vpu, curve):
    rng = np.random.default_rng(133)
    lanes = vectors.mixed_lanes(curve, rng, n_valid=3)
    # the first block (a warp, lanes_per_block lanes) holds valid lanes
    # beside s = 0; then s = n, s = 2^256 - 1, r = 0, the other hostile
    # lanes and the lanes that take each exceptional select; the last
    # block is ragged
    lanes = lanes[:3] + [ln for ln in lanes if ln[5] in (
        "s = 0", "s = n", "s = 2^256-1", "r = 0")] + lanes[3:] + \
        vectors.select_lanes(curve, rng)
    per = ecdsa.lanes_per_block("vpu")
    if len(lanes) % per == 0:
        lanes = lanes[:-1]
    got = [_host_mont16(vpu, curve, lanes, rev) for rev in (0, 1)]
    cols, host, _ = got[0]
    assert got[1][1] == host
    plain = ecdsa.verify_kernel(CURVES[curve], *(torch.from_numpy(a)
                                                 for a in cols)).tolist()
    assert host == plain == vectors.expected(curve, lanes)
    assert len(lanes) % per and any(host[:per]) and not all(host[:per])


@pytest.mark.parametrize("mod", range(len(MODULI)))
def test_mxu_warp_call_on_32_pairs(mxu, mod):
    m = MODULI[mod].modulus
    rng = np.random.default_rng(140 + mod)
    xs = [R - 1, m - 1, 0, 1] + [int.from_bytes(rng.bytes(32), "big")
                                 for _ in range(28)]
    ys = [m - 1, m - 1, 5, 1] + [int.from_bytes(rng.bytes(32), "big") % m
                                 for _ in range(28)]
    a, b = _words(xs), _words(ys)
    if mod == 4:        # the plain product, the fold through 2^256 = 38
        want = [x * y % m for x, y in zip(xs, ys)]
    else:
        want = [x * y * pow(R, -1, m) % m for x, y in zip(xs, ys)]
    for active in (0xFFFFFFFF, 0x5A0F00F3):
        out = np.zeros_like(a)
        mxu.host_warp_call(mod, _ptr(a), _ptr(b), _ptr(out),
                           ctypes.c_uint(active))
        got = _ints(out)
        assert [got[k] for k in range(32) if active >> k & 1] == \
            [want[k] for k in range(32) if active >> k & 1]


def _mxu_plain(fn, *args):
    from bdls_tpu_torch.ops import fold

    with fold.mul_backend("mxu"):
        return fn(*args)


@pytest.mark.parametrize("curve", sorted(CURVES))
def test_mxu_verify_lane_matches_plain(mxu, curve):
    assert mxu.host_collective() == 1
    rng = np.random.default_rng(135)
    lanes = vectors.mixed_lanes(curve, rng, n_valid=2) + \
        vectors.ladder_lanes(curve, rng)
    labels = [ln[5] for ln in lanes]
    cols = [np.ascontiguousarray(ints_to_limbs(c).view(np.int32))
            for c in vectors.columns(lanes)]
    g32 = vf.device_g32_table(curve, torch.device("cpu")).numpy()
    got = []
    for reverse in (0, 1):
        out = np.zeros(len(lanes), np.uint8)
        mxu.host_verify(CURVE_IDS[curve],
                        *(_ptr(a) for a in (*cols, g32, out)), len(lanes),
                        reverse)
        got.append(out.astype(bool).tolist())
    plain = _mxu_plain(vf.verify_fold, CURVES[curve],
                       *(torch.from_numpy(a) for a in cols)).tolist()
    want = vectors.expected(curve, lanes)
    assert got[0] == got[1] == plain == want
    assert not got[0][labels.index("R at infinity")]
    assert got[0][labels.index("forged r+n")]


@pytest.mark.parametrize("curve", sorted(CURVES))
def test_mxu_block_group_matches_plain(mxu, curve):
    from bdls_tpu_torch.ops import block_verify as bv

    req = vectors.block_request(curve, np.random.default_rng(136), 26,
                                msg_len=(0, 200), hostile=True)
    packed = bv.pack_block_request(req)
    arrs = [np.ascontiguousarray(packed[k]) for k in bv.PACKED_KEYS]
    NB, _, L = packed["words"].shape
    T, O = packed["org_mask"].shape
    g32 = vf.device_g32_table(curve, torch.device("cpu")).numpy()
    pflags, pvalid = bv.launch_block(CURVES[curve], packed, device="cpu",
                                     field="mxu")
    for reverse in (0, 1):
        hit = np.zeros((T, O), np.uint8)
        valid = np.zeros(L, np.uint8)
        flags = np.zeros(T, np.int32)
        mxu.host_block(CURVE_IDS[curve], *(_ptr(a) for a in arrs),
                       _ptr(g32), _ptr(hit), _ptr(valid), _ptr(flags), NB,
                       L, T, O, reverse)
        assert valid.astype(bool).tolist() == pvalid.tolist()
        assert flags.tolist() == pflags.tolist()
    assert pvalid.any() and not pvalid.all()


@pytest.mark.parametrize("curve", sorted(CURVES))
def test_mxu_pinned_lane_matches_plain(mxu, curve):
    rng = np.random.default_rng(137)
    lanes, keys = [], {}
    for lane in vectors.mixed_lanes(curve, rng, n_valid=2) + \
            vectors.zero_byte_lanes(curve, rng):
        try:
            vf.build_pinned_tables(curve, lane[0], lane[1])
        except ValueError:
            continue
        keys.setdefault(lane[:2], len(keys))
        lanes.append(lane)
    cap = len(keys)
    slots = [keys[lane[:2]] for lane in lanes]
    lanes += [lanes[0], lanes[0], lanes[0]]
    slots += [(slots[0] + 1) % cap, cap, -1]
    pools = {nm: np.zeros((cap, vf.pinned_positions(curve), 9, 8), np.int32)
             for nm in vf.PINNED_COORDS[curve]}
    for (qx, qy), i in keys.items():
        tabs = vf.pinned_device_tables(
            curve, vf.build_pinned_tables(curve, qx, qy))
        for nm in pools:
            pools[nm][i] = tabs[nm]
    cols = [np.ascontiguousarray(ints_to_limbs(c).view(np.int32))
            for c in vectors.columns(lanes)[2:]]
    slot = np.array(slots, np.int32)
    g32 = vf.device_g32_table(curve, torch.device("cpu")).numpy()
    psi = pools.get("psi_x", pools["x"])
    got = []
    for reverse in (0, 1):
        out = np.zeros(len(lanes), np.uint8)
        mxu.host_verify_pinned(
            CURVE_IDS[curve], *(_ptr(a) for a in (*cols, slot, pools["x"],
                                                  pools["y"], psi, g32,
                                                  out)),
            len(lanes), cap, reverse)
        got.append(out.astype(bool).tolist())
    plain = _mxu_plain(
        vf.verify_fold_pinned, CURVES[curve],
        *(torch.from_numpy(a) for a in cols), torch.from_numpy(slot),
        {nm: torch.from_numpy(v) for nm, v in pools.items()}).tolist()
    host = got[0]
    assert got[1] == host == plain
    assert host[:-3] == vectors.expected(curve, lanes[:-3])
    assert host[-3:] == [False, False, False]


def test_mxu_ed25519_lane_matches_plain_and_oracle(mxu):
    rng = np.random.default_rng(139)
    lanes = vectors.ed25519_mixed_lanes(rng, n_valid=2)
    krows = vectors.ed25519_k_rows(rng)
    rows = vectors.ed25519_rows(lanes) + [r[:6] for r in krows]
    labels = [ln[5] for ln in lanes]
    assert "R does not decompress" in labels
    assert any(r[4] >= ed_ops.L for r in rows)
    arrs = [np.ascontiguousarray(a.view(np.int32))
            for a in ed_ops.lanes_to_limbs(rows)]
    btab = ed_ops.device_b_table(torch.device("cpu")).numpy()
    got = []
    for reverse in (0, 1):
        out = np.zeros(len(rows), np.uint8)
        mxu.host_verify_ed25519(*(_ptr(a) for a in (*arrs, btab, out)),
                                len(rows), reverse)
        got.append(out.astype(bool).tolist())
    plain = _mxu_plain(ed_ops.verify_ed25519, ED25519,
                       *(torch.from_numpy(a) for a in arrs)).tolist()
    assert got[0] == got[1] == plain == \
        vectors.ed25519_expected(lanes) + vectors.ed25519_row_expected(krows)
