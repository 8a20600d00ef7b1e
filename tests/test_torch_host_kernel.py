"""The CUDA kernel's arithmetic, built for the host with g++.

``csrc/field.cuh``, ``csrc/point.cuh``, ``csrc/verify.cuh``,
``csrc/glv.cuh``, ``csrc/pinned.cuh``, ``csrc/sha256.cuh``,
``csrc/block.cuh``, the group bodies (``csrc/verify_group.cuh``,
``csrc/pinned_group.cuh``, ``csrc/edwards_group.cuh``) and
``csrc/edwards.cuh`` compile without ``__CUDACC__``
(``__host__``/``__device__`` vanish), so this test builds a tiny C shim
over them into ``build/``, loads it with ctypes, and checks:

- the Montgomery field ops of the five moduli against Python integers
  (edge values and seeded values: carry chains, the final conditional
  subtraction, the Fermat inverse);
- K1's lane body (``grp::verify_lane_group``, the shares of each step
  in turn) against the plain PyTorch ``verify_fold`` and the port's
  integer ECDSA, lane for lane, on valid, tampered and hostile lanes of
  both curves;
- the pinned-key kernel's GLV split (``glv::decompose``) against the
  integer oracle ``glv.decompose_host``, and K2's lane body
  (``grp::verify_pinned_group``) against the plain ``verify_fold_pinned``,
  with wrong and out-of-range slots among the lanes;
- the SHA-256 compression of K6 and K7 (``sha::lane_digest``) against
  ``hashlib`` on 200 seeded messages of 0-1015 bytes and a zero-block
  filler lane, and K7's per-lane body (``block_lane_group``: hash →
  digest limbs → K1's group body) and per-tx tally, run as
  ``csrc/block.cu`` runs them,
  against the plain ``block_kernel``, lane for lane and tx for tx, on a
  hostile block of each curve;
- K8's per-lane body (``grp::verify_ed25519_group``) against the plain
  ``verify_ed25519`` and the RFC 8032 oracle, on the RFC 8032 §7.1
  vectors, seeded signed messages and the hostile Ed25519 lanes;
- K9's arithmetic (``csrc/fp381.cuh``, ``csrc/bls12.cuh``): the 381-bit
  Montgomery field against Python integers; the dense one-thread FQ12
  product, square, Frobenius (k = 1, 2, 6) and per-lane inverse (a zero
  lane included), and the warp's x-chain final exponentiation, against
  the plain twin and the host oracle; the two kernels' bodies (the
  Miller body a warp a pair, then the final body a warp a side and the
  compare) against the plain twin stage for stage, on a valid
  certificate lane and the degenerate y = 0 lane
  (``test_torch_bls_warp.py`` holds the Miller body's two paths);
- the warp operations (``csrc/bls12.cuh``, a warp's 32 shares run in
  turn): the Karatsuba tower product, the cyclotomic square on elements
  after the easy part, conjugation and the sparse frob1 and frob2,
  against the dense operations and the oracle; and K11's body
  (``final_side`` and the compare, as ``bls_final_full_kernel`` runs
  them) on 18 sides, nine lanes of the kinds of ``chip_smoke.py``'s
  phase 3d, the zero side included, against the plain ``final_exp``
  (square-and-multiply) and the oracle's ``pow``;
- K10's per-lane term (``masked_count_host`` over ``lane_valid``, which
  the counting verify kernels' epilogue sums) against its plain twin.

Test-only: on the CPU the port itself runs the plain version. The test
skips, from a fixture, where g++ is absent. Comparisons are exact.
"""

from __future__ import annotations

import ctypes
import hashlib
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from bdls_tpu_torch.crypto import vectors
from bdls_tpu_torch.crypto.marshal import ints_to_limbs
from bdls_tpu_torch.ops import _build
from bdls_tpu_torch.ops.curves import CURVES, ED25519, EDWARDS_CURVES
from bdls_tpu_torch.ops.ecdsa import CURVE_IDS
from bdls_tpu_torch.ops import block_verify as bv
from bdls_tpu_torch.ops import bls_host as bh
from bdls_tpu_torch.ops import bls_kernel as bk
from bdls_tpu_torch.ops import ed25519 as ed_ops
from bdls_tpu_torch.ops import glv
from bdls_tpu_torch.ops import sha256 as sha_ops
from bdls_tpu_torch.ops import verify_fold as vf
from bdls_tpu_torch.ops.verify_fold import verify_fold

# the plain version runs many ops on tiny tensors: extra intra-op
# threads only contend with the other test workers
torch.set_num_threads(1)

SHIM = r"""
#include <string.h>

#include "block.cuh"
#include "bls12.cuh"
#include "edwards_group.cuh"
#include "mesh.cuh"
#include "pinned_group.cuh"
using namespace bdls;

// the warp's ops (csrc/bls12.cuh), a warp's shares run in turn, over N
// lanes of FQ12 values: 0 product, 1 cyclotomic square, 2 conjugation, 3
// and 4 the sparse frob1 and frob2, 5 K11's exact chain
// (x^((p^12 - 1)/r)), 6 K9's x-chain (its cube)
extern "C" void host_f12w(int op, const int32_t* x, const int32_t* y,
                          const uint32_t* frob, int32_t* out, int N) {
  fe_warp* w = new fe_warp;
  const uint32_t* frob2 = frob + FROB1_NNZ * FROB_ENTRY;
  for (int t = 0; t < N; ++t) {
    f12_load(w->v[0], x, t, N);
    f12_load(w->v[1], y, t, N);
    fq12& r = w->v[FW_OUT];
    switch (op) {
      case 0: w_mul(w->prod, 0, r, w->v[0], w->v[1]); break;
      case 1: w_cyclo_sqr(w->prod, 0, r, w->v[0]); break;
      case 2: w_conj(0, r, w->v[0]); break;
      case 3: w_frob(w->prod, 0, r, w->v[0], frob, FROB1_NNZ); break;
      case 4: w_frob(w->prod, 0, r, w->v[0], frob2, FROB2_NNZ); break;
      case 5: final_exp_exact<false>(*w, 0, frob); break;
      default: final_exp_exact<true>(*w, 0, frob); break;
    }
    f12_store(out, r, t, N);
  }
  delete w;
}

// the final launches' body, as csrc/bls.cu runs it: a block a lane, warp
// 0 then warp 1, each a share at a time, then thread 0's compare
template <bool CUBE>
static void final_blocks(const int32_t* n, const int32_t* d,
                         const uint32_t* frob, int32_t* fe, uint8_t* out,
                         int B) {
  fe_warp* ws = new fe_warp[2];
  const int N = 2 * B;
  for (int b = 0; b < B; ++b) {
    for (int side = 0; side < 2; ++side)
      final_side<CUBE>(ws[side], 0, n, side ? B + b : b, d,
                       side ? b : B + b, N, frob, fe, 2 * b + side);
    out[b] = compare_tail(ws[0].v[FW_OUT], ws[1].v[FW_OUT]) ? 1 : 0;
  }
  delete[] ws;
}

// K11's body
extern "C" void host_final_full(const int32_t* n, const int32_t* d,
                                const uint32_t* frob, int32_t* fe,
                                uint8_t* out, int B) {
  final_blocks<false>(n, d, frob, fe, out, B);
}

// K10's count: the sum the verify kernels' count epilogue reduces
extern "C" uint32_t host_masked_count(const uint8_t* ok,
                                      const uint8_t* mask, int n) {
  return masked_count_host(ok, mask, n);
}

extern "C" void host_fp381(int op, const uint32_t* a, const uint32_t* b,
                           uint32_t* out) {
  fp x, y, z;
  for (int i = 0; i < 12; ++i) { x.v[i] = a[i]; y.v[i] = b[i]; }
  switch (op) {
    case 0: fp_mul(z, x, y); break;
    case 1: fp_add(z, x, y); break;
    case 2: fp_sub(z, x, y); break;
    case 3: fp_to_mont(z, x); break;
    case 4: fp_from_mont(z, x); break;
    default: fp_inv(z, x); break;
  }
  for (int i = 0; i < 12; ++i) out[i] = z.v[i];
}

// the dense one-thread FQ12 ops over N lanes of (12 words, 12
// coefficients, N) arrays
extern "C" void host_f12(int op, const int32_t* x, const int32_t* y,
                         const uint32_t* frob, int32_t* out, int N) {
  const frob_tables fr = frob_at(frob);
  for (int t = 0; t < N; ++t) {
    fq12 a, b, r;
    f12_load(a, x, t, N);
    f12_load(b, y, t, N);
    switch (op) {
      case 0: f12_mul(r, a, b); break;
      case 1: f12_sqr(r, a); break;
      case 2: f12_frob(r, a, fr.k1); break;
      case 3: f12_frob(r, a, fr.k2); break;
      case 4: f12_frob(r, a, fr.k6); break;
      default: f12_inv(r, a, fr.k1); break;
    }
    f12_store(out, r, t, N);
  }
}

// the bodies of csrc/bls.cu's K9 kernels: the Miller launch a warp a
// pair, the final launch a block of two warps a lane
extern "C" void host_bls_miller(const int32_t* qx, const int32_t* qy,
                                const int32_t* px, const int32_t* py,
                                int32_t* n, int32_t* d, int N) {
  miller_warp* w = new miller_warp;
  for (int t = 0; t < N; ++t)
    miller_pair(*w, 0, qx, qy, px, py, t, N, n, d);
  delete w;
}

extern "C" void host_bls_final(const int32_t* n, const int32_t* d,
                               const uint32_t* frob, int32_t* fe,
                               uint8_t* out, int B) {
  final_blocks<true>(n, d, frob, fe, out, B);
}

template <class M>
static void field_op(int op, const uint32_t* a, const uint32_t* b,
                     uint32_t* out) {
  fe x, y, z;
  for (int i = 0; i < 8; ++i) { x.v[i] = a[i]; y.v[i] = b[i]; }
  switch (op) {
    case 0: mont_mul<M>(z, x, y); break;
    case 1: add_mod<M>(z, x, y); break;
    case 2: sub_mod<M>(z, x, y); break;
    case 3: to_mont<M>(z, x); break;
    default: mont_inv<M>(z, x); break;
  }
  for (int i = 0; i < 8; ++i) out[i] = z.v[i];
}

extern "C" void host_field(int mod, int op, const uint32_t* a,
                           const uint32_t* b, uint32_t* out) {
  if (mod == 0) field_op<P256P>(op, a, b, out);
  else if (mod == 1) field_op<P256N>(op, a, b, out);
  else if (mod == 2) field_op<K256P>(op, a, b, out);
  else if (mod == 3) field_op<K256N>(op, a, b, out);
  else field_op<P25519>(op, a, b, out);
}

extern "C" void host_verify_ed25519(const int32_t* ax, const int32_t* ay,
                                    const int32_t* rx, const int32_t* ry,
                                    const int32_t* s, const int32_t* k,
                                    const uint32_t* btab, uint8_t* out,
                                    int B) {
  grp::ed_state* st = new grp::ed_state;
  for (int b = 0; b < B; ++b)
    out[b] = grp::verify_ed25519_group<grp::ed_field>(
        grp::gctx{0, 0}, *st, ax, ay, rx, ry, s, k, btab, b, B) ? 1 : 0;
  delete st;
}

extern "C" void host_verify(int curve, const int32_t* qx, const int32_t* qy,
                            const int32_t* r, const int32_t* s,
                            const int32_t* e, const uint32_t* g32,
                            uint8_t* out, int B) {
  grp::lane_state* st = new grp::lane_state;
  for (int b = 0; b < B; ++b) {
    const grp::gctx g{0, 0};
    const bool ok = curve == 0
        ? grp::verify_lane_group<CurveP256>(g, *st, qx, qy, r, s, e, g32, b,
                                            B)
        : grp::verify_lane_group<CurveK256>(g, *st, qx, qy, r, s, e, g32, b,
                                            B);
    out[b] = ok ? 1 : 0;
  }
  delete st;
}

extern "C" void host_glv(const uint32_t* k, uint32_t* halves,
                         uint8_t* signs) {
  fe kk;
  for (int i = 0; i < 8; ++i) kk.v[i] = k[i];
  bool n1, n2;
  glv::decompose(halves, n1, halves + glv::HALF_WORDS, n2, kk);
  signs[0] = n1 ? 1 : 0;
  signs[1] = n2 ? 1 : 0;
}

extern "C" void host_verify_pinned(int curve, const int32_t* r,
                                   const int32_t* s, const int32_t* e,
                                   const int32_t* slot, const uint32_t* px,
                                   const uint32_t* py, const uint32_t* ppsi,
                                   const uint32_t* g32, uint8_t* out, int B,
                                   int cap) {
  grp::pin_state* st = new grp::pin_state;
  const grp::pin_tabs tabs{px, py, curve == 1 ? ppsi : px, g32, cap};
  for (int b = 0; b < B; ++b) {
    const grp::gctx g{0, 0};
    const bool ok = curve == 0
        ? grp::verify_pinned_group<CurveP256>(g, *st, r, s, e, slot, tabs, b,
                                              B)
        : grp::verify_pinned_group<CurveK256>(g, *st, r, s, e, slot, tabs, b,
                                              B);
    out[b] = ok ? 1 : 0;
  }
  delete st;
}

extern "C" void host_sha256(const uint32_t* words, const int32_t* nblocks,
                            uint32_t* out, int NB, int B) {
  for (int b = 0; b < B; ++b) {
    uint32_t st[8];
    sha::lane_digest(st, words, nblocks[b], NB, b, B);
    for (int j = 0; j < 8; ++j) out[(size_t)j * B + b] = st[j];
  }
}

// the three steps of csrc/block.cu, one lane or tx at a time
extern "C" void host_block(int curve, const uint32_t* words,
                           const int32_t* nblocks, const int32_t* qx,
                           const int32_t* qy, const int32_t* r,
                           const int32_t* s, const int32_t* lane_tx,
                           const int32_t* lane_org, const uint32_t* org_mask,
                           const int32_t* required, const uint32_t* g32,
                           uint8_t* hit, uint8_t* valid, int32_t* flags,
                           int NB, int L, int T, int O) {
  memset(hit, 0, (size_t)T * O);
  grp::lane_state* st = new grp::lane_state;
  for (int b = 0; b < L; ++b) {
    const grp::gctx g{0, 0};
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
  for (int t = 0; t < T; ++t) flags[t] = tally_tx(hit, org_mask, required, t, O);
  delete st;
}
"""

MODULI = [("P-256", "fp"), ("P-256", "fn"), ("secp256k1", "fp"),
          ("secp256k1", "fn"), ("ed25519", "fp")]
R = 1 << 256


@pytest.fixture(scope="module")
def shim():
    if shutil.which("g++") is None:
        pytest.skip("g++ not found: the host build of the kernel is skipped")
    return _build.host_shim(SHIM, "host_verify")


def _u32x8(x: int):
    return (ctypes.c_uint32 * 8)(*[(x >> (32 * i)) & 0xFFFFFFFF
                                   for i in range(8)])


def _int(a) -> int:
    return sum(int(a[i]) << (32 * i) for i in range(8))


@pytest.mark.parametrize("mod", range(len(MODULI)),
                         ids=[f"{c}:{k}" for c, k in MODULI])
def test_field_ops_match_python_ints(shim, mod):
    curve, kind = MODULI[mod]
    m = getattr({**CURVES, **EDWARDS_CURVES}[curve], kind).modulus
    rng = np.random.default_rng(100 + mod)
    # reduced inputs, as the kernels keep them (2^255 > 2^255 - 19)
    vals = [v % m for v in (0, 1, 2, m - 1, m - 2, 1 << 255,
                            (1 << 224) - 1)] + [
        int.from_bytes(rng.bytes(32), "big") % m for _ in range(60)]
    rinv = pow(R, -1, m)

    def op(code, a, b=0):
        out = (ctypes.c_uint32 * 8)()
        shim.host_field(mod, code, _u32x8(a), _u32x8(b), out)
        return _int(out)

    for i, a in enumerate(vals):
        b = vals[(7 * i + 3) % len(vals)]
        assert op(0, a, b) == a * b * rinv % m
        assert op(1, a, b) == (a + b) % m
        assert op(2, a, b) == (a - b) % m
    for a in [R - 1, m, m + 1] + vals[:10]:          # any a < 2^256
        assert op(3, a) == a * R % m
    for a in vals[:12]:
        assert op(4, a * R % m) == pow(a, m - 2, m) * R % m


@pytest.mark.parametrize("curve", sorted(CURVES))
def test_verify_lane_matches_plain(shim, curve):
    rng = np.random.default_rng(55)
    lanes = vectors.mixed_lanes(curve, rng)
    cols = [np.ascontiguousarray(ints_to_limbs(c).view(np.int32))
            for c in vectors.columns(lanes)]
    g32 = vf.device_g32_table(curve, torch.device("cpu")).numpy()
    out = np.zeros(len(lanes), np.uint8)
    ptr = [a.ctypes.data_as(ctypes.c_void_p) for a in (*cols, g32, out)]
    shim.host_verify(CURVE_IDS[curve], *ptr, len(lanes))
    host = out.astype(bool).tolist()
    plain = verify_fold(CURVES[curve],
                        *(torch.from_numpy(a) for a in cols)).tolist()
    assert host == plain
    assert host == vectors.expected(curve, lanes)


def test_glv_split_matches_integer_oracle(shim):
    rng = np.random.default_rng(56)
    n = glv.N
    ks = [0, 1, n - 1, glv.LAMBDA, n - glv.LAMBDA] + [
        int.from_bytes(rng.bytes(32), "big") % n for _ in range(500)]
    # k next to a step of c1 or c2 = (k·g) >> 384
    for g in (glv.G1C, glv.G2C):
        for m in (1, 7, 1 << 64):
            k = -((-m << glv.SHIFT) // g)
            ks += [k - 1, k, k + 1]
    for k in ks:
        halves = (ctypes.c_uint32 * 10)()
        signs = (ctypes.c_uint8 * 2)()
        shim.host_glv(_u32x8(k), halves, signs)
        k1 = sum(int(halves[i]) << (32 * i) for i in range(5))
        k2 = sum(int(halves[5 + i]) << (32 * i) for i in range(5))
        assert ((-k1 if signs[0] else k1), (-k2 if signs[1] else k2)) == \
            glv.decompose_host(k), hex(k)


@pytest.mark.parametrize("curve", sorted(CURVES))
def test_verify_pinned_lane_matches_plain(shim, curve):
    rng = np.random.default_rng(57)
    lanes, keys = [], {}
    for lane in vectors.mixed_lanes(curve, rng):
        try:
            vf.build_pinned_tables(curve, lane[0], lane[1])
        except ValueError:
            continue
        keys.setdefault(lane[:2], len(keys))
        lanes.append(lane)
    cap = len(keys)
    slots = [keys[lane[:2]] for lane in lanes]
    # a valid signature under another key's slot, and slots off the pool
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
    out = np.zeros(len(lanes), np.uint8)
    psi = pools.get("psi_x", pools["x"])
    ptr = [a.ctypes.data_as(ctypes.c_void_p)
           for a in (*cols, slot, pools["x"], pools["y"], psi, g32, out)]
    shim.host_verify_pinned(CURVE_IDS[curve], *ptr, len(lanes), cap)
    host = out.astype(bool).tolist()
    plain = vf.verify_fold_pinned(
        CURVES[curve], *(torch.from_numpy(a) for a in cols),
        torch.from_numpy(slot),
        {nm: torch.from_numpy(v) for nm, v in pools.items()}).tolist()
    assert host == plain
    want = vectors.expected(curve, lanes)
    assert host[:-3] == want[:-3] and host[-3:] == [False] * 3


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def test_sha256_lane_digest_matches_hashlib(shim):
    rng = np.random.default_rng(58)
    msgs = [rng.bytes(int(n)) for n in rng.integers(0, 1016, 198)]
    msgs += [b"", bytes(1015)]
    words, nblocks = sha_ops.pad_messages(msgs + [b""])
    nblocks[-1] = 0                          # bucket filler: the IV
    B = len(msgs) + 1
    out = np.zeros((8, B), np.uint32)
    shim.host_sha256(_ptr(words), _ptr(nblocks), _ptr(out), words.shape[0], B)
    digests = out.astype(">u4")
    for i, m in enumerate(msgs):
        assert digests[:, i].tobytes() == hashlib.sha256(m).digest(), len(m)
    assert out[:, -1].tolist() == sha_ops.H0.tolist()


@pytest.mark.parametrize("curve", sorted(CURVES))
def test_block_lane_and_tally_match_plain(shim, curve):
    req = vectors.block_request(curve, np.random.default_rng(59), 26,
                                msg_len=(0, 200), hostile=True)
    packed = bv.pack_block_request(req)
    arrs = [np.ascontiguousarray(packed[k]) for k in bv.PACKED_KEYS]
    NB, _, L = packed["words"].shape
    T, O = packed["org_mask"].shape
    g32 = vf.device_g32_table(curve, torch.device("cpu")).numpy()
    hit = np.zeros((T, O), np.uint8)
    valid = np.zeros(L, np.uint8)
    flags = np.zeros(T, np.int32)
    shim.host_block(CURVE_IDS[curve], *(_ptr(a) for a in arrs), _ptr(g32),
                    _ptr(hit), _ptr(valid), _ptr(flags), NB, L, T, O)
    pflags, pvalid = bv.launch_block(CURVES[curve], packed, device="cpu")
    assert valid.astype(bool).tolist() == pvalid.tolist()
    assert flags.tolist() == pflags.tolist()


def test_verify_lane_ed25519_matches_plain_and_oracle(shim):
    rng = np.random.default_rng(60)
    lanes = vectors.ed25519_mixed_lanes(rng)
    lanes += vectors.ed25519_signed_lanes(12, rng)
    arrs = [np.ascontiguousarray(a.view(np.int32))
            for a in ed_ops.lanes_to_limbs(vectors.ed25519_rows(lanes))]
    btab = ed_ops.device_b_table(torch.device("cpu")).numpy()
    out = np.zeros(len(lanes), np.uint8)
    shim.host_verify_ed25519(*(_ptr(a) for a in (*arrs, btab, out)),
                             len(lanes))
    host = out.astype(bool).tolist()
    plain = ed_ops.verify_ed25519(
        ED25519, *(torch.from_numpy(a) for a in arrs)).tolist()
    assert host == plain
    assert host == vectors.ed25519_expected(lanes)


# ---------------------------------------------------------------- K9

def _w12(x: int):
    return (ctypes.c_uint32 * 12)(*[(x >> (32 * i)) & 0xFFFFFFFF
                                    for i in range(12)])


def test_fp381_ops_match_python_ints(shim):
    p, R = bh.P, 1 << 384
    rng = np.random.default_rng(61)
    vals = [0, 1, 2, p - 1, p - 2, (1 << 380) + 5] + [
        int.from_bytes(rng.bytes(48), "little") % p for _ in range(60)]
    rinv = pow(R, -1, p)

    def op(code, a, b=0):
        out = (ctypes.c_uint32 * 12)()
        shim.host_fp381(code, _w12(a), _w12(b), out)
        return sum(int(out[i]) << (32 * i) for i in range(12))

    for i, a in enumerate(vals):
        b = vals[(7 * i + 3) % len(vals)]
        assert op(0, a, b) == a * b * rinv % p
        assert op(1, a, b) == (a + b) % p
        assert op(2, a, b) == (a - b) % p
        assert op(4, a) == a * rinv % p
    for a in [R - 1, p, p + 1] + vals[:10]:          # any a < 2^384
        assert op(3, a) == a * R % p
    for a in vals[:8]:
        assert op(5, a * R % p) == pow(a, p - 2, p) * R % p


def _f12_arr(elts) -> np.ndarray:
    return np.ascontiguousarray(bk.f12_words(elts).view(np.int32))


def _host_f12(shim, op, x, y=None):
    frob = bk.frob_table_host()
    out = np.zeros_like(x)
    shim.host_f12(op, _ptr(x), _ptr(x if y is None else y), _ptr(frob),
                  _ptr(out), x.shape[-1])
    return bk.words_to_ints(out)


def test_f12_ops_match_plain_and_oracle(shim):
    rng = np.random.default_rng(62)

    def rand():
        return bh.FQ12([int.from_bytes(rng.bytes(48), "little") % bh.P
                        for _ in range(12)])

    a = [rand(), rand(), bh.FQ12.zero()]
    b = [rand(), rand(), rand()]
    xa, xb = _f12_arr(a), _f12_arr(b)
    pa, pb = (bk.f12_from_words(torch.from_numpy(x)) for x in (xa, xb))

    def oracle(vals):
        return [[v.c[d] for v in vals] for d in range(12)]

    assert _host_f12(shim, 0, xa, xb) == bk.f12_to_ints(bk.f12_mul(pa, pb)) \
        == oracle([x * y for x, y in zip(a, b)])
    assert _host_f12(shim, 1, xa) == bk.f12_to_ints(bk.f12_sqr(pa)) \
        == oracle([x * x for x in a])
    for op, k in ((2, 1), (3, 2), (4, 6)):
        assert _host_f12(shim, op, xa) == \
            bk.f12_to_ints(bk.f12_frob(pa, k)) \
            == oracle([x.pow(bh.P ** k) for x in a]), k
    inv = _host_f12(shim, 5, xa)
    assert inv == bk.f12_to_ints(bk.f12_inv(pa))
    for i in (0, 1):
        assert bh.FQ12([inv[d][i] for d in range(12)]) * a[i] == \
            bh.FQ12.one()
    assert all(inv[d][2] == 0 for d in range(12))       # zero -> zero
    # the x-chain final exponentiation (K9's, on the warp): the oracle's,
    # cubed
    fe = _host_f12w(shim, 6, xa[..., :1].copy())
    want = a[0].pow((bh.P ** 12 - 1) // bh.R)
    assert fe == bk.f12_to_ints(bk.final_exp_fast(
        bk.f12_from_words(torch.from_numpy(xa[..., :1].copy())))) \
        == oracle([want * want * want])


def test_bls_kernel_bodies_match_plain(shim):
    """A valid certificate lane and the y = 0 "signature": Miller (n, d)
    of all four pairs, both final exponentiations and the verdicts,
    against the plain twin."""
    sk, pk = bh.keygen(0x5151)
    hm = bh.hash_to_g2(b"bls lane")
    forged = (bh.FQ12.scalar(1), bh.FQ12.zero())
    q = [bh.sign(sk, b"bls lane"), forged, hm, hm]
    p = [bh.G1, bh.G1, pk, pk]
    arrs = [_f12_arr([pt[i] for pt in pts]) for pts in (q, p) for i in (0, 1)]
    n, d = np.zeros_like(arrs[0]), np.zeros_like(arrs[0])
    shim.host_bls_miller(*(_ptr(a) for a in (*arrs, n, d)), 4)
    pn, pd = bk.miller_nd(*(bk.f12_from_words(torch.from_numpy(a))
                            for a in arrs))
    assert bk.words_to_ints(n) == bk.f12_to_ints(pn)
    assert bk.words_to_ints(d) == bk.f12_to_ints(pd)

    fe = np.zeros_like(n)
    out = np.zeros(2, np.uint8)
    shim.host_bls_final(_ptr(n), _ptr(d), _ptr(bk.frob_sparse_host()),
                        _ptr(fe), _ptr(out), 2)
    sides = bk.f12_mul(pn, bk.FP(torch.cat([pd.v[..., 2:], pd.v[..., :2]],
                                           dim=-1), pd.lb))
    pfe = bk.final_exp_fast(sides)
    got = bk.words_to_ints(fe)
    want = bk.f12_to_ints(pfe)
    # the kernel interleaves lhs (2b) and rhs (2b + 1); the twin stacks
    assert [[row[i] for i in (0, 2, 1, 3)] for row in got] == want
    verdict = bk._compare_tail(bk.FP(pfe.v[..., :2], pfe.lb),
                               bk.FP(pfe.v[..., 2:], pfe.lb))
    assert out.astype(bool).tolist() == verdict.tolist() == [True, False]


def _host_f12w(shim, op, x, y=None):
    out = np.zeros_like(x)
    shim.host_f12w(op, _ptr(x), _ptr(x if y is None else y),
                   _ptr(bk.frob_sparse_host()), _ptr(out), x.shape[-1])
    return bk.words_to_ints(out)


def test_k11_warp_ops_match_k9_ops_and_oracle(shim):
    """K11's product, conjugation and sparse Frobenius maps, run share by
    share, against K9's dense product and Frobenius matrices and the
    oracle, on seeded values and zero."""
    rng = np.random.default_rng(4317)

    def rand():
        return bh.FQ12([int.from_bytes(rng.bytes(48), "little") % bh.P
                        for _ in range(12)])

    a = [rand(), rand(), bh.FQ12.zero()]
    b = [rand(), bh.FQ12.zero(), rand()]
    xa, xb = _f12_arr(a), _f12_arr(b)

    def oracle(vals):
        return [[v.c[d] for v in vals] for d in range(12)]

    assert _host_f12w(shim, 0, xa, xb) == _host_f12(shim, 0, xa, xb) \
        == oracle([x * y for x, y in zip(a, b)])
    assert _host_f12w(shim, 2, xa) == _host_f12(shim, 4, xa) \
        == oracle([x.pow(bh.P ** 6) for x in a])
    for op, dense, k in ((3, 2, 1), (4, 3, 2)):
        assert _host_f12w(shim, op, xa) == _host_f12(shim, dense, xa) \
            == oracle([x.pow(bh.P ** k) for x in a]), k


def test_cyclotomic_square_matches_dense_square(shim):
    """Granger-Scott's square over the tower equals K9's dense square on
    elements after the easy part (f^((p^6 - 1)(p^2 + 1))), zero
    included."""
    rng = np.random.default_rng(4318)
    m = []
    for _ in range(3):
        f = bh.FQ12([int.from_bytes(rng.bytes(48), "little") % bh.P
                     for _ in range(12)])
        m1 = f.pow(bh.P ** 6) * f.inv()
        m.append(m1.pow(bh.P ** 2) * m1)
    m.append(bh.FQ12.zero())
    x = _f12_arr(m)
    assert _host_f12w(shim, 1, x) == _host_f12(shim, 1, x) \
        == [[(v * v).c[d] for v in m] for d in range(12)]
    # off the subgroup it is not a square: the test above is not vacuous
    y = _f12_arr([bh.FQ12([3] + [5] * 11)])
    assert _host_f12w(shim, 1, y) != _host_f12(shim, 1, y)


def _phase3d_lanes():
    """Nine of the ten lanes of ``chip_smoke.py``'s phase 3d (all but the
    forged ``pt_add(sig, G1)`` signature), built as it builds them:
    validator i's key (i + 1)·G1, a quorum's aggregate over H(d)
    (q(q + 1)/2)·H(d); valid certificates of the 128- and 1024-validator
    committees, a wrong binding, the three masked certificates as
    ``certificate_lanes`` packs them, the degenerate y = 0 "signature"
    and an all-zero lane. Returns the eight (12, 12, 9) word arrays."""
    from bdls_tpu_torch.consensus import threshold as TH

    pks, pk = [], None
    for _ in range(1024):
        pk = bh.pt_add(pk, bh.G1)
        pks.append(pk)
    aggs, certs = {}, {}
    for n, q in ((128, 85), (1024, 683)):
        aggs[n] = TH.ThresholdAggregator(pks[:n], q, max_pending=128)
        sk = q * (q + 1) // 2 % bh.R
        certs[n] = []
        for rnd in (0, 1):
            d = hashlib.sha256(b"bdls committee %d round %d"
                               % (n, rnd)).digest()
            certs[n].append(TH.QuorumCertificate(
                d, tuple(range(q)), bh.pt_mul(sk, aggs[n]._hm(d))))
    a128 = aggs[128]
    c0, c1 = certs[128]
    QC = TH.QuorumCertificate
    batch = [c0, c1, certs[1024][0],
             QC(c1.digest, c0.signers, c0.agg_sig),
             QC(c0.digest, c0.signers, None),
             QC(c0.digest, c0.signers[:-1], c0.agg_sig),
             QC(c0.digest, c0.signers[:-1] + (200,), c0.agg_sig)]
    lanes, _ = TH.certificate_lanes(batch, [a128, a128, aggs[1024]]
                                    + [a128] * 4)
    extra = [(bh.FQ12.scalar(1), bh.FQ12.zero()),
             (bh.FQ12.zero(), bh.FQ12.zero())]
    direct = (bk.pt_batch([bh.G1] * 2), bk.pt_batch(extra),
              bk.pt_batch([a128._agg_pubkey(c0.signers)] * 2),
              bk.pt_batch([a128._hm(c0.digest)] * 2))
    return [np.ascontiguousarray(np.concatenate([a, b], -1).view(np.int32))
            for pl, pd in zip(lanes, direct) for a, b in zip(pl, pd)]


def test_final_exp_full_matches_plain_and_oracle(shim):
    """K11's body (each side a warp, run share by share; thread 0's
    compare) on nine of phase 3d's lanes: every side equals the plain twin's
    square-and-multiply and the oracle's pow, the zero side included;
    each is the cube root of K9's x-chain value; the verdicts are K9's."""
    g1x, g1y, sigx, sigy, pkx, pky, hmx, hmy = _phase3d_lanes()
    B = sigx.shape[-1]
    q = [np.ascontiguousarray(np.concatenate(p, -1))
         for p in ((sigx, hmx), (sigy, hmy), (g1x, pkx), (g1y, pky))]
    n, d = np.zeros_like(q[0]), np.zeros_like(q[0])
    shim.host_bls_miller(*(_ptr(a) for a in (*q, n, d)), 2 * B)
    fe, out = np.zeros_like(n), np.zeros(B, np.uint8)
    shim.host_final_full(_ptr(n), _ptr(d), _ptr(bk.frob_sparse_host()),
                         _ptr(fe), _ptr(out), B)
    fast, fout = np.zeros_like(n), np.zeros(B, np.uint8)
    shim.host_bls_final(_ptr(n), _ptr(d), _ptr(bk.frob_sparse_host()),
                        _ptr(fast), _ptr(fout), B)
    # the kernel's column 2b is lane b's n1·d2, 2b + 1 its n2·d1
    order = [i // 2 + (B if i % 2 else 0) for i in range(2 * B)]
    nv, dv = bk.words_to_ints(n), bk.words_to_ints(d)
    sides = [bh.FQ12([nv[c][t] for c in range(12)])
             * bh.FQ12([dv[c][(t + B) % (2 * B)] for c in range(12)])
             for t in order]
    got = bk.words_to_ints(fe)
    plain = bk.f12_to_ints(bk.final_exp(bk.f12_from_words(torch.from_numpy(
        bk.f12_words(sides).view(np.int32)))))
    e = (bh.P ** 12 - 1) // bh.R
    assert got == plain == [[v.pow(e).c[c] for v in sides]
                            for c in range(12)]
    zero = [t for t, v in enumerate(sides) if v == bh.FQ12.zero()]
    assert {2 * B - 2, 2 * B - 1} <= set(zero)       # the all-zero lane
    cube = bk.words_to_ints(fast)
    for t in range(2 * B):
        v = bh.FQ12([got[c][t] for c in range(12)])
        assert v * v * v == bh.FQ12([cube[c][t] for c in range(12)]), t
    assert out.tolist() == fout.tolist()
    assert out.tolist()[:3] == [1, 1, 1] and out.tolist()[3] == 0


def test_masked_count_matches_plain(shim):
    from bdls_tpu_torch.parallel import mesh as pmesh

    shim.host_masked_count.restype = ctypes.c_uint32
    rng = np.random.default_rng(4316)
    for n in (0, 1, 31, 256, 2000, 2048, 8192):
        ok = rng.integers(0, 2, n).astype(np.uint8)
        for mask in (np.ones(n, np.uint8), np.zeros(n, np.uint8),
                     rng.integers(0, 2, n).astype(np.uint8),
                     (np.arange(n) < n - 5).astype(np.uint8)):
            want = int(pmesh.masked_count_plain(torch.from_numpy(ok),
                                                torch.from_numpy(mask)))
            assert shim.host_masked_count(_ptr(ok), _ptr(mask), n) == want \
                == int((ok & mask).sum()), n
