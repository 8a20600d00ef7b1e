"""K4 (``csrc/mont16.cuh``) and K5 (``csrc/mxu.cuh``) built for the host
with g++.

The headers compile without ``__CUDACC__``, so this test builds two C
shims into ``build/``: one as the vpu kernels are built, one with
``-DBDLS_MUL_MXU`` as the mxu builds are (every ``mont_mul`` is then K5's
product: the same staging, fragment assembly and column stores as on the
card, with the ``mma.sync`` tile emulated from the fragments by the PTX
layout). It checks, exactly:

- K5's ``mont_mul`` against the CIOS ``mont_mul_cios`` bit for bit, and
  against Python integers, on the five moduli at edge and seeded values;
- K4's block batch inverse (``m16::block_inv``) against integers with
  zero lanes among the others;
- K4 run as ``csrc/mont16.cu`` runs it (a block's lanes share one
  inverse; a thread past B takes part with s = 1) against the plain
  ``verify_kernel`` and the integer ECDSA, with s = 0, s = n, s >= n and
  r = 0 next to valid lanes in one block;
- the lane bodies of K1, K2 and K8 built with ``-DBDLS_MUL_MXU`` against
  their plain twins (and the integer oracles).

Test-only: on the CPU the port runs the plain versions. The test skips,
from a fixture, where g++ is absent.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

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
#include "mont16.cuh"
#include "edwards.cuh"
#include "pinned.cuh"
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

template <class FN>
static void binv(const uint32_t* x, uint32_t* out, int n) {
  fe in[64] = {}, inv[64] = {}, pre[64] = {}, suf[64] = {};
  for (int t = 0; t < n; ++t)
    for (int i = 0; i < 8; ++i) in[t].v[i] = x[8 * t + i];
  m16::block_inv<FN>(inv, in, n, pre, suf);
  for (int t = 0; t < n; ++t)
    for (int i = 0; i < 8; ++i) out[8 * t + i] = inv[t].v[i];
}

extern "C" void host_block_inv(int curve, const uint32_t* x, uint32_t* out,
                               int n) {
  if (curve == 0) binv<P256N>(x, out, n);
  else binv<K256N>(x, out, n);
}

// csrc/mont16.cu's kernel, block by block: T threads a block share one
// batch inverse; a thread past B enters with s = 1 and stores nothing
template <class C>
static void mont16_run(const int32_t* qx, const int32_t* qy, const int32_t* r,
                       const int32_t* s, const int32_t* e,
                       const uint32_t* gtab, uint8_t* out, int B, int T) {
  typedef typename C::N FN;
  for (int b0 = 0; b0 < B; b0 += T) {
    fe vs[64] = {}, sm[64] = {}, inv[64] = {}, pre[64] = {}, suf[64] = {};
    for (int t = 0; t < T; ++t) {
      const int b = b0 + t;
      if (b < B) load_limbs16(vs[t], s, b, B);
      else for (int i = 0; i < 8; ++i) vs[t].v[i] = i == 0 ? 1u : 0u;
      to_mont<FN>(sm[t], vs[t]);
    }
    m16::block_inv<FN>(inv, sm, T, pre, suf);
    for (int t = 0; t < T && b0 + t < B; ++t) {
      const int b = b0 + t;
      fe a[4];
      load_limbs16(a[0], qx, b, B);
      load_limbs16(a[1], qy, b, B);
      load_limbs16(a[2], r, b, B);
      load_limbs16(a[3], e, b, B);
      out[b] = m16::verify_lane_mont16<C>(a[0], a[1], a[2], vs[t], a[3],
                                          inv[t], gtab) ? 1 : 0;
    }
  }
}

extern "C" void host_mont16(int curve, const int32_t* qx, const int32_t* qy,
                            const int32_t* r, const int32_t* s,
                            const int32_t* e, const uint32_t* gtab,
                            uint8_t* out, int B, int T) {
  if (curve == 0) mont16_run<CurveP256>(qx, qy, r, s, e, gtab, out, B, T);
  else mont16_run<CurveK256>(qx, qy, r, s, e, gtab, out, B, T);
}

extern "C" void host_verify(int curve, const int32_t* qx, const int32_t* qy,
                            const int32_t* r, const int32_t* s,
                            const int32_t* e, const uint32_t* gtab,
                            uint8_t* out, int B) {
  for (int b = 0; b < B; ++b) {
    fe a[5];
    load_limbs16(a[0], qx, b, B);
    load_limbs16(a[1], qy, b, B);
    load_limbs16(a[2], r, b, B);
    load_limbs16(a[3], s, b, B);
    load_limbs16(a[4], e, b, B);
    const bool ok = curve == 0
        ? verify_lane<CurveP256>(a[0], a[1], a[2], a[3], a[4], gtab)
        : verify_lane<CurveK256>(a[0], a[1], a[2], a[3], a[4], gtab);
    out[b] = ok ? 1 : 0;
  }
}

extern "C" void host_verify_pinned(int curve, const int32_t* r,
                                   const int32_t* s, const int32_t* e,
                                   const int32_t* slot, const uint32_t* px,
                                   const uint32_t* py, const uint32_t* ppsi,
                                   const uint32_t* g32, uint8_t* out, int B,
                                   int cap) {
  for (int b = 0; b < B; ++b) {
    fe a[3];
    load_limbs16(a[0], r, b, B);
    load_limbs16(a[1], s, b, B);
    load_limbs16(a[2], e, b, B);
    const bool ok = curve == 0
        ? verify_pinned_lane<CurveP256>(a[0], a[1], a[2], slot[b], cap, px,
                                        py, px, g32)
        : verify_pinned_lane<CurveK256>(a[0], a[1], a[2], slot[b], cap, px,
                                        py, ppsi, g32);
    out[b] = ok ? 1 : 0;
  }
}

extern "C" void host_verify_ed25519(const int32_t* ax, const int32_t* ay,
                                    const int32_t* rx, const int32_t* ry,
                                    const int32_t* s, const int32_t* k,
                                    const uint32_t* btab, uint8_t* out,
                                    int B) {
  for (int b = 0; b < B; ++b) {
    fe a[6];
    load_limbs16(a[0], ax, b, B);
    load_limbs16(a[1], ay, b, B);
    load_limbs16(a[2], rx, b, B);
    load_limbs16(a[3], ry, b, B);
    load_limbs16(a[4], s, b, B);
    load_limbs16(a[5], k, b, B);
    out[b] = verify_lane_ed25519(a[0], a[1], a[2], a[3], a[4], a[5], btab)
        ? 1 : 0;
  }
}
"""

MODULI = [CURVES["P-256"].fp, CURVES["P-256"].fn, CURVES["secp256k1"].fp,
          CURVES["secp256k1"].fn, EDWARDS_CURVES["ed25519"].fp]
R = 1 << 256


def _compile(flags: tuple) -> ctypes.CDLL:
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not found: the host build of the kernel is skipped")
    h = hashlib.sha256((SHIM + " ".join(flags)).encode())
    for name in _build.HEADERS:
        h.update((_build.CSRC / name).read_bytes())
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib = _build.BUILD_DIR / f"host_k4k5-{h.hexdigest()[:16]}.so"
    if not lib.exists():
        src = lib.with_suffix(f".{os.getpid()}.cpp")
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        src.write_text(SHIM)
        try:
            subprocess.run(
                [gxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-Wall",
                 "-Werror", "-Wno-unknown-pragmas", *flags, "-I",
                 str(_build.CSRC), "-o", str(tmp), str(src)], check=True,
                capture_output=True, text=True)
            os.replace(tmp, lib)
        finally:
            src.unlink(missing_ok=True)
    return ctypes.CDLL(str(lib))


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


@pytest.mark.parametrize("curve", sorted(CURVES))
def test_block_inverse_with_zero_lanes(vpu, curve):
    n = CURVES[curve].fn.modulus
    rng = np.random.default_rng(131)
    vals = [0, 3, n - 1, 0] + [int.from_bytes(rng.bytes(32), "big") % n
                                for _ in range(33)]
    x = _words([v * R % n for v in vals])
    out = np.zeros_like(x)
    vpu.host_block_inv(CURVE_IDS[curve], _ptr(x), _ptr(out), len(vals))
    assert _ints(out) == [pow(v, -1, n) * R % n if v else 0 for v in vals]


@pytest.mark.parametrize("curve", sorted(CURVES))
def test_mont16_blocks_match_plain_and_integer_ecdsa(vpu, curve):
    rng = np.random.default_rng(133)
    lanes = vectors.mixed_lanes(curve, rng, n_valid=3)
    # the first block of 16 holds the valid lanes beside s = 0, s = n,
    # s = 2^256 - 1 and r = 0; the last block is ragged
    lanes = lanes[:3] + [ln for ln in lanes if ln[5] in (
        "s = 0", "s = n", "s = 2^256-1", "r = 0")] + lanes[3:]
    cols = [np.ascontiguousarray(ints_to_limbs(c).view(np.int32))
            for c in vectors.columns(lanes)]
    gtab = ecdsa.device_mont16_table(curve, torch.device("cpu")).numpy()
    out = np.zeros(len(lanes), np.uint8)
    vpu.host_mont16(CURVE_IDS[curve], *(_ptr(a) for a in (*cols, gtab, out)),
                    len(lanes), 16)
    host = out.astype(bool).tolist()
    plain = ecdsa.verify_kernel(CURVES[curve], *(torch.from_numpy(a)
                                                 for a in cols)).tolist()
    assert host == plain == vectors.expected(curve, lanes)
    assert len(lanes) % 16 and any(host[:16]) and not all(host[:16])


@pytest.mark.parametrize("curve", sorted(CURVES))
def test_mxu_verify_lane_matches_plain(mxu, curve):
    rng = np.random.default_rng(135)
    lanes = vectors.mixed_lanes(curve, rng, n_valid=2)
    cols = [np.ascontiguousarray(ints_to_limbs(c).view(np.int32))
            for c in vectors.columns(lanes)]
    gtab = vf.device_g_table(curve, torch.device("cpu")).numpy()
    out = np.zeros(len(lanes), np.uint8)
    mxu.host_verify(CURVE_IDS[curve], *(_ptr(a) for a in (*cols, gtab, out)),
                    len(lanes))
    plain = vf.verify_fold(CURVES[curve],
                           *(torch.from_numpy(a) for a in cols)).tolist()
    assert out.astype(bool).tolist() == plain == vectors.expected(curve,
                                                                  lanes)


@pytest.mark.parametrize("curve", sorted(CURVES))
def test_mxu_pinned_lane_matches_plain(mxu, curve):
    rng = np.random.default_rng(137)
    lanes, keys = [], {}
    for lane in vectors.mixed_lanes(curve, rng, n_valid=2):
        try:
            vf.build_pinned_tables(curve, lane[0], lane[1])
        except ValueError:
            continue
        keys.setdefault(lane[:2], len(keys))
        lanes.append(lane)
    cap = len(keys)
    slots = [keys[lane[:2]] for lane in lanes]
    lanes += [lanes[0], lanes[0]]
    slots += [(slots[0] + 1) % cap, cap]
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
    mxu.host_verify_pinned(
        CURVE_IDS[curve], *(_ptr(a) for a in (*cols, slot, pools["x"],
                                              pools["y"], psi, g32, out)),
        len(lanes), cap)
    plain = vf.verify_fold_pinned(
        CURVES[curve], *(torch.from_numpy(a) for a in cols),
        torch.from_numpy(slot),
        {nm: torch.from_numpy(v) for nm, v in pools.items()}).tolist()
    host = out.astype(bool).tolist()
    assert host == plain
    assert host[:-2] == vectors.expected(curve, lanes[:-2])
    assert host[-2:] == [False, False]


def test_mxu_ed25519_lane_matches_plain_and_oracle(mxu):
    rng = np.random.default_rng(139)
    lanes = vectors.ed25519_mixed_lanes(rng, n_valid=2)
    arrs = [np.ascontiguousarray(a.view(np.int32))
            for a in ed_ops.lanes_to_limbs(vectors.ed25519_rows(lanes))]
    btab = ed_ops.device_b_table(torch.device("cpu")).numpy()
    out = np.zeros(len(lanes), np.uint8)
    mxu.host_verify_ed25519(*(_ptr(a) for a in (*arrs, btab, out)),
                            len(lanes))
    plain = ed_ops.verify_ed25519(
        ED25519, *(torch.from_numpy(a) for a in arrs)).tolist()
    assert out.astype(bool).tolist() == plain == \
        vectors.ed25519_expected(lanes)
