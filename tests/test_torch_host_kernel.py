"""The CUDA kernel's arithmetic, built for the host with g++.

``csrc/field.cuh``, ``csrc/point.cuh`` and ``csrc/verify.cuh`` compile
without ``__CUDACC__`` (``__host__``/``__device__`` vanish), so this
test builds a tiny C shim over them into ``build/``, loads it with
ctypes, and checks:

- the Montgomery field ops of the four moduli against Python integers
  (edge values and seeded values: carry chains, the final conditional
  subtraction, the Fermat inverse);
- ``verify_lane`` — the per-lane body of the kernel — against the plain
  PyTorch ``verify_fold`` and the port's integer ECDSA, lane for lane,
  on valid, tampered and hostile lanes of both curves.

Test-only: on the CPU the port itself runs the plain version. The test
skips, from a fixture, where g++ is absent. Comparisons are exact.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from bdls_tpu_torch.crypto import vectors
from bdls_tpu_torch.crypto.marshal import ints_to_limbs
from bdls_tpu_torch.ops import _build
from bdls_tpu_torch.ops.curves import CURVES
from bdls_tpu_torch.ops.ecdsa import CURVE_IDS
from bdls_tpu_torch.ops.verify_fold import device_g_table, verify_fold

# the plain version runs many ops on tiny tensors: extra intra-op
# threads only contend with the other test workers
torch.set_num_threads(1)

SHIM = r"""
#include "verify.cuh"
using namespace bdls;

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
  else field_op<K256N>(op, a, b, out);
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
"""

MODULI = [("P-256", "fp"), ("P-256", "fn"), ("secp256k1", "fp"),
          ("secp256k1", "fn")]
R = 1 << 256


@pytest.fixture(scope="module")
def shim():
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not found: the host build of the kernel is skipped")
    h = hashlib.sha256(SHIM.encode())
    for name in _build.HEADERS:
        h.update((_build.CSRC / name).read_bytes())
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib = _build.BUILD_DIR / f"host_verify-{h.hexdigest()[:16]}.so"
    if not lib.exists():
        src = lib.with_suffix(f".{os.getpid()}.cpp")
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        src.write_text(SHIM)
        try:
            subprocess.run(
                [gxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-Wall",
                 "-Werror", "-Wno-unknown-pragmas", "-I", str(_build.CSRC),
                 "-o", str(tmp), str(src)], check=True, capture_output=True,
                text=True)
            os.replace(tmp, lib)
        finally:
            src.unlink(missing_ok=True)
    return ctypes.CDLL(str(lib))


def _u32x8(x: int):
    return (ctypes.c_uint32 * 8)(*[(x >> (32 * i)) & 0xFFFFFFFF
                                   for i in range(8)])


def _int(a) -> int:
    return sum(int(a[i]) << (32 * i) for i in range(8))


@pytest.mark.parametrize("mod", range(4), ids=[f"{c}:{k}" for c, k in MODULI])
def test_field_ops_match_python_ints(shim, mod):
    curve, kind = MODULI[mod]
    m = getattr(CURVES[curve], kind).modulus
    rng = np.random.default_rng(100 + mod)
    vals = [0, 1, 2, m - 1, m - 2, 1 << 255, (1 << 224) - 1] + [
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
    gtab = device_g_table(curve, torch.device("cpu")).numpy()
    out = np.zeros(len(lanes), np.uint8)
    ptr = [a.ctypes.data_as(ctypes.c_void_p) for a in (*cols, gtab, out)]
    shim.host_verify(CURVE_IDS[curve], *ptr, len(lanes))
    host = out.astype(bool).tolist()
    plain = verify_fold(CURVES[curve],
                        *(torch.from_numpy(a) for a in cols)).tolist()
    assert host == plain
    assert host == vectors.expected(curve, lanes)
