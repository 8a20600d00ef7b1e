"""The port's cold-start plane on the CPU, against the reference's.

The counterparts of ``tests/test_coldstart.py:68-258`` and ``:307``:

- the library store (``bdls_tpu_torch/ops/aot_cache.py``) round-trips a
  library built for the host with g++ (``_build.host_shim``: a
  ``field.cuh`` product, held against Python integers), a miss is
  silent, and each poisoning (a truncated file, another environment's
  fingerprint, a flipped payload byte, a payload that does not load or
  lacks an entry) is a counted reject under the reference's reason,
  the reference's ``AotStore`` poisoned the same way in the same test;
- ``_build.build`` with a store: a miss compiles and stores, a hit
  loads without the compiler, a rejected entry is compiled again, and
  without a compiler raises (the compiler faked with g++);
- the G tables through the snapshot store: a hit bit-identical to a
  fresh build, a corrupt snapshot counted and rebuilt;
- pinned-key snapshots in the port's pool layout: the round trip (pools
  bit-identical, the pinned plain twin's verdicts equal), a substituted
  key, an off-curve point and a wrong SKI each dropped as ``bad_key``
  with their neighbours kept, a tampered file read as ``corrupt`` and
  restoring 0, a pool handed out before a restore unchanged after it,
  and the reference's snapshot entries carried into the port's layout
  equal to the port's own;
- the warm-up race: two threads warming one (curve, bucket) warm it
  once and count one ``warmed`` hit; an eager first ``verify_batch``
  that races a warm-up waits for it.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import threading
import time

import numpy as np
import pytest
import torch

from bdls_tpu.crypto import tpu_provider as jtp
from bdls_tpu.crypto.csp import PublicKey as JPublicKey
from bdls_tpu.ops import aot_cache as jaot
from bdls_tpu_torch.crypto import vectors
from bdls_tpu_torch.crypto.csp import PublicKey, VerifyRequest
from bdls_tpu_torch.crypto.key_cache import KeyTableCache
from bdls_tpu_torch.crypto.sw import SwCSP
from bdls_tpu_torch.crypto.torch_provider import TorchCSP
from bdls_tpu_torch.ops import _build, aot_cache, ecdsa, table_snapshot
from bdls_tpu_torch.ops import verify_fold as vf
from bdls_tpu_torch.ops.curves import CURVES

# the plain version runs many ops on tiny tensors: extra intra-op
# threads only contend with the other test workers
torch.set_num_threads(1)

SHIM = r"""
#include "field.cuh"
using namespace bdls;

extern "C" int bdls_test_mul(const uint32_t* a, const uint32_t* b,
                             uint32_t* out) {
  fe x, y, z;
  for (int i = 0; i < 8; ++i) { x.v[i] = a[i]; y.v[i] = b[i]; }
  mont_mul<P256P>(z, x, y);
  for (int i = 0; i < 8; ++i) out[i] = z.v[i];
  return 0;
}
"""
ENTRY = "bdls_test_mul"


@pytest.fixture(scope="module")
def shim_path():
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    return _build.host_shim(SHIM, "host_coldstart")._name


def _mul_ok(path) -> bool:
    """The library's product against Python integers."""
    fn = getattr(ctypes.CDLL(path), ENTRY)
    p = CURVES["P-256"].fp.modulus
    rng = np.random.default_rng(5)
    for _ in range(4):
        a, b = (int.from_bytes(rng.bytes(32), "little") % p
                for _ in range(2))
        av = (ctypes.c_uint32 * 8)(*vf._int_to_u32x8(a))
        bv = (ctypes.c_uint32 * 8)(*vf._int_to_u32x8(b))
        out = (ctypes.c_uint32 * 8)()
        fn(av, bv, out)
        got = vf._u32_to_ints(np.array(list(out), np.uint32))[0]
        if got != a * b * pow(1 << 256, -1, p) % p:
            return False
    return True


# ---- the library store: round trip and poisoning ---------------------------

def test_store_round_trip_loads_a_working_library(tmp_path, shim_path):
    rejects: list[str] = []
    store = aot_cache.AotStore(str(tmp_path), on_reject=rejects.append)
    key = aot_cache.cache_key("verify.cu", _build._digest("verify.cu"))
    store.save_library(key, shim_path, {"nvcc": "g++ (test)"})
    path = store.load_library(key, [ENTRY])
    assert path is not None and path != shim_path
    assert _mul_ok(path)
    assert store.load_library(key, [ENTRY]) == path  # content-addressed
    assert rejects == []
    assert "platform=cpu" in aot_cache.fingerprint()


def test_store_miss_is_silent(tmp_path):
    rejects: list[str] = []
    store = aot_cache.AotStore(str(tmp_path), on_reject=rejects.append)
    assert store.load("never-saved") is None
    assert store.load_library("never-saved", [ENTRY]) is None
    assert rejects == []


def _truncate(path):
    raw = open(path, "rb").read()
    with open(path, "wb") as f:
        f.write(raw[:len(raw) // 2])


def _flip_last(path):
    raw = bytearray(open(path, "rb").read())
    raw[-1] ^= 0xFF
    with open(path, "wb") as f:
        f.write(bytes(raw))


def _port_case(case, tmp, shim_path) -> list[str]:
    rejects: list[str] = []
    store = aot_cache.AotStore(str(tmp), on_reject=rejects.append)
    key = aot_cache.cache_key("pinned.cu", "0123456789abcdef")
    entries = [ENTRY]
    if case == "not_loadable":
        store.save(key, b"not a shared library")
    else:
        path = store.save_library(key, shim_path)
        if case == "truncated":
            _truncate(path)
        elif case == "flipped":
            _flip_last(path)
        elif case == "fingerprint":
            store._fingerprint = "torch=9.9;cuda=9.9;platform=mars"
        elif case == "missing_entry":
            entries = [ENTRY, "bdls_not_there"]
    assert store.load_library(key, entries) is None
    return rejects


def _reference_case(case, tmp) -> list[str]:
    """The same poisoning of the reference's store (its payloads are
    serialized programs, so "does not load" is an undeserializable
    blob)."""
    rejects: list[str] = []
    store = jaot.AotStore(str(tmp), on_reject=rejects.append)
    key = jaot.cache_key("generic", "P-256", "fold", 8)
    if case in ("not_loadable", "missing_entry"):
        store.save(key, b"not a serialized exported program")
        assert store.load_exported(key) is None
        return rejects
    path = store.save(key, b"p" * 256)
    if case == "truncated":
        _truncate(path)
    elif case == "flipped":
        _flip_last(path)
    elif case == "fingerprint":
        store._fingerprint = "jax=9.9.9;jaxlib=9.9.9;platform=mars;kind=?"
    assert store.load(key) is None
    return rejects


@pytest.mark.parametrize("case", ["truncated", "fingerprint", "flipped",
                                  "not_loadable", "missing_entry"])
def test_store_poisoning_is_the_references_reject(tmp_path, shim_path, case):
    want = {"truncated": aot_cache.REJECT_TRUNCATED,
            "fingerprint": aot_cache.REJECT_FINGERPRINT}.get(
                case, aot_cache.REJECT_CORRUPT)
    port = _port_case(case, tmp_path / "port", shim_path)
    ref = _reference_case(case, tmp_path / "ref")
    assert port == [want]
    assert port == ref
    assert (aot_cache.REJECT_TRUNCATED, aot_cache.REJECT_FINGERPRINT,
            aot_cache.REJECT_CORRUPT) == (jaot.REJECT_TRUNCATED,
                                          jaot.REJECT_FINGERPRINT,
                                          jaot.REJECT_CORRUPT)
    assert (aot_cache.ENV_VAR, aot_cache.FORMAT_VERSION) == (
        jaot.ENV_VAR, jaot.FORMAT_VERSION)


# ---- _build through the store (the compiler faked with g++) ----------------

@pytest.fixture
def fake_builds(tmp_path, monkeypatch, shim_path):
    """Two builds whose "nvcc" copies the g++ library into place; the
    list records every compile."""
    compiled: list[str] = []

    def compile_one(src, eng, target):
        compiled.append(_build._key(src, eng))
        shutil.copyfile(shim_path, target)
        return 0, f"ptxas {src} {eng}", 0.01

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "jobs", lambda: [("sha256.cu", "vpu"),
                                                 ("verify.cu", "mxu")])
    monkeypatch.setattr(_build, "ENTRIES", {
        "sha256.cu": {ENTRY: []}, "verify.cu": {ENTRY: []}})
    monkeypatch.setattr(_build, "_compile", compile_one)
    monkeypatch.setattr(_build, "nvcc_path", lambda: "/usr/bin/true")
    monkeypatch.setattr(_build, "nvcc_version", lambda: "fake 1.0")
    return compiled


def test_build_stores_then_loads_without_the_compiler(tmp_path, fake_builds,
                                                      monkeypatch):
    rejects: list[str] = []
    store = aot_cache.AotStore(str(tmp_path / "store"),
                               on_reject=rejects.append)
    first = _build.build(store=store)
    assert sorted(fake_builds) == ["sha256.cu", "verify.cu:mxu"]
    assert first["from_store"] == [] and set(first["nvcc_seconds"]) == {
        "sha256.cu", "verify.cu:mxu"}
    assert len(os.listdir(store.dir)) == 2

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(_build, "nvcc_path", no_nvcc)
    fake_builds.clear()
    second = _build.build(store=store)
    assert fake_builds == [] and second["nvcc_seconds"] == {}
    assert sorted(second["from_store"]) == ["sha256.cu", "verify.cu:mxu"]
    assert all(_mul_ok(p) for p in second["paths"].values())
    assert rejects == []
    # without a store, the libraries under build/ are kept as they were
    assert _build.build()["cached"] and fake_builds == []


def test_build_rebuilds_rejected_entries_or_raises(tmp_path, fake_builds,
                                                   monkeypatch):
    rejects: list[str] = []
    store = aot_cache.AotStore(str(tmp_path / "store"),
                               on_reject=rejects.append)
    _build.build(store=store)

    def poison():
        for src, eng, hurt in (("sha256.cu", "vpu", _truncate),
                               ("verify.cu", "mxu", _flip_last)):
            hurt(store.path_for(aot_cache.cache_key(
                _build._key(src, eng), _build._digest(src, eng))))

    poison()
    fake_builds.clear()
    info = _build.build(store=store)
    assert rejects == [aot_cache.REJECT_TRUNCATED, aot_cache.REJECT_CORRUPT]
    assert sorted(fake_builds) == ["sha256.cu", "verify.cu:mxu"]
    assert info["from_store"] == []
    assert sorted(_build.build(store=store)["from_store"]) == [
        "sha256.cu", "verify.cu:mxu"]            # saved again

    poison()

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(_build, "nvcc_path", no_nvcc)
    with pytest.raises(RuntimeError, match="nvcc not found.*not in the store"):
        _build.build(store=store)


def test_provider_counts_builds_and_rejects(monkeypatch, tmp_path):
    monkeypatch.setenv(aot_cache.ENV_VAR, str(tmp_path))
    csp = TorchCSP(device="cpu", key_cache_size=0)
    try:
        assert csp._aot_store is not None
        csp._count_build({"from_store": ["a.cu", "b.cu:mxu"],
                          "nvcc_seconds": {"c.cu": 1.25}})
        csp._count_build(None)
        m = csp.metrics
        assert m.find("tpu_compile_cache_hits_total").value(
            ("persistent",)) == 2.0
        assert m.find("tpu_compile_programs_total").value(
            ("c.cu", "", "")) == 1.0
        assert m.find("tpu_compile_seconds").value(("c.cu", "", "")) == 1.25
        csp._aot_store._reject(aot_cache.REJECT_FINGERPRINT)
        assert m.find("tpu_aot_cache_rejects_total").value(
            ("fingerprint",)) == 1.0
    finally:
        csp.close()
    monkeypatch.delenv(aot_cache.ENV_VAR)
    off = TorchCSP(device="cpu", key_cache_size=0)
    try:
        assert off._aot_store is None
    finally:
        off.close()


# ---- G tables through the snapshot store -----------------------------------

@pytest.mark.parametrize("family,fn,build,curve", [
    ("g", vf.g_table_8bit, vf._g_table_8bit_build, "P-256"),
    ("g32", vf.g32_tables, vf._g32_tables_build, "secp256k1"),
])
def test_g_tables_snapshot_bit_identical(tmp_path, monkeypatch, family, fn,
                                         build, curve):
    monkeypatch.setenv(aot_cache.ENV_VAR, str(tmp_path))
    fresh = build(curve)
    fn.cache_clear()
    try:
        built = fn(curve)                       # a miss: builds, saves
        assert os.path.exists(table_snapshot.host_table_path(curve, family))
        fn.cache_clear()
        loaded = fn(curve)                      # a hit
        for t in (built, loaded):
            assert t.dtype == fresh.dtype and t.shape == fresh.shape
            assert np.array_equal(t, fresh) and not t.flags.writeable
    finally:
        fn.cache_clear()


def test_corrupt_g_table_snapshot_is_counted_and_rebuilt(tmp_path,
                                                         monkeypatch):
    monkeypatch.setenv(aot_cache.ENV_VAR, str(tmp_path))
    vf.g_table_8bit.cache_clear()
    csp = TorchCSP(device="cpu", key_cache_size=0)
    heard: list[str] = []
    table_snapshot.add_reject_listener(heard.append)
    try:
        want = vf.g_table_8bit("P-256").copy()
        with open(table_snapshot.host_table_path("P-256", "g"), "wb") as f:
            f.write(b"\x00garbage")
        vf.g_table_8bit.cache_clear()
        assert np.array_equal(vf.g_table_8bit("P-256"), want)
        assert heard == [table_snapshot.REJECT_CORRUPT]
        assert csp.metrics.find("tpu_aot_cache_rejects_total").value(
            ("corrupt",)) == 1.0
        # a snapshot of another shape (the reference's layout, say) is
        # rejected too, never handed to a kernel
        table_snapshot.save_host_tables("P-256", "g",
                                        [np.zeros((256, 23), np.uint32)])
        vf.g_table_8bit.cache_clear()
        assert np.array_equal(vf.g_table_8bit("P-256"), want)
        assert heard == [table_snapshot.REJECT_CORRUPT] * 2
    finally:
        vf.g_table_8bit.cache_clear()
        csp.close()


# ---- pinned-key snapshots ----------------------------------------------------

def _pub(scalar: int, curve: str = "P-256") -> PublicKey:
    return SwCSP().key_from_scalar(curve, scalar).public_key()


def _entry(scalar: int, curve: str = "P-256") -> dict:
    k = _pub(scalar, curve)
    return {"curve": curve, "ski": k.ski(), "x": k.x, "y": k.y,
            "tabs": vf.pinned_device_tables(
                curve, vf.build_pinned_tables(curve, k.x, k.y))}


def test_key_snapshot_round_trip(tmp_path):
    sw = SwCSP()
    scalars = (0x61, 0x62, 0x63)
    keys = [_pub(d) for d in scalars]
    src = KeyTableCache(4, device="cpu")
    for k in keys:
        src.pin(k)
    path = str(tmp_path / "warm.npz")
    assert src.snapshot_to(path) == 3
    rejects: list[str] = []
    dst = KeyTableCache(4, device="cpu")
    assert dst.restore_from(path, on_reject=rejects.append) == 3
    assert rejects == [] and all(dst.contains(k) for k in keys)
    s_slots, s_pools = src.lookup_batch("P-256", keys)
    d_slots, d_pools = dst.lookup_batch("P-256", keys)
    for nm in s_pools:
        for ss, ds in zip(s_slots, d_slots):
            assert torch.equal(s_pools[nm][ss], d_pools[nm][ds])
    # the pinned plain twin gives the same verdicts over both pools
    reqs = []
    for i, d in enumerate(scalars):
        h = sw.key_from_scalar("P-256", d)
        digest = sw.hash(b"snapshot %d" % i)
        r, s = sw.sign(h, digest)
        reqs.append(VerifyRequest(keys[i], digest if i else sw.hash(b"x"),
                                  r, s))
    from bdls_tpu_torch.crypto import marshal

    arrs = marshal.marshal_requests(reqs)
    cv = CURVES["P-256"]
    got = [ecdsa.launch_verify_pinned(cv, arrs[2:], np.asarray(sl, np.int32),
                                      pools, device="cpu").tolist()
           for sl, pools in ((s_slots, s_pools), (d_slots, d_pools))]
    assert got[0] == got[1] == [False, True, True]
    # a missing file is a no-op
    assert KeyTableCache(4, device="cpu").restore_from(
        str(tmp_path / "no.npz")) == 0


def test_key_snapshot_drops_bad_entries_keeps_neighbours(tmp_path):
    path = str(tmp_path / "pinned.npz")
    honest, victim = _entry(0x41), _entry(0x42)
    # another key's tables under this key's point: the position-0,
    # digit-1 check catches it
    imposter = dict(_entry(0x99), tabs=victim["tabs"])
    off_curve = _entry(0x43)
    off_curve["y"] = (off_curve["y"] + 1) % CURVES["P-256"].fp.modulus
    off_curve["ski"] = table_snapshot._ski(off_curve["x"], off_curve["y"])
    # the right tables and point filed under another key's SKI
    wrong_ski = dict(_entry(0x44), ski=honest["ski"])
    table_snapshot.save_pinned_snapshot(
        path, [imposter, honest, off_curve, wrong_ski])
    rejects: list[str] = []
    got = table_snapshot.load_pinned_snapshot(path, on_reject=rejects.append)
    assert [g["ski"] for g in got] == [honest["ski"]]
    assert rejects == [table_snapshot.REJECT_BAD_KEY] * 3
    for nm in honest["tabs"]:
        assert np.array_equal(got[0]["tabs"][nm], honest["tabs"][nm])
    cache = KeyTableCache(4, device="cpu")
    assert cache.restore_from(path) == 1
    assert cache.contains(_pub(0x41)) and not cache.contains(_pub(0x99))


def test_key_snapshot_tampered_file_restores_nothing(tmp_path):
    path = str(tmp_path / "pinned.npz")
    table_snapshot.save_pinned_snapshot(path, [_entry(0x41)])
    raw = bytearray(open(path, "rb").read())
    raw[len(raw) // 2] ^= 0xFF
    with open(path, "wb") as f:
        f.write(bytes(raw))
    rejects: list[str] = []
    cache = KeyTableCache(4, device="cpu")
    assert cache.restore_from(path, on_reject=rejects.append) == 0
    assert rejects == [table_snapshot.REJECT_CORRUPT] and len(cache) == 0


def test_restore_never_writes_a_published_pool(tmp_path):
    path = str(tmp_path / "pinned.npz")
    table_snapshot.save_pinned_snapshot(path, [_entry(0x51), _entry(0x52)])
    cache = KeyTableCache(3, device="cpu")
    held = [_pub(0x53), _pub(0x54)]
    for k in held:
        cache.pin(k)
    slots, pools = cache.lookup_batch("P-256", held)
    before = {nm: t.clone() for nm, t in pools.items()}
    # the curve has keys: the entries go through the copy-on-write insert
    # (one of them evicting the least recent held key)
    assert cache.restore_from(path) == 2
    for nm, t in pools.items():
        assert torch.equal(t, before[nm])
    assert cache.contains(_pub(0x51)) and cache.contains(_pub(0x52))
    assert cache.stats["evictions"] == 1
    # into a curve with no keys: one new pool, published whole
    other = str(tmp_path / "k1.npz")
    table_snapshot.save_pinned_snapshot(other, [_entry(0x55, "secp256k1")])
    assert cache.restore_from(other) == 1
    for nm, t in pools.items():
        assert torch.equal(t, before[nm])
    k1_slots, k1_pools = cache.lookup_batch(
        "secp256k1", [_pub(0x55, "secp256k1")])
    assert k1_slots == [0]
    want = _entry(0x55, "secp256k1")["tabs"]
    for nm in want:
        assert np.array_equal(k1_pools[nm][0].numpy(), want[nm])


def test_reference_snapshot_entries_carry_into_the_port_layout():
    """The reference's ``KeyTableCache.snapshot_entries`` of the same
    keys, carried by ``pinned_tables_from_reference`` and
    ``pinned_device_tables``, equal what the port snapshots."""
    scalars = {"P-256": (0x61, 0x62), "secp256k1": (0x71,)}
    ref = jtp.KeyTableCache(4)
    port = KeyTableCache(4, device="cpu")
    for curve, ds in scalars.items():
        for d in ds:
            k = _pub(d, curve)
            ref.pin(JPublicKey(curve, k.x, k.y))
            port.pin(k)
    ours = {e["ski"]: e for e in port.snapshot_entries()}
    theirs = ref.snapshot_entries()
    assert len(theirs) == len(ours) == 3
    for e in theirs:
        mine = ours[e["ski"]]
        assert (e["curve"], e["x"], e["y"]) == (mine["curve"], mine["x"],
                                                 mine["y"])
        carried = vf.pinned_device_tables(
            e["curve"], vf.pinned_tables_from_reference(e["tabs"]))
        assert set(carried) == set(mine["tabs"])
        for nm in carried:
            assert np.array_equal(carried[nm], mine["tabs"][nm])
        assert table_snapshot.validate_pinned_entry(
            e["curve"], e["x"], e["y"], carried)


# ---- the warm-up race --------------------------------------------------------

def _slowed(monkeypatch):
    """Slow every launch by 0.3 s and record how many run at once."""
    real = TorchCSP._launch_kernel
    state = {"now": 0, "most": 0}
    lock = threading.Lock()

    def slow(self, *a, **kw):
        with lock:
            state["now"] += 1
            state["most"] = max(state["most"], state["now"])
        try:
            time.sleep(0.3)
            return real(self, *a, **kw)
        finally:
            with lock:
                state["now"] -= 1

    monkeypatch.setattr(TorchCSP, "_launch_kernel", slow)
    return state


def _race(*fns):
    barrier = threading.Barrier(len(fns))
    errs: list = []

    def run(fn):
        try:
            barrier.wait(5.0)
            fn()
        except Exception as exc:  # noqa: BLE001
            errs.append(exc)

    ts = [threading.Thread(target=run, args=(fn,)) for fn in fns]
    for t in ts:
        t.start()
    for t in ts:
        t.join(30.0)
    assert not any(t.is_alive() for t in ts)
    assert not errs


def test_warmup_race_compiles_once(monkeypatch):
    """Two threads warming one (curve, bucket): one warm-up and one
    ``warmed`` hit (``tests/test_coldstart.py:307``)."""
    monkeypatch.delenv(aot_cache.ENV_VAR, raising=False)
    state = _slowed(monkeypatch)
    csp = TorchCSP(device="cpu", kernel_field="sw", buckets=(4,),
                   key_cache_size=0)
    try:
        _race(*[lambda: csp.warmup(pairs=[("P-256", 4)])] * 2)
        m = csp.metrics
        assert m.find("tpu_compile_programs_total").value(
            ("sw", "P-256", "4")) == 1.0
        assert m.find("tpu_compile_cache_hits_total").value(
            ("warmed",)) == 1.0
        assert state["most"] == 1
    finally:
        csp.close()


def test_eager_first_launch_waits_for_a_racing_warmup(monkeypatch):
    monkeypatch.delenv(aot_cache.ENV_VAR, raising=False)
    state = _slowed(monkeypatch)
    lanes = vectors.signed_lanes("P-256", 3, np.random.default_rng(3))
    reqs = [VerifyRequest(PublicKey("P-256", qx, qy), d, r, s)
            for qx, qy, r, s, d, _ in lanes]
    got: list = []
    csp = TorchCSP(device="cpu", kernel_field="sw", buckets=(4,),
                   key_cache_size=0)
    try:
        _race(lambda: csp.warmup(pairs=[("P-256", 4)]),
              lambda: got.extend(csp.verify_batch(reqs)))
        assert got == [True] * 3
        assert csp.metrics.find("tpu_compile_programs_total").value(
            ("sw", "P-256", "4")) == 1.0
        assert state["most"] == 1        # never alongside the warm-up
    finally:
        csp.close()
