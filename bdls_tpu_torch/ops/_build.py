"""Build and bind the CUDA kernels of ``bdls_tpu_torch/csrc``.

``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler
-fPIC`` compiles each source of :data:`SOURCES` (with the headers it
includes) into its own shared library under ``build/`` at the root of
the checkout, on first use. The sources of :data:`MXU_SOURCES` are built
a second time with ``-DBDLS_MUL_MXU``: the "mxu" engine, whose
``mont_mul`` is K5's tensor-core product (``csrc/mxu.cuh``). The
compilers run side by side, one process a (source, engine). A library's
name carries a hash of its source, the headers and the flags (the define
included), so an edited source never loads a stale build. The plain C
interfaces are bound with ``ctypes``: pointers and the stream are passed
as ``c_void_p``. A build error raises with the compiler's output; a
launch error raises from :func:`check` with the CUDA error code the C
entry returns.

With ``BDLS_TPU_AOT_CACHE`` set (:mod:`bdls_tpu_torch.ops.aot_cache`),
each build is looked up in that store first and loaded from it without
nvcc; a miss or a rejected entry is compiled with nvcc and saved there.
The libraries already under ``build/`` are then not read. A rejected
entry with no nvcc raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from types import SimpleNamespace
from typing import Optional

import numpy as np
import torch

from bdls_tpu_torch.ops import aot_cache

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
SOURCES = ("verify.cu", "pinned.cu", "sha256.cu", "block.cu", "ed25519.cu",
           "bls.cu", "mont16.cu")
HEADERS = ("field.cuh", "mxu.cuh", "point.cuh", "verify.cuh", "glv.cuh",
           "pinned.cuh", "verify_group.cuh", "pinned_group.cuh",
           "sha256.cuh", "block.cuh", "edwards.cuh", "edwards_group.cuh",
           "fp381.cuh",
           "bls12.cuh", "mont16.cuh", "mont16_group.cuh", "mesh.cuh")
# the limb-product engines: "vpu" (CIOS) builds every source, "mxu" (K5)
# the four whose lane bodies go through mont_mul
ENGINES = ("vpu", "mxu")
MXU_SOURCES = ("verify.cu", "pinned.cu", "block.cu", "ed25519.cu")
ENGINE_FLAGS = {"vpu": (), "mxu": ("-DBDLS_MUL_MXU",)}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
_VP = ctypes.c_void_p
_INT = ctypes.c_int
# the C entries of each source and their argument types
ENTRIES = {
    "verify.cu": {
        "bdls_verify_lane_threads": [],
        "bdls_verify": [_INT] + [_VP] * 7 + [_INT, _INT, _VP],
        "bdls_verify_masked": [_INT] + [_VP] * 9 + [_INT, _INT, _VP],
        "bdls_field_mul": [_INT] + [_VP] * 3 + [_INT, _VP],
        "bdls_copy": [_VP, _VP, ctypes.c_size_t, _VP]},
    "pinned.cu": {
        "bdls_pinned_lane_threads": [],
        "bdls_verify_pinned": [_INT] + [_VP] * 9 + [_INT, _INT, _INT, _VP],
        "bdls_verify_pinned_masked":
            [_INT] + [_VP] * 11 + [_INT, _INT, _INT, _VP]},
    "sha256.cu": {"bdls_sha256": [_VP] * 3 + [_INT] * 3 + [_VP]},
    "block.cu": {"bdls_verify_block":
                 [_INT] + [_VP] * 14 + [_INT] * 5 + [_VP]},
    "ed25519.cu": {
        "bdls_ed25519_lane_threads": [],
        "bdls_ed25519_lane_smem": [],
        "bdls_verify_ed25519": [_VP] * 8 + [_INT, _INT, _VP],
        "bdls_field_chain": [_INT] + [_VP] * 3 + [_INT, _VP]},
    "bls.cu": {"bdls_bls_miller": [_VP] * 6 + [_INT, _VP],
               "bdls_bls_final": [_VP] * 5 + [_INT, _VP],
               "bdls_bls_final_full": [_VP] * 5 + [_INT, _VP]},
    "mont16.cu": {
        "bdls_mont16_lane_threads": [],
        "bdls_mont16_lane_smem": [],
        "bdls_verify_mont16": [_INT] + [_VP] * 7 + [_INT, _INT, _VP],
        "bdls_verify_mont16_masked": [_INT] + [_VP] * 9 + [_INT, _INT, _VP]},
}

# threads a lane of the group bodies (csrc/verify_group.cuh:GROUP) in both
# engines' builds of K1, K2, K7 and K8 (the mxu builds make each round's
# products in one K5 call of the warp) and in K4's (vpu only). lib() holds
# each build's bdls_verify_lane_threads(), bdls_pinned_lane_threads(),
# bdls_ed25519_lane_threads() and bdls_mont16_lane_threads() to it.
VERIFY_GROUP = 8
LANE_THREADS = {"vpu": VERIFY_GROUP, "mxu": VERIFY_GROUP}

_lock = threading.Lock()
_libs: dict = {}
# guards every wrapper's launch count (the provider launches from two
# threads)
count_lock = threading.Lock()


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                       "(set CUDA_HOME or put nvcc on PATH)")


def _flags(engine: str) -> tuple:
    return NVCC_FLAGS + ENGINE_FLAGS[engine]


def _digest(source: str, engine: str = "vpu") -> str:
    h = hashlib.sha256(" ".join(_flags(engine)).encode())
    for name in (source,) + HEADERS:
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def _key(source: str, engine: str) -> str:
    """A build's key in :func:`build`'s maps: the source, or
    ``source:mxu`` for the mxu engine."""
    return source if engine == "vpu" else f"{source}:{engine}"


def _target(source: str, engine: str = "vpu") -> Path:
    tag = "" if engine == "vpu" else f"-{engine}"
    return BUILD_DIR / (f"libbdls_{Path(source).stem}{tag}-"
                        f"{_digest(source, engine)}.so")


def jobs() -> list[tuple[str, str]]:
    """Every (source, engine) build."""
    return [(s, "vpu") for s in SOURCES] + [(s, "mxu") for s in MXU_SOURCES]


def nvcc_version() -> str:
    """The last line of ``nvcc --version`` (the release and build)."""
    out = subprocess.run([nvcc_path(), "--version"], capture_output=True,
                         text=True, check=True).stdout
    return out.strip().splitlines()[-1]


def _compile(src: str, eng: str, target: Path) -> tuple[int, str, float]:
    """One nvcc run of (``src``, ``eng``) into ``target`` (renamed into
    place once built): its return code, output and wall seconds."""
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [nvcc_path(), *_flags(eng), "-o", str(tmp), str(CSRC / src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    secs = time.perf_counter() - t0
    if proc.returncode == 0:
        os.replace(tmp, target)
    return proc.returncode, proc.stdout, secs


def build(force: bool = False, store=None) -> dict:
    """Compile every build whose library is missing, all at once.

    Without ``store`` a library already under ``build/`` is kept (all
    are rebuilt with ``force``). With ``store`` (an
    :class:`~bdls_tpu_torch.ops.aot_cache.AotStore`) each build is
    looked up there: a hit loads from the store, a miss or a reject is
    compiled and saved into it.

    Returns ``{"paths": {key: path}, "seconds": wall time of the
    compilers, "ptxas": {key: -Xptxas -v report}, "cached": bool,
    "from_store": [keys], "nvcc_seconds": {key: seconds}}``, keyed by
    :func:`_key`; the report (registers, spills) is empty for a library
    that was not compiled here."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {_key(s, e): _target(s, e) for s, e in jobs()}
    from_store = []
    if store is None:
        todo = [(s, e) for s, e in jobs()
                if force or not paths[_key(s, e)].exists()]
    else:
        todo = []
        for src, eng in jobs():
            key = _key(src, eng)
            got = store.load_library(
                aot_cache.cache_key(key, _digest(src, eng)), ENTRIES[src])
            if got is None:
                todo.append((src, eng))
            else:
                paths[key] = Path(got)
                from_store.append(key)
    if todo:
        try:
            nvcc_path()
        except RuntimeError as exc:
            where = "" if store is None else f" (not in the store {store.root})"
            raise RuntimeError(
                f"{exc}; builds to make: {[_key(s, e) for s, e in todo]}"
                f"{where}") from exc
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=max(1, len(todo))) as pool:
        runs = {_key(s, e): pool.submit(_compile, s, e, paths[_key(s, e)])
                for s, e in todo}
        done = {key: run.result() for key, run in runs.items()}
    failed = [f"nvcc {key} failed ({rc}):\n{out}"
              for key, (rc, out, _) in done.items() if rc != 0]
    if failed:
        raise RuntimeError("\n".join(failed))
    if store is not None and todo:
        record = {"nvcc": nvcc_version()}
        for src, eng in todo:
            key = _key(src, eng)
            store.save_library(aot_cache.cache_key(key, _digest(src, eng)),
                               paths[key], dict(record, build=key))
    return {"paths": {k: str(p) for k, p in paths.items()},
            "seconds": time.perf_counter() - t0 if todo else 0.0,
            "ptxas": {key: out for key, (_, out, _) in done.items()},
            "cached": not todo, "from_store": from_store,
            "nvcc_seconds": {key: secs for key, (_, _, secs) in done.items()}}


def host_shim(source: str, stem: str, flags: tuple = (),
              headers: tuple = HEADERS) -> ctypes.CDLL:
    """Compile ``source``, C++ that includes ``headers`` of :data:`CSRC`,
    with g++ into a shared library for the host and load it: the
    kernels' lane bodies run on the CPU, a warp's 32 shares in turn (or
    host code of its own, such as ``aes_gcm.h``). The library,
    ``build/<stem>-<hash>.so``, is named by a hash of the source, the
    flags and the headers, and renamed into place once built, so
    processes side by side share one build."""
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the host build cannot be made")
    h = hashlib.sha256((source + " ".join(flags)).encode())
    for name in headers:
        h.update((CSRC / name).read_bytes())
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so = BUILD_DIR / f"{stem}-{h.hexdigest()[:16]}.so"
    if not so.exists():
        src = so.with_suffix(f".{os.getpid()}.cpp")
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        src.write_text(source)
        try:
            subprocess.run(
                [gxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-Wall",
                 "-Werror", "-Wno-unknown-pragmas", *flags, "-I", str(CSRC),
                 "-o", str(tmp), str(src)], check=True, capture_output=True,
                text=True)
            os.replace(tmp, so)
        finally:
            src.unlink(missing_ok=True)
    return ctypes.CDLL(str(so))


def load(store=None) -> Optional[dict]:
    """Build (or load from the store) and bind every library, once a
    process. ``store`` defaults to :func:`aot_cache.from_env`'s. Returns
    :func:`build`'s report when this call made the libraries, None when
    they were bound already."""
    with _lock:
        if _libs:
            return None
        if store is None:
            store = aot_cache.from_env()
        info = build(store=store)
        paths = info["paths"]
        libs = {}
        for eng in ENGINES:
            fns = {}
            for src, entries in ENTRIES.items():
                if eng != "vpu" and src not in MXU_SOURCES:
                    continue
                so = ctypes.CDLL(paths[_key(src, eng)])
                for name, argtypes in entries.items():
                    fn = getattr(so, name)
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
                    fns[name] = fn
            for src, entry in (("verify.cu", "bdls_verify_lane_threads"),
                               ("pinned.cu", "bdls_pinned_lane_threads"),
                               ("ed25519.cu", "bdls_ed25519_lane_threads"),
                               ("mont16.cu", "bdls_mont16_lane_threads")):
                if eng != "vpu" and src not in MXU_SOURCES:
                    continue
                got = fns[entry]()
                if got != LANE_THREADS[eng]:
                    raise RuntimeError(
                        f"the {eng} build of {src} runs {got} threads a "
                        f"lane, the wrappers expect {LANE_THREADS[eng]}")
            libs[eng] = SimpleNamespace(**fns)
        _libs.update(libs)
        return info


def lib(engine: str = "vpu") -> SimpleNamespace:
    """The C entries of one engine's builds, every build made (or loaded
    from the store, :func:`load`) on first call. ``"vpu"``:
    ``bdls_verify``, ``bdls_verify_lane_threads``,
    ``bdls_field_mul``, ``bdls_copy``, ``bdls_verify_pinned``,
    ``bdls_pinned_lane_threads``, ``bdls_sha256``, ``bdls_verify_block``,
    ``bdls_verify_ed25519``, ``bdls_ed25519_lane_threads``,
    ``bdls_ed25519_lane_smem``, ``bdls_field_chain``, ``bdls_bls_miller``,
    ``bdls_bls_final``, ``bdls_bls_final_full``, ``bdls_verify_mont16``,
    ``bdls_mont16_lane_threads``, ``bdls_mont16_lane_smem`` and the
    counting
    entries of K10's shards, ``bdls_verify_masked``,
    ``bdls_verify_pinned_masked``, ``bdls_verify_mont16_masked``;
    ``"mxu"``: the entries of :data:`MXU_SOURCES` under the same names,
    from their K5 builds."""
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}")
    load()
    return _libs[engine]


def as_int32(a, device=None) -> torch.Tensor:
    """A numpy array, nested list or tensor of 32-bit words -> a
    contiguous int32 tensor holding the same bit patterns (what every C
    entry takes), on ``device`` if given."""
    if isinstance(a, torch.Tensor):
        t = a if a.dtype == torch.int32 else a.to(torch.int32)
    else:
        t = torch.from_numpy(np.ascontiguousarray(
            np.asarray(a, dtype=np.uint32)).view(np.int32))
    if device is not None:
        t = t.to(device, non_blocking=True)
    return t.contiguous()


def check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")
