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
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
SOURCES = ("verify.cu", "pinned.cu", "sha256.cu", "block.cu", "ed25519.cu",
           "bls.cu", "mont16.cu")
HEADERS = ("field.cuh", "mxu.cuh", "point.cuh", "verify.cuh", "glv.cuh",
           "pinned.cuh", "sha256.cuh", "block.cuh", "edwards.cuh",
           "fp381.cuh", "bls12.cuh", "mont16.cuh")
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
        "bdls_verify": [_INT] + [_VP] * 7 + [_INT, _INT, _VP],
        "bdls_field_mul": [_INT] + [_VP] * 3 + [_INT, _VP],
        "bdls_copy": [_VP, _VP, ctypes.c_size_t, _VP]},
    "pinned.cu": {"bdls_verify_pinned":
                  [_INT] + [_VP] * 9 + [_INT, _INT, _INT, _VP]},
    "sha256.cu": {"bdls_sha256": [_VP] * 3 + [_INT] * 3 + [_VP]},
    "block.cu": {"bdls_verify_block":
                 [_INT] + [_VP] * 14 + [_INT] * 5 + [_VP]},
    "ed25519.cu": {"bdls_verify_ed25519": [_VP] * 8 + [_INT, _INT, _VP]},
    "bls.cu": {"bdls_bls_miller": [_VP] * 6 + [_INT, _INT, _VP],
               "bdls_bls_final": [_VP] * 5 + [_INT, _INT, _VP]},
    "mont16.cu": {"bdls_verify_mont16":
                  [_INT] + [_VP] * 7 + [_INT, _INT, _VP]},
}

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


def build(force: bool = False) -> dict:
    """Compile every build whose library is missing, all at once.
    Returns ``{"paths": {key: path}, "seconds": wall time, "ptxas": {key:
    -Xptxas -v report}, "cached": bool}``, keyed by :func:`_key`; the
    report (registers, spills) is empty for a library that was already
    built."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {_key(s, e): _target(s, e) for s, e in jobs()}
    todo = [(s, e) for s, e in jobs() if force or not paths[_key(s, e)].exists()]
    t0 = time.perf_counter()
    procs = {}
    for src, eng in todo:
        key = _key(src, eng)
        tmp = paths[key].with_suffix(f".{os.getpid()}.tmp")
        procs[key] = (tmp, subprocess.Popen(
            [nvcc_path(), *_flags(eng), "-o", str(tmp), str(CSRC / src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    reports, failed = {}, []
    for key, (tmp, proc) in procs.items():
        reports[key] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"nvcc {key} failed ({proc.returncode}):\n"
                          f"{reports[key]}")
        else:
            os.replace(tmp, paths[key])
    if failed:
        raise RuntimeError("\n".join(failed))
    return {"paths": {k: str(p) for k, p in paths.items()},
            "seconds": time.perf_counter() - t0 if todo else 0.0,
            "ptxas": reports, "cached": not todo}


def lib(engine: str = "vpu") -> SimpleNamespace:
    """The C entries of one engine's builds, every build made on first
    call. ``"vpu"``: ``bdls_verify``, ``bdls_field_mul``, ``bdls_copy``,
    ``bdls_verify_pinned``, ``bdls_sha256``, ``bdls_verify_block``,
    ``bdls_verify_ed25519``, ``bdls_bls_miller``, ``bdls_bls_final``,
    ``bdls_verify_mont16``; ``"mxu"``: the entries of
    :data:`MXU_SOURCES` under the same names, from their K5 builds."""
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}")
    with _lock:
        if not _libs:
            paths = build()["paths"]
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
                _libs[eng] = SimpleNamespace(**fns)
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
