"""Build and bind the CUDA kernels of ``bdls_tpu_torch/csrc``.

``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler
-fPIC`` compiles each source of :data:`SOURCES` (with the headers it
includes) into its own shared library under ``build/`` at the root of
the checkout, on first use. The compilers run side by side, one process
a source. A library's name carries a hash of its source, the headers and
the flags, so an edited source never loads a stale build. The plain C
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
           "bls.cu")
HEADERS = ("field.cuh", "point.cuh", "verify.cuh", "glv.cuh", "pinned.cuh",
           "sha256.cuh", "block.cuh", "edwards.cuh", "fp381.cuh", "bls12.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
_VP = ctypes.c_void_p
_INT = ctypes.c_int
# the C entries of each source and their argument types
ENTRIES = {
    "verify.cu": {
        "bdls_verify": [_INT] + [_VP] * 7 + [_INT, _INT, _VP],
        "bdls_copy": [_VP, _VP, ctypes.c_size_t, _VP]},
    "pinned.cu": {"bdls_verify_pinned":
                  [_INT] + [_VP] * 9 + [_INT, _INT, _INT, _VP]},
    "sha256.cu": {"bdls_sha256": [_VP] * 3 + [_INT] * 3 + [_VP]},
    "block.cu": {"bdls_verify_block":
                 [_INT] + [_VP] * 14 + [_INT] * 5 + [_VP]},
    "ed25519.cu": {"bdls_verify_ed25519": [_VP] * 8 + [_INT, _INT, _VP]},
    "bls.cu": {"bdls_bls_miller": [_VP] * 6 + [_INT, _INT, _VP],
               "bdls_bls_final": [_VP] * 5 + [_INT, _INT, _VP]},
}

_lock = threading.Lock()
_lib = None
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


def _digest(source: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in (source,) + HEADERS:
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def _target(source: str) -> Path:
    return BUILD_DIR / f"libbdls_{Path(source).stem}-{_digest(source)}.so"


def build(force: bool = False) -> dict:
    """Compile every source whose library is missing, all at once.
    Returns ``{"paths": {source: path}, "seconds": wall time,
    "ptxas": {source: -Xptxas -v report}, "cached": bool}``; the report
    (registers, spills) is empty for a library that was already built."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {src: _target(src) for src in SOURCES}
    todo = [src for src in SOURCES if force or not paths[src].exists()]
    t0 = time.perf_counter()
    procs = {}
    for src in todo:
        tmp = paths[src].with_suffix(f".{os.getpid()}.tmp")
        procs[src] = (tmp, subprocess.Popen(
            [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    reports, failed = {}, []
    for src, (tmp, proc) in procs.items():
        reports[src] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"nvcc {src} failed ({proc.returncode}):\n"
                          f"{reports[src]}")
        else:
            os.replace(tmp, paths[src])
    if failed:
        raise RuntimeError("\n".join(failed))
    return {"paths": {s: str(p) for s, p in paths.items()},
            "seconds": time.perf_counter() - t0 if todo else 0.0,
            "ptxas": reports, "cached": not todo}


def lib() -> SimpleNamespace:
    """The kernels' C entries (``bdls_verify``, ``bdls_copy``,
    ``bdls_verify_pinned``, ``bdls_sha256``, ``bdls_verify_block``,
    ``bdls_verify_ed25519``, ``bdls_bls_miller``, ``bdls_bls_final``),
    built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            paths = build()["paths"]
            fns = {}
            for src, entries in ENTRIES.items():
                so = ctypes.CDLL(paths[src])
                for name, argtypes in entries.items():
                    fn = getattr(so, name)
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
                    fns[name] = fn
            _lib = SimpleNamespace(**fns)
        return _lib


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
