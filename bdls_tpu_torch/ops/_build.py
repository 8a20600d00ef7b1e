"""Build and bind the CUDA kernels of ``bdls_tpu_torch/csrc``.

``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler
-fPIC`` compiles ``csrc/verify.cu`` (with the headers it includes) into a
shared library under ``build/`` at the root of the checkout, on first
use; the library's name carries a hash of the sources and flags, so an
edited source never loads a stale build. The plain C interface is bound
with ``ctypes``: pointers and the stream are passed as ``c_void_p``.
A build error raises with the compiler's output; a launch error raises
from :func:`check` with the CUDA error code the C entry returns.
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

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
SOURCES = ("verify.cu",)
HEADERS = ("field.cuh", "point.cuh", "verify.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_lib = None


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


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build(force: bool = False) -> dict:
    """Compile the kernels if the library for these sources is missing.
    Returns ``{"path", "seconds", "ptxas", "cached"}``; ``ptxas`` is the
    ``-Xptxas -v`` report (registers, spills) of a fresh build."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = BUILD_DIR / f"libbdls_verify-{_digest()}.so"
    if out.exists() and not force:
        return {"path": str(out), "seconds": 0.0, "ptxas": "",
                "cached": True}
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
           *(str(CSRC / s) for s in SOURCES)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    dt = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    return {"path": str(out), "seconds": dt,
            "ptxas": proc.stdout + proc.stderr, "cached": False}


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(build()["path"])
            fn = handle.bdls_verify
            fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 7
                           + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
            fn.restype = ctypes.c_int
            _lib = handle
        return _lib


def check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")
