"""Persistent store of the built kernel libraries.

The counterpart of ``bdls_tpu/ops/aot_cache.py``. Where the reference
stores ``jax.export`` programs, the port stores the shared libraries
that :mod:`bdls_tpu_torch.ops._build` makes with nvcc: one entry a
(source, engine) build, keyed by the build's key (``verify.cu``,
``verify.cu:mxu``) and its digest of sources, headers and flags
(:func:`cache_key`), and stamped with the environment it was built in
(:func:`fingerprint`). A process that finds every build in the store
loads them without nvcc; on the card a stored library is both of the
reference's tiers at once (no trace, no compile), so the reference's
XLA compile-cache tier and its program overlay have no counterpart.

The store is advisory: every load failure (a truncated file, another
environment's fingerprint, a payload whose digest does not match, a
payload that does not ``dlopen`` or lacks one of its C entries) is a
miss, counted through the caller's ``on_reject`` hook
(``tpu_aot_cache_rejects_total{reason}``), and the build runs nvcc
again. Without nvcc that build raises, as :func:`_build.nvcc_path`
does: nothing falls back to a plain twin.

Entry format, as the reference's: an 8-byte magic, a length-prefixed
JSON header (format version, readable key, fingerprint, payload digest
and size, and for the record the nvcc that built it), then the payload,
the library's bytes. Writes are atomic (temp file + rename). A loaded
payload is written once more, under its digest, to ``<root>/loaded``
and opened from there.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import os
import tempfile
from pathlib import Path
from typing import Callable, Optional

import torch

FORMAT_VERSION = 1
_MAGIC = b"BDLSAOT1"
ENV_VAR = "BDLS_TPU_AOT_CACHE"

# load-reject taxonomy (the {reason} label values)
REJECT_TRUNCATED = "truncated"
REJECT_FINGERPRINT = "fingerprint"
REJECT_CORRUPT = "corrupt"


def cache_root() -> Optional[str]:
    """The configured cache root (``$BDLS_TPU_AOT_CACHE``), or None."""
    root = os.environ.get(ENV_VAR, "").strip()
    return root or None


def enabled() -> bool:
    return cache_root() is not None


def _driver_version() -> str:
    """The CUDA driver's version (``cuDriverGetVersion``), or ``none``."""
    try:
        libcuda = ctypes.CDLL("libcuda.so.1")
        v = ctypes.c_int()
        if libcuda.cuDriverGetVersion(ctypes.byref(v)) != 0:
            return "none"
        return str(v.value)
    except OSError:
        return "none"


def fingerprint() -> str:
    """The environment an entry must match to load: torch's version and
    CUDA, the driver's version, and the card's name and compute
    capability (``platform=cpu`` where there is no card). nvcc is not
    part of it: a process without nvcc must be able to load."""
    base = f"torch={torch.__version__};cuda={torch.version.cuda}"
    if not torch.cuda.is_available():
        return f"{base};platform=cpu"
    major, minor = torch.cuda.get_device_capability(0)
    return (f"{base};driver={_driver_version()};platform=gpu;"
            f"kind={torch.cuda.get_device_name(0)};sm={major}{minor}")


def cache_key(build_key: str, digest: str) -> str:
    """Canonical content-address of one library: ``_build``'s (source,
    engine) key and its digest of sources, headers and flags."""
    return f"v{FORMAT_VERSION}|{build_key}|{digest}"


class AotStore:
    """Content-addressed on-disk store of built kernel libraries, one
    file a key under ``<root>/libraries``."""

    def __init__(self, root: str,
                 on_reject: Optional[Callable[[str], None]] = None):
        self.root = root
        self.dir = os.path.join(root, "libraries")
        self._loaded_dir = os.path.join(root, "loaded")
        os.makedirs(self.dir, exist_ok=True)
        os.makedirs(self._loaded_dir, exist_ok=True)
        self._on_reject = on_reject
        self._fingerprint = fingerprint()

    # ---- paths -----------------------------------------------------------
    def path_for(self, key: str) -> str:
        h = hashlib.sha256(key.encode()).hexdigest()[:40]
        return os.path.join(self.dir, f"{h}.aot")

    def _reject(self, reason: str) -> None:
        if self._on_reject is not None:
            try:
                self._on_reject(reason)
            except Exception:  # noqa: BLE001 — metrics must not break loads
                pass

    # ---- raw entry IO ----------------------------------------------------
    def save(self, key: str, payload: bytes, record: Optional[dict] = None
             ) -> str:
        """Write one entry atomically; ``record`` joins the header for
        the reader's information (it is not checked on load)."""
        header = json.dumps({
            "v": FORMAT_VERSION,
            "key": key,
            "fingerprint": self._fingerprint,
            "sha256": hashlib.sha256(payload).hexdigest(),
            "nbytes": len(payload),
            **(record or {}),
        }).encode()
        return _write_atomic(self.path_for(key), _MAGIC
                             + len(header).to_bytes(4, "big") + header
                             + payload)

    def load(self, key: str) -> Optional[bytes]:
        """The validated payload for ``key``, or None (miss or reject).
        Every malformed entry is classified, counted and treated as a
        miss."""
        path = self.path_for(key)
        try:
            with open(path, "rb") as f:
                raw = f.read()
        except FileNotFoundError:
            return None
        except OSError:
            self._reject(REJECT_CORRUPT)
            return None
        if len(raw) < len(_MAGIC) + 4:
            self._reject(REJECT_TRUNCATED)
            return None
        if raw[:len(_MAGIC)] != _MAGIC:
            self._reject(REJECT_CORRUPT)
            return None
        hlen = int.from_bytes(raw[len(_MAGIC):len(_MAGIC) + 4], "big")
        body = raw[len(_MAGIC) + 4:]
        if len(body) < hlen:
            self._reject(REJECT_TRUNCATED)
            return None
        try:
            header = json.loads(body[:hlen])
        except (ValueError, UnicodeDecodeError):
            self._reject(REJECT_CORRUPT)
            return None
        if header.get("v") != FORMAT_VERSION or header.get("key") != key:
            self._reject(REJECT_CORRUPT)
            return None
        if header.get("fingerprint") != self._fingerprint:
            self._reject(REJECT_FINGERPRINT)
            return None
        payload = body[hlen:]
        if len(payload) < int(header.get("nbytes", -1)):
            self._reject(REJECT_TRUNCATED)
            return None
        payload = payload[:int(header["nbytes"])]
        if hashlib.sha256(payload).hexdigest() != header.get("sha256"):
            self._reject(REJECT_CORRUPT)
            return None
        return payload

    # ---- library IO ------------------------------------------------------
    def save_library(self, key: str, path, record: Optional[dict] = None
                     ) -> str:
        """Store the library at ``path`` under ``key``."""
        return self.save(key, Path(path).read_bytes(), record)

    def load_library(self, key: str, entries) -> Optional[str]:
        """The path of the stored library for ``key``, opened once here
        to check it, or None. A payload that does not ``dlopen``, or
        lacks one of ``entries`` (C entry names), counts as corrupt."""
        payload = self.load(key)
        if payload is None:
            return None
        digest = hashlib.sha256(payload).hexdigest()[:32]
        path = _write_atomic(os.path.join(self._loaded_dir, f"{digest}.so"),
                             payload)
        try:
            so = ctypes.CDLL(path)
            for name in entries:
                getattr(so, name)
        except (OSError, AttributeError):
            self._reject(REJECT_CORRUPT)
            return None
        return path


def _write_atomic(path: str, data: bytes) -> str:
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path), suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    return path


def from_env(on_reject: Optional[Callable[[str], None]] = None
             ) -> Optional[AotStore]:
    """The process's store per ``$BDLS_TPU_AOT_CACHE``, or None when
    the cache is not configured (the default; no change of behaviour)."""
    root = cache_root()
    if root is None:
        return None
    try:
        return AotStore(root, on_reject=on_reject)
    except OSError:
        return None
