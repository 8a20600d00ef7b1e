"""AES-256-GCM on the host, for the cluster mesh's sealed frames.

The surface ``comm/cluster.py:SecureChannel`` uses of the
``cryptography`` package's ``AESGCM``, which the card's machine lacks:
``AESGCM(key).encrypt(nonce, data, aad)`` returns the ciphertext with
its 16-byte tag appended, ``decrypt`` takes it back and raises
:class:`InvalidTag` when the tag does not match (compared in constant
time, before any plaintext is written). Keys are 32 bytes, nonces 12.

The cipher is ``csrc/aes_gcm.h`` (AES-NI and PCLMULQDQ), built with g++
on first use by :func:`bdls_tpu_torch.ops._build.host_shim` into
``build/`` and bound with ctypes; each call releases the interpreter
lock. A CPU without the two instruction sets makes :func:`lib` raise:
there is no slower path.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

__all__ = ["AESGCM", "InvalidTag", "lib"]

NONCE_BYTES = 12
TAG_BYTES = 16
KEY_BYTES = 32

_SHIM = r"""
#include "aes_gcm.h"

extern "C" {

int bdls_aes_gcm_supported(void) {
    __builtin_cpu_init();
    return __builtin_cpu_supports("aes") && __builtin_cpu_supports("pclmul");
}

size_t bdls_aes_gcm_ctx_size(void) { return sizeof(bdls_aes::Ctx); }

void bdls_aes_gcm_init(void* ctx, const uint8_t* key) {
    bdls_aes::init(static_cast<bdls_aes::Ctx*>(ctx), key);
}

// out[0..n + 16): the ciphertext and the tag
void bdls_aes_gcm_seal(const void* ctx, const uint8_t* iv,
                       const uint8_t* aad, size_t aad_len,
                       const uint8_t* pt, size_t n, uint8_t* out) {
    const bdls_aes::Ctx* c = static_cast<const bdls_aes::Ctx*>(ctx);
    bdls_aes::ctr_xor(c, iv, pt, out, n);
    bdls_aes::tag(c, iv, aad, aad_len, out, n, out + n);
}

// in[0..n + 16): the ciphertext and the tag; 0 and out[0..n) written,
// or 1 (a tag that does not match) and nothing written
int bdls_aes_gcm_open(const void* ctx, const uint8_t* iv,
                      const uint8_t* aad, size_t aad_len,
                      const uint8_t* in, size_t n, uint8_t* out) {
    const bdls_aes::Ctx* c = static_cast<const bdls_aes::Ctx*>(ctx);
    uint8_t want[16];
    bdls_aes::tag(c, iv, aad, aad_len, in, n, want);
    uint8_t diff = 0;
    for (int j = 0; j < 16; ++j) diff |= uint8_t(want[j] ^ in[n + j]);
    if (diff) return 1;
    bdls_aes::ctr_xor(c, iv, in, out, n);
    return 0;
}

}
"""
_FLAGS = ("-maes", "-mpclmul", "-mssse3", "-msse4.1")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


class InvalidTag(Exception):
    """The tag does not authenticate the ciphertext, nonce and AAD."""


def lib() -> ctypes.CDLL:
    """Build (once a process) and bind ``csrc/aes_gcm.h``."""
    global _lib
    with _lock:
        if _lib is None:
            from bdls_tpu_torch.ops import _build

            so = _build.host_shim(_SHIM, "aes_gcm", _FLAGS,
                                  headers=("aes_gcm.h",))
            so.bdls_aes_gcm_supported.restype = ctypes.c_int
            so.bdls_aes_gcm_supported.argtypes = []
            if not so.bdls_aes_gcm_supported():
                raise RuntimeError(
                    "AES-256-GCM needs a CPU with AES-NI and PCLMULQDQ; "
                    "this one lacks them")
            vp, sz = ctypes.c_void_p, ctypes.c_size_t
            so.bdls_aes_gcm_ctx_size.restype = sz
            so.bdls_aes_gcm_ctx_size.argtypes = []
            so.bdls_aes_gcm_init.restype = None
            so.bdls_aes_gcm_init.argtypes = [vp, ctypes.c_char_p]
            so.bdls_aes_gcm_seal.restype = None
            so.bdls_aes_gcm_seal.argtypes = [
                vp, ctypes.c_char_p, ctypes.c_char_p, sz, ctypes.c_char_p,
                sz, vp]
            so.bdls_aes_gcm_open.restype = ctypes.c_int
            so.bdls_aes_gcm_open.argtypes = [
                vp, ctypes.c_char_p, ctypes.c_char_p, sz, ctypes.c_char_p,
                sz, vp]
            _lib = so
        return _lib


def _as_bytes(what: str, v) -> bytes:
    if isinstance(v, bytes):
        return v
    if isinstance(v, (bytearray, memoryview)):
        return bytes(v)
    raise TypeError(f"{what} must be bytes-like, not {type(v).__name__}")


class AESGCM:
    """AES-256-GCM under one key; safe to share between threads."""

    def __init__(self, key: bytes):
        key = _as_bytes("key", key)
        if len(key) != KEY_BYTES:
            raise ValueError(f"AESGCM key must be {KEY_BYTES} bytes")
        self._lib = lib()
        self._ctx = ctypes.create_string_buffer(
            self._lib.bdls_aes_gcm_ctx_size() + 16)
        # the context holds __m128i: align it to 16 bytes
        base = ctypes.addressof(self._ctx)
        self._ptr = ctypes.c_void_p(base + (-base % 16))
        self._lib.bdls_aes_gcm_init(self._ptr, key)

    @staticmethod
    def _args(nonce, aad) -> tuple[bytes, bytes]:
        nonce = _as_bytes("nonce", nonce)
        if len(nonce) != NONCE_BYTES:
            raise ValueError(f"nonce must be {NONCE_BYTES} bytes")
        return nonce, b"" if aad is None else _as_bytes("aad", aad)

    def encrypt(self, nonce: bytes, data: bytes,
                associated_data: Optional[bytes]) -> bytes:
        nonce, aad = self._args(nonce, associated_data)
        data = _as_bytes("data", data)
        out = bytearray(len(data) + TAG_BYTES)
        buf = (ctypes.c_char * len(out)).from_buffer(out)
        self._lib.bdls_aes_gcm_seal(self._ptr, nonce, aad, len(aad), data,
                                    len(data), ctypes.addressof(buf))
        del buf
        return bytes(out)

    def decrypt(self, nonce: bytes, data: bytes,
                associated_data: Optional[bytes]) -> bytes:
        nonce, aad = self._args(nonce, associated_data)
        data = _as_bytes("data", data)
        n = len(data) - TAG_BYTES
        if n < 0:
            raise InvalidTag("ciphertext shorter than its tag")
        out = bytearray(max(n, 1))
        buf = (ctypes.c_char * len(out)).from_buffer(out)
        bad = self._lib.bdls_aes_gcm_open(self._ptr, nonce, aad, len(aad),
                                          data, n, ctypes.addressof(buf))
        del buf
        if bad:
            raise InvalidTag("tag mismatch")
        return bytes(out[:n])
