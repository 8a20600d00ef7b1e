"""The port's host AES-256-GCM (``comm/aead.py`` over
``csrc/aes_gcm.h``) against the ``cryptography`` package's ``AESGCM``.

Every comparison is exact: the same ciphertext and tag for lengths 0, 1,
15, 16, 17, 4 KB + 3 and 1 MB, with and without AAD, under
``SecureChannel``'s little-endian counter nonces 0, 1, 2^32 and
2^64 - 1; each side opens the other's output; a flipped bit in the
ciphertext, the tag, the nonce or the AAD, or a truncated tag, raises
on both. ``tests/aes_gcm_kat.json`` holds known-answer vectors made
here with ``cryptography`` from fixed inputs; this file checks that
they are still what ``cryptography`` gives, and the card's test
(``test_torch_cuda.py``) reads them on the card's machine, which has no
``cryptography``.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest
from cryptography.exceptions import InvalidTag as RefInvalidTag
from cryptography.hazmat.primitives.ciphers.aead import AESGCM as RefAESGCM

from bdls_tpu_torch.comm import aead
from bdls_tpu_torch.comm.aead import AESGCM, InvalidTag

KAT = Path(__file__).resolve().parent / "aes_gcm_kat.json"
LENGTHS = (0, 1, 15, 16, 17, 4096 + 3, 1 << 20)
AADS = (None, b"", b"hdr", bytes(range(37)))
COUNTERS = (0, 1, 1 << 32, (1 << 64) - 1)


def _bytes(rng, n: int) -> bytes:
    return rng.integers(0, 256, n, dtype=np.uint8).tobytes()


def kat_vectors() -> list[dict]:
    """The known-answer vectors, from fixed inputs, by ``cryptography``."""
    rng = np.random.default_rng(20261018)
    out = []
    for n in (0, 1, 15, 16, 17, 64, 256 + 3):
        for aad in (None, b"aad", bytes(range(37))):
            for ctr in (0, 1, 1 << 32, (1 << 64) - 1):
                if ctr not in (0, (1 << 64) - 1) and aad is not None:
                    continue
                key, data = _bytes(rng, 32), _bytes(rng, n)
                nonce = ctr.to_bytes(12, "little")
                sealed = RefAESGCM(key).encrypt(nonce, data, aad)
                out.append({"key": key.hex(), "nonce": nonce.hex(),
                            "aad": None if aad is None else aad.hex(),
                            "plaintext": data.hex(),
                            "sealed": sealed.hex()})
    return out


@pytest.mark.parametrize("n", LENGTHS)
@pytest.mark.parametrize("aad", AADS, ids=("none", "empty", "3", "37"))
def test_seal_and_open_match_cryptography(n, aad):
    rng = np.random.default_rng(n * 7 + len(aad or b""))
    key, data = _bytes(rng, 32), _bytes(rng, n)
    nonce = _bytes(rng, 12)
    mine = AESGCM(key).encrypt(nonce, data, aad)
    theirs = RefAESGCM(key).encrypt(nonce, data, aad)
    assert mine == theirs
    assert len(mine) == n + 16
    assert AESGCM(key).decrypt(nonce, theirs, aad) == data
    assert RefAESGCM(key).decrypt(nonce, mine, aad) == data


@pytest.mark.parametrize("ctr", COUNTERS)
def test_secure_channel_counter_nonces(ctr):
    rng = np.random.default_rng(ctr % 1000)
    key, data = _bytes(rng, 32), _bytes(rng, 1000)
    nonce = ctr.to_bytes(12, "little")
    g = AESGCM(key)
    assert g.encrypt(nonce, data, None) == \
        RefAESGCM(key).encrypt(nonce, data, None)
    assert g.decrypt(nonce, g.encrypt(nonce, data, None), None) == data


def _tampered(sealed: bytes, i: int) -> bytes:
    b = bytearray(sealed)
    b[i] ^= 0x10
    return bytes(b)


@pytest.mark.parametrize("where", ("ciphertext", "last_ciphertext_byte",
                                   "tag", "nonce", "aad", "truncated",
                                   "too_short"))
def test_a_flipped_bit_raises_on_both(where):
    rng = np.random.default_rng(5)
    key, data = _bytes(rng, 32), _bytes(rng, 100)
    nonce, aad = bytes(12), b"frame"
    sealed = RefAESGCM(key).encrypt(nonce, data, aad)
    args = {"ciphertext": (nonce, _tampered(sealed, 3), aad),
            "last_ciphertext_byte": (nonce, _tampered(sealed, 99), aad),
            "tag": (nonce, _tampered(sealed, len(sealed) - 1), aad),
            "nonce": ((1).to_bytes(12, "little"), sealed, aad),
            "aad": (nonce, sealed, b"frame!"),
            "truncated": (nonce, sealed[:-1], aad),
            "too_short": (nonce, sealed[:15], aad)}[where]
    with pytest.raises(InvalidTag):
        AESGCM(key).decrypt(*args)
    with pytest.raises(RefInvalidTag):
        RefAESGCM(key).decrypt(*args)


def test_known_answer_file_is_what_cryptography_gives():
    committed = json.loads(KAT.read_text())
    assert committed == kat_vectors()
    for v in committed:
        aad = None if v["aad"] is None else bytes.fromhex(v["aad"])
        g = AESGCM(bytes.fromhex(v["key"]))
        nonce = bytes.fromhex(v["nonce"])
        assert g.encrypt(nonce, bytes.fromhex(v["plaintext"]), aad).hex() \
            == v["sealed"]
        assert g.decrypt(nonce, bytes.fromhex(v["sealed"]), aad).hex() \
            == v["plaintext"]


def test_max_frame_seals_and_opens():
    """``MAX_FRAME`` (32 MB), the largest frame the cluster carries."""
    from bdls_tpu_torch.comm.cluster import MAX_FRAME

    rng = np.random.default_rng(32)
    key, data = _bytes(rng, 32), _bytes(rng, MAX_FRAME)
    nonce = (7).to_bytes(12, "little")
    sealed = AESGCM(key).encrypt(nonce, data, None)
    assert sealed == RefAESGCM(key).encrypt(nonce, data, None)
    assert AESGCM(key).decrypt(nonce, sealed, None) == data


def test_bad_sizes_are_refused():
    with pytest.raises(ValueError):
        AESGCM(b"k" * 16)
    g = AESGCM(b"k" * 32)
    with pytest.raises(ValueError):
        g.encrypt(b"n" * 11, b"x", None)
    with pytest.raises(TypeError):
        g.encrypt(b"n" * 12, "text", None)


def test_a_cpu_without_aes_ni_raises_on_load(monkeypatch):
    """Where the instructions are missing the library refuses to load:
    there is no slower path."""
    from types import SimpleNamespace

    from bdls_tpu_torch.ops import _build

    def supported():
        return 0

    monkeypatch.setattr(aead, "_lib", None)
    monkeypatch.setattr(_build, "host_shim", lambda *a, **kw: SimpleNamespace(
        bdls_aes_gcm_supported=supported))
    with pytest.raises(RuntimeError, match="AES-NI"):
        aead.lib()
