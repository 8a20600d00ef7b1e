"""The port's SHA-256 stage vs the JAX package and hashlib, on the CPU.

- ``n_blocks`` and ``pad_messages`` are bit-identical to the reference's
  (words, block counts, dtypes, the ``max_blocks`` padding and its
  error);
- the plain ``sha256_words`` equals the reference's ``sha256_words``
  program on XLA:CPU and ``hashlib``: the FIPS 180-4 vectors, every
  length from 0 to 200 bytes and 1015, and a mixed-length batch with
  zero-block filler lanes (which return the IV);
- ``words_to_e16`` equals the reference's, and puts digest word j in
  limbs 2·(7 - j) and 2·(7 - j) + 1;
- ``sha256_batch`` on the CPU equals ``hashlib``.

Digests are integers: every comparison is exact.
"""

from __future__ import annotations

import hashlib

import numpy as np
import pytest
import torch

from bdls_tpu.ops import sha256 as jsha
from bdls_tpu_torch.ops import sha256 as sha
from bdls_tpu_torch.ops._build import as_int32

torch.set_num_threads(1)

FIPS_VECTORS = [
    (b"", "e3b0c44298fc1c149afbf4c8996fb92427ae41e4649b934ca495991b7852b855"),
    (b"abc",
     "ba7816bf8f01cfea414140de5dae2223b00361a396177a9cb410ff61f20015ad"),
    (b"abcdbcdecdefdefgefghfghighijhijkijkljklmklmnlmnomnopnopq",
     "248d6a61d20638b8e5c026930c3e6039a33ce45964ff2167f6ecedd419db06c1"),
    (b"abcdefghbcdefghicdefghijdefghijkefghijklfghijklmghijklmn"
     b"hijklmnoijklmnopjklmnopqklmnopqrlmnopqrsmnopqrstnopqrstu",
     "cf5b16a778af8380036ce59e7b0492370b249b11e8f07a51afac45037afee9d1"),
]


def _msgs(lengths, seed):
    rng = np.random.default_rng(seed)
    return [rng.bytes(int(n)) for n in lengths]


def _plain(words, nblocks) -> np.ndarray:
    out = sha.sha256_words(as_int32(words), as_int32(nblocks))
    return out.numpy().view(np.uint32)


def _jax(words, nblocks) -> np.ndarray:
    return np.asarray(jsha.launch_sha256(words, nblocks))


def _digests(w: np.ndarray) -> list[bytes]:
    be = w.astype(">u4")
    return [be[:, i].tobytes() for i in range(w.shape[1])]


def test_constants_match_reference():
    assert np.array_equal(sha.K, jsha._K_HOST)
    assert np.array_equal(sha.H0, jsha._H0_HOST)


@pytest.mark.parametrize("max_blocks", [None, 20])
def test_pad_messages_bit_identical(max_blocks):
    lengths = list(range(0, 201)) + [1015]
    msgs = _msgs(lengths, 1)
    for n in lengths:
        assert sha.n_blocks(n) == jsha.n_blocks(n)
    got = sha.pad_messages(msgs, max_blocks=max_blocks)
    want = jsha.pad_messages(msgs, max_blocks=max_blocks)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert np.array_equal(g, w)
    for mod in (sha, jsha):
        with pytest.raises(ValueError, match="max_blocks"):
            mod.pad_messages(msgs, max_blocks=15)


def test_fips_vectors():
    words, nblocks = sha.pad_messages([m for m, _ in FIPS_VECTORS])
    got = _digests(_plain(words, nblocks))
    assert [d.hex() for d in got] == [h for _, h in FIPS_VECTORS]
    assert np.array_equal(_plain(words, nblocks), _jax(words, nblocks))


def test_every_length_matches_jax_and_hashlib():
    msgs = _msgs(list(range(0, 201)) + [1015], 2)
    words, nblocks = sha.pad_messages(msgs)
    plain = _plain(words, nblocks)
    assert np.array_equal(plain, _jax(words, nblocks))
    assert _digests(plain) == [hashlib.sha256(m).digest() for m in msgs]


def test_mixed_batch_with_filler_lanes():
    msgs = _msgs([0, 3, 55, 56, 119, 120, 700, 1015], 3) + [b"", b""]
    words, nblocks = sha.pad_messages(msgs, max_blocks=16)
    nblocks[-2:] = 0                         # bucket filler lanes
    plain = _plain(words, nblocks)
    assert np.array_equal(plain, _jax(words, nblocks))
    assert _digests(plain)[:-2] == [hashlib.sha256(m).digest()
                                    for m in msgs[:-2]]
    assert plain[:, -1].tolist() == plain[:, -2].tolist() == \
        sha.H0.tolist()


def test_words_to_e16_matches_reference():
    rng = np.random.default_rng(4)
    w = rng.integers(0, 1 << 32, size=(8, 24), dtype=np.uint64) \
        .astype(np.uint32)
    w[:, 0] = 0xFFFFFFFF
    w[:, 1] = np.arange(8, dtype=np.uint32) + 1
    got = sha.words_to_e16(as_int32(w)).numpy()
    want = np.asarray(jsha.words_to_e16(w))
    assert np.array_equal(got.view(np.uint32), want)
    # word j is limbs 2·(7 - j) (low half) and 2·(7 - j) + 1
    for j in range(8):
        assert got[2 * (7 - j), 1] == j + 1 and got[2 * (7 - j) + 1, 1] == 0
    # the limbs read back as the digest, a big-endian 256-bit integer
    for b in range(w.shape[1]):
        val = sum(int(got[k, b]) << (16 * k) for k in range(16))
        assert val.to_bytes(32, "big") == _digests(w)[b]


def test_sha256_batch_on_the_cpu():
    msgs = [m for m, _ in FIPS_VECTORS] + _msgs([63, 64, 65, 1015], 5)
    assert sha.sha256_batch(msgs, device="cpu") == \
        [hashlib.sha256(m).digest() for m in msgs]
    assert sha.sha256_batch([], device="cpu") == []
