"""K6's two roles, built for the host with g++, in the kernel's order.

``csrc/sha256.cu`` runs a CTA for every 32 lanes: a schedule warp
(``sha::schedule_block``: a block's 16 words → its 64 K[t] + W[t]
words, written into one half of a shared ring laid out [t][lane]) and a
rounds warp (``sha::rounds_block``: the 64 rounds from the other half,
folded in while the lane has blocks left), to the group's longest
clipped count. The shim below runs the same header code in the same
order: the schedule of block i + 1 into the other half before the rounds
of block i, lane by lane, the lanes forward or reversed; the ring starts
poisoned, so a round that read a half not yet written would show.

Held, exactly, against ``hashlib``, the port's plain twin
``ops/sha256.py:sha256_words`` and the JAX package's
``bdls_tpu/ops/sha256.py:sha256_words`` on XLA:CPU:

- every message length from 0 to 1,100 bytes (the 55/56/63/64/119/120
  padding edges among them);
- a mixed batch whose 32-lane groups have different longest lanes;
- filler lanes with 0 (or a negative) block count: the IV;
- a count above NB: clipped to NB;
- B = 33: a group with one live lane.

And each role on its own: the schedule's words against FIPS 180-4's
message schedule in Python integers, the rounds' feed-forward only on a
live lane, the roles' digests against ``sha::lane_digest`` (K7's body).
The test skips, from a fixture, where g++ is absent.
"""

from __future__ import annotations

import ctypes
import hashlib
import shutil

import jax
import numpy as np
import pytest
import torch

from bdls_tpu.ops import sha256 as jsha
from bdls_tpu_torch.ops import _build
from bdls_tpu_torch.ops import sha256 as sha

torch.set_num_threads(1)

SHIM = r"""
#include <string.h>

#include "sha256.cuh"
using namespace bdls;

// K6's CTA program with one rounds warp, a group of 32 lanes at a time:
// the schedule of block 0, then for each block i the schedule of block
// i + 1 into the other half of the ring before the rounds of block i,
// each role lane by lane (reversed if rev).
extern "C" void host_sha256_roles(const uint32_t* words,
                                  const int32_t* nblocks, uint32_t* out,
                                  int NB, int B, int rev) {
  uint32_t ring[2][64][32];
  for (int base = 0; base < B; base += 32) {
    memset(ring, 0xA5, sizeof ring);
    int nb[32], most = 0;
    uint32_t st[32][8];
    for (int l = 0; l < 32; ++l) {
      nb[l] = sha::lane_blocks(nblocks, NB, base + l, B);
      most = nb[l] > most ? nb[l] : most;
      sha::init(st[l]);
    }
    auto schedule = [&](int j) {
      for (int k = 0; k < 32; ++k) {
        const int l = rev ? 31 - k : k;
        uint32_t w[16];
        sha::load_block(w, words, j, base + l, B);
        sha::schedule_block(&ring[j & 1][0][l], 32, w);
      }
    };
    if (most > 0) schedule(0);
    for (int i = 0; i < most; ++i) {
      if (i + 1 < most) schedule(i + 1);
      for (int k = 0; k < 32; ++k) {
        const int l = rev ? 31 - k : k;
        sha::rounds_block(st[l], &ring[i & 1][0][l], 32, i < nb[l]);
      }
    }
    for (int l = 0; l < 32 && base + l < B; ++l)
      for (int j = 0; j < 8; ++j) out[(size_t)j * B + base + l] = st[l][j];
  }
}

// K7's one-thread hash over the same inputs
extern "C" void host_lane_digest(const uint32_t* words,
                                 const int32_t* nblocks, uint32_t* out,
                                 int NB, int B) {
  for (int b = 0; b < B; ++b) {
    uint32_t st[8];
    sha::lane_digest(st, words, nblocks[b], NB, b, B);
    for (int j = 0; j < 8; ++j) out[(size_t)j * B + b] = st[j];
  }
}

// one lane's schedule of one block: kw[t] = K[t] + W[t]
extern "C" void host_schedule(const uint32_t* w16, uint32_t* kw) {
  uint32_t w[16];
  memcpy(w, w16, sizeof w);
  sha::schedule_block(kw, 1, w);
}

// one lane's rounds over kw[0..63] from state st, folded in if live
extern "C" void host_rounds(uint32_t* st, const uint32_t* kw, int live) {
  sha::rounds_block(st, kw, 1, live != 0);
}
"""

_jax_words = jax.jit(jsha.sha256_words)


@pytest.fixture(scope="module")
def shim():
    if shutil.which("g++") is None:
        pytest.skip("g++ not found: the host build of K6's roles is skipped")
    return _build.host_shim(SHIM, "host_sha256_roles")


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def _roles(shim, words, nblocks, rev: bool) -> np.ndarray:
    words = np.ascontiguousarray(words, np.uint32)
    nblocks = np.ascontiguousarray(nblocks, np.int32)
    B = words.shape[2]
    out = np.zeros((8, B), np.uint32)
    shim.host_sha256_roles(_ptr(words), _ptr(nblocks), _ptr(out),
                           words.shape[0], B, int(rev))
    return out


def _plain(words, nblocks) -> np.ndarray:
    out = sha.sha256_words(_build.as_int32(words), _build.as_int32(nblocks))
    return out.numpy().view(np.uint32)


def _jax(words, nblocks) -> np.ndarray:
    return np.asarray(_jax_words(words, np.asarray(nblocks, np.int32)))


def _digests(w: np.ndarray) -> list[bytes]:
    be = w.astype(">u4")
    return [be[:, i].tobytes() for i in range(w.shape[1])]


def _hold(shim, words, nblocks, rev, want_digests=None) -> np.ndarray:
    """The roles' digests, equal to the plain twin's and the JAX
    package's on the same inputs, and to ``want_digests`` where given."""
    got = _roles(shim, words, nblocks, rev)
    assert np.array_equal(got, _plain(words, nblocks))
    assert np.array_equal(got, _jax(words, nblocks))
    if want_digests is not None:
        assert _digests(got)[:len(want_digests)] == want_digests
    return got


@pytest.fixture(scope="module")
def every_length():
    rng = np.random.default_rng(151)
    msgs = [rng.bytes(n) for n in range(1101)]
    words, nblocks = sha.pad_messages(msgs)
    return msgs, words, nblocks, _plain(words, nblocks), _jax(words,
                                                               nblocks)


@pytest.mark.parametrize("rev", [False, True], ids=["forward", "reversed"])
def test_every_length_0_to_1100(shim, every_length, rev):
    msgs, words, nblocks, plain, ref = every_length
    assert words.shape[0] == sha.n_blocks(1100) == 18
    got = _roles(shim, words, nblocks, rev)
    assert np.array_equal(got, plain)
    assert np.array_equal(got, ref)
    for i, d in enumerate(_digests(got)):
        assert d == hashlib.sha256(msgs[i]).digest(), len(msgs[i])


@pytest.mark.parametrize("rev", [False, True], ids=["forward", "reversed"])
def test_groups_with_different_longest_lanes(shim, rev):
    """Six 32-lane groups: short lanes only, one 16-block lane among
    1-block lanes, fillers only, fillers among long lanes, every lane 16
    blocks, and lengths spread over 0-1015 bytes."""
    rng = np.random.default_rng(152)
    lens = ([int(v) for v in rng.integers(0, 56, 32)]
            + [1015] + [int(v) for v in rng.integers(0, 56, 31)]
            + [0] * 32
            + [int(v) for v in rng.integers(600, 1016, 32)]
            + [int(v) for v in rng.integers(952, 1016, 32)]
            + [int(v) for v in rng.integers(0, 1016, 32)])
    msgs = [rng.bytes(n) for n in lens]
    words, nblocks = sha.pad_messages(msgs, max_blocks=16)
    filler = np.zeros(len(msgs), bool)
    filler[64:96] = True
    filler[96:128:3] = True
    nblocks[filler] = 0
    most = [int(nblocks[g:g + 32].max()) for g in range(0, len(msgs), 32)]
    assert most[:3] == [1, 16, 0] and most[4] == 16
    got = _hold(shim, words, nblocks, rev)
    digests = _digests(got)
    iv = sha.H0.tolist()
    for i, m in enumerate(msgs):
        if filler[i]:
            assert got[:, i].tolist() == iv
        else:
            assert digests[i] == hashlib.sha256(m).digest(), i


def test_filler_lanes_return_the_iv(shim):
    """Counts of 0 and below: the IV, in a group of their own (the loop
    never runs) and among live lanes."""
    rng = np.random.default_rng(153)
    msgs = [rng.bytes(int(n)) for n in rng.integers(0, 300, 70)]
    words, nblocks = sha.pad_messages(msgs)
    nblocks[32:64] = 0
    nblocks[5] = -1
    nblocks[66] = -(1 << 31)
    got = _hold(shim, words, nblocks, False)
    for i in [5, 66] + list(range(32, 64)):
        assert got[:, i].tolist() == sha.H0.tolist()
    for i in (0, 64, 69):
        assert _digests(got)[i] == hashlib.sha256(msgs[i]).digest()
    none = _hold(shim, words, np.zeros_like(nblocks), True)
    assert (none.T == sha.H0).all()


def test_count_above_nb_is_clipped(shim):
    """A count above NB folds NB blocks: a 16-block message at NB 16 with
    count 99 is its hash; a lane padded to NB 20 with count 25 folds all
    20 blocks, as the plain twin and the reference do."""
    rng = np.random.default_rng(154)
    msgs = [rng.bytes(1015), rng.bytes(1000), rng.bytes(10)] + [
        rng.bytes(int(n)) for n in rng.integers(0, 1016, 37)]
    words, nblocks = sha.pad_messages(msgs, max_blocks=16)
    nblocks[0] = 99
    nblocks[1] = 1 << 30
    got = _hold(shim, words, nblocks, True,
                [hashlib.sha256(m).digest() for m in msgs[:1]])
    capped = nblocks.copy()
    capped[:2] = 16
    assert np.array_equal(got, _roles(shim, words, capped, False))
    words20, nb20 = sha.pad_messages(msgs, max_blocks=20)
    nb20[2] = 25
    got20 = _hold(shim, words20, nb20, False)
    nb20[2] = 20
    assert np.array_equal(got20, _roles(shim, words20, nb20, True))
    assert _digests(got20)[3:] == [hashlib.sha256(m).digest()
                                   for m in msgs[3:]]


@pytest.mark.parametrize("rev", [False, True], ids=["forward", "reversed"])
def test_b33_one_live_lane_in_the_last_group(shim, rev):
    rng = np.random.default_rng(155)
    msgs = [rng.bytes(int(n)) for n in rng.integers(0, 400, 32)]
    msgs.append(rng.bytes(1015))
    words, nblocks = sha.pad_messages(msgs)
    assert words.shape[2] == 33
    _hold(shim, words, nblocks, rev,
          [hashlib.sha256(m).digest() for m in msgs])


def test_roles_equal_lane_digest(shim):
    """K6's roles and K7's one-thread ``lane_digest`` agree on a batch
    with fillers and a clipped count."""
    rng = np.random.default_rng(156)
    msgs = [rng.bytes(int(n)) for n in rng.integers(0, 1016, 100)]
    words, nblocks = sha.pad_messages(msgs, max_blocks=16)
    nblocks[::7] = 0
    nblocks[3] = 40
    one = np.zeros((8, len(msgs)), np.uint32)
    shim.host_lane_digest(_ptr(words), _ptr(nblocks), _ptr(one),
                          words.shape[0], len(msgs))
    assert np.array_equal(_roles(shim, words, nblocks, False), one)


def _rotr(x: int, n: int) -> int:
    return ((x >> n) | (x << (32 - n))) & 0xFFFFFFFF


def test_schedule_block_is_k_plus_w(shim):
    """The schedule warp's words: K[t] + W[t] of FIPS 180-4 §6.2.2 step 1,
    in Python integers, for seeded blocks and the all-ones block."""
    rng = np.random.default_rng(157)
    blocks = [rng.integers(0, 1 << 32, 16, dtype=np.uint64)
              for _ in range(20)] + [np.full(16, 0xFFFFFFFF, np.uint64)]
    for blk in blocks:
        W = [int(v) for v in blk]
        for t in range(16, 64):
            s0 = _rotr(W[t - 15], 7) ^ _rotr(W[t - 15], 18) ^ (W[t - 15] >> 3)
            s1 = _rotr(W[t - 2], 17) ^ _rotr(W[t - 2], 19) ^ (W[t - 2] >> 10)
            W.append((W[t - 16] + s0 + W[t - 7] + s1) & 0xFFFFFFFF)
        want = [(int(k) + w) & 0xFFFFFFFF for k, w in zip(sha.K, W)]
        kw = np.zeros(64, np.uint32)
        shim.host_schedule(_ptr(blk.astype(np.uint32)), _ptr(kw))
        assert kw.tolist() == want


def test_rounds_block_folds_only_a_live_lane(shim):
    """One block through both roles is the hash of a one-block message;
    a lane that is not live keeps its state word for word."""
    msg = b"abc"
    words, _ = sha.pad_messages([msg])
    kw = np.zeros(64, np.uint32)
    shim.host_schedule(_ptr(np.ascontiguousarray(words[0, :, 0])), _ptr(kw))
    st = sha.H0.copy()
    shim.host_rounds(_ptr(st), _ptr(kw), 0)
    assert st.tolist() == sha.H0.tolist()
    shim.host_rounds(_ptr(st), _ptr(kw), 1)
    assert st.astype(">u4").tobytes() == hashlib.sha256(msg).digest()
