"""Batched SHA-256 — the hash stage of the block lane (K6).

The counterpart of ``bdls_tpu/ops/sha256.py``: FIPS 180-4 SHA-256 with
the batch on the minor axis, the layout of every other kernel input.

- **Padding is host work.** :func:`pad_messages` packs each lane's
  padded message into big-endian 32-bit words shaped ``(NB, 16, B)``
  (block-major, word, batch) plus a per-lane active block count
  ``(B,)``; it is bit-identical to the reference's. A lane with
  ``nblocks == 0`` (bucket filler) never compresses and returns the IV.
- **Compression** runs where the tensors lie: on a CUDA device the
  hand-written kernel ``csrc/sha256.cu`` (launched on the current stream,
  not synchronised; a build or launch error raises): a CTA of
  :data:`THREADS` threads for every 32 lanes, a schedule warp that loads
  each block's words and writes its 64 K[t] + W[t] words into a shared
  ring, and a rounds warp that runs the 64 rounds from them a block
  behind, to the CTA's longest lane; on the CPU the plain PyTorch
  version :func:`sha256_words`. Torch's ``uint32`` has no shifts, adds
  or compares on the CPU, so the plain version works in int64 with
  ``& 0xFFFFFFFF`` masks; its tensors carry the uint32 words as their
  int32 bit patterns. A block count outside ``[0, NB]`` is clipped
  to it on both.

``LAUNCHES_SHA256`` counts launches of the CUDA kernel: one per call
that launched it, and nothing else. ``ops.ecdsa.reset_launches`` clears
it with the other counts.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

from bdls_tpu_torch.ops import _build
from bdls_tpu_torch.utils.device import DeviceLike, resolve_device

LAUNCHES_SHA256 = {"sha256": 0}
# threads a CTA of K6: the schedule warp and the rounds warp of 32 lanes
THREADS = 64

_M32 = 0xFFFFFFFF

# FIPS 180-4 §4.2.2 round constants / §5.3.3 initial hash value
K = np.array([
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5,
    0x3956c25b, 0x59f111f1, 0x923f82a4, 0xab1c5ed5,
    0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
    0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174,
    0xe49b69c1, 0xefbe4786, 0x0fc19dc6, 0x240ca1cc,
    0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
    0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7,
    0xc6e00bf3, 0xd5a79147, 0x06ca6351, 0x14292967,
    0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
    0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85,
    0xa2bfe8a1, 0xa81a664b, 0xc24b8b70, 0xc76c51a3,
    0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
    0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5,
    0x391c0cb3, 0x4ed8aa4a, 0x5b9cca4f, 0x682e6ff3,
    0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
    0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2,
], dtype=np.uint32)

H0 = np.array([
    0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a,
    0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19,
], dtype=np.uint32)


# ---------------------------------------------------------- host padding

def n_blocks(msg_len: int) -> int:
    """FIPS 180-4 §5.1.1 block count for a message of ``msg_len`` bytes
    (payload + 0x80 + zero fill + 8-byte bit length)."""
    return (msg_len + 8) // 64 + 1


def pad_messages(msgs, max_blocks: int | None = None,
                 ) -> tuple[np.ndarray, np.ndarray]:
    """Pad a batch of raw messages into kernel inputs.

    Returns ``(words, nblocks)``: ``words`` is ``(NB, 16, B)`` uint32,
    big-endian 32-bit words per 512-bit block, block-major; ``nblocks``
    the per-lane ``(B,)`` int32 active block count. ``max_blocks`` pads
    the block axis up to a fixed shape (a bucket) and raises if a
    message needs more."""
    B = len(msgs)
    nblocks = np.array([n_blocks(len(m)) for m in msgs], dtype=np.int32)
    nb = int(nblocks.max()) if B else 1
    if max_blocks is not None:
        if max_blocks < nb:
            raise ValueError(f"max_blocks {max_blocks} < required {nb}")
        nb = int(max_blocks)
    buf = np.zeros((max(B, 1), nb * 64), dtype=np.uint8)
    for i, m in enumerate(msgs):
        L = len(m)
        buf[i, :L] = np.frombuffer(m, dtype=np.uint8)
        buf[i, L] = 0x80
        end = int(nblocks[i]) * 64
        buf[i, end - 8:end] = np.frombuffer(
            struct.pack(">Q", L * 8), dtype=np.uint8)
    by = buf.reshape(max(B, 1), nb, 16, 4).astype(np.uint32)
    w = (by[..., 0] << 24) | (by[..., 1] << 16) | (by[..., 2] << 8) \
        | by[..., 3]
    return np.ascontiguousarray(w.transpose(1, 2, 0)), nblocks


def _to_int32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> their int32 bit patterns."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


# ---------------------------------------------------------- plain version

def _rotr(x: torch.Tensor, n: int) -> torch.Tensor:
    return ((x >> n) | (x << (32 - n))) & _M32


def _compress(state: list, block: torch.Tensor) -> list:
    """One FIPS 180-4 §6.2.2 compression: ``state`` eight (B,) int64
    words, ``block`` (16, B) int64 big-endian words. The schedule is a
    rolling 16-word window, as in the reference and the kernel."""
    a, b, c, d, e, f, g, h = state
    w = list(block)
    for t in range(64):
        s1 = _rotr(e, 6) ^ _rotr(e, 11) ^ _rotr(e, 25)
        ch = (e & f) ^ (~e & g)
        t1 = (h + s1 + ch + int(K[t]) + w[0]) & _M32
        s0 = _rotr(a, 2) ^ _rotr(a, 13) ^ _rotr(a, 22)
        maj = (a & b) ^ (a & c) ^ (b & c)
        t2 = s0 + maj
        # W[t+16] = σ1(W[t+14]) + W[t+9] + σ0(W[t+1]) + W[t]
        sig0 = _rotr(w[1], 7) ^ _rotr(w[1], 18) ^ (w[1] >> 3)
        sig1 = _rotr(w[14], 17) ^ _rotr(w[14], 19) ^ (w[14] >> 10)
        w = w[1:] + [(sig1 + w[9] + sig0 + w[0]) & _M32]
        h, g, f, e, d, c, b, a = g, f, e, (d + t1) & _M32, c, b, a, \
            (t1 + t2) & _M32
    return [(s + v) & _M32 for s, v in zip(state, (a, b, c, d, e, f, g, h))]


def sha256_words(words, nblocks) -> torch.Tensor:
    """The plain hash: ``words`` (NB, 16, B) padded blocks (uint32 bit
    patterns in any integer tensor), ``nblocks`` (B,) active counts.
    Returns the digest as (8, B) int32 big-endian words (uint32 bit
    patterns). A lane stops folding once its block count is spent."""
    w64 = words.to(torch.int64) & _M32
    nbl = nblocks.to(torch.int64)
    B = w64.shape[2]
    state = [torch.full((B,), int(v), dtype=torch.int64, device=w64.device)
             for v in H0]
    for i in range(w64.shape[0]):
        nxt = _compress(state, w64[i])
        active = i < nbl
        state = [torch.where(active, n, s) for n, s in zip(nxt, state)]
    return _to_int32(torch.stack(state))


def words_to_e16(w: torch.Tensor) -> torch.Tensor:
    """Digest words (8, B) -> the (16, B) 16-bit-limb layout every
    verify kernel takes (limb 0 = least significant 16 bits of the
    digest as a 256-bit integer; word 0 is the most significant word).
    Returns int32."""
    w64 = w.to(torch.int64) & _M32
    rows = [None] * 16
    for j in range(8):
        rows[2 * (7 - j)] = w64[j] & 0xFFFF
        rows[2 * (7 - j) + 1] = w64[j] >> 16
    return torch.stack(rows).to(torch.int32)


# ------------------------------------------------------------ the kernel

def sha256_cuda(words: torch.Tensor, nblocks: torch.Tensor) -> torch.Tensor:
    """Launch K6 over ``words`` (NB, 16, B) and ``nblocks`` (B,), both
    contiguous int32 on one CUDA device; returns the (8, B) int32 digest
    words (not yet synchronised)."""
    dev = words.device
    if (words.dtype != torch.int32 or words.dim() != 3
            or words.shape[1] != 16 or not words.is_contiguous()):
        raise ValueError("sha256_cuda takes contiguous (NB, 16, B) int32 "
                         "words on a CUDA device")
    NB, _, B = words.shape
    if (nblocks.device != dev or nblocks.dtype != torch.int32
            or nblocks.shape != (B,) or not nblocks.is_contiguous()):
        raise ValueError("nblocks must be a contiguous (B,) int32 tensor "
                         "on the words' device")
    out = torch.empty((8, B), dtype=torch.int32, device=dev)
    lib = _build.lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.bdls_sha256(words.data_ptr(), nblocks.data_ptr(),
                             out.data_ptr(), NB, B, THREADS, stream)
    _build.check(rc, f"bdls_sha256(NB={NB}, B={B})")
    with _build.count_lock:
        LAUNCHES_SHA256["sha256"] += 1
    return out


def launch_sha256(words, nblocks, *, device: DeviceLike = None
                  ) -> torch.Tensor:
    """Start one hash over :func:`pad_messages` output (numpy or
    tensors) on ``device`` (default ``cuda``): K6 on the card, the
    plain version on the CPU. Returns the (8, B) int32 digest words; on
    the card not yet synchronised."""
    dev = resolve_device(device)
    w, nb = _build.as_int32(words, dev), _build.as_int32(nblocks, dev)
    if dev.type == "cuda":
        return sha256_cuda(w, nb)
    return sha256_words(w, nb)


def sha256_batch(msgs, *, device: DeviceLike = None,
                 max_blocks: int | None = None) -> list[bytes]:
    """Synchronous batch hash: pad, launch, read back. One 32-byte
    digest per message."""
    if not msgs:
        return []
    words, nblocks = pad_messages(msgs, max_blocks=max_blocks)
    w = launch_sha256(words, nblocks, device=device).cpu().numpy()
    w = w.view(np.uint32).astype(">u4")
    return [w[:, i].tobytes() for i in range(len(msgs))]
