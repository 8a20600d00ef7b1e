"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (an H100).

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):

1. the card: ``nvidia-smi`` name and power limit, torch and CUDA versions,
   device count; no CUDA device is a failure;
2. build the kernels of ``bdls_tpu_torch/csrc`` (``verify.cu``, the
   generic verify K1, whose captured graphs are K3; ``pinned.cu``, the
   pinned-key verify K2; ``sha256.cu``, the SHA-256 K6; ``block.cu``,
   the fused block program K7; ``ed25519.cu``, the Ed25519 verify K8;
   ``bls.cu``, the BLS12-381 certificate check K9; ``mont16.cu``, the
   gen-1 verify K4; and the mxu builds of ``verify.cu``, ``pinned.cu``,
   ``block.cu`` and ``ed25519.cu`` with ``-DBDLS_MUL_MXU``, whose
   products are K5's, ``csrc/mxu.cuh``) with nvcc for sm_90a, one
   compiler per build side by side, and print the build time and each
   kernel's ``-Xptxas -v`` registers, stack frame and spills;
3. per curve, at the bucket the main path launches (128 lanes for
   secp256k1, 2048 for P-256), the K1 kernel against the plain PyTorch
   version on the same card, lane for lane, and against the port's
   pure-Python ECDSA: valid, tampered and hostile lanes, filled up with
   the main path's own signatures (the forged votes and tampered
   endorsements included);
4. the same for K2 against its plain version, over a pool on the card:
   128 pinned consenter keys (secp256k1, 128 lanes) and 16 pinned
   endorser keys (P-256, 2048 lanes), with tampered digest, r and s,
   r or s out of [1, n), a lane under another key's slot, a u2 with a
   negative GLV half and the forged r + n lane mixed in;
4b. K6 against hashlib and its plain version at 2048 lanes (the block
   lane's preimages, the padding boundaries, zero-block filler lanes),
   exactly; K7 against its plain version, lane for lane and tx for tx,
   on a hostile 1000-tx P-256 block at the main shape (L 2048, T 2048,
   NB 16, O 4) and a hostile 50-tx secp256k1 block (L 128): tampered,
   high-S and overlong lanes, r and s out of range, a key off the curve,
   under-endorsed txs, the sentinel policy, one org endorsing twice;
3c. K8 against its plain twin and the RFC 8032 oracle at 128 and 2048
   lanes: the §7.1 vectors, seeded valid lanes, tampered message / R /
   S / key, S = L - 1, L, S + L and 2^256 - 1, A off the curve or out of
   range, non-canonical R, R with x = 0 and the sign bit set, an R that
   does not decompress, the identity as A and R, small-order A and
   torsion in A and R, filled up with the main path's votes;
3d. K9 (its Miller launch and its final launch) against its plain twin
   on the card, stage for stage ((n, d), both final exponentiations,
   the verdicts), and against the oracle's verdicts, on 9 lanes: valid
   certificates of the 128- and 1024-validator committees, a wrong
   binding, no signature, under quorum, a signer out of range (the last
   three masked by ``certificate_lanes``), the degenerate y = 0
   "signature" and an all-zero lane fed to the kernel directly;
3e. K4 against its plain twin (``ops/ecdsa.py:verify_kernel``) on the
   card and the integer ECDSA, lane for lane, on phase 3's batches (128
   secp256k1 lanes in two blocks, 2048 P-256 lanes in 32; the hostile
   set with s = n among them);
3f. K5's product (``bdls_field_mul`` of the mxu build) against the CIOS
   product of the vpu build and Python integers, bit for bit, on P-256 p
   and n, secp256k1 p and n and 2^255 - 19, at edge values and 4096
   seeded pairs each; then the mxu builds of K1, K2, K7 and K8 against
   their vpu kernels and their plain twins under the "mxu" engine, lane
   for lane (and tx for tx), on the inputs of phases 3, 4, 4b and 3c;
5. the K1 main path through ``TorchCSP(device="cuda", key_cache_size=0,
   use_cpu_fallback=False, latency_max_lanes=0)`` (the latency tier
   off; phase 6d drives it): one 128-validator secp256k1 vote round
   (``submit`` + ``flush``, two forged votes) and one 1000-tx x
   2-endorsement P-256 batch (``verify_batch``, 2000 lanes, a few
   tampered); exact verdicts, no fallback, and launch counts (set to 0
   just before, read just after): one launch per curve;
6. the K2 main path through ``TorchCSP(device="cuda")`` (the key cache
   on, as by default): the consensus seam ``CspBatchVerifier`` with 128
   consenters pinned verifies 128 envelopes (2 forged, 1 from a key
   outside the set): K2 for 127 lanes and K1 for the new key, one launch
   each; after the background build, a second round all K2;
   ``TorchBatchVerifier`` gives the same verdicts; then a 2000-lane
   P-256 block from 16 pinned endorsers in one K2 launch, no fallback;
6b. the block lane: the 1000-tx x 2-endorsement P-256 block (4 orgs,
   preimages of 200-1000 bytes) through ``TorchCSP(device="cuda")
   .verify_block`` with the default key cache: exactly one K7 launch and
   no other, no fallback, one block counted, the host oracle's flags;
   the secp256k1 block through the same entry (one K7 launch); the
   block's preimages through ``sha256_batch`` (one K6 launch);
6c. the Ed25519 vote path: a 128-validator committee's 85-vote quorum
   and a 1024-validator committee's 683-vote quorum (a few forged)
   through ``TorchCSP(device="cuda")`` ``submit`` + ``flush``: exact
   verdicts, one K8 launch a round, no K1, K2 or K3 launch, no fallback;
6d. K3 at full width: a 128-validator secp256k1 committee on
   ``TorchCSP(device="cuda", key_cache_size=0)`` after ``warmup``
   captured the latency buckets; ``CspBatchVerifier`` sets the quorum
   hint to 85; 85 ``submit`` calls (2 forged) at the reference's flush
   interval (2 ms) go out as one speculative flush, launched inside the
   interval, through exactly one K3 replay, no eager K1 launch, no cold
   fallback; once with the vote
   buckets off (bucket 128), once with ``VOTE_BUCKETS`` (bucket 85);
   then the ring repro: 21 requests at ``buckets=(8,)``, three runs,
   the same right verdicts;
6e. the certificate lane: ``TorchCSP(device="cuda").verify_certificates``
   with 2 certificates a call for committees of 128 (quorum 85) and 1024
   (quorum 683) validators, warmed as ``tools/tpu_ablate.py:cert_sweep``
   warms them, then counted: the verdicts of construction, one launch of
   each K9 kernel and no other, the host backend unused; 9 calls a
   committee by the host clock beside the oracle's time; a cross-round
   batch of 64 certificates (2 forged) in one launch pair;
5b. the main path under ``kernel_field="mont16"``: the 128-vote
   secp256k1 round (a counted cold fallback, then exactly one K4
   launch), the 2000-lane P-256 batch (one K4 launch), the vote round
   through ``CspBatchVerifier`` with 128 consenters pinned (K2 for 127
   lanes, K4 for the new key), the pinned block batch (one K2 launch) and
   ``verify_block`` (one K7 launch); no other kernel;
5c. the same under ``kernel_field="mxu"``, where only mxu builds may
   run: the vote round as one K3 replay over K1 + K5, the batch one
   K1 + K5 launch, the pinned lanes K2 + K5, ``verify_block`` one K7 + K5
   launch a block (the 1000-tx P-256 block and the 50-tx secp256k1 one),
   and an 85-vote Ed25519 round, one K8 + K5 launch;
7. timing with CUDA events after warm-up: each kernel's ms and
   verifies/s at buckets 128, 2048 and 8192 (the batches of phases 3 and
   4, tiled, verdicts checked; K2 also against its plain version at 128
   and 2048 for both curves), the provider's end-to-end verifies/s at
   8192, the vote round through the seam with the key cache on and off,
   the pinned block batch, and the plain versions' times, with each
   kernel's bound (:func:`needed_muls`, :func:`needed_muls_pinned`);
   K6 and K7 at the main shape and K7 on secp256k1, with their plain
   twins and bounds (:func:`sha_bound_ms`, :func:`block_bound_ms`), and
   9 ``verify_block`` calls against 9 lane-at-a-time calls (hashlib plus
   K1), in turns; a K3 replay against an eager K1 launch at buckets 85,
   128 and 171, and the quorum's submit-to-verdict median of 9 rounds
   with the latency tier on and off, in turns; K8 at 128, 2048 and 8192
   lanes with its bound (:func:`needed_muls_ed25519`); K9's two
   launches at 1, 2, 16 and 128 certificates with their bounds
   (:func:`k9_bound_ms`); 7f: K4 and the mxu builds of K1, K2 and K8 at
   128, 2048 and 8192 lanes, K7 + K5 at the main block shape, each with
   the bound of the function it computes, and K5's product alone (65,536
   products) beside the CIOS build, its plain twin and one float64
   ``torch.matmul`` of the plain twin's contraction;
8. one ``{"kernels": [...]}`` line, the card line, and as the last line
   ``{"ok": true, "device": {...}}``.

Everything is made from fixed seeds. Results also go to
``build/chip_smoke.json``.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 20261017
BUCKETS = (128, 2048, 8192)
PEAK_BYTES_PER_S = 3.35e12       # H100 SXM HBM3 (NVIDIA data sheet)
SMS = 132
# 32-bit integer multiply (and multiply-add) results per clock per SM,
# compute capability 9.0 (CUDA C++ Programming Guide, arithmetic
# instruction throughput table)
IMUL_PER_CLK_PER_SM = 64
# 32-bit multiply instructions; a widening 32x32->64 product counts as
# two (low and high halves)
MUL = 2 * 64                     # 256 x 256-bit schoolbook product
SQR = 2 * 36                     # 256-bit square: 28 cross products + 8
RED_P = {"P-256": 0,             # Solinas reduction: additions only
         # p = 2^256 - 2^32 - 977: high half times 977, then the carry
         "secp256k1": 2 * 8 + 2}
RED_N = 2 * 64 + 8               # Montgomery reduction mod the order n
# one 8x32-bit CIOS Montgomery product as the kernel does it: 8 rounds
# of 8 widening a·b products, one q = t0·n0 and 8 widening q·m products
MUL32_PER_MONT = 8 * (8 * 2 + 1 + 8 * 2)
LIMB_BYTES_PER_LANE = 5 * 16 * 4   # five (16, B) int32 arrays
G_TABLE_BYTES = 256 * 3 * 8 * 4
MAIN_BUCKET = {"secp256k1": 128, "P-256": 2048}
# bytes of one pinned lane's inputs and output: r, s, e as (16, B)
# int32, the int32 slot, one verdict byte
PINNED_LANE_BYTES = 3 * 16 * 4 + 4 + 1
ENTRY_BYTES = 2 * 8 * 4          # an affine table entry: x and y


def log(*a):
    print(*a, flush=True)


def smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def mont_muls_per_verify(curve) -> int:
    """Montgomery products one lane of csrc/verify.cuh performs (the
    kernel's own work, dead first ladder step included)."""
    dbl, add = (9, 14) if curve.a_kind == "zero" else (13, 14)
    fermat = 256 + bin(curve.fn.modulus - 2).count("1")
    return (1 + fermat + 2            # s to Montgomery, s^-1, u1, u2
            + 2 + 3                   # Q to Montgomery, on-curve check
            + dbl + 6 * add           # [2..8]·Q table
            + 33 * (8 * dbl + 3 * add)  # the dual ladder
            + 4)                      # X == r·Z and X == (r + n)·Z


def needed_muls(curve, lanes) -> float:
    """32-bit multiplies that verifying ``lanes`` in one launch needs, at
    the least work known for the function, not this kernel's choices:

    - Jacobian formulas of the Explicit-Formulas Database (dbl-2001-b for
      a = -3, dbl-2009-l for a = 0, add-2007-bl, madd-2007-bl with the G
      table affine): no multiply by b;
    - special-form reduction mod p, Montgomery mod n;
    - one Fermat inverse per launch and 3 products a lane (the batch
      inverse of s, as the reference's ``fold.batch_inv`` does);
    - P-256: 64 signed 4-bit windows of u2 (256 doublings) and 32 bytes
      of u1; secp256k1: the reference's GLV ladder (``dual_ladder_glv``),
      two 132-bit halves (132 doublings, 66 windows, a psi(Q) table) and
      32 positioned G bytes that are never doubled;
    - a zero window or byte needs no add: 1/16 of windows and 1/256 of
      bytes, the rate for uniform scalars;
    - a lane outside [1, n) or off the curve needs no ladder; the
      r + n product only where r + n < p.
    """
    name, p, n = curve.name, curve.fp.modulus, curve.fn.modulus
    mp, sp = MUL + RED_P[name], SQR + RED_P[name]
    mn, sn = MUL + RED_N, SQR + RED_N
    dbl = (3 if name == "P-256" else 2) * mp + 5 * sp
    add = 11 * mp + 5 * sp
    madd = 7 * mp + 4 * sp
    table = dbl + 6 * add                   # [2..8]·Q
    if name == "P-256":
        ladder = 256 * dbl + 64 * 15 / 16 * add + 32 * 255 / 256 * madd
    else:
        ladder = (2 * MUL + 4 * 2 * 16      # GLV split of u2
                  + 8 * mp                  # psi(Q) table: beta·X
                  + 132 * dbl + 66 * 15 / 16 * add
                  + 32 * 255 / 256 * madd + add)
    per_lane = 5 * mn + table + ladder + sp + mp   # ... X == r·Z^2
    total = (bin(n - 2).count("1") - 1) * mn + 255 * sn
    for qx, qy, r, s, _, _ in lanes:
        if not (qx < p and qy < p and (qx, qy) != (0, 0)
                and 0 < r < n and 0 < s < n):
            continue
        total += 2 * sp + mp                # y^2 == x^3 + a·x + b
        if (qy * qy - qx ** 3 - curve.a * qx - curve.b) % p:
            continue
        total += per_lane + (mp if r + n < p else 0)
    return total


def _pinned_work(curve, r, s, e):
    """Nonzero table entries one pinned lane adds: (Q entries as
    (half, position, digit) keys, G bytes as (position, byte) keys)."""
    from bdls_tpu_torch.ops import glv

    n = curve.fn.modulus
    w = pow(s, -1, n)
    u1, u2 = e * w % n, r * w % n
    g = [(j, (u1 >> (8 * j)) & 0xFF) for j in range(32)
         if (u1 >> (8 * j)) & 0xFF]
    if curve.name == "secp256k1":
        halves, nd = [abs(k) for k in glv.decompose_host(u2)], 33
    else:
        halves, nd = [u2], 64
    q = []
    for h, k in enumerate(halves):
        wd = k + sum(8 << (4 * i) for i in range(nd))
        for i in range(nd + 1):
            nib = (wd >> (4 * i)) & 0xF
            mag = abs(nib - 8) if i < nd else nib
            if mag:
                q.append((h, i, mag))
    return q, g


def needed_muls_pinned(curve, lanes) -> float:
    """32-bit multiplies that verifying ``lanes`` through pinned tables
    in one launch needs, at the least work known, not this kernel's
    choices: no doublings; one mixed addition (madd-2007-bl) per nonzero
    Q entry (at most 68 on secp256k1, 66 on P-256) and per nonzero byte
    of u1 (32 positioned G tables), all entries affine, the first entry
    loaded for free; the GLV split of u2 on secp256k1; one Fermat
    inverse per launch and 3 products a lane (the batch inverse of s),
    u1 and u2; X == r·Z, and (r + n)·Z where r + n < p. Lanes outside
    [1, n) need no ladder. The digits are counted from these lanes'
    scalars. ``lanes`` are (r, s, e) ints."""
    name, p, n = curve.name, curve.fp.modulus, curve.fn.modulus
    mp, sp = MUL + RED_P[name], SQR + RED_P[name]
    mn = MUL + RED_N
    madd = 7 * mp + 4 * sp
    split = 2 * MUL + 4 * 2 * 16 if name == "secp256k1" else 0
    total = (bin(n - 2).count("1") - 1) * mn + 255 * (SQR + RED_N)
    memo = {}
    for r, s, e in lanes:
        if not (0 < r < n and 0 < s < n):
            continue
        if (r, s, e) not in memo:
            q, g = _pinned_work(curve, r, s, e)
            adds = max(len(q) + len(g) - 1, 0)
            memo[r, s, e] = (5 * mn + split + adds * madd + mp
                             + (mp if r + n < p else 0))
        total += memo[r, s, e]
    return total


def pinned_bound_ms(curve, lanes, slots,
                    sm_clock_hz: float) -> tuple[float, str]:
    """The pinned kernel's bound: the larger of the multiplies over the
    card's multiply rate and the bytes over its memory rate. Bytes: each
    lane's inputs and verdict, and each table entry the batch needs,
    read once."""
    t_ops = needed_muls_pinned(curve, lanes) / (
        SMS * IMUL_PER_CLK_PER_SM * sm_clock_hz)
    entries = set()
    for (r, s, e), slot in set(zip(lanes, slots)):
        n = curve.fn.modulus
        if 0 < r < n and 0 < s < n:
            q, g = _pinned_work(curve, r, s, e)
            entries.update((slot,) + k for k in q)
            entries.update(g)
    t_bytes = (PINNED_LANE_BYTES * len(lanes)
               + ENTRY_BYTES * len(entries)) / PEAK_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def pinned_kernel_muls(curve) -> int:
    """32-bit multiplies one lane of csrc/pinned.cuh issues: a Fermat
    inverse, u1, u2, 102 (secp256k1) or 98 (P-256) complete additions,
    the final checks."""
    add, nadd = (12, 102) if curve.a_kind == "zero" else (14, 98)
    fermat = 256 + bin(curve.fn.modulus - 2).count("1")
    split = (2 * 64 * 2 + 2 * 20 * 2) if curve.a_kind == "zero" else 0
    return ((1 + fermat + 2 + nadd * add + 4) * MUL32_PER_MONT + split)


def bound_ms(curve, lanes, sm_clock_hz: float) -> tuple[float, str]:
    t_ops = needed_muls(curve, lanes) / (
        SMS * IMUL_PER_CLK_PER_SM * sm_clock_hz)
    t_bytes = (LIMB_BYTES_PER_LANE * len(lanes) + len(lanes)
               + G_TABLE_BYTES) / PEAK_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def cuda_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def make_pinned_inputs(sw, rng) -> dict:
    """The K2 main path's inputs: 128 consenter keys and 128 envelopes
    of one vote round (127 consenters vote, 2 of them forged, and one
    key outside the set), and a 1000-tx x 2-endorsement block from 16
    endorsers (a few tampered)."""
    from bdls_tpu_torch.consensus.identity import identity_of_key, \
        sign_payload
    from bdls_tpu_torch.crypto.csp import VerifyRequest

    consenters = [sw.key_gen("secp256k1", rng) for _ in range(128)]
    outsider = sw.key_gen("secp256k1", rng)
    envs, env_ok = [], []
    for v, key in enumerate(consenters[:127]):
        env = sign_payload(key, b"<lock> height 42 round 7 from %d" % v)
        forged = v % 61 == 7
        if forged:
            env.payload += b" (forged)"
        envs.append(env)
        env_ok.append(not forged)
    envs.append(sign_payload(outsider, b"<lock> height 42 round 7"))
    env_ok.append(True)
    endorsers = [sw.key_gen("P-256", rng) for _ in range(16)]
    block, block_ok = [], []
    for tx in range(1000):
        digest = sw.hash(b"tx-%d" % tx + rng.bytes(16))
        for j in range(2):
            key = endorsers[(2 * tx + j) % len(endorsers)]
            r, s = sw.sign(key, digest)
            tampered = tx % 97 == 5 and j == 1
            d = sw.hash(b"forged") if tampered else digest
            block.append(VerifyRequest(key.public_key(), d, r, s))
            block_ok.append(not tampered)
    return {"idents": [identity_of_key(k) for k in consenters],
            "outsider": outsider.public_key(), "envs": envs,
            "env_ok": env_ok,
            "endorsers": [k.public_key() for k in endorsers],
            "block": block, "block_ok": block_ok}


def _envelope_lane(env) -> tuple:
    from bdls_tpu_torch.consensus.identity import envelope_digest

    d = envelope_digest(env.version, env.pub_x, env.pub_y, env.payload)
    return (int.from_bytes(env.pub_x, "big"), int.from_bytes(env.pub_y, "big"),
            int.from_bytes(env.sig_r, "big"), int.from_bytes(env.sig_s, "big"),
            d, "main path")


def _pinned_args(lanes, slots, dev):
    from bdls_tpu_torch.crypto import vectors
    from bdls_tpu_torch.crypto.marshal import ints_to_limbs

    cols = vectors.columns(lanes)[2:]
    args = [torch.from_numpy(ints_to_limbs(c).view(np.int32)).to(dev)
            for c in cols]
    return args + [torch.tensor(slots, dtype=torch.int32, device=dev)]


def check_pinned_kernel(pin, rng, dev) -> dict:
    """Phase 4: per curve, K2 on the card against its plain version on
    the same inputs, lane for lane, and against the integer ECDSA."""
    from bdls_tpu_torch.crypto import vectors
    from bdls_tpu_torch.crypto.csp import PublicKey
    from bdls_tpu_torch.crypto.key_cache import KeyTableCache
    from bdls_tpu_torch.ops import ecdsa, glv
    from bdls_tpu_torch.ops.curves import CURVES
    from bdls_tpu_torch.ops.verify_fold import build_pinned_tables, \
        verify_fold_pinned

    def pinnable(curve, lane):
        try:
            build_pinned_tables(curve, lane[0], lane[1])
            return True
        except ValueError:
            return False

    from bdls_tpu_torch.consensus.verifier import identity_keys

    # the main path's requests and its whole key set, pinned
    fills = {
        "secp256k1": ([_envelope_lane(e) for e in pin["envs"][:127]],
                      pin["env_ok"][:127], identity_keys(pin["idents"])),
        "P-256": ([(q.key.x, q.key.y, q.r, q.s, q.digest, "main path")
                   for q in pin["block"]], pin["block_ok"], pin["endorsers"]),
    }
    out = {}
    for curve_name, cv in CURVES.items():
        n = cv.fn.modulus
        mixed = [ln for ln in vectors.mixed_lanes(curve_name, rng)
                 if pinnable(curve_name, ln)]
        valid = next(ln for ln in mixed if ln[5] == "valid")
        other = next(ln for ln in mixed if ln[:2] != valid[:2])
        reqs, oks, key_set = fills[curve_name]
        k = MAIN_BUCKET[curve_name] - len(mixed) - 1
        idx = [i % len(reqs) for i in range(k)]
        lanes = mixed + [valid[:5] + ("under another key's slot",)] + [
            reqs[i] for i in idx]
        want = (vectors.expected(curve_name, mixed) + [False]
                + [oks[i] for i in idx])
        cache = KeyTableCache(256, device=dev)
        keys = [PublicKey(curve_name, ln[0], ln[1]) for ln in lanes]
        cache.warm(list(dict.fromkeys(key_set + keys)), wait=True)
        slots, pools = cache.lookup_batch(curve_name, keys)
        slots[len(mixed)] = cache.lookup_batch(
            curve_name, [PublicKey(curve_name, *other[:2])])[0][0]
        args = _pinned_args(lanes, slots, dev)
        kern = ecdsa.verify_pinned_cuda(cv, *args, pools).cpu().numpy()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plain = verify_fold_pinned(cv, *args, pools).cpu().numpy()
        plain_ms = (time.perf_counter() - t0) * 1e3
        diff = np.abs(kern.astype(np.int64) - plain.astype(np.int64))
        bad = [lanes[i][5] for i in np.flatnonzero(diff)]
        log(f"{curve_name}: K2 vs plain on {len(lanes)} lanes "
            f"({len(mixed) + 1} mixed, {len(cache)} keys pinned): "
            f"{int(diff.sum())} differ {bad}; valid {int(kern.sum())}; "
            f"plain {plain_ms:.0f} ms")
        if diff.any():
            raise SystemExit(f"{curve_name}: K2 disagrees with plain")
        if not np.array_equal(kern, np.array(want)):
            raise SystemExit(f"{curve_name}: K2 disagrees with SwCSP")
        if curve_name == "secp256k1" and not any(
                min(glv.decompose_host(ln[2] * pow(ln[3], -1, n) % n)) < 0
                for ln, ok in zip(lanes, want) if ok):
            raise SystemExit("no valid lane has a negative GLV half")
        out[curve_name] = {
            "lanes": lanes, "slots": slots, "want": np.array(want),
            "pools": pools, "cache": cache, "keys": len(cache),
            "max_abs_err": int(diff.max()), "plain_ms": plain_ms}
    return out


def drive_pinned_main_path(pin):
    """Phase 6: the consensus vote round through CspBatchVerifier over
    TorchCSP with its key cache, twice, then the pinned block batch.
    Counts are set to 0 just before each run and read just after."""
    from bdls_tpu_torch.consensus.verifier import CspBatchVerifier, \
        TorchBatchVerifier, identity_keys
    from bdls_tpu_torch.crypto.torch_provider import TorchCSP
    from bdls_tpu_torch.ops import ecdsa
    from bdls_tpu_torch.ops.curves import CURVES

    csp = TorchCSP(device="cuda", use_cpu_fallback=False, flush_interval=1.0)
    csp.warmup([(c, b) for c in CURVES for b in BUCKETS])
    verifier = CspBatchVerifier(csp, consenters=pin["idents"])
    csp.warm_keys(identity_keys(pin["idents"]), wait=True)
    csp.warm_keys(pin["endorsers"], wait=True)
    none = {"P-256": 0, "secp256k1": 0}
    k1_only = {"P-256": 0, "secp256k1": 1}

    def run(what, fn, want):
        before = csp.stats["pinned_lanes"]
        ecdsa.reset_launches()
        t = time.perf_counter()
        got = fn()
        ms = (time.perf_counter() - t) * 1e3
        k1, k2 = dict(ecdsa.LAUNCHES), dict(ecdsa.LAUNCHES_PINNED)
        lanes = csp.stats["pinned_lanes"] - before
        log(f"{what}: {ms:.2f} ms, {lanes} pinned lanes, K1 launches {k1}, "
            f"K2 launches {k2}")
        if got != want:
            raise SystemExit(f"{what}: verdicts differ from construction")
        return {"ms": ms, "pinned_lanes": lanes, "k1": k1, "k2": k2}

    envs, env_ok = pin["envs"], pin["env_ok"]
    first = run("vote round through the seam, 128 envelopes, one new key",
                lambda: verifier.verify_envelopes(envs), env_ok)
    if (first["pinned_lanes"], first["k1"], first["k2"]) != (
            127, k1_only, k1_only):
        raise SystemExit(f"first vote round: {first}")
    deadline = time.time() + 60
    while (not csp.key_cache.contains(pin["outsider"])
           and time.time() < deadline):
        time.sleep(0.01)
    second = run("second vote round, the new key pinned in the background",
                 lambda: verifier.verify_envelopes(envs), env_ok)
    if (second["pinned_lanes"], second["k1"], second["k2"]) != (
            128, none, k1_only):
        raise SystemExit(f"second vote round: {second}")
    if TorchBatchVerifier(device="cuda").verify_envelopes(envs) != env_ok:
        raise SystemExit("TorchBatchVerifier: verdicts differ")
    block = run(f"block batch, {len(pin['block'])} lanes from 16 pinned "
                f"endorsers", lambda: csp.verify_batch(pin["block"]),
                pin["block_ok"])
    if (block["pinned_lanes"], block["k1"], block["k2"]) != (
            len(pin["block"]), none, {"P-256": 1, "secp256k1": 0}):
        raise SystemExit(f"pinned block batch: {block}")
    if csp.stats["fallbacks"] != 0:
        raise SystemExit(f"K2 main path: fallbacks {csp.stats}")
    summary = {"vote_round_first": first, "vote_round_second": second,
               "block_batch": block,
               "launches": {"secp256k1": first["k2"]["secp256k1"],
                            "P-256": block["k2"]["P-256"]},
               "key_cache": csp.stats["key_cache"]}
    return summary, (csp, verifier)


def time_pinned(pinned, summary, live, pin, sm_clock_hz, dev) -> None:
    """Phase 7 for K2: kernel ms and bound at each bucket, the plain
    version at bucket 8, the vote round through the seam with the key
    cache on and off, and the pinned block batch."""
    from bdls_tpu_torch.consensus.verifier import CspBatchVerifier
    from bdls_tpu_torch.crypto.torch_provider import TorchCSP
    from bdls_tpu_torch.ops import ecdsa
    from bdls_tpu_torch.ops.curves import CURVES
    from bdls_tpu_torch.ops.verify_fold import verify_fold_pinned

    for curve_name, cv in CURVES.items():
        res = pinned[curve_name]
        lanes, slots, want = res["lanes"], res["slots"], res["want"]
        rse = [(ln[2], ln[3], int.from_bytes(ln[4], "big")) for ln in lanes]
        res["needed_muls_per_lane"] = needed_muls_pinned(cv, rse) / len(rse)
        res["buckets"] = {}
        for b in BUCKETS:
            idx = [i % len(lanes) for i in range(b)]
            args = _pinned_args([lanes[i] for i in idx],
                                [slots[i] for i in idx], dev)
            ok = ecdsa.verify_pinned_cuda(cv, *args, res["pools"])
            ok = ok.cpu().numpy()
            if not np.array_equal(ok, want[idx]):
                raise SystemExit(f"{curve_name} K2 B={b}: verdicts differ")
            if b in (128, 2048):
                # both main buckets, for both curves, lane for lane
                plain = verify_fold_pinned(cv, *args, res["pools"])
                if not np.array_equal(ok, plain.cpu().numpy()):
                    raise SystemExit(f"{curve_name} K2 B={b}: kernel "
                                     f"disagrees with plain")
            reps = 20 if b <= 2048 else 10
            ms = cuda_ms(
                lambda: ecdsa.verify_pinned_cuda(cv, *args, res["pools"]),
                reps)
            bms, by = pinned_bound_ms(cv, [rse[i] for i in idx],
                                      [slots[i] for i in idx], sm_clock_hz)
            res["buckets"][b] = {"ms": ms, "verifies_per_s": b / ms * 1e3,
                                 "bound_ms": bms, "bound_by": by,
                                 "bound_share": bms / ms}
            log(f"{curve_name} K2 B={b}: kernel {ms:.3f} ms "
                f"({b / ms * 1e3:,.0f} verifies/s), bound {bms:.4f} ms "
                f"({by}, {bms / ms:.2%} of the kernel time)"
                + (", equal to plain" if b in (128, 2048) else ""))
        args8 = _pinned_args(lanes[:8], slots[:8], dev)
        t0 = time.perf_counter()
        verify_fold_pinned(cv, *args8, res["pools"])
        torch.cuda.synchronize()
        res["plain_ms_bucket8"] = (time.perf_counter() - t0) * 1e3
        log(f"{curve_name} K2: plain {res['plain_ms']:.0f} ms at "
            f"B={MAIN_BUCKET[curve_name]}, {res['plain_ms_bucket8']:.0f} ms "
            f"at B=8")
        res["cache"].close()

    csp, verifier = live
    envs, env_ok = pin["envs"], pin["env_ok"]

    def rounds(ver, n=9):
        out = []
        for _ in range(n):
            t = time.perf_counter()
            if ver.verify_envelopes(envs) != env_ok:
                raise SystemExit("vote round: verdicts differ")
            out.append((time.perf_counter() - t) * 1e3)
        return sorted(out)

    ecdsa.reset_launches()
    on = rounds(verifier)
    on_launches = (dict(ecdsa.LAUNCHES), dict(ecdsa.LAUNCHES_PINNED))
    if on_launches != ({"P-256": 0, "secp256k1": 0},
                       {"P-256": 0, "secp256k1": 9}):
        raise SystemExit(f"cache-on vote rounds: launches {on_launches}")
    # the cache off and the latency tier off: K1's eager launch against
    # K2, as in earlier runs (phase 7c times the tier)
    off_csp = TorchCSP(device="cuda", key_cache_size=0,
                       use_cpu_fallback=False, flush_interval=1.0,
                       latency_max_lanes=0)
    off_csp.warmup([("secp256k1", 128)])
    ecdsa.reset_launches()
    off = rounds(CspBatchVerifier(off_csp))
    off_launches = (dict(ecdsa.LAUNCHES), dict(ecdsa.LAUNCHES_PINNED))
    off_csp.close()
    if off_launches != ({"P-256": 0, "secp256k1": 9},
                        {"P-256": 0, "secp256k1": 0}):
        raise SystemExit(f"cache-off vote rounds: launches {off_launches}")
    blocks = []
    for _ in range(5):
        t = time.perf_counter()
        if csp.verify_batch(pin["block"]) != pin["block_ok"]:
            raise SystemExit("pinned block batch: verdicts differ")
        blocks.append((time.perf_counter() - t) * 1e3)
    blocks.sort()
    if csp.stats["fallbacks"] != 0:
        raise SystemExit("a fallback happened during K2 timing")
    csp.close()
    summary.update({"vote_round_cache_on_ms": on,
                    "vote_round_cache_off_ms": off,
                    "block_batch_pinned_ms": blocks})
    log(f"vote round through the seam, 128 envelopes: cache on median "
        f"{on[4]:.2f} ms (min {on[0]:.2f}, max {on[-1]:.2f}), 9 K2 "
        f"launches; cache off median {off[4]:.2f} ms (min {off[0]:.2f}, "
        f"max {off[-1]:.2f}), 9 K1 launches; pinned block batch "
        f"{len(pin['block'])} lanes "
        f"median {blocks[2]:.2f} ms (min {blocks[0]:.2f}, "
        f"max {blocks[-1]:.2f})")


# 32-bit integer instructions one SHA-256 compression of a 64-byte block
# needs, at the least known for the function, with Hopper's three-input
# add (IADD3) and logic (LOP3) and the funnel-shift rotate (SHF): a round
# takes 6 rotates, 4 logic ops (Σ0, Σ1, Ch, Maj) and 4 adds (T1 of five
# terms in 2, a = T1 + Σ0 + Maj in 1, e = d + T1 in 1); each of the 48
# schedule words 4 rotates, 2 shifts, 2 logic ops and 2 adds; the feed-
# forward 8 adds
SHA_OPS_PER_BLOCK = 64 * (6 + 4 + 4) + 48 * (4 + 2 + 2 + 2) + 8
# 32-bit integer adds, logic ops and shifts per clock per SM, compute
# capability 9.0 (CUDA C++ Programming Guide, arithmetic instruction
# throughput table): the same 64 as multiplies
IOP_PER_CLK_PER_SM = 64


def active_blocks(nblocks, NB: int) -> int:
    """512-bit blocks the lanes actually compress."""
    return int(np.minimum(np.maximum(np.asarray(nblocks), 0), NB).sum())


def sha_bound_ms(nblocks, NB: int, sm_clock_hz: float) -> tuple[float, str]:
    """K6's bound: the compressions the lanes need over the integer
    issue rate, against the bytes: the active blocks' words and each
    lane's block count read once, the 32-byte digest written once."""
    blocks = active_blocks(nblocks, NB)
    t_ops = blocks * SHA_OPS_PER_BLOCK / (
        SMS * IOP_PER_CLK_PER_SM * sm_clock_hz)
    t_bytes = (64 * blocks + (4 + 32) * len(nblocks)) / PEAK_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def limbs_to_ints(a) -> list[int]:
    """(16, L) 16-bit limbs -> L ints."""
    a = np.asarray(a).astype(object)
    return [sum(int(a[k, b]) << (16 * k) for k in range(16))
            for b in range(a.shape[1])]


def block_bound_ms(curve, packed: dict,
                   sm_clock_hz: float) -> tuple[float, str]:
    """K7's bound: the verify multiplies of :func:`needed_muls` on the
    packed lanes (filler lanes fail the curve check and need no ladder)
    plus the SHA-256 work of the active blocks, summed over one 64-a-
    clock issue rate; against the bytes: the active words, the four limb
    arrays, the lane coordinates, the (T, O) mask, required, the flags,
    the verdicts and the G table, each once."""
    cols = [limbs_to_ints(packed[k]) for k in ("qx", "qy", "r", "s")]
    lanes = [(qx, qy, r, s, None, None) for qx, qy, r, s in zip(*cols)]
    NB, _, L = packed["words"].shape
    T, O = packed["org_mask"].shape
    blocks = active_blocks(packed["nblocks"], NB)
    ops = needed_muls(curve, lanes) + blocks * SHA_OPS_PER_BLOCK
    t_ops = ops / (SMS * IMUL_PER_CLK_PER_SM * sm_clock_hz)
    nbytes = (64 * blocks + 4 * L + 4 * 16 * 4 * L + 2 * 4 * L
              + 4 * T * O + 4 * T + 4 * T + L + G_TABLE_BYTES)
    t_bytes = nbytes / PEAK_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def make_block_inputs(rng) -> dict:
    """The block lane's inputs: the main path's 1000-tx x 2-endorsement
    P-256 block (4 orgs, 2 endorsers each, one shared preimage of 200-
    1000 bytes a tx, every 97th tx from tx 5 tampered), a hostile block
    of the same shape, and a hostile 50-tx secp256k1 block (128 lanes)."""
    from bdls_tpu_torch.crypto import vectors

    return {
        "main": vectors.block_request("P-256", rng, 1000),
        "P-256": vectors.block_request("P-256", rng, 1000, hostile=True),
        "secp256k1": vectors.block_request("secp256k1", rng, 50,
                                           hostile=True),
    }


def packed_on(packed: dict, dev) -> list:
    from bdls_tpu_torch.ops import _build, block_verify

    return [_build.as_int32(packed[k], dev)
            for k in block_verify.PACKED_KEYS]


def check_block_kernels(blk, dev) -> dict:
    """Phase 4b: K6 against hashlib and its plain version at 2048 lanes
    (the main block's preimages, the padding boundaries, zero-block
    filler lanes), exactly; K7 against its plain version, lane for lane
    and tx for tx, on the hostile P-256 block at the main shape and the
    hostile secp256k1 block, and against the host oracle."""
    from bdls_tpu_torch.crypto import blocklane
    from bdls_tpu_torch.crypto.sw import SwCSP
    from bdls_tpu_torch.crypto.torch_provider import block_lane_screen
    from bdls_tpu_torch.ops import _build, block_verify, sha256
    from bdls_tpu_torch.ops.curves import CURVES

    out = {}
    pattern = bytes(range(256)) * 4
    msgs = [ln.msg for ln in blk["main"].lanes] + [
        pattern[:n] for n in (0, 55, 56, 63, 64, 119, 120, 1015)]
    words, nblocks = sha256.pad_messages(msgs + [b""] * (2048 - len(msgs)),
                                         max_blocks=16)
    nblocks[len(msgs):] = 0
    w, nb = _build.as_int32(words, dev), _build.as_int32(nblocks, dev)
    kern = sha256.sha256_cuda(w, nb).cpu().numpy()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain = sha256.sha256_words(w, nb).cpu().numpy()
    plain_ms = (time.perf_counter() - t0) * 1e3
    be = kern.view(np.uint32).astype(">u4")
    if not np.array_equal(kern, plain):
        raise SystemExit("K6 disagrees with its plain version")
    if [be[:, i].tobytes() for i in range(len(msgs))] != [
            hashlib.sha256(m).digest() for m in msgs]:
        raise SystemExit("K6 disagrees with hashlib")
    if kern.view(np.uint32)[:, len(msgs):].T.tolist() != [
            sha256.H0.tolist()] * (2048 - len(msgs)):
        raise SystemExit("K6: a zero-block filler lane is not the IV")
    log(f"K6 vs plain and hashlib on 2048 lanes ({len(msgs)} messages, "
        f"{2048 - len(msgs)} filler): equal; plain {plain_ms:.0f} ms")
    out["sha256"] = {"max_abs_err": 0, "plain_ms_check": plain_ms}

    sw = SwCSP()
    for curve_name in ("P-256", "secp256k1"):
        cv = CURVES[curve_name]
        req = blk[curve_name]
        packed = block_verify.pack_block_request(
            req, lane_ok=block_lane_screen(curve_name))
        ts = packed_on(packed, dev)
        kflags, kvalid = block_verify.verify_block_cuda(cv, *ts)
        kflags, kvalid = kflags.cpu().numpy(), kvalid.cpu().numpy()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pflags, pvalid = block_verify.block_kernel(cv, *ts)
        pflags, pvalid = pflags.cpu().numpy(), pvalid.cpu().numpy()
        plain_ms = (time.perf_counter() - t0) * 1e3
        dv = np.abs(kvalid.astype(np.int64) - pvalid.astype(np.int64))
        df = np.abs(kflags.astype(np.int64) - pflags.astype(np.int64))
        host = blocklane.verify_block_host(sw.verify_batch, req)
        NB, _, L = packed["words"].shape
        T, O = packed["org_mask"].shape
        log(f"{curve_name}: K7 vs plain at L {L}, T {T}, NB {NB}, O {O} "
            f"({len(req.lanes)} lanes, {req.ntx} txs): {int(dv.sum())} "
            f"lanes and {int(df.sum() // 2)} txs differ; valid "
            f"{int(kvalid.sum())}, txs valid "
            f"{int((kflags[:req.ntx] == 0).sum())}; plain {plain_ms:.0f} ms")
        if dv.any() or df.any():
            raise SystemExit(f"{curve_name}: K7 disagrees with plain")
        if kflags[:req.ntx].tolist() != host.tolist():
            raise SystemExit(f"{curve_name}: K7 disagrees with the host "
                             f"oracle")
        out[curve_name] = {"packed": packed, "ts": ts,
                           "max_abs_err": int(max(dv.max(), df.max())),
                           "plain_ms": plain_ms,
                           "shape": {"L": L, "T": T, "NB": NB, "O": O}}
    return out


def drive_block_main_path(blk):
    """Phase 6b: the committer's block lane. The 1000-tx block through
    ``TorchCSP(device="cuda").verify_block`` with the default key cache
    (which the block lane does not use): one K7 launch and no other, no
    fallback, the host oracle's flags. Then the hostile secp256k1 block
    through the same entry (K7 secp256k1's own path), and the main
    block's preimages through ``sha256_batch`` (K6's own path). Counts
    are set to 0 just before each run and read just after."""
    from bdls_tpu_torch.crypto import blocklane
    from bdls_tpu_torch.crypto.sw import SwCSP
    from bdls_tpu_torch.crypto.torch_provider import TorchCSP
    from bdls_tpu_torch.ops import block_verify, ecdsa, sha256

    sw = SwCSP()
    csp = TorchCSP(device="cuda", use_cpu_fallback=False)
    if csp.key_cache is None:
        raise SystemExit("the default TorchCSP has no key cache")

    def counts():
        return {"K1": dict(ecdsa.LAUNCHES), "K2": dict(ecdsa.LAUNCHES_PINNED),
                "K6": dict(sha256.LAUNCHES_SHA256),
                "K7": dict(block_verify.LAUNCHES_BLOCK)}

    def run(what, req, curve_name):
        want = blocklane.verify_block_host(sw.verify_batch, req)
        ecdsa.reset_launches()
        t = time.perf_counter()
        got = csp.verify_block(req)
        ms = (time.perf_counter() - t) * 1e3
        seen = counts()
        log(f"{what}: {ms:.2f} ms, {int((got == 0).sum())} of {req.ntx} "
            f"txs valid, launches {seen}")
        want_k7 = {"P-256": 0, "secp256k1": 0}
        want_k7[curve_name] = 1
        zero = {"P-256": 0, "secp256k1": 0}
        if seen != {"K1": zero, "K2": zero, "K6": {"sha256": 0},
                    "K7": want_k7}:
            raise SystemExit(f"{what}: launches {seen}")
        if got.tolist() != want.tolist():
            raise SystemExit(f"{what}: flags differ from the host oracle")
        return {"ms": ms, "launches": seen["K7"][curve_name],
                "txs_valid": int((got == 0).sum())}

    main = run(f"block lane, {blk['main'].ntx} txs x 2 endorsements, "
               f"{len(blk['main'].lanes)} lanes", blk["main"], "P-256")
    stats = csp.stats
    if (csp._c_block_fallbacks.value() != 0
            or csp._c_block_blocks.value() != 1
            or stats["pinned_lanes"] != 0 or stats["batches"] != 0):
        raise SystemExit(f"block lane main path: fallbacks "
                         f"{csp._c_block_fallbacks.value()}, blocks "
                         f"{csp._c_block_blocks.value()}, stats {stats}")
    k1 = run(f"secp256k1 block lane, {blk['secp256k1'].ntx} txs, "
             f"{len(blk['secp256k1'].lanes)} lanes", blk["secp256k1"],
             "secp256k1")
    msgs = [ln.msg for ln in blk["main"].lanes]
    ecdsa.reset_launches()
    t = time.perf_counter()
    digests = sha256.sha256_batch(msgs)
    sha_ms = (time.perf_counter() - t) * 1e3
    seen = counts()
    log(f"sha256_batch, {len(msgs)} preimages: {sha_ms:.2f} ms, launches "
        f"{seen}")
    if seen["K6"] != {"sha256": 1} or any(
            v for k in ("K1", "K2", "K7") for v in seen[k].values()):
        raise SystemExit(f"sha256_batch: launches {seen}")
    if digests != [hashlib.sha256(m).digest() for m in msgs]:
        raise SystemExit("sha256_batch: digests differ from hashlib")
    if csp._c_block_fallbacks.value() != 0:
        raise SystemExit("a block-lane fallback happened")
    return {"main": main, "secp256k1": k1,
            "sha256_batch": {"ms": sha_ms, "launches": 1}}, csp


def time_block(checked, blk, csp, sm_clock_hz, dev) -> dict:
    """Phase 7b: K6 and K7 (both curves) with CUDA events and their
    bounds, the plain twins on the main block's arrays, then 9
    ``verify_block`` calls and 9 lane-at-a-time calls
    (``verify_block_host`` over a key-cache-off TorchCSP: hashlib plus
    K1), in turns."""
    from bdls_tpu_torch.crypto import blocklane
    from bdls_tpu_torch.crypto.torch_provider import TorchCSP, \
        block_lane_screen
    from bdls_tpu_torch.ops import block_verify, ecdsa, sha256
    from bdls_tpu_torch.ops.curves import CURVES

    out = {}
    packed = block_verify.pack_block_request(
        blk["main"], lane_ok=block_lane_screen("P-256"))
    ts = packed_on(packed, dev)
    NB, _, L = packed["words"].shape
    ms = cuda_ms(lambda: sha256.sha256_cuda(ts[0], ts[1]), 50)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sha256.sha256_words(ts[0], ts[1])
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    bms, by = sha_bound_ms(packed["nblocks"], NB, sm_clock_hz)
    blocks = active_blocks(packed["nblocks"], NB)
    out["sha256"] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
                     "bound_by": by, "lanes": L, "active_blocks": blocks,
                     "ops_per_block": SHA_OPS_PER_BLOCK}
    log(f"K6 at (NB {NB}, {L} lanes, {blocks} active blocks): kernel "
        f"{ms:.4f} ms, bound {bms:.5f} ms ({by}, {bms / ms:.2%}), plain "
        f"{plain_ms:.0f} ms")
    cv = CURVES["P-256"]
    ms = cuda_ms(lambda: block_verify.verify_block_cuda(cv, *ts), 20)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    block_verify.block_kernel(cv, *ts)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    bms, by = block_bound_ms(cv, packed, sm_clock_hz)
    e16 = sha256.words_to_e16(sha256.sha256_cuda(ts[0], ts[1])).contiguous()
    k1_ms = cuda_ms(lambda: ecdsa.verify_fold_cuda(cv, *ts[2:6], e16), 20)
    out["P-256"] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
                    "bound_by": by, "k1_same_lanes_ms": k1_ms}
    log(f"K7 P-256 at the main shape: kernel {ms:.3f} ms (K1 on the same "
        f"{L} lanes {k1_ms:.3f} ms), bound {bms:.4f} ms ({by}, "
        f"{bms / ms:.2%}), plain {plain_ms:.0f} ms")
    kc = checked["secp256k1"]
    cv = CURVES["secp256k1"]
    ms = cuda_ms(lambda: block_verify.verify_block_cuda(cv, *kc["ts"]), 20)
    bms, by = block_bound_ms(cv, kc["packed"], sm_clock_hz)
    out["secp256k1"] = {"ms": ms, "plain_ms": kc["plain_ms"],
                        "bound_ms": bms, "bound_by": by}
    log(f"K7 secp256k1 at L {kc['shape']['L']}: kernel {ms:.3f} ms, bound "
        f"{bms:.4f} ms ({by}, {bms / ms:.2%}), plain {kc['plain_ms']:.0f} "
        f"ms")

    req = blk["main"]
    lane_csp = TorchCSP(device="cuda", key_cache_size=0,
                        use_cpu_fallback=False, flush_interval=1.0)
    lane_csp.warmup([("P-256", 2048)])
    want = blocklane.verify_block_host(lane_csp.verify_batch, req).tolist()
    fused, lane = [], []
    ecdsa.reset_launches()
    for _ in range(9):
        t = time.perf_counter()
        if csp.verify_block(req).tolist() != want:
            raise SystemExit("verify_block: flags differ")
        fused.append((time.perf_counter() - t) * 1e3)
        t = time.perf_counter()
        if blocklane.verify_block_host(lane_csp.verify_batch,
                                       req).tolist() != want:
            raise SystemExit("lane-at-a-time: flags differ")
        lane.append((time.perf_counter() - t) * 1e3)
    seen = (dict(block_verify.LAUNCHES_BLOCK), dict(ecdsa.LAUNCHES))
    lane_csp.close()
    csp.close()
    if seen != ({"P-256": 9, "secp256k1": 0}, {"P-256": 9, "secp256k1": 0}):
        raise SystemExit(f"block timing: launches {seen}")
    if csp._c_block_fallbacks.value() or lane_csp.stats["fallbacks"]:
        raise SystemExit("a fallback happened during block timing")
    fused.sort()
    lane.sort()
    out["verify_block_ms"] = fused
    out["lane_at_a_time_ms"] = lane
    log(f"block of {req.ntx} txs, {len(req.lanes)} lanes: verify_block "
        f"median {fused[4]:.2f} ms (min {fused[0]:.2f}, max {fused[-1]:.2f}), "
        f"9 K7 launches; lane at a time (hashlib + K1) median {lane[4]:.2f} "
        f"ms (min {lane[0]:.2f}, max {lane[-1]:.2f}), 9 K1 launches")
    return out


# ---------------------------------------------------------------- Ed25519
# one Montgomery-free 32-bit reduction of a 512-bit product mod
# 2^255 - 19: the high half times 38 (8 widening products), then the
# carry word times 38 again
RED_P25519 = 2 * 8 + 2
ED_LANE_BYTES = 6 * 16 * 4       # six (16, B) int32 arrays
ED_ENTRY_BYTES = 3 * 8 * 4       # a B-table entry: x, y, t


def _ed_digits(k: int) -> list[int]:
    """K8's 66 signed 4-bit digits of k, LSB first."""
    w = k + sum(8 << (4 * i) for i in range(64))
    ds = [((w >> (4 * i)) & 0xF) - 8 for i in range(64)]
    return ds + [w >> 256, 0]


def needed_muls_ed25519(rows) -> float:
    """32-bit multiplies that verifying ``rows`` (``ed25519_lane``
    tuples) in one launch needs, at the least work known for the
    function, not the kernel's choices:

    - extended twisted-Edwards formulas of the Explicit-Formulas
      Database with a = -1: dbl-2008-hwcd 4M + 4S; add-2008-hwcd-3 8M
      with the table entries kept as (Y - X, Y + X, 2Z, 2d·T); the
      positioned B entries affine with 2d·t stored, 7M;
    - special-form reduction mod 2^255 - 19;
    - [k](-A): the [2..8]·(-A) table (1 doubling, 6 additions), then
      4 doublings a signed digit below the top nonzero one and one
      addition per nonzero digit of k (the run's own digits);
    - [S]B: one addition per nonzero byte of S, no doubling;
    - the on-curve checks of A and R (2S + 3M each), the final sum of
      the two accumulators and the projective compare (2M);
    - a lane with S >= L or a coordinate >= p needs no work past its
      range check, a lane with a point off the curve none past the
      curve checks.
    """
    from bdls_tpu_torch.ops.ed25519 import L, P, on_curve as ed_on_curve

    mp, sp = MUL + RED_P25519, SQR + RED_P25519
    dbl, add, madd = 4 * mp + 4 * sp, 8 * mp, 7 * mp
    on_curve = 2 * sp + 3 * mp
    total = 0.0
    for ax, ay, rx, ry, s, k in rows:
        if s >= L or max(ax, ay, rx, ry) >= P:
            continue
        total += 2 * on_curve
        if not (ed_on_curve(ax, ay) and ed_on_curve(rx, ry)):
            continue
        ds = _ed_digits(k)
        top = max((i for i, d in enumerate(ds) if d), default=-1)
        nz = sum(1 for d in ds if d)
        nb = sum(1 for j in range(32) if (s >> (8 * j)) & 0xFF)
        total += (dbl + 6 * add + 4 * max(top, 0) * dbl + nz * add
                  + nb * madd + add + 2 * mp)
    return total


def ed25519_bound_ms(rows, sm_clock_hz: float) -> tuple[float, str]:
    """K8's bound: the multiplies of :func:`needed_muls_ed25519` over the
    card's multiply rate, against the bytes: each lane's six limb
    arrays and its verdict, and every B-table entry the batch needs,
    once."""
    t_ops = needed_muls_ed25519(rows) / (
        SMS * IMUL_PER_CLK_PER_SM * sm_clock_hz)
    entries = {(j, (s >> (8 * j)) & 0xFF) for _, _, _, _, s, _ in rows
               for j in range(32)}
    t_bytes = ((ED_LANE_BYTES + 1) * len(rows)
               + ED_ENTRY_BYTES * len(entries)) / PEAK_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def make_ed25519_inputs(rng) -> dict:
    """The Ed25519 vote path's inputs: a 128-validator committee's
    85-vote quorum and a 1024-validator committee's 683-vote quorum
    (2t + 1, as ``tests/test_committee_growth.py`` sizes them), each
    vote an RFC 8032 signature over the round's 32-byte digest; every
    61st voter from the 8th signs another digest (forged)."""
    from bdls_tpu_torch.crypto.csp import VerifyRequest
    from bdls_tpu_torch.crypto.sw import SwCSP

    sw = SwCSP()
    rounds = {}
    for n, quorum in ((128, 85), (1024, 683)):
        digest = sw.hash(b"bdls height 42 round 7 committee %d" % n)
        reqs, oks = [], []
        for v in range(quorum):
            key = sw.key_gen("ed25519", rng)
            forged = v % 61 == 7
            r, s = sw.sign(key, sw.hash(b"other round") if forged
                           else digest)
            reqs.append(VerifyRequest(key.public_key(), digest, r, s))
            oks.append(not forged)
        rounds[n] = (reqs, oks)
    return rounds


def _ed_lane_of(q) -> tuple:
    return (q.key.x, q.key.y, q.r, q.s, q.digest, "main path")


def check_ed25519_kernel(ed_in, rng, dev) -> dict:
    """Phase 3c: K8 on the card against its plain twin, lane for lane,
    and both against the RFC 8032 oracle (``verify_affine``), at 128 and
    2048 lanes: the RFC 8032 §7.1 vectors, seeded valid lanes and every
    hostile lane of ``vectors.ed25519_mixed_lanes``, filled up with the
    main path's own votes."""
    from bdls_tpu_torch.crypto import vectors
    from bdls_tpu_torch.ops import ed25519 as ed
    from bdls_tpu_torch.ops.curves import ED25519

    mixed = vectors.ed25519_mixed_lanes(rng)
    fill = [_ed_lane_of(q) for n in (128, 1024) for q in ed_in[n][0]]
    out = {}
    for b in (128, 2048):
        lanes = mixed + [fill[i % len(fill)] for i in range(b - len(mixed))]
        want = np.array(vectors.ed25519_expected(lanes))
        rows = vectors.ed25519_rows(lanes)
        args = [torch.from_numpy(a.view(np.int32)).to(dev)
                for a in ed.lanes_to_limbs(rows)]
        kern = ed.verify_ed25519_cuda(*args).cpu().numpy()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plain = ed.verify_ed25519(ED25519, *args).cpu().numpy()
        plain_ms = (time.perf_counter() - t0) * 1e3
        diff = np.abs(kern.astype(np.int64) - plain.astype(np.int64))
        bad = [lanes[i][5] for i in np.flatnonzero(diff)]
        log(f"ed25519: K8 vs plain on {b} lanes ({len(mixed)} mixed): "
            f"{int(diff.sum())} differ {bad}; valid {int(kern.sum())}; "
            f"plain {plain_ms:.0f} ms")
        if diff.any():
            raise SystemExit("ed25519: K8 disagrees with its plain twin")
        if not np.array_equal(kern, want):
            raise SystemExit("ed25519: K8 disagrees with the RFC 8032 "
                             "oracle")
        out[b] = {"lanes": lanes, "rows": rows, "want": want,
                  "max_abs_err": int(diff.max()), "plain_ms": plain_ms}
    return out


def drive_ed25519_main_path(ed_in) -> dict:
    """Phase 5b: the Ed25519 vote path at full width through
    ``TorchCSP(device="cuda")`` (``submit`` + ``flush``): the 85-vote
    and the 683-vote quorum, each in exactly one K8 launch, no K1 or K2
    launch, no fallback, the verdicts of construction. Counts are set to
    0 just before each round and read just after."""
    from bdls_tpu_torch.crypto.torch_provider import TorchCSP
    from bdls_tpu_torch.ops import ecdsa
    from bdls_tpu_torch.ops import ed25519 as ed

    csp = TorchCSP(device="cuda", use_cpu_fallback=False, flush_interval=1.0)
    csp.warmup([("ed25519", b) for b in BUCKETS])
    out = {}
    for n in (128, 1024):
        reqs, oks = ed_in[n]
        ecdsa.reset_launches()
        t0 = time.perf_counter()
        futs = [csp.submit(q) for q in reqs]
        csp.flush()
        got = [f.result(60) for f in futs]
        ms = (time.perf_counter() - t0) * 1e3
        seen = (dict(ed.LAUNCHES_ED25519), dict(ecdsa.LAUNCHES),
                dict(ecdsa.LAUNCHES_PINNED), dict(ecdsa.LAUNCHES_LATENCY))
        log(f"ed25519 vote round, {n} validators, {len(reqs)} votes "
            f"({len(reqs) - sum(oks)} forged): {ms:.2f} ms, K8 launches "
            f"{seen[0]}, K1 {seen[1]}, K2 {seen[2]}, K3 {seen[3]}")
        if got != oks:
            raise SystemExit(f"ed25519 round {n}: verdicts differ")
        if seen[0] != {"ed25519": 1} or any(
                v for d in seen[1:] for v in d.values()):
            raise SystemExit(f"ed25519 round {n}: launches {seen}")
        out[n] = {"ms": ms, "launches": 1, "votes": len(reqs)}
    if csp.stats["fallbacks"] != 0:
        raise SystemExit(f"ed25519 main path: {csp.stats}")
    return out, csp


def _identities(votes) -> list[bytes]:
    return [q.key.x.to_bytes(32, "big") + q.key.y.to_bytes(32, "big")
            for q in votes]


def drive_latency_main_path(votes, vote_ok) -> dict:
    """Phase 5c: K3 at full width. A 128-validator secp256k1 committee on
    ``TorchCSP(device="cuda", key_cache_size=0)`` (flush interval at the
    reference default), warmed so every latency-eligible bucket has its
    captured slots; ``CspBatchVerifier`` with the 128 identities sets the
    quorum hint to 85; 85 ``submit`` calls (2 forged) go out as one
    speculative flush through exactly one K3 replay, with no eager K1
    launch and no cold fallback. Once with the vote buckets off (bucket
    128), once with ``vote_buckets=VOTE_BUCKETS`` (bucket 85). Then the
    ring repro: 21 requests at ``buckets=(8,)``, three runs."""
    from bdls_tpu_torch.consensus.verifier import CspBatchVerifier
    from bdls_tpu_torch.crypto import vectors
    from bdls_tpu_torch.crypto.csp import PublicKey, VerifyRequest
    from bdls_tpu_torch.crypto.sw import SwCSP
    from bdls_tpu_torch.crypto.torch_provider import TorchCSP, VOTE_BUCKETS
    from bdls_tpu_torch.ops import ecdsa

    os.environ.pop("BDLS_TPU_VOTE_BUCKETS", None)
    quorum, want = votes[:85], vote_ok[:85]
    out = {}
    for label, vb, bucket in (("vote buckets off", None, 128),
                              ("vote buckets on", VOTE_BUCKETS, 85)):
        csp = TorchCSP(device="cuda", key_cache_size=0,
                       use_cpu_fallback=False, vote_buckets=vb)
        csp.warmup([("secp256k1", b) for b in csp.buckets
                    if b <= 2048])
        CspBatchVerifier(csp, consenters=_identities(votes))
        if csp.quorum_lanes != 85:
            raise SystemExit(f"quorum hint {csp.quorum_lanes}, want 85")
        # one round first: the flusher and drainer threads exist
        [f.result(60) for f in [csp.submit(q) for q in quorum]]
        before = csp.stats
        qw = csp.metrics.find("tpu_verify_queue_wait_seconds")
        qw0 = qw.snapshot()
        ecdsa.reset_launches()
        t0 = time.perf_counter()
        futs = [csp.submit(q) for q in quorum]
        t_sub = time.perf_counter() - t0
        got = [f.result(60) for f in futs]
        ms = (time.perf_counter() - t0) * 1e3
        st = csp.stats
        seen = (dict(ecdsa.LAUNCHES_LATENCY), dict(ecdsa.LAUNCHES),
                dict(ecdsa.LAUNCHES_PINNED))
        spec = st["speculative_flushes"] - before["speculative_flushes"]
        cold = st["latency_cold_fallbacks"] - before["latency_cold_fallbacks"]
        # the one flush's queue wait: first submit to the launch
        qw1 = qw.snapshot()
        wait_ms = (qw1["sum"] - qw0["sum"]) * 1e3
        log(f"K3 quorum round ({label}, bucket {bucket}): 85 submits in "
            f"{t_sub * 1e3:.2f} ms, flushed {wait_ms:.2f} ms after the "
            f"first (flush_interval {csp.flush_interval * 1e3:.0f} ms), "
            f"verdicts after {ms:.2f} ms; speculative flushes {spec}, cold "
            f"fallbacks {cold}, K3 replays {seen[0]}, eager K1 {seen[1]}, "
            f"K2 {seen[2]}")
        if got != want:
            raise SystemExit(f"K3 round ({label}): verdicts differ")
        if (qw1["count"] - qw0["count"] != 1
                or wait_ms >= csp.flush_interval * 1e3):
            raise SystemExit(f"K3 round ({label}): the flush waited "
                             f"{wait_ms:.2f} ms, not launched at quorum")
        if spec < 1 or cold != 0 or st["fallbacks"] != 0:
            raise SystemExit(f"K3 round ({label}): stats {st}")
        if seen != ({"P-256": 0, "secp256k1": 1},
                    {"P-256": 0, "secp256k1": 0},
                    {"P-256": 0, "secp256k1": 0}):
            raise SystemExit(f"K3 round ({label}): launches {seen}")
        out[bucket] = {"ms": ms, "submit_ms": t_sub * 1e3, "launches": 1,
                       "flush_wait_ms": wait_ms, "speculative_flushes": spec}
        if bucket == 128:
            live = csp
        else:
            csp.close()

    lanes = vectors.mixed_lanes("secp256k1", np.random.default_rng(SEED + 4),
                                n_valid=2)[:21]
    reqs = [VerifyRequest(PublicKey("secp256k1", qx, qy), d, r, s)
            for qx, qy, r, s, d, _ in lanes]
    want = SwCSP().verify_batch(reqs)
    ring = TorchCSP(device="cuda", key_cache_size=0, buckets=(8,),
                    use_cpu_fallback=False)
    ring.warmup([("secp256k1", 8)])
    ecdsa.reset_launches()
    runs = [ring.verify_batch(reqs) for _ in range(3)]
    replays = ecdsa.LAUNCHES_LATENCY["secp256k1"]
    eager = ecdsa.LAUNCHES["secp256k1"]
    ring.close()
    log(f"ring repro, 21 secp256k1 requests at buckets=(8,), 3 runs: "
        f"{'stable' if runs == [runs[0]] * 3 else 'UNSTABLE'}, "
        f"{'equal to' if runs[0] == want else 'DIFFERENT from'} SwCSP; "
        f"{replays} K3 replays, {eager} eager K1 launches (slots busy)")
    if runs != [want] * 3 or replays + eager != 9 or replays < 3:
        raise SystemExit("ring repro failed")
    out["ring_repro"] = {"runs": 3, "k3_replays": replays,
                         "eager_k1": eager}
    return out, live


def time_latency(lat_lanes, lat_want, live, quorum, want, sm_clock_hz,
                 dev) -> dict:
    """Phase 7c: a K3 replay (staging copy → K1 → verdict copy, captured)
    against an eager K1 launch (kernel alone, and with the same two
    copies launched one by one as the throughput tier does), at buckets
    85, 128 and 171 on secp256k1, with CUDA events and by the host clock
    from launch to event; then the quorum's submit-to-verdict median of
    9 rounds with the tier on against ``latency_max_lanes=0``, in
    turns."""
    from bdls_tpu_torch.consensus.verifier import CspBatchVerifier
    from bdls_tpu_torch.crypto.marshal import ints_to_limbs
    from bdls_tpu_torch.crypto import vectors
    from bdls_tpu_torch.crypto.torch_provider import TorchCSP
    from bdls_tpu_torch.ops import ecdsa
    from bdls_tpu_torch.ops.curves import SECP256K1

    out = {}
    stream = torch.cuda.Stream(dev)
    for b in (85, 128, 171):
        idx = [i % len(lat_lanes) for i in range(b)]
        tiled = [lat_lanes[i] for i in idx]
        arrs = [ints_to_limbs(c) for c in vectors.columns(tiled)]
        slot = ecdsa.LatencySlot(SECP256K1, b, device=dev, stream=stream)
        slot.stage(arrs)
        slot.launch().synchronize()
        got = slot.verdict()
        host = torch.from_numpy(np.stack(arrs).view(np.int32)).pin_memory()
        limbs = host.to(dev)
        eager = ecdsa.verify_fold_cuda(SECP256K1, *limbs).cpu().numpy()
        if not (np.array_equal(got, eager)
                and np.array_equal(got, lat_want[idx])):
            raise SystemExit(f"K3 B={b}: replay differs from eager K1")
        res = {"max_abs_err": int(np.abs(got.astype(np.int64)
                                         - eager.astype(np.int64)).max())}
        outbuf = torch.empty(b, dtype=torch.bool, pin_memory=True)

        def replay():
            slot.graph.replay()

        def eager_copies():
            buf = host.to(dev, non_blocking=True)
            ok = ecdsa.verify_fold_cuda(SECP256K1, *buf)
            outbuf.copy_(ok, non_blocking=True)

        with torch.cuda.stream(stream):
            res["replay_ms"] = cuda_ms(replay, 20)
            res["eager_k1_ms"] = cuda_ms(
                lambda: ecdsa.verify_fold_cuda(SECP256K1, *limbs), 20)
            res["eager_copies_ms"] = cuda_ms(eager_copies, 20)
            # host clock from the launch call to the event, one at a time
            hr, he = [], []
            for _ in range(9):
                t = time.perf_counter()
                slot.launch().synchronize()
                hr.append((time.perf_counter() - t) * 1e3)
                t = time.perf_counter()
                eager_copies()
                ev = torch.cuda.Event()
                ev.record(stream)
                ev.synchronize()
                he.append((time.perf_counter() - t) * 1e3)
        res["replay_host_ms"] = sorted(hr)[4]
        res["eager_host_ms"] = sorted(he)[4]
        bms, by = bound_ms(SECP256K1, tiled, sm_clock_hz)
        res.update({"bound_ms": bms, "bound_by": by})
        out[b] = res
        log(f"K3 B={b}: replay {res['replay_ms']:.3f} ms (host "
            f"{res['replay_host_ms']:.3f}), eager K1 {res['eager_k1_ms']:.3f}"
            f" ms, eager copies + K1 {res['eager_copies_ms']:.3f} ms (host "
            f"{res['eager_host_ms']:.3f}), bound {bms:.4f} ms ({by})")

    off = TorchCSP(device="cuda", key_cache_size=0, use_cpu_fallback=False,
                   latency_max_lanes=0)
    off.warmup([("secp256k1", 128)])
    CspBatchVerifier(off, consenters=_identities(quorum))
    quorum = quorum[:85]

    def round_ms(csp):
        t = time.perf_counter()
        got = [f.result(60) for f in [csp.submit(q) for q in quorum]]
        ms = (time.perf_counter() - t) * 1e3
        if got != want:
            raise SystemExit("quorum round: verdicts differ")
        return ms

    round_ms(off)
    on_ms, off_ms = [], []
    ecdsa.reset_launches()
    for _ in range(9):
        on_ms.append(round_ms(live))
        off_ms.append(round_ms(off))
    seen = (dict(ecdsa.LAUNCHES_LATENCY), dict(ecdsa.LAUNCHES))
    live.close()
    off.close()
    if seen != ({"P-256": 0, "secp256k1": 9}, {"P-256": 0, "secp256k1": 9}):
        raise SystemExit(f"quorum timing: launches {seen}")
    on_ms.sort()
    off_ms.sort()
    out["quorum_on_ms"], out["quorum_off_ms"] = on_ms, off_ms
    log(f"quorum round, 85 secp256k1 votes, submit to verdict: tier on "
        f"median {on_ms[4]:.2f} ms (min {on_ms[0]:.2f}, max {on_ms[-1]:.2f}),"
        f" 9 K3 replays; latency_max_lanes=0 median {off_ms[4]:.2f} ms "
        f"(min {off_ms[0]:.2f}, max {off_ms[-1]:.2f}), 9 eager K1 launches")
    return out


def time_ed25519(checked, ed_csp, sm_clock_hz, dev) -> dict:
    """Phase 7d: K8 with CUDA events at 128, 2048 and 8192 lanes (phase
    3c's batches, tiled, verdicts checked), its bound and its plain
    twin's time (phase 3c)."""
    from bdls_tpu_torch.ops import ed25519 as ed

    ed_csp.close()
    base = checked[2048]
    out = {}
    for b in BUCKETS:
        idx = [i % len(base["rows"]) for i in range(b)]
        rows = [base["rows"][i] for i in idx]
        args = [torch.from_numpy(a.view(np.int32)).to(dev)
                for a in ed.lanes_to_limbs(rows)]
        ok = ed.verify_ed25519_cuda(*args).cpu().numpy()
        if not np.array_equal(ok, base["want"][idx]):
            raise SystemExit(f"K8 B={b}: verdicts differ")
        ms = cuda_ms(lambda: ed.verify_ed25519_cuda(*args),
                     10 if b <= 2048 else 5)
        bms, by = ed25519_bound_ms(rows, sm_clock_hz)
        out[b] = {"ms": ms, "verifies_per_s": b / ms * 1e3,
                  "bound_ms": bms, "bound_by": by, "bound_share": bms / ms}
        log(f"K8 B={b}: kernel {ms:.3f} ms ({b / ms * 1e3:,.0f} "
            f"verifies/s), bound {bms:.4f} ms ({by}, {bms / ms:.2%} of the "
            f"kernel time)"
            + (f", plain {checked[b]['plain_ms']:.0f} ms" if b in checked
               else ""))
    return out


# ------------------------------------------------------------ BLS12-381
# one 381-bit CIOS Montgomery product as 32-bit multiplies: 144 widening
# a·b products, 12 q = t0·n0 and 144 widening q·p products
MUL381 = 2 * 144 + 12 + 2 * 144
# The least work known for one certificate check, e(g1, sig)·e(-pk, H(m))
# == 1, in Fp products (m), with an Fp2 product 3m (Karatsuba) and an Fp2
# square 2m (complex squaring):
# - two optimal-ate Miller loops on the twist sharing f (a multi-pairing):
#   63 doubling steps, each one Fp12 square (2 Fp6 products, 12 Fp2
#   products) and per pairing a doubling with its line, 3 Fp2 products +
#   6 Fp2 squares + 4m, and a sparse product of f by the line, 13 Fp2
#   products; 5 addition steps, per pairing 11 Fp2 products + 2 Fp2
#   squares + 4m and the sparse product (Aranha, Karabina, Longa,
#   Gebotys, Lopez, "Faster explicit formulas for computing pairings over
#   ordinary curves", Eurocrypt 2011, sections 4-5);
# - one shared final exponentiation: the easy part, an Fp12 inverse (one
#   Fp inverse by Fermat, 608 products and squares, plus 100m through the
#   tower), 2 Fp12 products (18 Fp2 products each) and a p^2-Frobenius
#   (10m); the hard part, 5 exponentiations by x, each 63 cyclotomic
#   squares (6 Fp2 squares each, Karabina's compressed squaring) and 5
#   Fp12 products, then 10 Fp12 products and 3 Frobenius maps (15m each)
#   (the BLS12 chain of Hayashida, Hayasaka, Teruya, "Efficient final
#   exponentiation via cyclotomic structure for pairings over families of
#   elliptic curves", 2020).
M2, S2, F12_MUL = 3, 2, 18 * 3
MILLER_M = (63 * (12 * M2 + 2 * (3 * M2 + 6 * S2 + 4 + 13 * M2))
            + 5 * 2 * (11 * M2 + 2 * S2 + 4 + 13 * M2))
FINAL_M = (608 + 100 + 2 * F12_MUL + 10
           + 5 * (63 * 6 * S2 + 5 * F12_MUL) + 10 * F12_MUL + 3 * 15)
F12_BYTES = 12 * 12 * 4          # one FQ12 value, (12 words, 12 coefficients)
# the kernel's own work in 381-bit products (csrc/bls12.cuh), an FQ12
# product or Frobenius 144, a square 78: a Miller loop takes 63 steps of
# 5 squares and 14 products and 5 chord-and-add steps of 17 products; a
# final exponentiation takes the input product, the inverse (11
# Frobenius maps, 11 products, a Fermat inverse of 380 squares and 228
# products in Fp, 12 Fp products), the easy part (2 Frobenius, 2
# products), 5 powers by |x| (63 squares, 5 products each) and 15
# products or Frobenius maps and a square around them
K9_MILLER_PRODUCTS = 63 * (5 * 78 + 14 * 144) + 5 * 17 * 144
K9_FINAL_PRODUCTS = (144 + 22 * 144 + 380 + 228 + 12 + 4 * 144
                     + 5 * (63 * 78 + 5 * 144) + 15 * 144 + 78)
CERT_COMMITTEES = ((128, 85), (1024, 683))


def k9_bound_ms(kernel: str, lanes: int,
                sm_clock_hz: float) -> tuple[float, str]:
    """K9's bound at ``lanes`` certificates: the least-work multiplies
    (:data:`MILLER_M` for the Miller launch, :data:`FINAL_M` for the
    final launch) over the card's 32-bit multiply rate, against the
    bytes each launch must move once: the Miller launch reads the eight
    FQ12 coordinates and writes (n, d) of both pairs; the final launch
    reads those and writes the verdict byte."""
    m = MILLER_M if kernel == "miller" else FINAL_M
    t_ops = m * MUL381 * lanes / (SMS * IMUL_PER_CLK_PER_SM * sm_clock_hz)
    nbytes = (8 + 4) * F12_BYTES if kernel == "miller" else 4 * F12_BYTES + 1
    t_bytes = nbytes * lanes / PEAK_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def make_cert_inputs() -> dict:
    """The certificate lane's inputs, as ``tools/tpu_ablate.py:
    cert_sweep`` makes them: validator i's key is (i + 1)·G1, so a
    quorum's aggregate signature over H(d) is (q(q + 1)/2)·H(d). For the
    committees of 128 (quorum 85) and 1024 (quorum 683): a call of 2
    certificates over two rounds' digests, signed by the first 2t + 1
    validators; and a cross-round batch of 64 certificates (32 rounds of
    each committee) of which 2 are forged (the aggregate of a quorum
    with one vote counted twice). H(d) is computed once, through each
    aggregator's own cache."""
    from bdls_tpu_torch.consensus import threshold as TH
    from bdls_tpu_torch.ops import bls_host as B

    pks, pk = [], None
    for _ in range(max(n for n, _ in CERT_COMMITTEES)):
        pk = B.pt_add(pk, B.G1)
        pks.append(pk)
    out = {"batch": ([], [], [])}
    for n, q in CERT_COMMITTEES:
        agg = TH.ThresholdAggregator(pks[:n], q, max_pending=128)
        sk_sum = q * (q + 1) // 2 % B.R

        def cert(round_: int, forged: bool = False):
            d = hashlib.sha256(b"bdls committee %d round %d"
                               % (n, round_)).digest()
            k = sk_sum + 1 if forged else sk_sum
            return TH.QuorumCertificate(d, tuple(range(q)),
                                        B.pt_mul(k, agg._hm(d)))

        out[n] = {"agg": agg, "pair": [cert(0), cert(1)]}
        certs, aggs, want = out["batch"]
        for r in range(2, 34):
            forged = r == 9
            certs.append(cert(r, forged))
            aggs.append(agg)
            want.append(not forged)
    return out


def check_bls_kernel(cert_in, dev) -> dict:
    """Phase 3d: K9 on the card against its plain twin, stage for stage
    (the Miller launch's (n, d), the final launch's FE(n1·d2) and
    FE(n2·d1), the verdicts), and against the oracle's verdicts
    (``ThresholdAggregator.verify_certificate``) on 9 lanes: valid
    certificates of both committees, a wrong binding (another round's
    digest), the masked certificates (no signature, under quorum, a
    signer out of range) as ``certificate_lanes`` packs them, and two
    lanes fed to the kernel directly: the degenerate y = 0 "signature"
    and an all-zero lane."""
    from bdls_tpu_torch.consensus import threshold as TH
    from bdls_tpu_torch.ops import bls_host as B
    from bdls_tpu_torch.ops import bls_kernel as K

    a128, a1k = cert_in[128]["agg"], cert_in[1024]["agg"]
    c0, c1 = cert_in[128]["pair"]
    QC = TH.QuorumCertificate
    certs = [c0, c1, cert_in[1024]["pair"][0],
             QC(c1.digest, c0.signers, c0.agg_sig),
             QC(c0.digest, c0.signers, None),
             QC(c0.digest, c0.signers[:-1], c0.agg_sig),
             QC(c0.digest, c0.signers[:-1] + (200,), c0.agg_sig)]
    aggs = [a128, a128, a1k, a128, a128, a128, a128]
    t0 = time.perf_counter()
    want = [agg.verify_certificate(c) for c, agg in zip(certs, aggs)]
    oracle_s = time.perf_counter() - t0
    lanes, mask = TH.certificate_lanes(certs, aggs)
    extra = [(B.FQ12.scalar(1), B.FQ12.zero()),
             (B.FQ12.zero(), B.FQ12.zero())]
    g1, pk, hm = (K.pt_batch([B.G1] * 2),
                  K.pt_batch([a128._agg_pubkey(c0.signers)] * 2),
                  K.pt_batch([a128._hm(c0.digest)] * 2))
    direct = (g1, K.pt_batch(extra), pk, hm)
    arrs = [torch.from_numpy(np.concatenate([a, b], -1).view(np.int32))
            .to(dev) for pl, pd in zip(lanes, direct)
            for a, b in zip(pl, pd)]
    want += [False, False]
    mask += [True, True]
    q = [torch.cat([arrs[2], arrs[6]], -1), torch.cat([arrs[3], arrs[7]], -1)]
    p = [torch.cat([arrs[0], arrs[4]], -1), torch.cat([arrs[1], arrs[5]], -1)]
    n, d = K.miller_cuda(*q, *p)
    ok, fe = K.final_cuda(n, d)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pn, pd = K.miller_nd(*(K.f12_from_words(t) for t in (*q, *p)))
    torch.cuda.synchronize()
    plain_miller_ms = (time.perf_counter() - t0) * 1e3
    B_ = len(want)
    t0 = time.perf_counter()
    sides = K.f12_mul(pn, K.FP(torch.cat([pd.v[..., B_:], pd.v[..., :B_]],
                                         -1), pd.lb))
    pfe = K.final_exp_fast(sides)
    pok = K._compare_tail(K.FP(pfe.v[..., :B_], pfe.lb),
                          K.FP(pfe.v[..., B_:], pfe.lb))
    torch.cuda.synchronize()
    plain_final_ms = (time.perf_counter() - t0) * 1e3
    # the kernel interleaves lhs (2b) and rhs (2b + 1); the twin stacks
    order = [i // 2 + (B_ if i % 2 else 0) for i in range(2 * B_)]
    errs = {}
    for name, kern, plain in (("n", n, pn), ("d", d, pd),
                              ("fe", fe[..., np.argsort(order)], pfe)):
        kv = np.array(K.words_to_ints(kern), dtype=object)
        pv = np.array(K.f12_to_ints(plain), dtype=object)
        errs[name] = int(max(abs(int(x)) for x in (kv - pv).ravel()))
    raw, praw = ok.cpu().tolist(), pok.cpu().tolist()
    got = [bool(m) and r for m, r in zip(mask, raw)]
    log(f"K9 vs plain on {B_} lanes: raw verdicts {raw}, plain {praw}; "
        f"max |kernel - plain| of n, d, fe: {errs}; masked {got}; oracle "
        f"{want} ({oracle_s:.1f} s for 7 certificates); plain Miller "
        f"{plain_miller_ms:.0f} ms, plain final {plain_final_ms:.0f} ms")
    if raw != praw or any(errs.values()):
        raise SystemExit("K9 disagrees with its plain twin")
    if got != want or want != [True, True, True] + [False] * 6:
        raise SystemExit("K9 disagrees with the oracle")
    return {"lanes": B_, "args": arrs, "want_raw": raw,
            "max_abs_err": errs, "max_abs_err_verdict": 0,
            "plain_miller_ms": plain_miller_ms,
            "plain_final_ms": plain_final_ms, "oracle_s_7_certs": oracle_s}


def drive_cert_main_path(cert_in) -> tuple[dict, object]:
    """Phase 6e: the certificate lane through ``TorchCSP(device="cuda")
    .verify_certificates``: per committee (128 and 1024 validators) a
    call of 2 certificates, warmed once as ``cert_sweep`` warms them (the
    aggregated key and H(m) cached), then counted: the verdicts of
    construction, one launch of each K9 kernel, no other kernel, no host
    backend; then the cross-round batch of 64 certificates (2 forged) in
    one launch pair. Counts are set to 0 just before each call and read
    just after. Then 9 calls a committee by the host clock, beside the
    oracle's time (backend ``"host"``) on the same certificates."""
    from bdls_tpu_torch.crypto.torch_provider import TorchCSP
    from bdls_tpu_torch.ops import bls_kernel as K
    from bdls_tpu_torch.ops import ecdsa

    os.environ.pop("BDLS_CERT_BACKEND", None)
    csp = TorchCSP(device="cuda", use_cpu_fallback=False)
    out = {}

    def counted(certs, aggs, want, label):
        ecdsa.reset_launches()
        K.reset_launches()
        t0 = time.perf_counter()
        got = csp.verify_certificates(certs, aggs)
        ms = (time.perf_counter() - t0) * 1e3
        seen = (dict(K.LAUNCHES_BLS), dict(ecdsa.LAUNCHES),
                dict(ecdsa.LAUNCHES_PINNED), dict(ecdsa.LAUNCHES_LATENCY))
        log(f"certificates, {label}: {ms:.1f} ms, K9 launches {seen[0]}, "
            f"K1 {seen[1]}, K2 {seen[2]}, K3 {seen[3]}; "
            f"{sum(got)} of {len(got)} valid")
        if got != want:
            raise SystemExit(f"certificates {label}: verdicts differ")
        if seen[0] != {"miller": 1, "final": 1} or any(
                v for d_ in seen[1:] for v in d_.values()):
            raise SystemExit(f"certificates {label}: launches {seen}")
        return ms

    for n, q in CERT_COMMITTEES:
        certs = cert_in[n]["pair"]
        aggs = [cert_in[n]["agg"]] * len(certs)
        csp.verify_certificates(certs, aggs)            # warm
        first = counted(certs, aggs, [True, True],
                        f"{n} validators, 2 a call")
        runs = []
        for _ in range(9):
            t0 = time.perf_counter()
            if csp.verify_certificates(certs, aggs) != [True, True]:
                raise SystemExit("certificates: verdicts differ")
            runs.append((time.perf_counter() - t0) * 1e3)
        runs.sort()
        t0 = time.perf_counter()
        host = csp.verify_certificates(certs, aggs, backend="host")
        host_ms = (time.perf_counter() - t0) * 1e3
        if host != [True, True]:
            raise SystemExit("certificates: the oracle disagrees")
        log(f"certificates, {n} validators (quorum {q}), 2 a call: median "
            f"{runs[4]:.2f} ms (min {runs[0]:.2f}, max {runs[-1]:.2f}) over "
            f"9 calls; the oracle (backend host) {host_ms:.0f} ms")
        out[n] = {"quorum": q, "first_ms": first, "ms_runs": runs,
                  "median_ms": runs[4], "host_ms": host_ms,
                  "launches": {"miller": 1, "final": 1}}
    certs, aggs, want = cert_in["batch"]
    ms = counted(certs, aggs, want, f"cross-round batch of {len(certs)}")
    out["batch"] = {"certs": len(certs), "forged": want.count(False),
                    "ms": ms, "launches": {"miller": 1, "final": 1}}
    if csp._c_cert_host.value() != 2 * len(CERT_COMMITTEES):
        raise SystemExit("certificates: the host backend ran unasked")
    csp.close()
    return out


def time_bls(checked, sm_clock_hz, dev) -> dict:
    """Phase 7e: K9 with CUDA events at 1, 2, 16 and 128 lanes (phase
    3d's lanes, tiled, verdicts checked): the Miller launch over the 2B
    pairs and the final launch, each with its bound."""
    from bdls_tpu_torch.ops import bls_kernel as K

    base, want = checked["args"], checked["want_raw"]
    out = {}
    for b in (1, 2, 16, 128):
        idx = torch.tensor([i % len(want) for i in range(b)], device=dev)
        args = [a.index_select(-1, idx).contiguous() for a in base]
        ok = K.verify_bls_cuda(*args).cpu().tolist()
        if ok != [want[i % len(want)] for i in range(b)]:
            raise SystemExit(f"K9 B={b}: verdicts differ")
        q = [torch.cat([args[2], args[6]], -1),
             torch.cat([args[3], args[7]], -1)]
        p = [torch.cat([args[0], args[4]], -1),
             torch.cat([args[1], args[5]], -1)]
        n, d = K.miller_cuda(*q, *p)
        row = {"miller_ms": cuda_ms(lambda: K.miller_cuda(*q, *p), 3),
               "final_ms": cuda_ms(lambda: K.final_cuda(n, d), 3)}
        for k in ("miller", "final"):
            bms, by = k9_bound_ms(k, b, sm_clock_hz)
            row[f"{k}_bound_ms"], row[f"{k}_bound_by"] = bms, by
        row["ms"] = row["miller_ms"] + row["final_ms"]
        row["certs_per_s"] = b / row["ms"] * 1e3
        out[b] = row
        log(f"K9 B={b}: Miller {row['miller_ms']:.2f} ms (bound "
            f"{row['miller_bound_ms']:.5f} ms, {row['miller_bound_by']}), "
            f"final {row['final_ms']:.2f} ms (bound "
            f"{row['final_bound_ms']:.5f} ms), {row['certs_per_s']:.1f} "
            f"certificates/s")
    return out


# ------------------------------------------------- K4 and K5 (kernel fields)
# 32-bit multiplies of one modular product at the least work known, for
# K5's bound: a schoolbook 256 x 256-bit product and a Montgomery
# reduction (the moduli of the check include the orders n, which have no
# special form)
K5_PRODUCT_MULS = MUL + RED_N
K5_PRODUCTS = 65536


def lane_args(lanes, dev) -> list:
    from bdls_tpu_torch.crypto import vectors
    from bdls_tpu_torch.crypto.marshal import ints_to_limbs

    return [torch.from_numpy(ints_to_limbs(c).view(np.int32)).to(dev)
            for c in vectors.columns(lanes)]


def launch_counts() -> dict:
    """Every kernel's launch count, keyed by kernel and build."""
    from bdls_tpu_torch.ops import block_verify, ecdsa
    from bdls_tpu_torch.ops import ed25519 as ed

    return {"K1": dict(ecdsa.LAUNCHES), "K1+K5": dict(ecdsa.LAUNCHES_MXU),
            "K2": dict(ecdsa.LAUNCHES_PINNED),
            "K2+K5": dict(ecdsa.LAUNCHES_PINNED_MXU),
            "K3": dict(ecdsa.LAUNCHES_LATENCY),
            "K3+K5": dict(ecdsa.LAUNCHES_LATENCY_MXU),
            "K4": dict(ecdsa.LAUNCHES_MONT16),
            "K7": dict(block_verify.LAUNCHES_BLOCK),
            "K7+K5": dict(block_verify.LAUNCHES_BLOCK_MXU),
            "K8": dict(ed.LAUNCHES_ED25519),
            "K8+K5": dict(ed.LAUNCHES_ED25519_MXU)}


def nonzero_counts() -> dict:
    return {k: {c: v for c, v in d.items() if v}
            for k, d in launch_counts().items() if any(d.values())}


def check_mont16_kernel(batch, truth, dev) -> dict:
    """Phase 3e: K4 against its plain twin on the card and the integer
    ECDSA, lane for lane, at the main buckets (128 secp256k1 lanes, two
    blocks; 2048 P-256 lanes, 32 blocks): phase 3's lanes, the hostile
    set (r or s of 0, n or 2^256 - 1, Q off the curve or (0, 0), the
    forged r + n lane, tampered digests) filled up with the main path's
    requests."""
    from bdls_tpu_torch.ops import ecdsa
    from bdls_tpu_torch.ops.curves import CURVES

    out = {}
    for curve_name, cv in CURVES.items():
        lanes, want = batch[curve_name], truth[curve_name]
        if not any(ln[5] == "s = n" for ln in lanes):
            raise SystemExit("phase 3e: the s = n lane is missing")
        args = lane_args(lanes, dev)
        kern = ecdsa.verify_mont16_cuda(cv, *args).cpu().numpy()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plain = ecdsa.verify_kernel(cv, *args).cpu().numpy()
        plain_ms = (time.perf_counter() - t0) * 1e3
        diff = np.abs(kern.astype(np.int64) - plain.astype(np.int64))
        bad = [lanes[i][5] for i in np.flatnonzero(diff)]
        log(f"{curve_name}: K4 vs plain on {len(lanes)} lanes "
            f"({-(-len(lanes) // ecdsa.THREADS)} blocks): {int(diff.sum())} "
            f"differ {bad}; valid {int(kern.sum())}; plain {plain_ms:.0f} ms")
        if diff.any():
            raise SystemExit(f"{curve_name}: K4 disagrees with its plain twin")
        if not np.array_equal(kern, want):
            raise SystemExit(f"{curve_name}: K4 disagrees with SwCSP")
        out[curve_name] = {"max_abs_err": int(diff.max()),
                           "plain_ms": plain_ms, "lanes": len(lanes)}
    return out


def _words(xs) -> np.ndarray:
    return np.array([[(x >> (32 * i)) & 0xFFFFFFFF for i in range(8)]
                     for x in xs], np.uint32)


def _field_mul(engine: str, mod: int, a, b):
    from bdls_tpu_torch.ops import _build

    out = torch.empty_like(a)
    _build.check(_build.lib(engine).bdls_field_mul(
        mod, a.data_ptr(), b.data_ptr(), out.data_ptr(), a.shape[0],
        torch.cuda.current_stream().cuda_stream), "bdls_field_mul")
    return out


def check_mxu(batch, truth, pinned, checked, ed_checked, rng, dev) -> dict:
    """Phase 3f: K5's product (the mxu builds' mont_mul) against the CIOS
    mont_mul and Python integers, bit for bit, on the five moduli at edge
    values and 4096 seeded pairs each; then each mxu build against its
    vpu kernel on the inputs of phases 3 (K1), 4 (K2), 4b (K7, lane for
    lane and tx for tx) and 3c (K8), and each plain twin under the "mxu"
    engine timed for the record."""
    from bdls_tpu_torch.ops import block_verify as bv
    from bdls_tpu_torch.ops import ecdsa, fold
    from bdls_tpu_torch.ops import ed25519 as ed
    from bdls_tpu_torch.ops.curves import CURVES, ED25519, EDWARDS_CURVES
    from bdls_tpu_torch.ops.verify_fold import verify_fold, \
        verify_fold_pinned

    out = {"product": {}}
    R = 1 << 256
    mods = [CURVES["P-256"].fp, CURVES["P-256"].fn, CURVES["secp256k1"].fp,
            CURVES["secp256k1"].fn, EDWARDS_CURVES["ed25519"].fp]
    names = ["P-256 p", "P-256 n", "secp256k1 p", "secp256k1 n",
             "2^255 - 19"]
    for i, (ctx, name) in enumerate(zip(mods, names)):
        m = ctx.modulus
        edge = [0, 1, 2, m - 1, m - 2, m, m + 1, R - 1, R - 2, 1 << 255,
                (1 << 224) - 1, R - m]
        xs = edge + [int.from_bytes(rng.bytes(32), "big")
                     for _ in range(4096)]
        ys = [v % m for v in edge[::-1]] + [
            int.from_bytes(rng.bytes(32), "big") % m for _ in range(4096)]
        a = torch.from_numpy(_words(xs).view(np.int32)).to(dev)
        b = torch.from_numpy(_words(ys).view(np.int32)).to(dev)
        cios = _field_mul("vpu", i, a, b).cpu().numpy().view(np.uint32)
        mma = _field_mul("mxu", i, a, b).cpu().numpy().view(np.uint32)
        got = [sum(int(r[k]) << (32 * k) for k in range(8)) for r in mma]
        want = [x * y * pow(R, -1, m) % m for x, y in zip(xs, ys)]
        ndiff = int((cios != mma).any(axis=1).sum())
        nbad = sum(g != w for g, w in zip(got, want))
        log(f"K5 product mod {name}: {len(xs)} pairs, {ndiff} differ from "
            f"the CIOS product, {nbad} from the integers")
        if ndiff or nbad:
            raise SystemExit(f"K5 product mod {name}: disagrees")
        out["product"][name] = {"pairs": len(xs), "max_abs_err": 0}

    def compare(what, kern, vpu, want=None):
        diff = np.abs(kern.astype(np.int64) - vpu.astype(np.int64))
        if diff.any() or (want is not None and not np.array_equal(kern,
                                                                  want)):
            raise SystemExit(f"{what}: the mxu build disagrees")
        return int(diff.max())

    def plain_ms(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with fold.mul_backend("mxu"):
            res = fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3, res

    for curve_name, cv in CURVES.items():
        args = lane_args(batch[curve_name], dev)
        kern = ecdsa.verify_fold_cuda(cv, *args, engine="mxu").cpu().numpy()
        vpu = ecdsa.verify_fold_cuda(cv, *args).cpu().numpy()
        ms, plain = plain_ms(lambda: verify_fold(cv, *args))
        err = compare(f"{curve_name} K1", kern, vpu, truth[curve_name])
        compare(f"{curve_name} K1 plain", plain.cpu().numpy(), kern)
        out[f"K1 {curve_name}"] = {"max_abs_err": err, "plain_ms": ms,
                                   "lanes": len(args[0][0])}
        res = pinned[curve_name]
        pargs = _pinned_args(res["lanes"], res["slots"], dev)
        kern = ecdsa.verify_pinned_cuda(cv, *pargs, res["pools"],
                                        engine="mxu").cpu().numpy()
        vpu = ecdsa.verify_pinned_cuda(cv, *pargs,
                                       res["pools"]).cpu().numpy()
        ms, plain = plain_ms(lambda: verify_fold_pinned(cv, *pargs,
                                                        res["pools"]))
        err = compare(f"{curve_name} K2", kern, vpu, res["want"])
        compare(f"{curve_name} K2 plain", plain.cpu().numpy(), kern)
        out[f"K2 {curve_name}"] = {"max_abs_err": err, "plain_ms": ms,
                                   "lanes": len(res["lanes"])}
        ts = checked[curve_name]["ts"]
        kf, kv = bv.verify_block_cuda(cv, *ts, engine="mxu")
        vf_, vv = bv.verify_block_cuda(cv, *ts)
        ms, (pf, pv) = plain_ms(lambda: bv.block_kernel(cv, *ts))
        err = max(compare(f"{curve_name} K7 lanes", kv.cpu().numpy(),
                          vv.cpu().numpy()),
                  compare(f"{curve_name} K7 txs", kf.cpu().numpy(),
                          vf_.cpu().numpy()))
        compare(f"{curve_name} K7 plain", pf.cpu().numpy(), kf.cpu().numpy())
        out[f"K7 {curve_name}"] = {"max_abs_err": err, "plain_ms": ms,
                                   "shape": checked[curve_name]["shape"]}
        log(f"{curve_name}: K1, K2 and K7 mxu builds equal their vpu "
            f"kernels and plain twins (plain under mxu: K1 "
            f"{out[f'K1 {curve_name}']['plain_ms']:.0f} ms, K2 "
            f"{out[f'K2 {curve_name}']['plain_ms']:.0f} ms, K7 "
            f"{out[f'K7 {curve_name}']['plain_ms']:.0f} ms)")
    for b in (128, 2048):
        c = ed_checked[b]
        eargs = [torch.from_numpy(x.view(np.int32)).to(dev)
                 for x in ed.lanes_to_limbs(c["rows"])]
        kern = ed.verify_ed25519_cuda(*eargs, engine="mxu").cpu().numpy()
        vpu = ed.verify_ed25519_cuda(*eargs).cpu().numpy()
        ms, plain = plain_ms(lambda: ed.verify_ed25519(ED25519, *eargs))
        err = compare(f"K8 B={b}", kern, vpu, c["want"])
        compare(f"K8 B={b} plain", plain.cpu().numpy(), kern)
        out[f"K8 {b}"] = {"max_abs_err": err, "plain_ms": ms}
        log(f"ed25519 B={b}: K8 mxu build equals its vpu kernel and plain "
            f"twin (plain under mxu {ms:.0f} ms)")
    return out


def drive_field_main_path(field, votes, vote_ok, block, block_ok, pin, blk,
                          ed_in) -> dict:
    """Phases 5b (``kernel_field="mont16"``) and 5c (``"mxu"``): the main
    path through ``TorchCSP(device="cuda", kernel_field=field)``. Each run
    sets every count to 0 just before and reads them just after, and must
    launch exactly the kernels the field names:

    - the 128-vote secp256k1 round (``submit`` + ``flush``, key cache
      off): mont16 counts a cold fallback and launches K4 once; mxu
      replays K3 over K1 + K5 once;
    - the 2000-lane P-256 batch: one K4, or one K1 + K5;
    - the vote round through ``CspBatchVerifier`` with 128 consenters
      pinned (one new key): K2 (mont16) or K2 + K5 (mxu) for 127 lanes,
      K4 or K1 + K5 for the new key; the pinned block batch, one K2 or
      K2 + K5 launch;
    - ``verify_block`` of the 1000-tx block: one K7 (mont16 runs the fold
      program's) or K7 + K5; mxu adds the secp256k1 block and the
      85-vote Ed25519 round (one K8 + K5 launch)."""
    from bdls_tpu_torch.consensus.verifier import CspBatchVerifier, \
        identity_keys
    from bdls_tpu_torch.crypto import blocklane
    from bdls_tpu_torch.crypto.sw import SwCSP
    from bdls_tpu_torch.crypto.torch_provider import TorchCSP
    from bdls_tpu_torch.ops import ecdsa
    from bdls_tpu_torch.ops.curves import CURVES

    mx = field == "mxu"
    gen = "K1+K5" if mx else "K4"
    pin_k = "K2+K5" if mx else "K2"
    out = {}

    def run(what, fn, want, expect):
        ecdsa.reset_launches()
        t = time.perf_counter()
        got = fn()
        ms = (time.perf_counter() - t) * 1e3
        seen = nonzero_counts()
        log(f"[{field}] {what}: {ms:.2f} ms, launches {seen}")
        if got != want:
            raise SystemExit(f"[{field}] {what}: verdicts differ")
        if seen != expect:
            raise SystemExit(f"[{field}] {what}: launches {seen}, want "
                             f"{expect}")
        out[what] = {"ms": ms, "launches": seen}
        return seen

    csp = TorchCSP(device="cuda", key_cache_size=0, use_cpu_fallback=False,
                   flush_interval=1.0, kernel_field=field)
    csp.warmup([(c, b) for c in CURVES for b in BUCKETS])
    cold = csp.stats["latency_cold_fallbacks"]

    def vote_round():
        futs = [csp.submit(v) for v in votes]
        csp.flush()
        return [f.result(60) for f in futs]

    run("vote round, 128 secp256k1 lanes", vote_round, vote_ok,
        {"K3+K5": {"secp256k1": 1}} if mx else {"K4": {"secp256k1": 1}})
    cold = csp.stats["latency_cold_fallbacks"] - cold
    if cold != (0 if mx else 1):
        raise SystemExit(f"[{field}] vote round: {cold} cold fallbacks")
    run("block batch, 2000 P-256 lanes", lambda: csp.verify_batch(block),
        block_ok, {gen: {"P-256": 1}})
    if csp.stats["fallbacks"]:
        raise SystemExit(f"[{field}] fallbacks {csp.stats}")
    csp.close()
    out["cold_fallbacks"] = cold

    csp = TorchCSP(device="cuda", use_cpu_fallback=False, flush_interval=1.0,
                   kernel_field=field)
    csp.warmup([("secp256k1", 128), ("P-256", 2048)])
    verifier = CspBatchVerifier(csp, consenters=pin["idents"])
    csp.warm_keys(identity_keys(pin["idents"]), wait=True)
    csp.warm_keys(pin["endorsers"], wait=True)
    before = csp.stats["pinned_lanes"]
    run("vote round through the seam, 128 envelopes, one new key",
        lambda: verifier.verify_envelopes(pin["envs"]), pin["env_ok"],
        {pin_k: {"secp256k1": 1}, gen: {"secp256k1": 1}})
    if csp.stats["pinned_lanes"] - before != 127:
        raise SystemExit(f"[{field}] pinned lanes {csp.stats}")
    run("pinned block batch, 2000 lanes from 16 endorsers",
        lambda: csp.verify_batch(pin["block"]), pin["block_ok"],
        {pin_k: {"P-256": 1}})
    sw = SwCSP()
    host = blocklane.verify_block_host(sw.verify_batch, blk["main"]).tolist()
    run("verify_block, the 1000-tx block",
        lambda: csp.verify_block(blk["main"]).tolist(), host,
        {"K7+K5" if mx else "K7": {"P-256": 1}})
    if mx:
        host = blocklane.verify_block_host(sw.verify_batch,
                                           blk["secp256k1"]).tolist()
        run("verify_block, the 50-tx secp256k1 block",
            lambda: csp.verify_block(blk["secp256k1"]).tolist(), host,
            {"K7+K5": {"secp256k1": 1}})
        reqs, oks = ed_in[128]
        csp.warmup([("ed25519", 128)])

        def ed_round():
            futs = [csp.submit(q) for q in reqs]
            csp.flush()
            return [f.result(60) for f in futs]

        run("Ed25519 round, 85 votes of 128", ed_round, oks,
            {"K8+K5": {"ed25519": 1}})
    if csp.stats["fallbacks"] or csp.stats["kernel"] != field:
        raise SystemExit(f"[{field}] stats {csp.stats}")
    csp.close()
    return out


def time_k4k5(batch, truth, pinned, checked, ed_checked, blk_packed,
              sm_clock_hz, dev) -> dict:
    """Phase 7f: K4 and each mxu build with CUDA events at 128, 2048 and
    8192 lanes (phase 3's, 4's and 3c's batches tiled, verdicts checked),
    a K3 replay over K1 + K5 at 128 secp256k1 lanes, K7 + K5 at the main
    block shape, each beside its bound from
    :func:`needed_muls`, :func:`needed_muls_pinned`,
    :func:`needed_muls_ed25519` and :func:`block_bound_ms` (the least
    work of the function, whatever computes it); and K5's product alone:
    the mxu and CIOS ``bdls_field_mul`` over 65,536 products mod the
    P-256 order, its plain twin (``fold.mul`` under "mxu") and one
    ``torch.matmul`` in float64 of the plain twin's contraction (the
    0/1 selector by the outer products) on the same operands."""
    from bdls_tpu_torch.crypto import vectors
    from bdls_tpu_torch.crypto.marshal import ints_to_limbs
    from bdls_tpu_torch.ops import block_verify as bv
    from bdls_tpu_torch.ops import ecdsa, fold, mxu
    from bdls_tpu_torch.ops import ed25519 as ed
    from bdls_tpu_torch.ops.curves import CURVES

    out = {}
    for curve_name, cv in CURVES.items():
        lanes, want = batch[curve_name], truth[curve_name]
        res = pinned[curve_name]
        rse = [(ln[2], ln[3], int.from_bytes(ln[4], "big"))
               for ln in res["lanes"]]
        for b in BUCKETS:
            idx = [i % len(lanes) for i in range(b)]
            tiled = [lanes[i] for i in idx]
            args = lane_args(tiled, dev)
            reps = 10 if b <= 2048 else 5
            bms, by = bound_ms(cv, tiled, sm_clock_hz)
            for kern, fn in (
                    ("K4", lambda: ecdsa.verify_mont16_cuda(cv, *args)),
                    ("K1+K5", lambda: ecdsa.verify_fold_cuda(
                        cv, *args, engine="mxu"))):
                if not np.array_equal(fn().cpu().numpy(), want[idx]):
                    raise SystemExit(f"{kern} {curve_name} B={b}: verdicts "
                                     f"differ")
                ms = cuda_ms(fn, reps)
                out.setdefault(f"{kern} {curve_name}", {})[b] = {
                    "ms": ms, "verifies_per_s": b / ms * 1e3,
                    "bound_ms": bms, "bound_by": by, "bound_share": bms / ms}
                log(f"{kern} {curve_name} B={b}: kernel {ms:.3f} ms, bound "
                    f"{bms:.4f} ms ({by}, {bms / ms:.2%})")
            if curve_name == "secp256k1" and b == 128:
                # K3 over K1 + K5: a captured slot's replay (copies
                # included), as the vote round launches it
                slot = ecdsa.LatencySlot(cv, b, device=dev, field="mxu",
                                         stream=torch.cuda.current_stream())
                slot.stage([ints_to_limbs(c)
                            for c in vectors.columns(tiled)])
                slot.launch().synchronize()
                if not np.array_equal(slot.verdict(), want[idx]):
                    raise SystemExit("K3+K5: verdicts differ")
                ms = cuda_ms(slot.launch, reps)
                out["K3+K5 secp256k1"] = {b: {
                    "ms": ms, "verifies_per_s": b / ms * 1e3,
                    "bound_ms": bms, "bound_by": by, "bound_share": bms / ms}}
                log(f"K3+K5 secp256k1 B={b}: replay {ms:.3f} ms, bound "
                    f"{bms:.4f} ms ({by})")
            pidx = [i % len(res["lanes"]) for i in range(b)]
            pargs = _pinned_args([res["lanes"][i] for i in pidx],
                                 [res["slots"][i] for i in pidx], dev)

            def k2():
                return ecdsa.verify_pinned_cuda(cv, *pargs, res["pools"],
                                                engine="mxu")

            if not np.array_equal(k2().cpu().numpy(), res["want"][pidx]):
                raise SystemExit(f"K2+K5 {curve_name} B={b}: verdicts differ")
            ms = cuda_ms(k2, reps)
            bms, by = pinned_bound_ms(cv, [rse[i] for i in pidx],
                                      [res["slots"][i] for i in pidx],
                                      sm_clock_hz)
            out.setdefault(f"K2+K5 {curve_name}", {})[b] = {
                "ms": ms, "verifies_per_s": b / ms * 1e3, "bound_ms": bms,
                "bound_by": by, "bound_share": bms / ms}
            log(f"K2+K5 {curve_name} B={b}: kernel {ms:.3f} ms, bound "
                f"{bms:.4f} ms ({by}, {bms / ms:.2%})")
    cv = CURVES["P-256"]
    ts = packed_on(blk_packed, dev)
    ms = cuda_ms(lambda: bv.verify_block_cuda(cv, *ts, engine="mxu"), 5)
    bms, by = block_bound_ms(cv, blk_packed, sm_clock_hz)
    out["K7+K5 P-256"] = {"ms": ms, "bound_ms": bms, "bound_by": by,
                          "shape": checked["P-256"]["shape"]}
    log(f"K7+K5 P-256 at the main block shape: kernel {ms:.3f} ms, bound "
        f"{bms:.4f} ms ({by})")
    base = ed_checked[2048]
    for b in BUCKETS:
        idx = [i % len(base["rows"]) for i in range(b)]
        rows = [base["rows"][i] for i in idx]
        eargs = [torch.from_numpy(a.view(np.int32)).to(dev)
                 for a in ed.lanes_to_limbs(rows)]

        def k8():
            return ed.verify_ed25519_cuda(*eargs, engine="mxu")

        if not np.array_equal(k8().cpu().numpy(), base["want"][idx]):
            raise SystemExit(f"K8+K5 B={b}: verdicts differ")
        ms = cuda_ms(k8, 5 if b <= 2048 else 3)
        bms, by = ed25519_bound_ms(rows, sm_clock_hz)
        out.setdefault("K8+K5", {})[b] = {
            "ms": ms, "verifies_per_s": b / ms * 1e3, "bound_ms": bms,
            "bound_by": by, "bound_share": bms / ms}
        log(f"K8+K5 B={b}: kernel {ms:.3f} ms, bound {bms:.4f} ms ({by})")

    # K5's product alone, mod the P-256 order
    ctx = CURVES["P-256"].fn
    m, n = ctx.modulus, K5_PRODUCTS
    rng = np.random.default_rng(SEED + 6)
    xs = [int.from_bytes(rng.bytes(32), "big") % m for _ in range(n)]
    ys = [int.from_bytes(rng.bytes(32), "big") % m for _ in range(n)]
    a = torch.from_numpy(_words(xs).view(np.int32)).to(dev)
    b = torch.from_numpy(_words(ys).view(np.int32)).to(dev)
    mxu_ms = cuda_ms(lambda: _field_mul("mxu", 1, a, b), 10)
    cios_ms = cuda_ms(lambda: _field_mul("vpu", 1, a, b), 10)
    fa = fold.from_limbs16(lane_args([(x, 0, 0, 0, b"", "")
                                      for x in xs], dev)[0])
    fb = fold.from_limbs16(lane_args([(y, 0, 0, 0, b"", "")
                                      for y in ys], dev)[0])
    fctx = fold.fold_ctx(m)
    with fold.mul_backend("mxu"):
        fold.mul(fctx, fa, fb)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fold.mul(fctx, fa, fb)
        torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    diag, outer = mxu.digit_operands(fa, fb)
    lib_ms = cuda_ms(lambda: torch.matmul(diag, outer), 10)
    t_ops = n * K5_PRODUCT_MULS / (SMS * IMUL_PER_CLK_PER_SM * sm_clock_hz)
    t_bytes = 3 * 32 * n / PEAK_BYTES_PER_S
    bms = max(t_ops, t_bytes) * 1e3
    by = "operations" if t_ops >= t_bytes else "bytes"
    out["K5 product"] = {"ms": mxu_ms, "cios_ms": cios_ms,
                         "plain_ms": plain_ms, "library_ms": lib_ms,
                         "bound_ms": bms, "bound_by": by, "products": n}
    log(f"K5 product, {n} Montgomery products mod the P-256 order: mxu "
        f"{mxu_ms:.3f} ms, CIOS {cios_ms:.3f} ms, bound {bms:.5f} ms ({by}); "
        f"plain twin (fold.mul under mxu) {plain_ms:.1f} ms; torch.matmul "
        f"float64 of its contraction ({tuple(diag.shape)} x "
        f"{tuple(outer.shape)}) {lib_ms:.3f} ms")
    return out


def main() -> int:
    # ---- 1. the card ---------------------------------------------------
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    card = smi("name,power.limit")
    log(card)
    sm_clock_hz = float(smi("clocks.max.sm").split()[0]) * 1e6
    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} devices {torch.cuda.device_count()} "
        f"max SM clock {sm_clock_hz / 1e6:.0f} MHz")

    from bdls_tpu_torch.crypto import vectors
    from bdls_tpu_torch.crypto.csp import PublicKey, VerifyRequest
    from bdls_tpu_torch.crypto.marshal import ints_to_limbs
    from bdls_tpu_torch.crypto.sw import SwCSP
    from bdls_tpu_torch.crypto.torch_provider import TorchCSP
    from bdls_tpu_torch.ops import _build, ecdsa
    from bdls_tpu_torch.ops.curves import CURVES
    from bdls_tpu_torch.ops.verify_fold import verify_fold

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    names = {"P-256": "verify_kernel<CurveP256>",
             "secp256k1": "verify_kernel<CurveK256>"}
    pnames = {"P-256": "pinned_kernel<CurveP256>",
              "secp256k1": "pinned_kernel<CurveK256>"}
    bnames = {"P-256": "block_lane_kernel<CurveP256>",
              "secp256k1": "block_lane_kernel<CurveK256>"}
    mnames = {"P-256": "mont16_kernel<CurveP256>",
              "secp256k1": "mont16_kernel<CurveK256>"}

    # ---- 2. build --------------------------------------------------------
    info = _build.build(force=True)
    log(f"build: nvcc {info['seconds']:.1f} s (one compiler a source, side "
        f"by side) -> {sorted(info['paths'].values())}")
    regs = {}
    for key, report in info["ptxas"].items():
        cur = entry = None
        build = " [mxu]" if key.endswith(":mxu") else ""
        for line in report.splitlines():
            if "Function properties for" in line:
                # a frame line follows: the kernel's, or a called
                # function's (K5's mont_mul_mma), which is not recorded
                active = entry is not None and line.rstrip().endswith(entry)
            elif "Compiling entry" in line:
                entry = line.split("'")[1]
                active = True
                table = (names if "verify_kernel" in line else
                         pnames if "pinned_kernel" in line else
                         mnames if "mont16_kernel" in line else bnames)
                cur = (table["P-256"] if "CurveP256" in line else
                       table["secp256k1"] if "CurveK256" in line else
                       "sha256_kernel" if "sha256_kernel" in line else
                       "block_tally_kernel" if "block_tally" in line else
                       "ed25519_kernel" if "ed25519_kernel" in line else
                       "bls_miller_kernel" if "bls_miller_kernel" in line
                       else "bls_final_kernel" if "bls_final_kernel" in line
                       else None)
                cur = cur and cur + build
            elif cur and active and re.search(r"Used \d+ registers|spill",
                                              line):
                regs.setdefault(cur, []).append(line.strip())
    for kern, lines in sorted(regs.items()):
        log(f"ptxas {kern}: " + " | ".join(lines))
    _build.lib()

    def limbs(lanes):
        return [torch.from_numpy(ints_to_limbs(c).view(np.int32)).to(dev)
                for c in vectors.columns(lanes)]

    # ---- the main path's requests (pure-Python ECDSA, seeded) ----------
    sw = SwCSP()
    t0 = time.perf_counter()
    round_digest = sw.hash(b"bdls round 7 height 42")
    votes, vote_ok = [], []
    for v in range(128):
        key = sw.key_gen("secp256k1", rng)
        # two Byzantine validators sign another message
        forged = v % 61 == 7
        r, s = sw.sign(key, sw.hash(b"other round") if forged
                       else round_digest)
        votes.append(VerifyRequest(key.public_key(), round_digest, r, s))
        vote_ok.append(not forged)
    endorsers = [sw.key_gen("P-256", rng) for _ in range(64)]
    block, block_ok = [], []
    for tx in range(1000):
        digest = sw.hash(b"tx-%d" % tx + rng.bytes(16))
        for j in range(2):
            key = endorsers[(2 * tx + j) % len(endorsers)]
            r, s = sw.sign(key, digest)
            tampered = tx % 97 == 5 and j == 1
            d = sw.hash(b"forged") if tampered else digest
            block.append(VerifyRequest(key.public_key(), d, r, s))
            block_ok.append(not tampered)
    log(f"signed 128 votes + 2000 endorsements in "
        f"{time.perf_counter() - t0:.1f} s (pure-Python ECDSA)")
    t0 = time.perf_counter()
    pinned_in = make_pinned_inputs(sw, rng)
    log(f"signed 128 consensus envelopes + 2000 endorsements by 16 "
        f"endorsers in {time.perf_counter() - t0:.1f} s")

    # ---- 3. kernel vs plain vs the integer ECDSA, at the main buckets ---
    # each curve's batch: valid, tampered and hostile lanes, filled up to
    # the main path's bucket with the main path's own requests
    fill = {"secp256k1": (votes, vote_ok), "P-256": (block, block_ok)}
    batch, truth, results = {}, {}, {}
    for curve_name, cv in CURVES.items():
        mixed = vectors.mixed_lanes(curve_name, rng)
        reqs, oks = fill[curve_name]
        k = MAIN_BUCKET[curve_name] - len(mixed)
        idx = [i % len(reqs) for i in range(k)]
        lanes = mixed + [(q.key.x, q.key.y, q.r, q.s, q.digest, "main path")
                         for q in (reqs[i] for i in idx)]
        want = np.array(vectors.expected(curve_name, mixed)
                        + [oks[i] for i in idx])
        args = limbs(lanes)
        kern = ecdsa.verify_fold_cuda(cv, *args).cpu().numpy()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plain = verify_fold(cv, *args).cpu().numpy()
        plain_ms = (time.perf_counter() - t0) * 1e3
        diff = np.abs(kern.astype(np.int64) - plain.astype(np.int64))
        bad = [lanes[i][5] for i in np.flatnonzero(diff)]
        log(f"{curve_name}: kernel vs plain on {len(lanes)} lanes "
            f"({len(mixed)} mixed): {int(diff.sum())} differ {bad}; "
            f"valid {int(kern.sum())}; plain {plain_ms:.0f} ms")
        if diff.any():
            raise SystemExit(f"{curve_name}: kernel disagrees with plain")
        if not np.array_equal(kern, want):
            raise SystemExit(f"{curve_name}: kernel disagrees with SwCSP")
        batch[curve_name], truth[curve_name] = lanes, want
        results[curve_name] = {"max_abs_err": int(diff.max()),
                               "lanes_checked": len(lanes),
                               "plain_ms": plain_ms}

    # ---- 4. K2 vs plain vs the integer ECDSA, at the main buckets ------
    pinned = check_pinned_kernel(pinned_in, rng, dev)

    # ---- 4b. K6 and K7 vs plain, hashlib and the host oracle -----------
    t0 = time.perf_counter()
    blk = make_block_inputs(rng)
    log(f"signed the block lane's {sum(len(r.lanes) for r in blk.values())} "
        f"endorsements in {time.perf_counter() - t0:.1f} s")
    checked = check_block_kernels(blk, dev)

    # ---- 3c. K8 vs plain vs the RFC 8032 oracle, at 128 and 2048 -------
    t0 = time.perf_counter()
    ed_in = make_ed25519_inputs(rng)
    log(f"signed 85 + 683 Ed25519 votes in {time.perf_counter() - t0:.1f} s")
    ed_checked = check_ed25519_kernel(ed_in, rng, dev)

    # ---- 3d. K9 vs plain vs the oracle, stage for stage, on 9 lanes ----
    t0 = time.perf_counter()
    cert_in = make_cert_inputs()
    log(f"made the committees of 128 and 1024 BLS keys and 68 quorum "
        f"certificates in {time.perf_counter() - t0:.1f} s")
    bls_checked = check_bls_kernel(cert_in, dev)

    # ---- 3e. K4 vs plain vs the integer ECDSA, at the main buckets -----
    k4_checked = check_mont16_kernel(batch, truth, dev)

    # ---- 3f. K5's product vs CIOS; each mxu build vs its vpu kernel ----
    mxu_checked = check_mxu(batch, truth, pinned, checked, ed_checked, rng,
                            dev)

    # ---- 5. the K1 main path ----------------------------------------------
    # a flush window far longer than the 128 submits take: the round
    # goes out as one launch, at the explicit flush(); the latency tier
    # off, so the vote round is K1's eager launch (phase 6d drives K3)
    csp = TorchCSP(device="cuda", key_cache_size=0, use_cpu_fallback=False,
                   flush_interval=1.0, latency_max_lanes=0)
    csp.warmup([(c, b) for c in CURVES for b in BUCKETS])
    ecdsa.reset_launches()
    t0 = time.perf_counter()
    futs = [csp.submit(v) for v in votes]
    csp.flush()
    got_votes = [f.result(60) for f in futs]
    vote_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    got = csp.verify_batch(block)
    block_s = time.perf_counter() - t0
    launches = dict(ecdsa.LAUNCHES)
    stats = csp.stats
    log(f"main path: vote round 128 lanes {vote_s * 1e3:.2f} ms, "
        f"block batch 2000 lanes {block_s * 1e3:.2f} ms, "
        f"launches {launches}, stats {stats}")
    if got_votes != vote_ok:
        raise SystemExit("vote round: verdicts differ from construction")
    if got != block_ok:
        raise SystemExit("block batch: verdicts differ from construction")
    if stats["fallbacks"] != 0 or stats["batches"] <= 0:
        raise SystemExit(f"main path: bad stats {stats}")
    if launches != {"P-256": 1, "secp256k1": 1}:
        raise SystemExit(f"main path: launches {launches}, want 1 each")
    if any(ecdsa.LAUNCHES_PINNED.values()):
        raise SystemExit("K1 main path: the pinned kernel ran without a "
                         "key cache")

    # ---- 6. the K2 main path ---------------------------------------------
    pinned_main, live = drive_pinned_main_path(pinned_in)

    # ---- 6b. the block lane (K7), and K6's own path ------------------------
    block_main, block_csp = drive_block_main_path(blk)

    # ---- 6c. the Ed25519 vote path (K8) -----------------------------------
    ed_main, ed_csp = drive_ed25519_main_path(ed_in)

    # ---- 6d. the latency tier (K3) and the ring repro --------------------
    lat_main, lat_csp = drive_latency_main_path(votes, vote_ok)

    # ---- 6e. the certificate lane (K9) -------------------------------------
    cert_main = drive_cert_main_path(cert_in)

    # ---- 5b. the main path under kernel_field="mont16" (K4) --------------
    main_mont16 = drive_field_main_path("mont16", votes, vote_ok, block,
                                        block_ok, pinned_in, blk, ed_in)

    # ---- 5c. the main path under kernel_field="mxu" (K5's builds) --------
    main_mxu = drive_field_main_path("mxu", votes, vote_ok, block, block_ok,
                                     pinned_in, blk, ed_in)

    # ---- 7. timing -------------------------------------------------------
    def vote_round():
        t = time.perf_counter()
        fs = [csp.submit(v) for v in votes]
        csp.flush()
        if [f.result(60) for f in fs] != vote_ok:
            raise SystemExit("vote round: verdicts differ")
        return (time.perf_counter() - t) * 1e3

    def block_batch():
        t = time.perf_counter()
        if csp.verify_batch(block) != block_ok:
            raise SystemExit("block batch: verdicts differ")
        return (time.perf_counter() - t) * 1e3

    ecdsa.reset_launches()
    vote_ms = sorted(vote_round() for _ in range(9))
    timed_launches = dict(ecdsa.LAUNCHES)
    block_ms = sorted(block_batch() for _ in range(5))
    log(f"vote round 128 lanes: median {vote_ms[4]:.2f} ms "
        f"(min {vote_ms[0]:.2f}, max {vote_ms[-1]:.2f}), "
        f"{timed_launches['secp256k1']} launches in 9 rounds; block batch "
        f"2000 lanes: median {block_ms[2]:.2f} ms (min {block_ms[0]:.2f}, "
        f"max {block_ms[-1]:.2f})")
    if timed_launches["secp256k1"] != 9:
        raise SystemExit(f"vote rounds: launches {timed_launches}, want 9")
    for curve_name, cv in CURVES.items():
        res = results[curve_name]
        lanes, want = batch[curve_name], truth[curve_name]
        res["buckets"] = {}
        for b in BUCKETS:
            idx = [i % len(lanes) for i in range(b)]
            tiled = [lanes[i] for i in idx]
            args = limbs(tiled)
            ok = ecdsa.verify_fold_cuda(cv, *args).cpu().numpy()
            if not np.array_equal(ok, want[idx]):
                raise SystemExit(f"{curve_name} B={b}: verdicts differ")
            reps = 20 if b <= 2048 else 10
            ms = cuda_ms(lambda: ecdsa.verify_fold_cuda(cv, *args), reps)
            bms, by = bound_ms(cv, tiled, sm_clock_hz)
            res["buckets"][b] = {"ms": ms, "verifies_per_s": b / ms * 1e3,
                                 "bound_ms": bms, "bound_by": by,
                                 "bound_share": bms / ms}
            log(f"{curve_name} B={b}: kernel {ms:.3f} ms "
                f"({b / ms * 1e3:,.0f} verifies/s), bound {bms:.4f} ms "
                f"({by}, {bms / ms:.2%} of the kernel time)")
        args8 = limbs(lanes[:8])
        t0 = time.perf_counter()
        verify_fold(cv, *args8)
        torch.cuda.synchronize()
        res["plain_ms_bucket8"] = (time.perf_counter() - t0) * 1e3
        # the provider adds the low-S policy for P-256
        half = cv.fn.modulus // 2
        reqs, pwant = [], []
        for i in range(8192):
            qx, qy, r, s, d, _ = lanes[i % len(lanes)]
            reqs.append(VerifyRequest(PublicKey(curve_name, qx, qy), d, r, s))
            pwant.append(bool(want[i % len(lanes)])
                         and (curve_name != "P-256" or s <= half))
        csp.verify_batch(reqs)
        t0 = time.perf_counter()
        reps = 3
        for _ in range(reps):
            if csp.verify_batch(reqs) != pwant:
                raise SystemExit(f"{curve_name}: provider verdicts differ")
        e2e = (time.perf_counter() - t0) / reps
        res["provider_8192_s"] = e2e
        res["provider_verifies_per_s"] = 8192 / e2e
        # the kernel's share of the end-to-end time at 8192 lanes; the
        # rest is host work (screen, marshal, copies, futures)
        res["kernel_share_8192"] = res["buckets"][8192]["ms"] / (e2e * 1e3)
        log(f"{curve_name}: plain {res['plain_ms']:.0f} ms at "
            f"B={MAIN_BUCKET[curve_name]}, {res['plain_ms_bucket8']:.0f} ms "
            f"at B=8; provider 8192 lanes {e2e * 1e3:.1f} ms "
            f"({8192 / e2e:,.0f} verifies/s end to end, kernel share "
            f"{res['kernel_share_8192']:.2f})")
    csp.close()
    if csp.stats["fallbacks"] != 0:
        raise SystemExit("a fallback happened during timing")
    time_pinned(pinned, pinned_main, live, pinned_in, sm_clock_hz, dev)
    block_times = time_block(checked, blk, block_csp, sm_clock_hz, dev)
    lat_times = time_latency(batch["secp256k1"], truth["secp256k1"],
                             lat_csp, votes, vote_ok[:85], sm_clock_hz, dev)
    ed_times = time_ed25519(ed_checked, ed_csp, sm_clock_hz, dev)
    bls_times = time_bls(bls_checked, sm_clock_hz, dev)
    from bdls_tpu_torch.crypto.torch_provider import block_lane_screen
    from bdls_tpu_torch.ops import block_verify

    k4k5_times = time_k4k5(
        batch, truth, pinned, checked, ed_checked,
        block_verify.pack_block_request(
            blk["main"], lane_ok=block_lane_screen("P-256")),
        sm_clock_hz, dev)

    # ---- 8. report -------------------------------------------------------
    kernels = []
    for curve_name, cv in CURVES.items():
        res = results[curve_name]
        mb = MAIN_BUCKET[curve_name]
        at = res["buckets"][mb]
        lanes = batch[curve_name]
        kernels.append({
            "name": f"{names[curve_name]} ({curve_name})",
            "route": "cuda",
            "source": "bdls_tpu_torch/csrc/verify.cu",
            "replaces": "bdls_tpu/ops/verify_fold.py:860",
            "launches": launches[curve_name],
            "max_abs_err": res["max_abs_err"],
            "ms": at["ms"],
            "plain_ms": res["plain_ms"],
            "bound_ms": at["bound_ms"],
            "bound_by": at["bound_by"],
            "library_ms": None,
            "bucket": mb,
            "needed_muls_per_lane": needed_muls(cv, lanes) / len(lanes),
            "kernel_muls_per_verify":
                mont_muls_per_verify(cv) * MUL32_PER_MONT,
            "by_bucket": res["buckets"],
            "plain_ms_bucket8": res["plain_ms_bucket8"],
            "provider_verifies_per_s_8192":
                res["provider_verifies_per_s"],
            "kernel_share_8192": res["kernel_share_8192"],
        })
    for curve_name, cv in CURVES.items():
        res = pinned[curve_name]
        at = res["buckets"][MAIN_BUCKET[curve_name]]
        kernels.append({
            "name": f"{pnames[curve_name]} ({curve_name})",
            "route": "cuda",
            "source": "bdls_tpu_torch/csrc/pinned.cu",
            "replaces": "bdls_tpu/ops/verify_fold.py:736",
            "launches": pinned_main["launches"][curve_name],
            "max_abs_err": res["max_abs_err"],
            "ms": at["ms"],
            "plain_ms": res["plain_ms"],
            "bound_ms": at["bound_ms"],
            "bound_by": at["bound_by"],
            "library_ms": None,
            "bucket": MAIN_BUCKET[curve_name],
            "keys_pinned": res["keys"],
            "needed_muls_per_lane": res["needed_muls_per_lane"],
            "kernel_muls_per_verify": pinned_kernel_muls(cv),
            "by_bucket": res["buckets"],
            "plain_ms_bucket8": res["plain_ms_bucket8"],
        })
    sha = block_times["sha256"]
    kernels.append({
        "name": "sha256_kernel",
        "route": "cuda",
        "source": "bdls_tpu_torch/csrc/sha256.cu",
        "replaces": "bdls_tpu/ops/sha256.py:170",
        "launches": block_main["sha256_batch"]["launches"],
        "max_abs_err": checked["sha256"]["max_abs_err"],
        "ms": sha["ms"],
        "plain_ms": sha["plain_ms"],
        "bound_ms": sha["bound_ms"],
        "bound_by": sha["bound_by"],
        "library_ms": None,
        "lanes": sha["lanes"],
        "active_blocks": sha["active_blocks"],
        "ops_per_block": sha["ops_per_block"],
        "path": "sha256_batch over the main block's preimages; its body "
                "also runs inside every K7 launch",
    })
    for curve_name in ("P-256", "secp256k1"):
        tm, ck = block_times[curve_name], checked[curve_name]
        kernels.append({
            "name": f"{bnames[curve_name]} + block_tally_kernel "
                    f"({curve_name})",
            "route": "cuda",
            "source": "bdls_tpu_torch/csrc/block.cu",
            "replaces": "bdls_tpu/ops/block_verify.py:85",
            "launches": block_main["main" if curve_name == "P-256"
                                   else "secp256k1"]["launches"],
            "max_abs_err": ck["max_abs_err"],
            "ms": tm["ms"],
            "plain_ms": tm["plain_ms"],
            "bound_ms": tm["bound_ms"],
            "bound_by": tm["bound_by"],
            "library_ms": None,
            "shape": ck["shape"],
            "path": ("TorchCSP.verify_block, the 1000-tx block"
                     if curve_name == "P-256" else
                     "TorchCSP.verify_block, a 50-tx secp256k1 block"),
        })
    lt = lat_times[128]
    kernels.append({
        "name": "K3: captured graph of copy, verify_kernel<CurveK256>, "
                "copy (secp256k1)",
        "route": "cuda",
        "source": "bdls_tpu_torch/csrc/verify.cu",
        "graph": "bdls_tpu_torch/ops/ecdsa.py:LatencySlot",
        "replaces": "bdls_tpu/ops/ecdsa.py:244",
        "launches": lat_main[128]["launches"],
        "max_abs_err": lt["max_abs_err"],
        "ms": lt["replay_ms"],
        "plain_ms": results["secp256k1"]["plain_ms"],
        "bound_ms": lt["bound_ms"],
        "bound_by": lt["bound_by"],
        "library_ms": None,
        "bucket": 128,
        "by_bucket": {b: lat_times[b] for b in (85, 128, 171)},
        "quorum_on_ms_median": lat_times["quorum_on_ms"][4],
        "quorum_off_ms_median": lat_times["quorum_off_ms"][4],
        "path": "TorchCSP submit x 85 at quorum occupancy, 128-validator "
                "secp256k1 committee, key cache off (bucket 128; bucket 85 "
                "with VOTE_BUCKETS)",
    })
    et = ed_times[2048]
    kernels.append({
        "name": "ed25519_kernel",
        "route": "cuda",
        "source": "bdls_tpu_torch/csrc/ed25519.cu",
        "replaces": "bdls_tpu/ops/ed25519.py:494",
        "launches": ed_main[1024]["launches"],
        "max_abs_err": max(c["max_abs_err"] for c in ed_checked.values()),
        "ms": et["ms"],
        "plain_ms": ed_checked[2048]["plain_ms"],
        "bound_ms": et["bound_ms"],
        "bound_by": et["bound_by"],
        "library_ms": None,
        "bucket": 2048,
        "by_bucket": ed_times,
        "plain_ms_bucket128": ed_checked[128]["plain_ms"],
        "path": "TorchCSP submit + flush, the 683-vote quorum of a "
                "1024-validator committee (bucket 2048; the 85-vote quorum "
                "of 128 validators in bucket 128)",
    })
    for kern, replaces, plain in (
            ("miller", "bdls_tpu/ops/bls_kernel.py:498", "plain_miller_ms"),
            ("final", "bdls_tpu/ops/bls_kernel.py:519", "plain_final_ms")):
        at = bls_times[2]
        errs = bls_checked["max_abs_err"]
        kernels.append({
            "name": f"bls_{kern}_kernel",
            "route": "cuda",
            "source": "bdls_tpu_torch/csrc/bls.cu",
            "replaces": replaces,
            "launches": cert_main[1024]["launches"][kern],
            "max_abs_err": max(errs["n"], errs["d"]) if kern == "miller"
            else max(errs["fe"], bls_checked["max_abs_err_verdict"]),
            "ms": at[f"{kern}_ms"],
            "plain_ms": bls_checked[plain],
            "bound_ms": at[f"{kern}_bound_ms"],
            "bound_by": at[f"{kern}_bound_by"],
            "library_ms": None,
            "lanes": 2,
            "plain_lanes": bls_checked["lanes"],
            "kernel_products_per_cert": 2 * (K9_MILLER_PRODUCTS
                                             if kern == "miller"
                                             else K9_FINAL_PRODUCTS),
            "least_products_per_cert": MILLER_M if kern == "miller"
            else FINAL_M,
            "by_lanes": {b: {k: v for k, v in r.items()
                             if k.startswith(kern) or k == "ms"}
                         for b, r in bls_times.items()},
            "also_replaces": None if kern == "miller" else
            "bdls_tpu/ops/bls_kernel.py:508 (full-exponent FE), :552 "
            "(the compare)",
            "path": "TorchCSP.verify_certificates, 2 certificates a call, "
                    "committees of 128 and 1024 validators; a cross-round "
                    "batch of 64",
        })
    def main_launches(run, what, kern, curve):
        return run[what]["launches"].get(kern, {}).get(curve, 0)

    for curve_name, what in (("secp256k1", "vote round, 128 secp256k1 lanes"),
                             ("P-256", "block batch, 2000 P-256 lanes")):
        t = k4k5_times[f"K4 {curve_name}"][MAIN_BUCKET[curve_name]]
        kernels.append({
            "name": f"{mnames[curve_name]} ({curve_name})",
            "route": "cuda",
            "source": "bdls_tpu_torch/csrc/mont16.cu",
            "replaces": "bdls_tpu/ops/ecdsa.py:58",
            "launches": main_launches(main_mont16, what, "K4", curve_name),
            "max_abs_err": k4_checked[curve_name]["max_abs_err"],
            "ms": t["ms"],
            "plain_ms": k4_checked[curve_name]["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"],
            "library_ms": None,
            "bucket": MAIN_BUCKET[curve_name],
            "by_bucket": k4k5_times[f"K4 {curve_name}"],
            "path": f"TorchCSP(kernel_field=\"mont16\"): the {what}",
        })
    mxu_paths = (
        ("verify_kernel<CurveP256> [mxu] (P-256)", "verify.cu", "K1+K5",
         "P-256", "block batch, 2000 P-256 lanes", "K1 P-256",
         "K1+K5 P-256", 2048),
        ("K3: captured graph of copy, verify_kernel<CurveK256> [mxu], copy "
         "(secp256k1)", "verify.cu", "K3+K5", "secp256k1",
         "vote round, 128 secp256k1 lanes", "K1 secp256k1",
         "K3+K5 secp256k1", 128),
        ("pinned_kernel<CurveK256> [mxu] (secp256k1)", "pinned.cu", "K2+K5",
         "secp256k1", "vote round through the seam, 128 envelopes, one new "
         "key", "K2 secp256k1", "K2+K5 secp256k1", 128),
        ("pinned_kernel<CurveP256> [mxu] (P-256)", "pinned.cu", "K2+K5",
         "P-256", "pinned block batch, 2000 lanes from 16 endorsers",
         "K2 P-256", "K2+K5 P-256", 2048),
        ("block_lane_kernel<CurveP256> [mxu] + block_tally_kernel (P-256)",
         "block.cu", "K7+K5", "P-256", "verify_block, the 1000-tx block",
         "K7 P-256", "K7+K5 P-256", None),
        ("ed25519_kernel [mxu]", "ed25519.cu", "K8+K5", "ed25519",
         "Ed25519 round, 85 votes of 128", "K8 2048", "K8+K5", 2048),
    )
    k5_launches = 0
    for name, src, kern, curve_name, what, ck, tk, bucket in mxu_paths:
        t = k4k5_times[tk] if bucket is None else k4k5_times[tk][bucket]
        n = main_launches(main_mxu, what, kern, curve_name)
        k5_launches += n
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"bdls_tpu_torch/csrc/{src} with csrc/mxu.cuh "
                      f"(-DBDLS_MUL_MXU)",
            "replaces": "bdls_tpu/ops/mxu.py:98 (bound by "
                        "bdls_tpu/ops/fold.py:375-400)",
            "launches": n,
            "max_abs_err": mxu_checked[ck]["max_abs_err"],
            "ms": t["ms"],
            "plain_ms": mxu_checked[ck]["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"],
            "library_ms": None,
            "bucket": bucket,
            "by_bucket": None if bucket is None else k4k5_times[tk],
            "path": f"TorchCSP(kernel_field=\"mxu\"): the {what}",
        })
    k5 = k4k5_times["K5 product"]
    kernels.append({
        "name": "mxu::mont_mul_mma (K5: mma.sync m16n8k32 u8, in every mxu "
                "build)",
        "route": "cuda",
        "source": "bdls_tpu_torch/csrc/mxu.cuh",
        "replaces": "bdls_tpu/ops/mxu.py:98",
        "launches": k5_launches,
        "max_abs_err": max(v["max_abs_err"]
                           for v in mxu_checked["product"].values()),
        "ms": k5["ms"],
        "plain_ms": k5["plain_ms"],
        "bound_ms": k5["bound_ms"],
        "bound_by": k5["bound_by"],
        "library_ms": k5["library_ms"],
        "products": k5["products"],
        "cios_ms": k5["cios_ms"],
        "path": "timed alone through bdls_field_mul (65,536 products mod "
                "the P-256 order); launches: the mxu builds' launches on "
                "the kernel_field=\"mxu\" main path",
    })
    idle = [k["name"] for k in kernels if not k["launches"]]
    if idle:
        raise SystemExit(f"kernels the main path never launched: {idle}")
    report = {"card": card, "sm_clock_hz": sm_clock_hz,
              "torch": torch.__version__, "cuda": torch.version.cuda,
              "build_s": info["seconds"], "ptxas": regs,
              "vote_round_ms": vote_s * 1e3,
              "block_batch_ms": block_s * 1e3,
              "vote_round_ms_runs": vote_ms, "block_batch_ms_runs": block_ms,
              "pinned_main_path": pinned_main,
              "block_main_path": block_main,
              "block_timing": block_times,
              "ed25519_main_path": ed_main,
              "latency_main_path": lat_main,
              "latency_timing": {str(k): v for k, v in lat_times.items()},
              "cert_main_path": {str(k): v for k, v in cert_main.items()},
              "bls_timing": bls_times,
              "bls_check": {k: v for k, v in bls_checked.items()
                            if k != "args"},
              "k4_check": k4_checked, "mxu_check": mxu_checked,
              "mont16_main_path": main_mont16, "mxu_main_path": main_mxu,
              "k4k5_timing": k4k5_times,
              "kernels": kernels}
    os.makedirs("build", exist_ok=True)
    with open(os.path.join("build", "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1)
    log(json.dumps({"kernels": kernels}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
