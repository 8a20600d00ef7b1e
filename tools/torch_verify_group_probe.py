"""Probe the thread-group verify bodies (K1, K2, K4, K7, K8) and K6's
builds on one NVIDIA GPU.

    python3 tools/torch_verify_group_probe.py [--groups 4,8,16,32]
        [--one-lane] [--compare DIR]
    python3 tools/torch_verify_group_probe.py --pinned
        [--builds 8,16,4] [--k1-builds 8,8+BDLS_MUL_MXU] [--compare DIR]
        [--turns 3]
    python3 tools/torch_verify_group_probe.py --ed25519
        [--ed-builds 8,16] [--compare DIR] [--turns 3]
    python3 tools/torch_verify_group_probe.py --block
        [--block-builds 8,8+BDLS_MUL_MXU,8@other] [--compare DIR]
    python3 tools/torch_verify_group_probe.py --mont16
        [--m16-builds 8,16] [--k1-builds 8] [--compare DIR] [--turns 3]
    python3 tools/torch_verify_group_probe.py --sha256
        [--sha-builds 1,2@other,1+BDLS_SHA_MBARRIER@other] [--sass]
        [--compare DIR] [--turns 3]

K1 (the default): builds ``bdls_tpu_torch/csrc/verify.cu`` once per
entry of ``--groups`` with ``-DBDLS_VERIFY_GROUP=<threads a lane>`` (an
entry ``8+NAME`` also defines NAME), with the nvcc flags of
``bdls_tpu_torch/ops/_build.py``, one compiler an entry, side by side,
into ``build/probe/``; ``--compare DIR`` also builds each entry from a
copy of the sources at DIR (another tree's), timed before this tree's.
Prints each build's ``-Xptxas -v`` lines, then for each build and curve
checks the verdicts of 128 seeded lanes (valid, tampered and hostile,
``crypto/vectors.py``) against the integer ECDSA and times the kernel by
CUDA events at 128, 2048 and 8192 lanes (the lanes tiled), with blocks of
one warp and, with ``--one-lane``, of one lane.

K2 (``--pinned``): builds ``csrc/pinned.cu`` once per entry of
``--builds`` (a group size and defines, as for K1, ``8+BDLS_MUL_MXU``
the mxu build; ``@other`` for the copy at ``--compare``) and
``csrc/verify.cu`` once per entry of ``--k1-builds`` (default the group
size, and with ``--compare`` also K1 from the copy, ``K1@other``), side
by side. An ``@other`` mxu build that runs one thread a lane (an earlier
tree's) is launched in blocks of 64 threads, every other build in
blocks of one warp. Per curve, 128 lanes under keys pinned in a pool on
the card (mixed, ladder-edge and zero-byte lanes whose keys can be pinned, a
valid lane under another key's slot and under slot -1, filled with valid
lanes): every K2 build's verdicts must equal the integer ECDSA and the
plain twin ``verify_fold_pinned`` on the card, and K1's the integer
ECDSA on the same lanes. Then each build is timed by CUDA events at
128, 2048 and 8192 lanes (tiled), in turns (``--turns`` rounds, the
order reversed every other round; the median of the rounds is kept).

K8 (``--ed25519``): builds ``csrc/ed25519.cu`` once per entry of
``--ed-builds`` (a group size of 8 or more, then any defines; an entry
``N@other`` builds the copy at ``--compare``, whose header may allow
other sizes; ``8+BDLS_MUL_MXU`` is the mxu build, the same group body
over K5's warp call; ``8+BDLS_MUL_MXU@other`` an earlier tree's mxu
build, which may run one thread a lane, then in blocks of 64) and, with
``--compare DIR`` and no ``@other`` entry, the
copy's as ``1@other`` (an earlier one-thread K8: no
``bdls_ed25519_lane_threads``, blocks of 64 threads, the B table as
(x, y, xy) in Montgomery form, as its mxu build reads it too), side by
side. On 128 lanes (the mixed and hostile
lanes, the rows with a chosen k, filled with valid signatures) every
build's verdicts must equal the RFC 8032 oracle and, at 128, the plain
twin on the card; then each is timed by CUDA events at 128, 2048 and
8192 lanes (tiled), in turns as for K2; then each build's ``bdls_field_chain``
(the group bodies' product, one K5 call of the warp in an mxu build):
one warp, 4,096 dependent calls on each of the five moduli.

K7 (``--block``): builds ``csrc/block.cu`` once per entry of
``--block-builds`` (as ``--builds``; an ``@other`` mxu build is taken as
an earlier tree's one-thread build, blocks of 64 threads) and, on a
hostile block of each curve (P-256 1000 txs at L 2048, secp256k1 60 at
L 128), holds every build's flags and lane verdicts to the plain twin's
on the card, then times them in turns.

K4 (``--mont16``): builds ``csrc/mont16.cu`` once per entry of
``--m16-builds`` (a group size and defines; an ``@other`` entry builds
the copy at ``--compare``) and, with ``--compare DIR`` and no ``@other``
entry, the copy's as ``1@other`` (an earlier one-thread K4: no
``bdls_mont16_lane_threads``, blocks of 64 threads); and K1 as
``--pinned`` does (``--k1-builds``, with ``--compare`` also the copy's),
side by side. Per curve, 128 lanes (mixed, ladder-edge and the lanes
that take each of K4's exceptional selects, ``vectors.select_lanes``,
filled with valid lanes): every build's verdicts must equal the integer
ECDSA at 128, 2048 and 8192 lanes (tiled); then all are timed by CUDA
events, in turns as for K2.

K6 (``--sha256``): builds ``csrc/sha256.cu`` once per entry of
``--sha-builds`` (default ``1``, this tree's kernel): a leading number
R > 0 is a build of a schedule warp and R rounds warps a CTA
(``-DBDLS_SHA_ROUND_WARPS=R``, launched with 32·(1 + R) threads), 0 a
build of one thread a lane (launched in CTAs of 128, the one-thread
kernel's); then any defines; ``@other`` builds the copy at
``--compare``. This tree's kernel is R = 1 and takes no defines; an
earlier tree's source with the variants (``BDLS_SHA_ROUND_WARPS``,
``BDLS_SHA_MBARRIER``, the handshake by mbarriers, and
``BDLS_SHA_PREFETCH``, one thread a lane with the next block's words
loaded ahead) builds them as ``@other`` entries. With ``--compare`` and
no ``@other`` entry the copy's one-thread K6 is added as ``0@other``. Every build's digests must equal
``hashlib`` (the IV on filler lanes) on the main block's preimage shape
(1000 preimages of 200-1000 bytes, the first of 1000, each hashed by two
lanes, then 48 filler lanes: 2048 lanes, NB 16), its first 128 lanes, the
same at 2049 lanes (the last CTA with one live lane), tiled four times
(8192) and a uniform batch (2048 lanes of 16 blocks); then each is
timed at the timed shapes (not 2049), in turns as for K2, by CUDA
events over 200 launches from the host and over the replays of a CUDA
graph of 32 launches (no host between launches), with the ns a round on
the longest lane from the graph's time; "uniform 1" and "uniform 4"
(2048 lanes of 1 and 4 blocks) beside "uniform" give the cost of a block
and of a launch. ``--sass`` prints each build's SASS by opcode
(``cuobjdump -sass``, written beside the library).

The field (``--fields``): one thread a lane, 128 lanes in blocks of
64, each lane runs a dependent chain of ``--chain`` Montgomery products
x <- x·y·R^-1 mod m, the CIOS product (``field.cuh:mont_mul_cios``, the
one-thread bodies') and the carry-save one
(``verify_group.cuh:mont_mul_cs``, the group bodies'), for P-256's and
secp256k1's p and n: the latency of one product on one thread, the
chain's end checked against Python integers on every lane.

Every mode prints the card's name and power limit and, as the last
line, a JSON object of every number; also written to
``build/verify_group_probe.json`` (``build/pinned_group_probe.json``,
``build/ed25519_group_probe.json``, ``build/mont16_group_probe.json``,
``build/field_chain_probe.json``, ``build/sha256_probe.json``).
Exits non-zero on a failed build or a wrong verdict or value.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

SEED = 20261017
# every library build() loaded, by (source, label)
LOADED: dict = {}
SIZES = (128, 2048, 8192)
PINNED_BUILDS = "8,16,4"
ED_BUILDS = "8,16"
SHA_BUILDS = "1"


def _defines(label: str) -> tuple[int, list[str]]:
    """A build label -> (threads a lane, -D flags): ``8+NAME+NAME=1``."""
    spec = label.split("@")[0].split("+")
    return int(spec[0]), [f"-DBDLS_VERIFY_GROUP={spec[0]}"] + [
        f"-D{d}" for d in spec[1:]]


def build(groups, compare=None, source: str = "verify.cu",
          entry: str = "bdls_verify",
          threads_entry: str | None = "bdls_verify_lane_threads",
          lane_threads: dict = None, defines=_defines) -> dict:
    """One build of ``source`` a label: a size, then any defines after
    "+", and "@other" for the copy of the sources at ``compare``. A
    build runs the label's size threads a lane (the mxu builds too); an
    "@other" build with ``BDLS_MUL_MXU`` may be an earlier tree's
    one-thread mxu build (1). Returns {label: the bound C entry}. With
    ``lane_threads`` (a dict filled with each label's threads a lane) a
    build without ``threads_entry`` is an earlier one-thread build: it
    is entered as 0, and its label's size must be 1. With no
    ``threads_entry`` (a source that has none, K7's ``block.cu``) the
    label says it: 1 for an "@other" mxu build, else its size.
    ``defines`` maps a label to (size, -D flags)."""
    from bdls_tpu_torch.ops import _build

    out_dir = _build.BUILD_DIR / "probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for g in groups:
        _, other = g.partition("@")[::2]
        src = Path(compare) if other else _build.CSRC
        so = out_dir / (f"lib{Path(source).stem}_"
                        f"{g.replace('@', '_at_').replace('=', '_')}.so")
        procs[g] = (so, subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, *defines(g)[1],
             "-o", str(so), str(src / source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs, reports = {}, {}
    for g, (so, proc) in procs.items():
        reports[g] = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"nvcc {source} {g} failed:\n{reports[g]}")
        lib = LOADED[(source, g)] = ctypes.CDLL(str(so))
        fn = getattr(lib, entry)
        fn.argtypes = _build.ENTRIES[source][entry]
        fn.restype = ctypes.c_int
        one_thread_label = "@other" in g and "BDLS_MUL_MXU" in g
        missing = lane_threads is not None and threads_entry is not None \
            and not hasattr(lib, threads_entry)
        if threads_entry is None:
            got = 1 if one_thread_label else defines(g)[0]
        else:
            got = 1 if missing else getattr(lib, threads_entry)()
        one_thread = one_thread_label and got == 1
        if got != defines(g)[0] and not one_thread:
            raise SystemExit(f"{source} {g}: the build runs {got} threads "
                             "a lane")
        if lane_threads is not None:
            lane_threads[g] = 0 if missing else got
        libs[g] = fn
    print(f"nvcc {time.perf_counter() - t0:.1f} s for {source} "
          f"{list(groups)}", flush=True)
    for g, rep in reports.items():
        for line in rep.splitlines():
            if "Used" in line or "spill" in line or "Compiling entry" in line:
                print(f"ptxas {source} {g}: {line.strip()}", flush=True)
    return libs


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def _events_ms(fn, reps: int) -> float:
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def _graph_ms(fn, launches: int = 32, replays: int = 8) -> float:
    """``fn``'s launches (on the current stream) captured into one CUDA
    graph and replayed: the time a launch on the device with no host
    between launches, by CUDA events over the replays."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    side.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    return _events_ms(graph.replay, replays) / launches


def _write(name: str, result: dict) -> None:
    os.makedirs(ROOT / "build", exist_ok=True)
    (ROOT / "build" / name).write_text(json.dumps(result, indent=1))
    print(json.dumps(result))


def probe_k1(args, card: str) -> int:
    # a size, or a size and defines: "8+NAME+NAME=1"
    groups = args.groups.split(",")
    if args.compare:
        groups = [x for g in groups for x in (f"{g}@other", g)]
    libs = build(groups, args.compare)

    from bdls_tpu_torch.crypto import vectors
    from bdls_tpu_torch.crypto.marshal import ints_to_limbs
    from bdls_tpu_torch.ops.curves import CURVES
    from bdls_tpu_torch.ops.ecdsa import CURVE_IDS
    from bdls_tpu_torch.ops.verify_fold import device_g32_table

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    batch = {}
    for curve in CURVES:
        lanes = vectors.mixed_lanes(curve, rng)
        lanes += vectors.signed_lanes(curve, 128 - len(lanes), rng)
        batch[curve] = (lanes, np.array(vectors.expected(curve, lanes)))

    def launch(fn, curve, cols, g32, out, B, threads):
        rc = fn(CURVE_IDS[curve], *(c.data_ptr() for c in cols),
                g32.data_ptr(), out.data_ptr(), B, threads,
                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise SystemExit(f"launch failed: CUDA error {rc}")

    result = {"card": card, "groups": {}}
    for g in groups:
        fn = libs[g]
        res = result["groups"][g] = {}
        size = _defines(g)[0]
        geoms = [32] + ([size] if size < 32 and args.one_lane else [])
        for curve in CURVES:
            lanes, want = batch[curve]
            g32 = device_g32_table(curve, dev)
            for B in SIZES:
                idx = [i % len(lanes) for i in range(B)]
                cols = [torch.from_numpy(ints_to_limbs(c).view(np.int32))
                        .to(dev) for c in vectors.columns(
                            [lanes[i] for i in idx])]
                out = torch.zeros(B, dtype=torch.uint8, device=dev)
                for threads in geoms:
                    out.zero_()
                    launch(fn, curve, cols, g32, out, B, threads)
                    torch.cuda.synchronize()
                    ok = out.cpu().numpy().astype(bool)
                    if not np.array_equal(ok, want[idx]):
                        bad = [lanes[idx[i]][5] for i in
                               np.flatnonzero(ok != want[idx])][:8]
                        raise SystemExit(f"group {g} {curve} B={B} "
                                         f"threads {threads}: wrong {bad}")
                    reps = args.reps if B <= 2048 else max(args.reps // 2, 3)
                    ms = _events_ms(lambda: launch(fn, curve, cols, g32, out,
                                                   B, threads), reps)
                    key = f"{curve} B={B} threads={threads}"
                    res[key] = ms
                    print(f"group {g}: {key}: {ms:.3f} ms", flush=True)
    print(card, flush=True)
    _write("verify_group_probe.json", result)
    return 0


def _pinned_batch(curve: str, rng, dev):
    """128 lanes under pinnable keys, the pool on ``dev``, the slots and
    the integer ECDSA's verdicts (slot overrides applied)."""
    from bdls_tpu_torch.crypto import vectors
    from bdls_tpu_torch.ops import verify_fold as vf

    def pinnable(lane) -> bool:
        try:
            vf.build_pinned_tables(curve, lane[0], lane[1])
        except ValueError:
            return False
        return True

    lanes = [ln for ln in vectors.mixed_lanes(curve, rng)
             + vectors.ladder_lanes(curve, rng)
             + vectors.zero_byte_lanes(curve, rng) if pinnable(ln)]
    lanes += vectors.signed_lanes(curve, 126 - len(lanes), rng)
    keys: dict = {}
    for ln in lanes:
        keys.setdefault(ln[:2], len(keys))
    cap = len(keys)
    slots = [keys[ln[:2]] for ln in lanes]
    valid = next(i for i, ln in enumerate(lanes) if ln[5] == "valid")
    lanes += [lanes[valid]] * 2
    slots += [(slots[valid] + 1) % cap, -1]
    generic = np.array(vectors.expected(curve, lanes))
    want = generic.copy()
    want[-2:] = False
    pools = {nm: np.zeros((cap, vf.pinned_positions(curve), 9, 8), np.int32)
             for nm in vf.PINNED_COORDS[curve]}
    for (qx, qy), i in keys.items():
        tabs = vf.pinned_device_tables(
            curve, vf.build_pinned_tables(curve, qx, qy))
        for nm in pools:
            pools[nm][i] = tabs[nm]
    pools = {nm: torch.from_numpy(v).to(dev) for nm, v in pools.items()}
    return lanes, np.array(slots, np.int32), pools, cap, want, generic


# a dependent chain of Montgomery products a lane, for --fields
FIELD_CHAIN_CU = r"""
#include <cuda_runtime.h>

#include "verify_group.cuh"

namespace {

template <class M, bool CS>
__global__ void chain_kernel(const uint32_t* __restrict__ in,
                             uint32_t* __restrict__ out, int n, int B) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  bdls::fe x, y;
  for (int j = 0; j < 8; ++j) {
    x.v[j] = in[(size_t)i * 16 + j];
    y.v[j] = in[(size_t)i * 16 + 8 + j];
  }
#pragma unroll 1
  for (int k = 0; k < n; ++k) {
    bdls::fe t;
    if (CS) bdls::grp::mont_mul_cs<M>(t, x, y);
    else bdls::mont_mul_cios<M>(t, x, y);
    x = t;
  }
  for (int j = 0; j < 8; ++j) out[(size_t)i * 8 + j] = x.v[j];
}

template <class M>
int launch(int cs, const uint32_t* in, uint32_t* out, int n, int B,
           int threads, cudaStream_t st) {
  const dim3 grid((B + threads - 1) / threads);
  if (cs) chain_kernel<M, true><<<grid, threads, 0, st>>>(in, out, n, B);
  else chain_kernel<M, false><<<grid, threads, 0, st>>>(in, out, n, B);
  return (int)cudaGetLastError();
}

// acc <- acc + P, n complete additions (point.cuh:point_add) a lane
template <class C>
__global__ void add_chain_kernel(const uint32_t* __restrict__ in,
                                 uint32_t* __restrict__ out, int n, int B) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  bdls::pt p;
  uint32_t* w = &p.x.v[0];
  for (int j = 0; j < 24; ++j) w[j] = in[(size_t)i * 24 + j];
  bdls::pt acc = p;
#pragma unroll 1
  for (int k = 0; k < n; ++k) bdls::point_add<C>(acc, acc, p);
  const uint32_t* a = &acc.x.v[0];
  for (int j = 0; j < 24; ++j) out[(size_t)i * 24 + j] = a[j];
}

// n GLV splits (glv.cuh:decompose) a lane, each of k with its low word
// XORed by the last split's words
__global__ void glv_chain_kernel(const uint32_t* __restrict__ in,
                                 uint32_t* __restrict__ out, int n, int B) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  bdls::fe k;
  for (int j = 0; j < 8; ++j) k.v[j] = in[(size_t)i * 8 + j];
#pragma unroll 1
  for (int r = 0; r < n; ++r) {
    uint32_t k1[bdls::glv::HALF_WORDS], k2[bdls::glv::HALF_WORDS];
    bool n1, n2;
    bdls::glv::decompose(k1, n1, k2, n2, k);
    k.v[0] ^= k1[0] ^ k2[1];
  }
  for (int j = 0; j < 8; ++j) out[(size_t)i * 8 + j] = k.v[j];
}

}  // namespace

// curve: 0 P-256, 1 secp256k1; in, out: B x (x, y, z) words
extern "C" int bdls_probe_add_chain(int curve, const void* in, void* out,
                                    int n, int B, int threads,
                                    void* stream) {
  const dim3 grid((B + threads - 1) / threads);
  cudaStream_t st = (cudaStream_t)stream;
  const uint32_t* a = (const uint32_t*)in;
  uint32_t* o = (uint32_t*)out;
  if (curve == 0)
    add_chain_kernel<bdls::CurveP256><<<grid, threads, 0, st>>>(a, o, n, B);
  else
    add_chain_kernel<bdls::CurveK256><<<grid, threads, 0, st>>>(a, o, n, B);
  return (int)cudaGetLastError();
}

// in, out: B x 8 words (secp256k1 scalars below n)
extern "C" int bdls_probe_glv_chain(const void* in, void* out, int n, int B,
                                    int threads, void* stream) {
  const dim3 grid((B + threads - 1) / threads);
  glv_chain_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)in, (uint32_t*)out, n, B);
  return (int)cudaGetLastError();
}

// mod: 0 P-256 p, 1 P-256 n, 2 secp256k1 p, 3 secp256k1 n; cs: 1 the
// carry-save product, 0 CIOS. in: B x (x, y) words, out: B x 8 words.
extern "C" int bdls_probe_chain(int mod, int cs, const void* in, void* out,
                                int n, int B, int threads, void* stream) {
  const uint32_t* a = (const uint32_t*)in;
  uint32_t* o = (uint32_t*)out;
  cudaStream_t st = (cudaStream_t)stream;
  switch (mod) {
    case 0: return launch<bdls::P256P>(cs, a, o, n, B, threads, st);
    case 1: return launch<bdls::P256N>(cs, a, o, n, B, threads, st);
    case 2: return launch<bdls::K256P>(cs, a, o, n, B, threads, st);
    case 3: return launch<bdls::K256N>(cs, a, o, n, B, threads, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
"""


def probe_fields(args, card: str) -> int:
    from bdls_tpu_torch.ops import _build
    from bdls_tpu_torch.ops.curves import CURVES

    out_dir = _build.BUILD_DIR / "probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = out_dir / "field_chain.cu"
    so = out_dir / "libfield_chain.so"
    src.write_text(FIELD_CHAIN_CU)
    proc = subprocess.run(
        [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
         "-o", str(so), str(src)], capture_output=True, text=True)
    report = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise SystemExit(f"nvcc field_chain.cu failed:\n{report}")
    for line in report.splitlines():
        if "Used" in line or "spill" in line or "Compiling entry" in line:
            print(f"ptxas field_chain.cu: {line.strip()}", flush=True)
    fn = ctypes.CDLL(str(so)).bdls_probe_chain
    fn.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2 + \
        [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    mods = [("P-256", "p"), ("P-256", "n"), ("secp256k1", "p"),
            ("secp256k1", "n")]
    B, n = 128, args.chain
    rng = np.random.default_rng(SEED)
    stream = torch.cuda.current_stream().cuda_stream
    result = {"card": card, "lanes": B, "chain": n, "ns_per_product": {}}
    for mod, (curve, kind) in enumerate(mods):
        m = (CURVES[curve].fp if kind == "p" else CURVES[curve].fn).modulus
        vals = [int.from_bytes(rng.bytes(32), "big") % m
                for _ in range(2 * B)]
        words = np.array([[(v >> (32 * j)) & 0xFFFFFFFF for j in range(8)]
                          for v in vals], np.uint32).reshape(B, 16)
        dev_in = torch.from_numpy(words.view(np.int32)).cuda()
        dev_out = torch.zeros((B, 8), dtype=torch.int32, device="cuda")
        rinv = pow(1 << 256, -1, m)
        for cs in (0, 1):
            def run():
                rc = fn(mod, cs, dev_in.data_ptr(), dev_out.data_ptr(), n,
                        B, 64, stream)
                if rc != 0:
                    raise SystemExit(f"chain launch: CUDA error {rc}")

            run()
            torch.cuda.synchronize()
            got = dev_out.cpu().numpy().view(np.uint32).astype(object)
            yr = [vals[2 * i + 1] * rinv % m for i in range(B)]
            for i in range(B):
                x = vals[2 * i] * pow(yr[i], n, m) % m
                if sum(int(w) << (32 * j) for j, w in enumerate(got[i])) \
                        != x:
                    raise SystemExit(f"{curve} {kind} cs={cs}: lane {i} "
                                     "wrong")
            ms = _events_ms(run, 3)
            key = f"{curve} {kind} {'carry-save' if cs else 'CIOS'}"
            result["ns_per_product"][key] = ms * 1e6 / n
            print(f"{key}: {ms * 1e6 / n:.1f} ns a product "
                  f"({ms:.3f} ms for a chain of {n})", flush=True)
    probe_chains(args, ctypes.CDLL(str(so)), result, B, rng, stream)
    print(card, flush=True)
    _write("field_chain_probe.json", result)
    return 0


def probe_chains(args, lib, result: dict, B: int, rng, stream) -> None:
    """--fields, continued: a chain of complete additions acc += P a
    lane (both curves; acc ends as (n + 1)·P, checked on 4 lanes), and
    a chain of secp256k1 GLV splits (checked on 4 lanes against the
    integer oracle)."""
    from bdls_tpu_torch.crypto.sw import _mul_add
    from bdls_tpu_torch.ops import glv
    from bdls_tpu_torch.ops.curves import CURVES

    VP, INT = ctypes.c_void_p, ctypes.c_int
    add = lib.bdls_probe_add_chain
    add.argtypes = [INT, VP, VP, INT, INT, INT, VP]
    add.restype = INT
    split = lib.bdls_probe_glv_chain
    split.argtypes = [VP, VP, INT, INT, INT, VP]
    split.restype = INT
    n = args.chain // 4

    def words(vals) -> np.ndarray:
        return np.array([[(v >> (32 * j)) & 0xFFFFFFFF for j in range(8)]
                         for v in vals], np.uint32)

    def ints(row) -> list[int]:
        return [sum(int(w) << (32 * j) for j, w in enumerate(row[8 * c:
                                                              8 * c + 8]))
                for c in range(len(row) // 8)]

    result["ns_per_addition"] = {}
    for cid, curve in enumerate(("P-256", "secp256k1")):
        cv = CURVES[curve]
        p, R = cv.fp.modulus, 1 << 256
        pts = [_mul_add(cv, int.from_bytes(rng.bytes(32), "big")
                        % (cv.fn.modulus - 1) + 1, (cv.gx, cv.gy))
               for _ in range(4)]
        lanes = [pts[i % 4] for i in range(B)]
        host = np.stack([words([x * R % p, y * R % p, R % p]).reshape(-1)
                         for x, y in lanes])
        dev_in = torch.from_numpy(host.view(np.int32)).cuda()
        dev_out = torch.zeros_like(dev_in)

        def run():
            rc = add(cid, dev_in.data_ptr(), dev_out.data_ptr(), n, B, 64,
                     stream)
            if rc != 0:
                raise SystemExit(f"add chain: CUDA error {rc}")

        run()
        torch.cuda.synchronize()
        got = dev_out.cpu().numpy().view(np.uint32)
        rinv = pow(R, -1, p)
        for i in range(4):
            X, Y, Z = (v * rinv % p for v in ints(got[i]))
            want = _mul_add(cv, n + 1, lanes[i])
            if Z == 0 or X != want[0] * Z % p or Y != want[1] * Z % p:
                raise SystemExit(f"add chain {curve}: lane {i} wrong")
        ms = _events_ms(run, 3)
        result["ns_per_addition"][curve] = ms * 1e6 / n
        print(f"{curve}: {ms * 1e6 / n:.1f} ns a complete addition "
              f"({ms:.3f} ms for a chain of {n})", flush=True)
    nk = CURVES["secp256k1"].fn.modulus
    ks = [int.from_bytes(rng.bytes(32), "big") % nk for _ in range(B)]
    dev_in = torch.from_numpy(words(ks).view(np.int32)).cuda()
    dev_out = torch.zeros_like(dev_in)

    def run_split():
        rc = split(dev_in.data_ptr(), dev_out.data_ptr(), n, B, 64, stream)
        if rc != 0:
            raise SystemExit(f"GLV chain: CUDA error {rc}")

    run_split()
    torch.cuda.synchronize()
    got = dev_out.cpu().numpy().view(np.uint32)
    for i in range(4):
        k = ks[i]
        for _ in range(n):
            k1, k2 = (abs(v) for v in glv.decompose_host(k))
            k ^= (k1 & 0xFFFFFFFF) ^ ((k2 >> 32) & 0xFFFFFFFF)
        if ints(got[i])[0] != k:
            raise SystemExit(f"GLV chain: lane {i} wrong")
    ms = _events_ms(run_split, 3)
    result["ns_per_glv_split"] = ms * 1e6 / n
    print(f"secp256k1: {ms * 1e6 / n:.1f} ns a GLV split ({ms:.3f} ms for "
          f"a chain of {n})", flush=True)


def probe_k2(args, card: str) -> int:
    from bdls_tpu_torch.crypto import vectors
    from bdls_tpu_torch.crypto.marshal import ints_to_limbs
    from bdls_tpu_torch.ops import _build
    from bdls_tpu_torch.ops.curves import CURVES
    from bdls_tpu_torch.ops.ecdsa import CURVE_IDS
    from bdls_tpu_torch.ops.verify_fold import device_g32_table, \
        verify_fold_pinned

    labels = args.builds.split(",")
    k1_labels = (args.k1_builds or str(_build.VERIFY_GROUP)).split(",")
    if args.compare and not any("@" in lb for lb in k1_labels):
        k1_labels.append(f"{k1_labels[0]}@other")
    lane_threads: dict = {}
    libs = build(labels, args.compare, source="pinned.cu",
                 entry="bdls_verify_pinned",
                 threads_entry="bdls_pinned_lane_threads",
                 lane_threads=lane_threads)
    k1_threads: dict = {}
    k1s = build(k1_labels, args.compare, lane_threads=k1_threads)

    def block(threads_a_lane: int) -> int:
        # one warp a block; an earlier one-thread mxu build, 64 threads
        # (its wrappers' blocks)
        return 32 if threads_a_lane > 1 else 64
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    stream = torch.cuda.current_stream().cuda_stream
    result = {"card": card, "builds": labels, "k1_builds": k1_labels,
              "ms": {}}

    for curve, cv in CURVES.items():
        lanes, slots, pools, cap, want, generic = _pinned_batch(curve, rng,
                                                                dev)
        g32 = device_g32_table(curve, dev)
        psi = pools.get("psi_x", pools["x"])
        for B in SIZES:
            idx = [i % len(lanes) for i in range(B)]
            cols = [torch.from_numpy(ints_to_limbs(c).view(np.int32)).to(dev)
                    for c in vectors.columns([lanes[i] for i in idx])]
            sl = torch.from_numpy(slots[idx]).to(dev)
            out = torch.zeros(B, dtype=torch.uint8, device=dev)

            def k2(label):
                rc = libs[label](
                    CURVE_IDS[curve], *(c.data_ptr() for c in cols[2:]),
                    sl.data_ptr(), pools["x"].data_ptr(),
                    pools["y"].data_ptr(), psi.data_ptr(), g32.data_ptr(),
                    out.data_ptr(), B, cap, block(lane_threads[label]),
                    stream)
                if rc != 0:
                    raise SystemExit(f"{label} launch: CUDA error {rc}")

            def k1(label):
                rc = k1s[label](CURVE_IDS[curve],
                                *(c.data_ptr() for c in cols),
                                g32.data_ptr(), out.data_ptr(), B,
                                block(k1_threads[label]), stream)
                if rc != 0:
                    raise SystemExit(f"K1 {label} launch: CUDA error {rc}")

            runs = {label: (lambda lb=label: k2(lb)) for label in labels}
            for label in k1_labels:
                runs[f"K1 {label}"] = lambda lb=label: k1(lb)
            plain = None
            if B == 128:
                plain = verify_fold_pinned(cv, *cols[2:], sl,
                                           pools).cpu().numpy()
                if not np.array_equal(plain, want[idx]):
                    raise SystemExit(f"the plain twin is wrong on {curve}")
            for label, fn in runs.items():
                out.zero_()
                fn()
                torch.cuda.synchronize()
                ok = out.cpu().numpy().astype(bool)
                is_k1 = label.startswith("K1")
                truth = (generic if is_k1 else want)[idx]
                if not np.array_equal(ok, truth):
                    bad = [lanes[idx[i]][5] for i in
                           np.flatnonzero(ok != truth)][:8]
                    raise SystemExit(f"{label} {curve} B={B}: wrong {bad}")
                if plain is not None and not is_k1 and \
                        not np.array_equal(ok, plain):
                    raise SystemExit(f"{label} {curve}: differs from the "
                                     "plain twin")
            reps = args.reps if B <= 2048 else max(args.reps // 2, 3)
            order = list(runs)
            times = {label: [] for label in order}
            for turn in range(args.turns):
                for label in (order if turn % 2 == 0 else order[::-1]):
                    times[label].append(_events_ms(runs[label], reps))
            for label, ts in times.items():
                ms = float(np.median(ts))
                result["ms"][f"{label} {curve} B={B}"] = ms
                print(f"{label}: {curve} B={B}: {ms:.3f} ms "
                      f"(turns {', '.join(f'{t:.3f}' for t in ts)})",
                      flush=True)
    print(card, flush=True)
    _write("pinned_group_probe.json", result)
    return 0


def _ed25519_tables(dev) -> dict:
    """K8's B table in each form a build may read: "plain", this tree's
    (y - x, y + x, 2d·xy) (``device_b_table``); "xyt", (x, y, xy) in
    Montgomery form, as the earlier one-thread K8 reads it."""
    from bdls_tpu_torch.ops import ed25519 as ed
    from bdls_tpu_torch.ops.verify_fold import _ints_to_u32, _u32_to_ints

    def on_card(tab):
        return torch.from_numpy(np.ascontiguousarray(tab).view(np.int32)
                                .copy()).to(dev)

    def mont(tab):
        return on_card(_ints_to_u32([v * (1 << 256) % ed.P for v in
                                     _u32_to_ints(tab)]).reshape(tab.shape))

    return {"plain": ed.device_b_table(dev),
            "xyt": mont(ed.b_tables_positioned())}


def probe_ed25519(args, card: str) -> int:
    from bdls_tpu_torch.crypto import vectors
    from bdls_tpu_torch.ops import ed25519 as ed
    from bdls_tpu_torch.ops.curves import ED25519

    labels = args.ed_builds.split(",")
    if args.compare and not any("@" in label for label in labels):
        labels.append("1@other")
    threads_of: dict = {}
    libs = build(labels, args.compare, source="ed25519.cu",
                 entry="bdls_verify_ed25519",
                 threads_entry="bdls_ed25519_lane_threads",
                 lane_threads=threads_of)
    dev = torch.device("cuda")
    tables = _ed25519_tables(dev)
    stream = torch.cuda.current_stream().cuda_stream
    rng = np.random.default_rng(SEED)
    lanes = vectors.ed25519_mixed_lanes(rng)
    krows = vectors.ed25519_k_rows(rng)
    lanes += vectors.ed25519_signed_lanes(128 - len(lanes) - len(krows),
                                          rng)
    rows = vectors.ed25519_rows(lanes) + [r[:6] for r in krows]
    names = [ln[5] for ln in lanes] + [r[6] for r in krows]
    want = np.array(vectors.ed25519_expected(lanes)
                    + vectors.ed25519_row_expected(krows))
    result = {"card": card, "builds": labels, "lane_threads": threads_of,
              "ms": {}}

    def form(label):
        return "xyt" if threads_of[label] == 0 else "plain"

    for B in SIZES:
        idx = [i % len(rows) for i in range(B)]
        args_b = [torch.from_numpy(a.view(np.int32)).to(dev)
                  for a in ed.lanes_to_limbs([rows[i] for i in idx])]
        out = torch.zeros(B, dtype=torch.uint8, device=dev)

        def k8(label):
            threads = 32 if threads_of[label] > 1 else 64
            rc = libs[label](*(a.data_ptr() for a in args_b),
                             tables[form(label)].data_ptr(), out.data_ptr(),
                             B, threads, stream)
            if rc != 0:
                raise SystemExit(f"{label} launch: CUDA error {rc}")

        plain = None
        if B == 128:
            plain = ed.verify_ed25519(ED25519, *args_b).cpu().numpy()
            if not np.array_equal(plain, want[idx]):
                raise SystemExit("the plain twin is wrong")
        for label in labels:
            out.zero_()
            k8(label)
            torch.cuda.synchronize()
            ok = out.cpu().numpy().astype(bool)
            if not np.array_equal(ok, want[idx]):
                bad = [names[idx[i]] for i in
                       np.flatnonzero(ok != want[idx])][:8]
                raise SystemExit(f"{label} B={B}: wrong {bad}")
            if plain is not None and not np.array_equal(ok, plain):
                raise SystemExit(f"{label}: differs from the plain twin")
        reps = args.reps if B <= 2048 else max(args.reps // 2, 3)
        times = {label: [] for label in labels}
        for turn in range(args.turns):
            for label in (labels if turn % 2 == 0 else labels[::-1]):
                times[label].append(_events_ms(lambda: k8(label), reps))
        for label, ts in times.items():
            ms = float(np.median(ts))
            result["ms"][f"{label} B={B}"] = ms
            print(f"K8 {label}: B={B}: {ms:.3f} ms "
                  f"(turns {', '.join(f'{t:.3f}' for t in ts)})", flush=True)
    result["call_ns"] = _group_products(labels, rng, stream)
    print(card, flush=True)
    _write("ed25519_group_probe.json", result)
    return 0


def _group_products(labels, rng, stream) -> dict:
    """Each K8 build's ``bdls_field_chain`` (the group bodies' product:
    one K5 call of the warp in an mxu build, ``mont_mul_cs`` or
    ``mul_25519`` on each thread in a vpu build): one warp, --chain
    dependent products a thread on the five moduli, checked against
    Python integers on all 32 threads; ns a call. A build without the
    entry (an earlier tree's) is left out."""
    from bdls_tpu_torch.ops.curves import CURVES, EDWARDS_CURVES

    R = 1 << 256
    mods = [("P-256 p", CURVES["P-256"].fp), ("P-256 n", CURVES["P-256"].fn),
            ("secp256k1 p", CURVES["secp256k1"].fp),
            ("secp256k1 n", CURVES["secp256k1"].fn),
            ("2^255 - 19", EDWARDS_CURVES["ed25519"].fp)]
    n = 4096
    out: dict = {}
    for label in labels:
        lib = LOADED[("ed25519.cu", label)]
        if not hasattr(lib, "bdls_field_chain"):
            continue
        fn = lib.bdls_field_chain
        fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 3 + \
            [ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        for i, (name, ctx) in enumerate(mods):
            m = ctx.modulus
            xs = [int.from_bytes(rng.bytes(32), "big") % m for _ in range(32)]
            ys = [int.from_bytes(rng.bytes(32), "big") % m for _ in range(32)]

            def words(vals):
                return torch.from_numpy(np.array(
                    [[(v >> (32 * j)) & 0xFFFFFFFF for j in range(8)]
                     for v in vals], np.uint32).view(np.int32)).cuda()

            a, b = words(xs), words(ys)
            o = torch.empty_like(a)

            def run():
                rc = fn(i, a.data_ptr(), b.data_ptr(), o.data_ptr(), n,
                        stream)
                if rc != 0:
                    raise SystemExit(f"bdls_field_chain: CUDA error {rc}")

            run()
            torch.cuda.synchronize()
            yy = ys if i == 4 else [y * pow(R, -1, m) % m for y in ys]
            got = [sum(int(w) << (32 * j) for j, w in enumerate(row))
                   for row in o.cpu().numpy().view(np.uint32)]
            if got != [x * pow(y, n, m) % m for x, y in zip(xs, yy)]:
                raise SystemExit(f"bdls_field_chain {label} {name}: wrong")
            ns = _events_ms(run, 3) * 1e6 / n
            out[f"{label} {name}"] = ns
            print(f"product {label}: mod {name}: {ns:.1f} ns a call "
                  f"(one warp, {n} dependent calls)", flush=True)
    return out


def probe_block(args, card: str) -> int:
    """K7 (``--block``): ``csrc/block.cu`` once per entry of
    ``--block-builds`` (as ``--builds``; an "@other" mxu build launched
    in blocks of 64 threads, an earlier tree's one thread a lane), on a
    hostile block of each curve (P-256 1000 txs, L 2048; secp256k1 60
    txs, L 128): every build's flags and lane verdicts equal the plain
    twin's on the card, then each is timed by CUDA events in turns."""
    from bdls_tpu_torch.crypto import vectors
    from bdls_tpu_torch.ops import _build
    from bdls_tpu_torch.ops import block_verify as bv
    from bdls_tpu_torch.ops.curves import CURVES
    from bdls_tpu_torch.ops.ecdsa import CURVE_IDS
    from bdls_tpu_torch.ops.verify_fold import device_g32_table

    labels = args.block_builds.split(",")
    threads_of: dict = {}
    libs = build(labels, args.compare, source="block.cu",
                 entry="bdls_verify_block", threads_entry=None,
                 lane_threads=threads_of)
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    stream = torch.cuda.current_stream().cuda_stream
    result = {"card": card, "builds": labels, "ms": {}}
    for curve, ntx in (("P-256", 1000), ("secp256k1", 60)):
        cv = CURVES[curve]
        packed = bv.pack_block_request(
            vectors.block_request(curve, rng, ntx, hostile=True))
        ts = [_build.as_int32(packed[k], dev) for k in bv.PACKED_KEYS]
        NB, _, L = packed["words"].shape
        T, O = packed["org_mask"].shape
        g32 = device_g32_table(curve, dev)
        hit = torch.zeros((T, O), dtype=torch.uint8, device=dev)
        valid = torch.zeros(L, dtype=torch.uint8, device=dev)
        flags = torch.zeros(T, dtype=torch.int32, device=dev)

        def k7(label):
            threads = 32 if threads_of[label] > 1 else 64
            rc = libs[label](CURVE_IDS[curve], *(t.data_ptr() for t in ts),
                             g32.data_ptr(), hit.data_ptr(),
                             valid.data_ptr(), flags.data_ptr(), NB, L, T,
                             O, threads, stream)
            if rc != 0:
                raise SystemExit(f"{label} launch: CUDA error {rc}")

        pflags, pvalid = bv.block_kernel(cv, *ts)
        pflags, pvalid = pflags.cpu().numpy(), pvalid.cpu().numpy()
        for label in labels:
            valid.zero_()
            flags.fill_(-1)
            k7(label)
            torch.cuda.synchronize()
            if not (np.array_equal(flags.cpu().numpy(), pflags) and
                    np.array_equal(valid.cpu().numpy().astype(bool),
                                   pvalid)):
                raise SystemExit(f"K7 {label} {curve}: differs from the "
                                 "plain twin")
        times = {label: [] for label in labels}
        for turn in range(args.turns):
            for label in (labels if turn % 2 == 0 else labels[::-1]):
                times[label].append(_events_ms(lambda: k7(label),
                                               args.reps))
        for label, tl in times.items():
            ms = float(np.median(tl))
            result["ms"][f"{label} {curve} L={L}"] = ms
            print(f"K7 {label}: {curve} L={L}: {ms:.3f} ms "
                  f"(turns {', '.join(f'{t:.3f}' for t in tl)})",
                  flush=True)
    print(card, flush=True)
    _write("block_group_probe.json", result)
    return 0


def probe_k4(args, card: str) -> int:
    from bdls_tpu_torch.crypto import vectors
    from bdls_tpu_torch.crypto.marshal import ints_to_limbs
    from bdls_tpu_torch.ops import _build
    from bdls_tpu_torch.ops.curves import CURVES
    from bdls_tpu_torch.ops.ecdsa import CURVE_IDS, device_mont16_table
    from bdls_tpu_torch.ops.verify_fold import device_g32_table

    labels = args.m16_builds.split(",")
    if args.compare and not any("@" in lb for lb in labels):
        labels.append("1@other")
    k1_labels = (args.k1_builds or str(_build.VERIFY_GROUP)).split(",")
    if args.compare and not any("@" in lb for lb in k1_labels):
        k1_labels.append(f"{k1_labels[0]}@other")
    threads_of: dict = {}
    libs = build(labels, args.compare, source="mont16.cu",
                 entry="bdls_verify_mont16",
                 threads_entry="bdls_mont16_lane_threads",
                 lane_threads=threads_of)
    k1_threads: dict = {}
    k1s = build(k1_labels, args.compare, lane_threads=k1_threads)
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    stream = torch.cuda.current_stream().cuda_stream
    result = {"card": card, "builds": labels, "k1_builds": k1_labels,
              "lane_threads": threads_of, "ms": {}}

    def block(threads_a_lane: int) -> int:
        # one warp a block; an earlier one-thread K4, 64 threads (its
        # wrapper's blocks)
        return 32 if threads_a_lane > 1 else 64

    for curve in CURVES:
        lanes = (vectors.mixed_lanes(curve, rng)
                 + vectors.ladder_lanes(curve, rng)
                 + vectors.select_lanes(curve, rng))
        lanes += vectors.signed_lanes(curve, 128 - len(lanes), rng)
        want = np.array(vectors.expected(curve, lanes))
        gtab = device_mont16_table(curve, dev)
        g32 = device_g32_table(curve, dev)
        for B in SIZES:
            idx = [i % len(lanes) for i in range(B)]
            cols = [torch.from_numpy(ints_to_limbs(c).view(np.int32)).to(dev)
                    for c in vectors.columns([lanes[i] for i in idx])]
            out = torch.zeros(B, dtype=torch.uint8, device=dev)

            def k4(label):
                rc = libs[label](CURVE_IDS[curve],
                                 *(c.data_ptr() for c in cols),
                                 gtab.data_ptr(), out.data_ptr(), B,
                                 block(threads_of[label]), stream)
                if rc != 0:
                    raise SystemExit(f"{label} launch: CUDA error {rc}")

            def k1(label):
                rc = k1s[label](CURVE_IDS[curve],
                                *(c.data_ptr() for c in cols),
                                g32.data_ptr(), out.data_ptr(), B,
                                block(k1_threads[label]), stream)
                if rc != 0:
                    raise SystemExit(f"K1 {label} launch: CUDA error {rc}")

            runs = {f"K4 {label}": (lambda lb=label: k4(lb))
                    for label in labels}
            for label in k1_labels:
                runs[f"K1 {label}"] = lambda lb=label: k1(lb)
            for label, fn in runs.items():
                out.zero_()
                fn()
                torch.cuda.synchronize()
                ok = out.cpu().numpy().astype(bool)
                if not np.array_equal(ok, want[idx]):
                    bad = [lanes[idx[i]][5] for i in
                           np.flatnonzero(ok != want[idx])][:8]
                    raise SystemExit(f"{label} {curve} B={B}: wrong {bad}")
            reps = args.reps if B <= 2048 else max(args.reps // 2, 3)
            order = list(runs)
            times = {label: [] for label in order}
            for turn in range(args.turns):
                for label in (order if turn % 2 == 0 else order[::-1]):
                    times[label].append(_events_ms(runs[label], reps))
            for label, ts in times.items():
                ms = float(np.median(ts))
                result["ms"][f"{label} {curve} B={B}"] = ms
                print(f"{label}: {curve} B={B}: {ms:.3f} ms "
                      f"(turns {', '.join(f'{t:.3f}' for t in ts)})",
                      flush=True)
    print(card, flush=True)
    _write("mont16_group_probe.json", result)
    return 0

def _sha_defines(label: str) -> tuple[int, list[str]]:
    """A K6 build label -> (rounds warps a CTA, -D flags): ``R+NAME``;
    R = 0 is a build of one thread a lane."""
    spec = label.split("@")[0].split("+")
    rounds = int(spec[0])
    return rounds, ([f"-DBDLS_SHA_ROUND_WARPS={rounds}"] if rounds else []) \
        + [f"-D{d}" for d in spec[1:]]


def _sha_batches(rng) -> dict:
    """K6's shapes, each lane a message or None for a filler lane (count
    0); "uniform k" batches of 2048 lanes of k blocks give the cost a
    block and the fixed cost of a launch."""
    from bdls_tpu_torch.ops import sha256

    def uniform(k):
        lo = 64 * k - 72 if k > 1 else 0
        msgs = [rng.bytes(int(n)) for n in rng.integers(lo, lo + 56, 2048)]
        assert {sha256.n_blocks(len(m)) for m in msgs} == {k}
        return msgs

    lens = [1000] + [int(v) for v in rng.integers(200, 1001, 999)]
    main = [m for n in lens for m in [rng.bytes(n)] * 2] + [None] * 48
    return {"main": main, "first 128": main[:128],
            "2049": main[:2000] + [None] * 48 + [rng.bytes(1015)],
            "tiled x4": main * 4, "uniform": uniform(16),
            "uniform 1": uniform(1), "uniform 4": uniform(4)}


def _sass_histogram(so: Path, label: str) -> dict:
    """The kernels' SASS of one library (``cuobjdump -sass``), written
    beside it, and its instruction count by opcode."""
    from bdls_tpu_torch.ops import _build

    tool = Path(_build.nvcc_path()).parent / "cuobjdump"
    sass = subprocess.run([str(tool), "-sass", str(so)], capture_output=True,
                          text=True, check=True).stdout
    so.with_suffix(".sass").write_text(sass)
    hist: dict = {}
    for line in sass.splitlines():
        part = line.split("*/", 1)
        if not line.strip().startswith("/*") or len(part) < 2:
            continue
        words = part[1].replace(";", " ").split()
        if words and words[0].startswith("@"):
            words = words[1:]
        if words:
            hist[words[0]] = hist.get(words[0], 0) + 1
    top = sorted(hist.items(), key=lambda kv: -kv[1])
    print(f"sass sha256.cu {label}: {sum(hist.values())} instructions; "
          + ", ".join(f"{k} {v}" for k, v in top[:24]), flush=True)
    return hist


def probe_sha256(args, card: str) -> int:
    """K6 (``--sha256``): the builds of ``--sha-builds`` side by side,
    every build's digests against hashlib at five shapes, then each timed
    in turns at four."""
    from bdls_tpu_torch.ops import _build, sha256

    labels = args.sha_builds.split(",")
    if args.compare and not any("@" in lb for lb in labels):
        labels.append("0@other")
    libs = build(labels, args.compare, source="sha256.cu",
                 entry="bdls_sha256", threads_entry=None,
                 defines=_sha_defines)
    sass = {}
    if args.sass:
        for label in labels:
            so = Path(LOADED[("sha256.cu", label)]._name)
            sass[label] = _sass_histogram(so, label)
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    iv = sha256.H0.astype(">u4").tobytes()
    result = {"card": card, "builds": labels, "ms": {}, "graph_ms": {},
              "ns_per_round": {}, "shapes": {}, "sass": sass}

    def threads(label: str) -> int:
        rounds = _sha_defines(label)[0]
        return 32 * (1 + rounds) if rounds else 128

    for name, lanes in _sha_batches(rng).items():
        words, nblocks = sha256.pad_messages(
            [m if m is not None else b"" for m in lanes], max_blocks=16)
        nblocks[[m is None for m in lanes]] = 0
        want = [hashlib.sha256(m).digest() if m is not None else iv
                for m in lanes]
        w, nb = _build.as_int32(words, dev), _build.as_int32(nblocks, dev)
        NB, _, B = words.shape
        out = torch.zeros((8, B), dtype=torch.int32, device=dev)
        longest = int(nblocks.max())
        result["shapes"][name] = {"lanes": B, "NB": NB,
                                  "active_blocks": int(nblocks.sum()),
                                  "longest_blocks": longest}

        def k6(label):
            rc = libs[label](w.data_ptr(), nb.data_ptr(), out.data_ptr(),
                             NB, B, threads(label),
                             torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                raise SystemExit(f"K6 {label} launch: CUDA error {rc}")

        for label in labels:
            out.fill_(-1)
            k6(label)
            torch.cuda.synchronize()
            be = out.cpu().numpy().view(np.uint32).astype(">u4")
            bad = [i for i in range(B) if be[:, i].tobytes() != want[i]]
            if bad:
                raise SystemExit(f"K6 {label} {name}: lanes {bad[:8]} "
                                 "differ from hashlib")
        print(f"K6 {name} ({B} lanes, {int(nblocks.sum())} active blocks, "
              f"longest {longest}): every build equals hashlib", flush=True)
        if name == "2049":
            continue
        times = {label: [] for label in labels}
        graphs = {label: [] for label in labels}
        for turn in range(args.turns):
            for label in (labels if turn % 2 == 0 else labels[::-1]):
                times[label].append(_events_ms(lambda: k6(label), 200))
                graphs[label].append(_graph_ms(lambda: k6(label)))
        for label, tl in times.items():
            ms, gms = float(np.median(tl)), float(np.median(graphs[label]))
            ns = gms * 1e6 / (64 * longest)
            result["ms"][f"{label} {name}"] = ms
            result["graph_ms"][f"{label} {name}"] = gms
            result["ns_per_round"][f"{label} {name}"] = ns
            print(f"K6 {label}: {name}: {ms:.4f} ms a launch from the host "
                  f"(turns {', '.join(f'{t:.4f}' for t in tl)}), "
                  f"{gms:.4f} ms in a graph (turns "
                  f"{', '.join(f'{t:.4f}' for t in graphs[label])}), "
                  f"{ns:.2f} ns a round", flush=True)
    print(card, flush=True)
    _write("sha256_probe.json", result)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--groups", default="4,8,16,32")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--one-lane", action="store_true",
                    help="also time blocks of one lane")
    ap.add_argument("--compare", default=None,
                    help="a copy of bdls_tpu_torch/csrc (another tree's): "
                         "K1's builds also made from it, as <group>@other")
    ap.add_argument("--pinned", action="store_true",
                    help="probe K2's builds (csrc/pinned.cu) against K1")
    ap.add_argument("--builds", default=PINNED_BUILDS,
                    help="K2's builds: <group>+DEFINE..., <group>@other")
    ap.add_argument("--k1-builds", default=None,
                    help="with --pinned, K1's builds (default the group "
                         "size; with --compare and no @other entry also "
                         "<group>@other)")
    ap.add_argument("--turns", type=int, default=3)
    ap.add_argument("--fields", action="store_true",
                    help="time a chain of Montgomery products a lane")
    ap.add_argument("--chain", type=int, default=4096)
    ap.add_argument("--block", action="store_true",
                    help="probe K7's builds (csrc/block.cu)")
    ap.add_argument("--block-builds", default="8",
                    help="K7's builds, as --builds")
    ap.add_argument("--ed25519", action="store_true",
                    help="probe K8's builds (csrc/ed25519.cu)")
    ap.add_argument("--mont16", action="store_true",
                    help="probe K4's builds (csrc/mont16.cu) against K1")
    ap.add_argument("--m16-builds", default="8",
                    help="K4's builds: <group>+DEFINE...[@other]; with "
                         "--compare and no @other entry also the copy's, "
                         "as 1@other (an earlier one-thread K4)")
    ap.add_argument("--sha256", action="store_true",
                    help="probe K6's builds (csrc/sha256.cu)")
    ap.add_argument("--sha-builds", default=SHA_BUILDS,
                    help="K6's builds: <rounds warps, 0 for one thread a "
                         "lane>+DEFINE...[@other]; with --compare and no "
                         "@other entry also the copy's, as 0@other")
    ap.add_argument("--sass", action="store_true",
                    help="with --sha256, each build's SASS by opcode")
    ap.add_argument("--ed-builds", default=ED_BUILDS,
                    help="K8's builds: <group>+DEFINE...[@other]; with "
                         "--compare and no @other entry also the copy's, "
                         "as 1@other")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    card = _card()
    if args.fields:
        return probe_fields(args, card)
    if args.ed25519:
        return probe_ed25519(args, card)
    if args.block:
        return probe_block(args, card)
    if args.mont16:
        return probe_k4(args, card)
    if args.sha256:
        return probe_sha256(args, card)
    return probe_k2(args, card) if args.pinned else probe_k1(args, card)


if __name__ == "__main__":
    sys.exit(main())
