"""Probe K1's thread-group body on one NVIDIA GPU.

    python3 tools/torch_verify_group_probe.py [--groups 4,8,16,32]
        [--one-lane] [--compare DIR]

Builds ``bdls_tpu_torch/csrc/verify.cu`` once per entry of ``--groups``
with ``-DBDLS_VERIFY_GROUP=<threads a lane>`` (an entry ``8+NAME`` also
defines NAME), with the nvcc flags of ``bdls_tpu_torch/ops/_build.py``,
one compiler an entry, side by side, into ``build/probe/``;
``--compare DIR`` also builds each entry from a copy of the sources at
DIR (another tree's), timed before this tree's. Prints each build's
``-Xptxas -v`` lines, then for each build and curve checks the verdicts
of 128 seeded lanes (valid, tampered and hostile, ``crypto/vectors.py``)
against the integer ECDSA and times the kernel by CUDA events at 128,
2048 and 8192 lanes (the lanes tiled), with blocks of one warp and,
with ``--one-lane``, of one lane. Prints the card's name and power limit
and, as the last line, a JSON object of every number; also writes it to
``build/verify_group_probe.json``. Exits non-zero on a failed build or
a wrong verdict.
"""

from __future__ import annotations

import argparse
import ctypes
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
SIZES = (128, 2048, 8192)


def build(groups, compare=None) -> dict:
    """One build of verify.cu a group label: a size, then any defines
    after "+", and "@other" for the copy of the sources at ``compare``."""
    from bdls_tpu_torch.ops import _build

    out_dir = _build.BUILD_DIR / "probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for g in groups:
        spec, _, other = g.partition("@")
        src = Path(compare) if other else _build.CSRC
        so = out_dir / f"libverify_{g.replace('@', '_at_')}.so"
        procs[g] = (so, subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS,
             f"-DBDLS_VERIFY_GROUP={spec.split('+')[0]}",
             *[f"-D{d}" for d in spec.split("+")[1:]], "-o", str(so),
             str(src / "verify.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs, reports = {}, {}
    for g, (so, proc) in procs.items():
        reports[g] = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"nvcc group {g} failed:\n{reports[g]}")
        lib = ctypes.CDLL(str(so))
        fn = lib.bdls_verify
        fn.argtypes = _build.ENTRIES["verify.cu"]["bdls_verify"]
        fn.restype = ctypes.c_int
        if lib.bdls_verify_lane_threads() != int(g.split("+")[0]
                                                 .split("@")[0]):
            raise SystemExit(f"group {g}: the build runs "
                             f"{lib.bdls_verify_lane_threads()} threads")
        libs[g] = fn
    print(f"nvcc {time.perf_counter() - t0:.1f} s for groups {list(groups)}",
          flush=True)
    for g, rep in reports.items():
        for line in rep.splitlines():
            if "Used" in line or "spill" in line or "Compiling entry" in line:
                print(f"ptxas g{g}: {line.strip()}", flush=True)
    return libs


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--groups", default="4,8,16,32")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--one-lane", action="store_true",
                    help="also time blocks of one lane")
    ap.add_argument("--compare", default=None,
                    help="a copy of bdls_tpu_torch/csrc (another tree's): "
                         "each group also built from it, as <group>@other")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
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
        size = int(g.split("+")[0].split("@")[0])
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
                    e0 = torch.cuda.Event(enable_timing=True)
                    e1 = torch.cuda.Event(enable_timing=True)
                    reps = args.reps if B <= 2048 else max(args.reps // 2, 3)
                    e0.record()
                    for _ in range(reps):
                        launch(fn, curve, cols, g32, out, B, threads)
                    e1.record()
                    torch.cuda.synchronize()
                    ms = e0.elapsed_time(e1) / reps
                    key = f"{curve} B={B} threads={threads}"
                    res[key] = ms
                    print(f"group {g}: {key}: {ms:.3f} ms", flush=True)
    print(card, flush=True)
    os.makedirs(ROOT / "build", exist_ok=True)
    (ROOT / "build" / "verify_group_probe.json").write_text(
        json.dumps(result, indent=1))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
