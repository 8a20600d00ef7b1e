"""Fused block validation: hash → ECDSA verify → policy, one launch (K7).

The counterpart of ``bdls_tpu/ops/block_verify.py``. A whole block's
endorsement lanes go in as raw messages plus key and signature limbs;
per-tx flags come out, with no return to the host between the stages:

1. **hash**: SHA-256 of each lane's padded message
   (:mod:`bdls_tpu_torch.ops.sha256`), the digest straight into the
   16-bit-limb layout the verify takes;
2. **verify**: the generic ECDSA verify (K1's body);
3. **policy**: each valid lane marks its (tx, org) cell of a hit
   bitmap, the per-tx org mask intersects it, and a distinct-org count
   against ``required`` gives ``TXFLAG_VALID`` or
   ``TXFLAG_POLICY_FAILURE``.

Every axis is bucket-padded (:func:`plan_buckets`), as in the reference;
filler lanes carry ``tx = -1`` and never hit. :func:`pack_block_request`
is bit-identical to the reference's, key for key, and
:func:`launch_block` takes either package's packed dict.

Where the tensors lie decides what runs: on a CUDA device the
hand-written kernel ``csrc/block.cu``, launched on the current stream
and not synchronised (a build or launch error raises; there is no
fallback); on the CPU the plain PyTorch version :func:`block_kernel`.
``LAUNCHES_BLOCK`` counts launches of the CUDA kernel per curve: one per
call that launched it, and nothing else.
"""

from __future__ import annotations

import numpy as np
import torch

from bdls_tpu_torch.crypto.blocklane import TXFLAG_POLICY_FAILURE, \
    TXFLAG_VALID, lane_screened, policy_org_masks
from bdls_tpu_torch.crypto.marshal import FILLER32, bytes32_to_limbs
from bdls_tpu_torch.ops import _build, fold
from bdls_tpu_torch.ops import sha256 as sha_ops
from bdls_tpu_torch.ops.curves import CURVES, Curve
from bdls_tpu_torch.ops.ecdsa import CURVE_IDS, FOLD_FIELDS, \
    block_threads, engine_for
from bdls_tpu_torch.ops.verify_fold import device_g32_table, verify_fold
from bdls_tpu_torch.utils.device import DeviceLike, resolve_device

# bucket families, as the reference: every distinct tuple is one shape
LANE_BUCKETS = (8, 32, 128, 512, 2048, 8192)
TX_BUCKETS = (8, 32, 128, 512, 2048)
NB_BUCKETS = (1, 2, 4, 8, 16)
ORG_BUCKETS = (4, 8, 16, 32)

# the kernel's inputs, in the order of its C entry
PACKED_KEYS = ("words", "nblocks", "qx", "qy", "r", "s", "lane_tx",
               "lane_org", "org_mask", "required")

LAUNCHES_BLOCK = {name: 0 for name in CURVE_IDS}
# K7 from its mxu build (K5's product), counted apart
LAUNCHES_BLOCK_MXU = {name: 0 for name in CURVE_IDS}
_COUNTS = {"vpu": LAUNCHES_BLOCK, "mxu": LAUNCHES_BLOCK_MXU}


def _bucket_for(n: int, buckets) -> int:
    for b in buckets:
        if b >= n:
            return b
    raise ValueError(f"{n} exceeds the largest bucket {buckets[-1]}")


def plan_buckets(n_lanes: int, n_tx: int, n_blocks: int,
                 n_orgs: int) -> tuple[int, int, int, int]:
    """Round every axis up to its bucket family; a ``ValueError`` past
    the largest bucket of any."""
    return (_bucket_for(max(n_lanes, 1), LANE_BUCKETS),
            _bucket_for(max(n_tx, 1), TX_BUCKETS),
            _bucket_for(max(n_blocks, 1), NB_BUCKETS),
            _bucket_for(max(n_orgs, 1), ORG_BUCKETS))


def request_buckets(req) -> tuple[int, int, int, int]:
    """:func:`plan_buckets` for a request: its lanes, txs, the block
    count of its longest message (screened lanes included) and its
    orgs."""
    nb_need = max((sha_ops.n_blocks(len(ln.msg)) for ln in req.lanes),
                  default=1)
    return plan_buckets(len(req.lanes), req.ntx, nb_need, req.norgs)


# ---------------------------------------------------------- plain version

def block_kernel(curve: Curve, words, nblocks, qx16, qy16, r16, s16,
                 lane_tx, lane_org, org_mask, required):
    """The plain fused program. Shapes: ``words`` (NB, 16, L) padded
    message blocks, ``nblocks`` (L,), the four (16, L) limb arrays,
    ``lane_tx``/``lane_org`` (L,) bitmap coordinates (tx = -1 for
    filler lanes), ``org_mask`` (T, O), ``required`` (T,); integer
    tensors holding the reference's uint32/int32 bit patterns. Returns
    ``(flags (T,) int32, valid (L,) bool)``."""
    e16 = sha_ops.words_to_e16(sha_ops.sha256_words(words, nblocks))
    valid = verify_fold(curve, qx16, qy16, r16, s16, e16)
    T, O = org_mask.shape
    tx, org = lane_tx.to(torch.int64), lane_org.to(torch.int64)
    hits = valid & (tx >= 0) & (tx < T) & (org >= 0) & (org < O)
    hit = torch.zeros(T * O, dtype=torch.bool, device=valid.device)
    hit[(tx * O + org)[hits]] = True
    cnt = (hit.view(T, O) & (org_mask != 0)).sum(dim=1)
    flags = torch.where(cnt >= required.to(torch.int64), TXFLAG_VALID,
                        TXFLAG_POLICY_FAILURE).to(torch.int32)
    return flags, valid


# ------------------------------------------------------------ the kernel

def verify_block_cuda(curve: Curve, words, nblocks, qx, qy, r, s, lane_tx,
                      lane_org, org_mask, required, *, engine: str = "vpu"):
    """Launch K7 over the ten inputs of :data:`PACKED_KEYS`, contiguous
    int32 tensors on one CUDA device, from the ``engine``'s build
    ("mxu": K7 with K5's product); returns ``(flags (T,) int32, valid
    (L,) bool)`` (not yet synchronised)."""
    ts = (words, nblocks, qx, qy, r, s, lane_tx, lane_org, org_mask,
          required)
    dev = words.device
    if words.dim() != 3 or words.shape[1] != 16 or org_mask.dim() != 2:
        raise ValueError("verify_block_cuda takes (NB, 16, L) words and a "
                         "(T, O) org_mask")
    NB, _, L = words.shape
    T, O = org_mask.shape
    shapes = ((NB, 16, L), (L,), (16, L), (16, L), (16, L), (16, L), (L,),
              (L,), (T, O), (T,))
    for t, shape in zip(ts, shapes):
        if (t.device != dev or t.dtype != torch.int32
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError("verify_block_cuda takes contiguous int32 "
                             "tensors of matching shapes on one CUDA device")
    hit = torch.empty((T, O), dtype=torch.uint8, device=dev)
    valid = torch.empty(L, dtype=torch.uint8, device=dev)
    flags = torch.empty(T, dtype=torch.int32, device=dev)
    gtab = device_g32_table(curve.name, dev)
    lib = _build.lib(engine)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.bdls_verify_block(
            CURVE_IDS[curve.name], *(t.data_ptr() for t in ts),
            gtab.data_ptr(), hit.data_ptr(), valid.data_ptr(),
            flags.data_ptr(), NB, L, T, O, block_threads(engine), stream)
    _build.check(rc, f"bdls_verify_block[{engine}]({curve.name}, L={L}, "
                     f"T={T})")
    with _build.count_lock:
        _COUNTS[engine][curve.name] += 1
    return flags, valid.view(torch.bool)


def launch_block(curve: Curve, packed: dict, *, device: DeviceLike = None,
                 field: str = "fold"):
    """Start one fused block launch over :func:`pack_block_request`
    output (this package's or the reference's: numpy arrays or
    tensors) on ``device`` (default ``cuda``), on the engine
    :data:`FOLD_FIELDS` gives ``field``. Returns ``(flags (T,) int32,
    valid (L,) bool)`` tensors; on the card not yet synchronised."""
    dev = resolve_device(device)
    engine = engine_for(field, FOLD_FIELDS)
    ts = [_build.as_int32(packed[k], dev) for k in PACKED_KEYS]
    if dev.type == "cuda":
        return verify_block_cuda(curve, *ts, engine=engine)
    with fold.mul_backend(engine):
        return block_kernel(curve, *ts)


# ---------------------------------------------------------- host packing

def pack_block_request(req, *, lane_ok=None,
                       buckets: tuple[int, int, int, int] | None = None,
                       ) -> dict:
    """Marshal one block request into the fused program's bucket-padded
    input arrays.

    ``lane_ok`` is the host-side lane screen (default: the wire length
    screen); the provider adds its low-S policy there. Lanes it rejects
    pack FILLER32 fields with ``tx = -1``: well-formed kernel work that
    can never hit a bitmap row. Filler tx rows demand 1-of-nothing and
    are sliced off by the caller."""
    screen = lane_ok if lane_ok is not None else lane_screened
    L, T = len(req.lanes), req.ntx
    if buckets is None:
        buckets = request_buckets(req)
    Lb, Tb, NBb, Ob = buckets

    msgs: list[bytes] = []
    cols: tuple[list, ...] = ([], [], [], [])
    lane_tx = np.full(Lb, -1, dtype=np.int32)
    lane_org = np.zeros(Lb, dtype=np.int32)
    for i, ln in enumerate(req.lanes):
        if screen(ln):
            msgs.append(ln.msg)
            for col, val in zip(cols, (ln.qx, ln.qy, ln.r, ln.s)):
                col.append(val.rjust(32, b"\0"))
            if 0 <= ln.tx < T and 0 <= ln.org < req.norgs:
                lane_tx[i] = ln.tx
                lane_org[i] = ln.org
        else:
            msgs.append(b"")
            for col in cols:
                col.append(FILLER32)
    for _ in range(Lb - L):
        msgs.append(b"")
        for col in cols:
            col.append(FILLER32)
    words, nblocks = sha_ops.pad_messages(msgs, max_blocks=NBb)

    mask = np.zeros((Tb, Ob), dtype=np.uint32)
    mask[:T, :req.norgs] = policy_org_masks(req.policies, req.norgs)
    required = np.ones(Tb, dtype=np.int32)
    required[:T] = [int(p.required) for p in req.policies]

    qx, qy, r, s = (bytes32_to_limbs(c) for c in cols)
    return {
        "words": words, "nblocks": nblocks.astype(np.int32),
        "qx": qx, "qy": qy, "r": r, "s": s,
        "lane_tx": lane_tx, "lane_org": lane_org,
        "org_mask": mask, "required": required,
        "ntx": T,
    }


def verify_block_fused(req, *, lane_ok=None, device: DeviceLike = None,
                       field: str = "fold") -> np.ndarray:
    """Synchronous fused verify: pack, launch, read back, slice the real
    tx rows. Returns per-tx int32 TXFLAG_* verdicts."""
    curve = CURVES[req.curve]
    packed = pack_block_request(req, lane_ok=lane_ok)
    flags, _valid = launch_block(curve, packed, device=device, field=field)
    return flags.cpu().numpy()[:packed["ntx"]].astype(np.int32)
