"""Batched ECDSA verification — the port's launch wrappers.

The counterpart of ``bdls_tpu/ops/ecdsa.py`` (``verify_kernel``,
``launch_verify``, ``launch_verify_pinned``, ``launch_verify_latency``,
``verify_limbs``, ``verify_batch``) for the generic-key program (K1),
the pinned-key program (K2), the latency tier's form of K1 (K3,
:class:`LatencySlot`) and the gen-1 ``mont16`` program (K4). The kernel
field picks the program, as the reference's ``field=`` does:

- ``"fold"`` (the default here, see below) runs K1/K2/K3 on the "vpu"
  engine (``csrc/field.cuh``'s CIOS product);
- ``"mxu"`` runs the same programs on the "mxu" engine: their K5 builds,
  whose products go through the tensor cores (``csrc/mxu.cuh``); the
  plain twins run under ``fold.mul_backend("mxu")``;
- ``"mont16"`` runs K4 (``csrc/mont16.cu``; plain twin
  :func:`verify_kernel`) for generic lanes and, as the reference's
  ``PINNED_FIELDS`` says, K2 on the vpu engine for pinned lanes. It has
  no latency program.

The reference's ``DEFAULT_FIELD`` reads ``BDLS_KERNEL_FIELD`` and
defaults to ``"mont16"``; here the ops-level default stays ``"fold"``,
because every caller without a field means K1 (ROADMAP.md, Queue C,
deliberate differences). The provider passes its field explicitly.

Where a limb tensor lies decides what runs:

- on a CUDA device, the hand-written kernel for the curve
  (``csrc/verify.cu``, ``csrc/pinned.cu``), launched on the current
  stream and not synchronised; a build or launch error raises (there is
  no fallback to the plain version);
- on the CPU, the plain PyTorch version
  (:func:`bdls_tpu_torch.ops.verify_fold.verify_fold`,
  :func:`bdls_tpu_torch.ops.verify_fold.verify_fold_pinned`).

``LAUNCHES`` and ``LAUNCHES_PINNED`` count kernel launches per curve:
one per call that launched the CUDA kernel, and nothing else.
``LAUNCHES_LATENCY`` counts replays of K3's captured graphs, which
launch the same K1 kernel and are not counted in ``LAUNCHES``. Those
three count the vpu builds; ``LAUNCHES_MXU``, ``LAUNCHES_PINNED_MXU`` and
``LAUNCHES_LATENCY_MXU`` count the mxu builds, ``LAUNCHES_MONT16`` K4.

Semantics: standard ECDSA over short-Weierstrass curves, the digest
taken as a 256-bit integer reduced mod n. The low-S policy stays in the
provider; the kernel accepts any s in [1, n-1].
"""

from __future__ import annotations

import functools
from typing import Sequence

import numpy as np
import torch

from bdls_tpu_torch.crypto.marshal import ints_to_limbs
from bdls_tpu_torch.ops import _build, fold, mxu  # noqa: F401 (mxu engine)
from bdls_tpu_torch.ops import mont
from bdls_tpu_torch.ops.curves import Curve
from bdls_tpu_torch.ops.jacobian import fixed_base_table, shamir_mul, \
    windowed_dual_mul
from bdls_tpu_torch.ops.mont import add_const_carry, batch_inv, eq, \
    from_mont, geq_const, is_zero, mod_add, mont_inv, mont_mul, mont_sqr, \
    reduce_once, to_mont
from bdls_tpu_torch.ops.verify_fold import check_pools, device_g32_table, \
    device_g_table, verify_fold, verify_fold_pinned
from bdls_tpu_torch.utils.device import DeviceLike, resolve_device

CURVE_IDS = {"P-256": 0, "secp256k1": 1}
# the ops-level default field (the reference's is "mont16"; see above)
DEFAULT_FIELD = "fold"
# fields that run the fold verify program, and the engine each binds
FOLD_FIELDS = {"fold": "vpu", "mxu": "mxu"}
# the engine the pinned-key program binds per field: mont16 rides the vpu
# engine for its pinned lanes, as in the reference
PINNED_FIELDS = {"fold": "vpu", "mxu": "mxu", "mont16": "vpu"}
LAUNCHES = {name: 0 for name in CURVE_IDS}
LAUNCHES_PINNED = {name: 0 for name in CURVE_IDS}
LAUNCHES_LATENCY = {name: 0 for name in CURVE_IDS}
LAUNCHES_MXU = {name: 0 for name in CURVE_IDS}
LAUNCHES_PINNED_MXU = {name: 0 for name in CURVE_IDS}
LAUNCHES_LATENCY_MXU = {name: 0 for name in CURVE_IDS}
LAUNCHES_MONT16 = {name: 0 for name in CURVE_IDS}
_GENERIC = {"vpu": LAUNCHES, "mxu": LAUNCHES_MXU}
_PINNED = {"vpu": LAUNCHES_PINNED, "mxu": LAUNCHES_PINNED_MXU}
_LATENCY = {"vpu": LAUNCHES_LATENCY, "mxu": LAUNCHES_LATENCY_MXU}
# threads per block: one lane per thread; small blocks spread a bucket
# over as many of the 132 SMs as it has warps
THREADS = 64


def reset_launches() -> None:
    """Set every kernel's launch count to 0: K1, K2, K3's replays (each
    build) and K4 here, K6 in ``ops.sha256``, K7 in ``ops.block_verify``
    and K8 in ``ops.ed25519`` (each build)."""
    from bdls_tpu_torch.ops import block_verify, ed25519, sha256

    with _build.count_lock:
        for counts in (LAUNCHES, LAUNCHES_PINNED, LAUNCHES_LATENCY,
                       LAUNCHES_MXU, LAUNCHES_PINNED_MXU,
                       LAUNCHES_LATENCY_MXU, LAUNCHES_MONT16,
                       sha256.LAUNCHES_SHA256, block_verify.LAUNCHES_BLOCK,
                       block_verify.LAUNCHES_BLOCK_MXU,
                       ed25519.LAUNCHES_ED25519,
                       ed25519.LAUNCHES_ED25519_MXU):
            for k in counts:
                counts[k] = 0


def engine_for(field: str, table: dict) -> str:
    """The limb engine ``table`` (:data:`FOLD_FIELDS`, :data:`PINNED_FIELDS`
    or ``ed25519.ENGINES``) binds for ``field``; a field without that
    program raises."""
    try:
        return table[field]
    except KeyError:
        raise ValueError(f"kernel field {field!r} has no such program "
                         f"(fields: {sorted(table)})") from None


# ------------------------------------------------------- K4's plain twin

def verify_kernel(curve: Curve, qx, qy, r, s, e, *, inv: str = "batch",
                  ladder: str = "windowed") -> torch.Tensor:
    """The gen-1 ``mont16`` verify, the plain twin of K4
    (``bdls_tpu/ops/ecdsa.py:verify_kernel`` under ``field="mont16"``).
    Five ``(16, B)`` tensors of 16-bit limbs (any integer dtype, values
    < 2^256) -> ``(B,)`` bool.

    The 4-bit windowed dual ladder (or Shamir's, ``ladder="shamir"``) in
    Jacobian coordinates, one batch inversion of s across the batch (or a
    Fermat inverse a lane, ``inv="fermat"``), and the inversion-free
    check ``X == r·Z^2`` or ``X == (r + n)·Z^2`` (mod p), the latter only
    where r + n < p. K4 runs inv="batch", ladder="windowed", inverting
    across each thread block (the same values)."""
    if inv not in ("batch", "fermat") or ladder not in ("windowed",
                                                          "shamir"):
        raise ValueError(f"unknown strategy inv={inv!r} ladder={ladder!r}")
    qx, qy, r, s, e = (a.to(torch.int64) & mont.MASK
                       for a in (qx, qy, r, s, e))
    fp, fn = curve.fp, curve.fn
    r_ok = ~is_zero(r) & ~geq_const(r, fn.m_limbs)
    s_ok = ~is_zero(s) & ~geq_const(s, fn.m_limbs)
    q_ok = ~geq_const(qx, fp.m_limbs) & ~geq_const(qy, fp.m_limbs)

    e_red = reduce_once(fn, e)       # e < 2^256 < 2n for both curves
    s_m = to_mont(fn, s)
    sinv_m = batch_inv(fn, s_m) if inv == "batch" else mont_inv(fn, s_m)
    u1 = from_mont(fn, mont_mul(fn, to_mont(fn, e_red), sinv_m))
    u2 = from_mont(fn, mont_mul(fn, to_mont(fn, r), sinv_m))

    qx_m, qy_m = to_mont(fp, qx), to_mont(fp, qy)
    y2 = mont_sqr(fp, qy_m)
    x3 = mont_mul(fp, mont_sqr(fp, qx_m), qx_m)
    rhs = mod_add(fp, x3, mont.bcast_const(curve.b_mont, x3).expand_as(x3))
    if curve.a_kind != "zero":
        rhs = mod_add(fp, rhs, mont_mul(
            fp, mont.bcast_const(curve.a_mont, qx_m), qx_m))
    on_curve = eq(y2, rhs) & ~(is_zero(qx) & is_zero(qy))

    mul = windowed_dual_mul if ladder == "windowed" else shamir_mul
    rp = mul(curve, u1, u2, qx_m, qy_m)
    not_inf = ~is_zero(rp.z)

    z2 = mont_sqr(fp, rp.z)
    ok1 = eq(rp.x, mont_mul(fp, to_mont(fp, r), z2))
    rn, carry = add_const_carry(r, fn.m_limbs)
    rn_fits = (carry == 0) & ~geq_const(rn, fp.m_limbs)
    ok2 = rn_fits & eq(rp.x, mont_mul(fp, to_mont(fp, rn), z2))
    return r_ok & s_ok & q_ok & on_curve & not_inf & (ok1 | ok2)


@functools.lru_cache(maxsize=None)
def device_mont16_table(curve_name: str, device: torch.device) -> torch.Tensor:
    """K4's host G table: :func:`~bdls_tpu_torch.ops.jacobian.
    fixed_base_table` (the reference's, bit for bit) as ``(16, 2, 8)``
    int32 words on ``device``."""
    xs, ys = fixed_base_table(curve_name)
    tab = np.stack([xs, ys], axis=1).astype(np.uint32)       # (16, 2, 16)
    words = tab[..., 0::2] | (tab[..., 1::2] << 16)
    return torch.from_numpy(np.ascontiguousarray(words).view(np.int32)
                            ).to(device)


def _check_limbs(arrs, what: str) -> None:
    dev, B = arrs[0].device, arrs[0].shape[1]
    for a in arrs:
        if (a.device != dev or a.dtype != torch.int32 or a.dim() != 2
                or a.shape != (16, B) or not a.is_contiguous()):
            raise ValueError(f"{what} takes {len(arrs)} contiguous "
                             "(16, B) int32 tensors on one CUDA device")


def verify_mont16_cuda(curve: Curve, qx, qy, r, s, e) -> torch.Tensor:
    """Launch K4 (``csrc/mont16.cu``) over five ``(16, B)`` int32 CUDA
    tensors; returns the ``(B,)`` bool verdict (not yet synchronised)."""
    arrs = (qx, qy, r, s, e)
    _check_limbs(arrs, "verify_mont16_cuda")
    dev, B = qx.device, qx.shape[1]
    out = torch.empty(B, dtype=torch.uint8, device=dev)
    gtab = device_mont16_table(curve.name, dev)
    lib = _build.lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.bdls_verify_mont16(CURVE_IDS[curve.name],
                                    *(a.data_ptr() for a in arrs),
                                    gtab.data_ptr(), out.data_ptr(), B,
                                    THREADS, stream)
    _build.check(rc, f"bdls_verify_mont16({curve.name}, B={B})")
    with _build.count_lock:
        LAUNCHES_MONT16[curve.name] += 1
    return out.view(torch.bool)


def verify_fold_cuda(curve: Curve, qx, qy, r, s, e, *,
                     engine: str = "vpu") -> torch.Tensor:
    """Launch K1 over five ``(16, B)`` int32 CUDA tensors, from the
    ``engine``'s build ("mxu": K1 with K5's product); returns the
    ``(B,)`` bool verdict (not yet synchronised)."""
    arrs = (qx, qy, r, s, e)
    _check_limbs(arrs, "verify_fold_cuda")
    dev, B = qx.device, qx.shape[1]
    out = torch.empty(B, dtype=torch.uint8, device=dev)
    gtab = device_g_table(curve.name, dev)
    lib = _build.lib(engine)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.bdls_verify(CURVE_IDS[curve.name],
                             *(a.data_ptr() for a in arrs),
                             gtab.data_ptr(), out.data_ptr(), B, THREADS,
                             stream)
    _build.check(rc, f"bdls_verify[{engine}]({curve.name}, B={B})")
    with _build.count_lock:
        _GENERIC[engine][curve.name] += 1
    return out.view(torch.bool)


def verify_pinned_cuda(curve: Curve, r, s, e, slot, pools: dict, *,
                       engine: str = "vpu") -> torch.Tensor:
    """Launch the pinned-key kernel over three ``(16, B)`` int32 CUDA
    tensors, the ``(B,)`` int32 slots and the pool (see
    :func:`~bdls_tpu_torch.ops.verify_fold.check_pools`), all on one
    device; returns the ``(B,)`` bool verdict (not yet synchronised)."""
    _check_limbs((r, s, e), "verify_pinned_cuda")
    dev, B = r.device, r.shape[1]
    if (slot.device != dev or slot.dtype != torch.int32
            or slot.shape != (B,) or not slot.is_contiguous()):
        raise ValueError("slot must be a contiguous (B,) int32 tensor on "
                         "the limbs' device")
    cap = check_pools(curve.name, pools)
    for t in pools.values():
        if t.device != dev or not t.is_contiguous():
            raise ValueError("pools must be contiguous, on the limbs' device")
    psi = pools.get("psi_x")
    out = torch.empty(B, dtype=torch.uint8, device=dev)
    g32 = device_g32_table(curve.name, dev)
    lib = _build.lib(engine)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.bdls_verify_pinned(
            CURVE_IDS[curve.name], r.data_ptr(), s.data_ptr(), e.data_ptr(),
            slot.data_ptr(), pools["x"].data_ptr(), pools["y"].data_ptr(),
            None if psi is None else psi.data_ptr(), g32.data_ptr(),
            out.data_ptr(), B, cap, THREADS, stream)
    _build.check(rc, f"bdls_verify_pinned[{engine}]({curve.name}, B={B})")
    with _build.count_lock:
        _PINNED[engine][curve.name] += 1
    return out.view(torch.bool)


def launch_verify(curve: Curve, arrs: Sequence, *,
                  device: DeviceLike = None,
                  field: str = DEFAULT_FIELD) -> torch.Tensor:
    """Start one verify over five pre-marshaled ``(16, B)`` limb arrays
    (numpy ``uint32`` or tensors) on ``device`` (default ``cuda``), with
    the program of ``field``: K1 from the field's engine, or K4 for
    ``"mont16"`` (the plain twins on the CPU). Returns the ``(B,)`` bool
    tensor; on the card it is not yet synchronised."""
    dev = resolve_device(device)
    if field != "mont16":
        engine = engine_for(field, FOLD_FIELDS)
    ts = [_build.as_int32(a, dev) for a in arrs]
    if field == "mont16":
        if dev.type == "cuda":
            return verify_mont16_cuda(curve, *ts)
        return verify_kernel(curve, *ts)
    if dev.type == "cuda":
        return verify_fold_cuda(curve, *ts, engine=engine)
    with fold.mul_backend(engine):
        return verify_fold(curve, *ts)


def launch_verify_pinned(curve: Curve, arrs_rse: Sequence, slot, pools: dict,
                         *, device: DeviceLike = None,
                         field: str = DEFAULT_FIELD) -> torch.Tensor:
    """Start one pinned-key verify: ``arrs_rse`` the three pre-marshaled
    ``(16, B)`` limb arrays (r, s, e), ``slot`` the ``(B,)`` pool slots,
    ``pools`` the key cache's pool snapshot on ``device`` (default
    ``cuda``); K2 from the engine :data:`PINNED_FIELDS` gives ``field``.
    Returns the ``(B,)`` bool tensor; on the card it is not yet
    synchronised."""
    dev = resolve_device(device)
    engine = engine_for(field, PINNED_FIELDS)
    ts = [_build.as_int32(a, dev) for a in arrs_rse]
    sl = torch.as_tensor(np.asarray(slot, dtype=np.int32)) \
        if not isinstance(slot, torch.Tensor) else slot.to(torch.int32)
    sl = sl.to(dev, non_blocking=True).contiguous()
    if dev.type == "cuda":
        return verify_pinned_cuda(curve, *ts, sl, pools, engine=engine)
    with fold.mul_backend(engine):
        return verify_fold_pinned(curve, *ts, sl, pools)


def verify_limbs(curve: Curve, arrs: Sequence, *,
                 device: DeviceLike = None,
                 field: str = DEFAULT_FIELD) -> np.ndarray:
    """Synchronous verify over pre-marshaled limb arrays."""
    return launch_verify(curve, arrs, device=device,
                         field=field).cpu().numpy()


def verify_batch(curve: Curve, qx: list[int], qy: list[int], r: list[int],
                 s: list[int], e: list[int], *,
                 device: DeviceLike = None,
                 field: str = DEFAULT_FIELD) -> np.ndarray:
    """Host-facing batch verify over Python ints (each < 2^256).
    Returns a bool numpy array."""
    arrs = [ints_to_limbs(v) for v in (qx, qy, r, s, e)]
    return verify_limbs(curve, arrs, device=device, field=field)


class LatencySlot:
    """One staging slot of the latency tier for one (curve, bucket): the
    Hopper form of K3 (``bdls_tpu/ops/ecdsa.py:_jitted_verify_latency_
    cached``, K1's program over donated input buffers).

    The slot owns a page-locked ``(5, 16, size)`` int32 staging buffer
    and a page-locked ``(size,)`` verdict buffer; on the card also the
    static device buffers and one ``torch.cuda.CUDAGraph`` captured over
    them, whose three nodes are the copy of the staging buffer to the
    device, the K1 kernel (``bdls_verify``, ``csrc/verify.cu``) and the
    copy of the verdict back. A flush writes the staging buffer
    (:meth:`stage`) and replays the graph (:meth:`launch`): nothing is
    allocated and no launch is prepared on the host. The graph bakes its
    pointers in, so a slot must not be staged again until the verdict of
    its last launch has been read (the provider's ring keeps that rule).

    ``field`` picks the build the graph holds: ``"fold"`` K1, ``"mxu"``
    K1 with K5's product (:data:`FOLD_FIELDS`; ``"mont16"`` has no
    latency program, as in the reference).

    On the CPU there is no graph: :meth:`launch` runs the plain version
    over the staging buffer, as the throughput tier does."""

    def __init__(self, curve: Curve, size: int, *,
                 device: DeviceLike = None, stream=None,
                 field: str = DEFAULT_FIELD):
        dev = resolve_device(device)
        self.engine = engine_for(field, FOLD_FIELDS)
        self.curve = curve
        self.size = size
        self.device = dev
        pin = dev.type == "cuda"
        self.host = torch.zeros((5, 16, size), dtype=torch.int32,
                                pin_memory=pin)
        self._host_np = self.host.numpy()
        self.graph = None
        if pin:
            self.out = torch.zeros(size, dtype=torch.uint8, pin_memory=True)
            self._capture(stream)

    def _capture(self, stream) -> None:
        """Allocate the device buffers, make sure the G table and the K1
        module exist, then capture copy → kernel → copy on a side
        stream. ``stream`` is where the replays will run; the capture
        itself uses a private stream, so no other thread's work on the
        provider's stream can land in the graph."""
        dev, size = self.device, self.size
        lib = _build.lib(self.engine)
        self.dev_in = torch.zeros((5, 16, size), dtype=torch.int32,
                                  device=dev)
        self.dev_out = torch.zeros(size, dtype=torch.uint8, device=dev)
        gtab = device_g_table(self.curve.name, dev)
        nbytes = self.host.numel() * 4
        ptrs = [self.dev_in[i].data_ptr() for i in range(5)]
        cid = CURVE_IDS[self.curve.name]

        def body(st: int) -> None:
            _build.check(lib.bdls_copy(self.dev_in.data_ptr(),
                                       self.host.data_ptr(), nbytes, st),
                         "bdls_copy (staging)")
            _build.check(lib.bdls_verify(cid, *ptrs, gtab.data_ptr(),
                                         self.dev_out.data_ptr(), size,
                                         THREADS, st),
                         f"bdls_verify[{self.engine}]({self.curve.name}, "
                         f"B={size})")
            _build.check(lib.bdls_copy(self.out.data_ptr(),
                                       self.dev_out.data_ptr(), size, st),
                         "bdls_copy (verdict)")

        side = torch.cuda.Stream(dev)
        with torch.cuda.device(dev):
            # one eager run loads the module and touches every buffer:
            # nothing may be loaded or allocated during the capture
            with torch.cuda.stream(side):
                body(side.cuda_stream)
            with _build.count_lock:
                _GENERIC[self.engine][self.curve.name] += 1
            side.synchronize()
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, stream=side,
                                  capture_error_mode="thread_local"):
                body(torch.cuda.current_stream(dev).cuda_stream)
        self.graph = graph
        self.stream = stream

    def stage(self, arrs: Sequence) -> None:
        """Write five ``(16, n)`` limb arrays (n <= size) into the
        staging buffer, padding by replicating lane 0 as
        :func:`~bdls_tpu_torch.crypto.marshal.pad_lanes` does."""
        n = arrs[0].shape[1]
        for buf, a in zip(self._host_np, arrs):
            buf[:, :n] = np.asarray(a).view(np.int32)
            if n < self.size:
                buf[:, n:] = buf[:, :1]

    def launch(self):
        """Start the verify of the staged lanes. On the card: replay the
        graph on the slot's stream and return the event recorded after
        it (the verdict lands in :attr:`out`). On the CPU: return the
        plain version's ``(size,)`` bool verdict."""
        if self.graph is None:
            with fold.mul_backend(self.engine):
                return verify_fold(self.curve, *self.host)
        with torch.cuda.device(self.device), torch.cuda.stream(self.stream):
            self.graph.replay()
            event = torch.cuda.Event()
            event.record(self.stream)
        with _build.count_lock:
            _LATENCY[self.engine][self.curve.name] += 1
        return event

    def verdict(self) -> np.ndarray:
        """The last replay's ``(size,)`` bool verdict, copied out of the
        slot (call after its event completed)."""
        return self.out.numpy().astype(bool)
