"""Batched ECDSA verification — the port's launch wrappers.

The counterpart of ``bdls_tpu/ops/ecdsa.py`` (``launch_verify``,
``launch_verify_pinned``, ``launch_verify_latency``, ``verify_limbs``,
``verify_batch``) for the generic-key program (K1), the pinned-key
program (K2) and the latency tier's form of K1 (K3,
:class:`LatencySlot`). Where a limb tensor lies decides what runs:

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
launch the same K1 kernel and are not counted in ``LAUNCHES``.

Semantics: standard ECDSA over short-Weierstrass curves, the digest
taken as a 256-bit integer reduced mod n. The low-S policy stays in the
provider; the kernel accepts any s in [1, n-1].
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from bdls_tpu_torch.crypto.marshal import ints_to_limbs
from bdls_tpu_torch.ops import _build
from bdls_tpu_torch.ops.curves import Curve
from bdls_tpu_torch.ops.verify_fold import check_pools, device_g32_table, \
    device_g_table, verify_fold, verify_fold_pinned
from bdls_tpu_torch.utils.device import DeviceLike, resolve_device

CURVE_IDS = {"P-256": 0, "secp256k1": 1}
LAUNCHES = {name: 0 for name in CURVE_IDS}
LAUNCHES_PINNED = {name: 0 for name in CURVE_IDS}
LAUNCHES_LATENCY = {name: 0 for name in CURVE_IDS}
# threads per block: one lane per thread; small blocks spread a bucket
# over as many of the 132 SMs as it has warps
THREADS = 64


def reset_launches() -> None:
    """Set every kernel's launch count to 0: K1, K2 and K3's replays
    here, K6 in ``ops.sha256``, K7 in ``ops.block_verify`` and K8 in
    ``ops.ed25519``."""
    from bdls_tpu_torch.ops import block_verify, ed25519, sha256

    with _build.count_lock:
        for counts in (LAUNCHES, LAUNCHES_PINNED, LAUNCHES_LATENCY,
                       sha256.LAUNCHES_SHA256, block_verify.LAUNCHES_BLOCK,
                       ed25519.LAUNCHES_ED25519):
            for k in counts:
                counts[k] = 0


def verify_fold_cuda(curve: Curve, qx, qy, r, s, e) -> torch.Tensor:
    """Launch the CUDA kernel over five ``(16, B)`` int32 CUDA tensors;
    returns the ``(B,)`` bool verdict (not yet synchronised)."""
    arrs = (qx, qy, r, s, e)
    dev = qx.device
    B = qx.shape[1]
    for a in arrs:
        if (a.device != dev or a.dtype != torch.int32 or a.dim() != 2
                or a.shape != (16, B) or not a.is_contiguous()):
            raise ValueError("verify_fold_cuda takes five contiguous "
                             "(16, B) int32 tensors on one CUDA device")
    out = torch.empty(B, dtype=torch.uint8, device=dev)
    gtab = device_g_table(curve.name, dev)
    lib = _build.lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.bdls_verify(CURVE_IDS[curve.name],
                             *(a.data_ptr() for a in arrs),
                             gtab.data_ptr(), out.data_ptr(), B, THREADS,
                             stream)
    _build.check(rc, f"bdls_verify({curve.name}, B={B})")
    with _build.count_lock:
        LAUNCHES[curve.name] += 1
    return out.view(torch.bool)


def verify_pinned_cuda(curve: Curve, r, s, e, slot,
                       pools: dict) -> torch.Tensor:
    """Launch the pinned-key kernel over three ``(16, B)`` int32 CUDA
    tensors, the ``(B,)`` int32 slots and the pool (see
    :func:`~bdls_tpu_torch.ops.verify_fold.check_pools`), all on one
    device; returns the ``(B,)`` bool verdict (not yet synchronised)."""
    dev = r.device
    B = r.shape[1]
    for a in (r, s, e):
        if (a.device != dev or a.dtype != torch.int32 or a.dim() != 2
                or a.shape != (16, B) or not a.is_contiguous()):
            raise ValueError("verify_pinned_cuda takes three contiguous "
                             "(16, B) int32 tensors on one CUDA device")
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
    lib = _build.lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.bdls_verify_pinned(
            CURVE_IDS[curve.name], r.data_ptr(), s.data_ptr(), e.data_ptr(),
            slot.data_ptr(), pools["x"].data_ptr(), pools["y"].data_ptr(),
            None if psi is None else psi.data_ptr(), g32.data_ptr(),
            out.data_ptr(), B, cap, THREADS, stream)
    _build.check(rc, f"bdls_verify_pinned({curve.name}, B={B})")
    with _build.count_lock:
        LAUNCHES_PINNED[curve.name] += 1
    return out.view(torch.bool)


def launch_verify(curve: Curve, arrs: Sequence, *,
                  device: DeviceLike = None) -> torch.Tensor:
    """Start one verify over five pre-marshaled ``(16, B)`` limb arrays
    (numpy ``uint32`` or tensors) on ``device`` (default ``cuda``).
    Returns the ``(B,)`` bool tensor; on the card it is not yet
    synchronised."""
    dev = resolve_device(device)
    ts = [_build.as_int32(a, dev) for a in arrs]
    if dev.type == "cuda":
        return verify_fold_cuda(curve, *ts)
    return verify_fold(curve, *ts)


def launch_verify_pinned(curve: Curve, arrs_rse: Sequence, slot, pools: dict,
                         *, device: DeviceLike = None) -> torch.Tensor:
    """Start one pinned-key verify: ``arrs_rse`` the three pre-marshaled
    ``(16, B)`` limb arrays (r, s, e), ``slot`` the ``(B,)`` pool slots,
    ``pools`` the key cache's pool snapshot on ``device`` (default
    ``cuda``). Returns the ``(B,)`` bool tensor; on the card it is not
    yet synchronised."""
    dev = resolve_device(device)
    ts = [_build.as_int32(a, dev) for a in arrs_rse]
    sl = torch.as_tensor(np.asarray(slot, dtype=np.int32)) \
        if not isinstance(slot, torch.Tensor) else slot.to(torch.int32)
    sl = sl.to(dev, non_blocking=True).contiguous()
    if dev.type == "cuda":
        return verify_pinned_cuda(curve, *ts, sl, pools)
    return verify_fold_pinned(curve, *ts, sl, pools)


def verify_limbs(curve: Curve, arrs: Sequence, *,
                 device: DeviceLike = None) -> np.ndarray:
    """Synchronous verify over pre-marshaled limb arrays."""
    return launch_verify(curve, arrs, device=device).cpu().numpy()


def verify_batch(curve: Curve, qx: list[int], qy: list[int], r: list[int],
                 s: list[int], e: list[int], *,
                 device: DeviceLike = None) -> np.ndarray:
    """Host-facing batch verify over Python ints (each < 2^256).
    Returns a bool numpy array."""
    arrs = [ints_to_limbs(v) for v in (qx, qy, r, s, e)]
    return verify_limbs(curve, arrs, device=device)


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

    On the CPU there is no graph: :meth:`launch` runs the plain version
    over the staging buffer, as the throughput tier does."""

    def __init__(self, curve: Curve, size: int, *,
                 device: DeviceLike = None, stream=None):
        dev = resolve_device(device)
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
        lib = _build.lib()
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
                         f"bdls_verify({self.curve.name}, B={size})")
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
                LAUNCHES[self.curve.name] += 1
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
            return verify_fold(self.curve, *self.host)
        with torch.cuda.device(self.device), torch.cuda.stream(self.stream):
            self.graph.replay()
            event = torch.cuda.Event()
            event.record(self.stream)
        with _build.count_lock:
            LAUNCHES_LATENCY[self.curve.name] += 1
        return event

    def verdict(self) -> np.ndarray:
        """The last replay's ``(size,)`` bool verdict, copied out of the
        slot (call after its event completed)."""
        return self.out.numpy().astype(bool)
