"""Provider factory for the port — config-selected CSP.

The counterpart of ``bdls_tpu/crypto/factory.py`` (which hard-wires
``TpuCSP``), with ``"SW"`` (the pure-Python provider), ``"TORCH"``
(:class:`~bdls_tpu_torch.crypto.torch_provider.TorchCSP`) and
``"REMOTE"`` (:class:`~bdls_tpu_torch.sidecar.remote_csp.RemoteCSP`, a
verifyd daemon's client). The reference's ``"TPU"`` name stays with the
JAX package.

The process-wide default (:func:`init_default`, :func:`get_default`,
:func:`reset_default`) follows ``bdls_tpu/crypto/factory.py:117-140``
with one deliberate difference: when nothing initialized it,
:func:`get_default` builds the card provider, ``TorchCSP()``, which
raises without CUDA, where the reference quietly falls back to a SW
provider. The host provider is the caller's explicit choice
(``init_default(FactoryOpts(default="SW"))``).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Optional

from bdls_tpu_torch.crypto.csp import CSP
from bdls_tpu_torch.crypto.sw import SwCSP
from bdls_tpu_torch.crypto.torch_provider import DEFAULT_BUCKETS, TorchCSP


@dataclass
class FactoryOpts:
    default: str = "SW"  # "SW" | "TORCH" | "REMOTE"
    # verifyd endpoint ("host:port", or several comma-separated). When
    # set, the node's CSP is a RemoteCSP forwarding verify_batch to the
    # shared daemon, whatever ``default`` names; "REMOTE" without an
    # endpoint raises
    verify_endpoint: Optional[str] = None
    # the daemon's transport tier: "auto" or "socket" (the gRPC tier is
    # not ported)
    verify_transport: str = "auto"
    # tenant id the daemon accounts this node under (quota + metrics);
    # None -> "default"
    verify_tenant: Optional[str] = None
    torch_buckets: tuple = DEFAULT_BUCKETS
    torch_flush_interval: float = 0.002
    # the counted sw fallback; only with torch_device="cpu"
    torch_cpu_fallback: bool = False
    # None -> "cuda" (raises without a card); "cpu" runs the plain version
    torch_device: Optional[str] = None
    # pinned keys per curve; 0 turns the pinned-key kernel off; None
    # reads BDLS_TPU_KEY_CACHE_SIZE (256 when unset)
    torch_key_cache_size: Optional[int] = None
    # kernel generation ("fold", "mont16", "mxu", "sw"); None reads
    # BDLS_TPU_KERNEL (the reference's tpu_kernel_field)
    torch_kernel_field: Optional[str] = None
    # buckets >= this split across the mesh (K10) when more than one
    # device is attached; None reads BDLS_TPU_MESH_THRESHOLD (the
    # reference's tpu_mesh_threshold)
    torch_mesh_threshold: Optional[int] = None
    # the node's MetricsProvider and Tracer (None: private registry /
    # the process-global tracer)
    metrics: Optional[object] = None
    tracer: Optional[object] = None


def get_csp(opts: Optional[FactoryOpts] = None) -> CSP:
    opts = opts or FactoryOpts()
    name = opts.default.upper()
    if opts.verify_endpoint or name == "REMOTE":
        if not opts.verify_endpoint:
            raise ValueError(
                "REMOTE provider requires verify_endpoint (host:port)")
        from bdls_tpu_torch.sidecar.remote_csp import RemoteCSP

        return RemoteCSP(
            endpoint=opts.verify_endpoint,
            transport=opts.verify_transport,
            tenant=opts.verify_tenant or "default",
            metrics=opts.metrics,
            tracer=opts.tracer,
        )
    if name == "SW":
        return SwCSP()
    if name == "TORCH":
        return TorchCSP(
            buckets=opts.torch_buckets,
            flush_interval=opts.torch_flush_interval,
            use_cpu_fallback=opts.torch_cpu_fallback,
            device=opts.torch_device,
            key_cache_size=opts.torch_key_cache_size,
            kernel_field=opts.torch_kernel_field,
            mesh_threshold=opts.torch_mesh_threshold,
            metrics=opts.metrics,
            tracer=opts.tracer,
        )
    raise ValueError(f"unknown CSP provider: {opts.default}")


_default_lock = threading.Lock()
_default: Optional[CSP] = None


def init_default(opts: Optional[FactoryOpts] = None) -> CSP:
    """Initialize the process-wide default provider (once-guarded)."""
    global _default
    with _default_lock:
        if _default is None:
            _default = get_csp(opts)
        return _default


def get_default() -> CSP:
    """The process-wide default provider; if nothing initialized it
    yet, the card provider (``TorchCSP()``, raising without CUDA), never
    a quiet SW fallback."""
    if _default is None:
        return init_default(FactoryOpts(default="TORCH"))
    return _default


def reset_default() -> None:
    """Test hook."""
    global _default
    with _default_lock:
        _default = None
