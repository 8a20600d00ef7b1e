"""Provider factory for the port — config-selected CSP.

The counterpart of ``bdls_tpu/crypto/factory.py`` (which hard-wires
``TpuCSP``), with ``"SW"`` (the pure-Python provider) and ``"TORCH"``
(:class:`~bdls_tpu_torch.crypto.torch_provider.TorchCSP`). The
reference's ``"TPU"`` and ``"REMOTE"`` names stay with the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from bdls_tpu_torch.crypto.csp import CSP
from bdls_tpu_torch.crypto.key_cache import DEFAULT_KEY_CACHE_SIZE
from bdls_tpu_torch.crypto.sw import SwCSP
from bdls_tpu_torch.crypto.torch_provider import DEFAULT_BUCKETS, TorchCSP


@dataclass
class FactoryOpts:
    default: str = "SW"  # "SW" | "TORCH"
    torch_buckets: tuple = DEFAULT_BUCKETS
    torch_flush_interval: float = 0.002
    # the counted sw fallback; only with torch_device="cpu"
    torch_cpu_fallback: bool = False
    # None -> "cuda" (raises without a card); "cpu" runs the plain version
    torch_device: Optional[str] = None
    # pinned keys per curve; 0 turns the pinned-key kernel off
    torch_key_cache_size: int = DEFAULT_KEY_CACHE_SIZE
    # the node's MetricsProvider and Tracer (None: private registry /
    # the process-global tracer)
    metrics: Optional[object] = None
    tracer: Optional[object] = None


def get_csp(opts: Optional[FactoryOpts] = None) -> CSP:
    opts = opts or FactoryOpts()
    name = opts.default.upper()
    if name == "SW":
        return SwCSP()
    if name == "TORCH":
        return TorchCSP(
            buckets=opts.torch_buckets,
            flush_interval=opts.torch_flush_interval,
            use_cpu_fallback=opts.torch_cpu_fallback,
            device=opts.torch_device,
            key_cache_size=opts.torch_key_cache_size,
            metrics=opts.metrics,
            tracer=opts.tracer,
        )
    raise ValueError(f"unknown CSP provider: {opts.default}")
