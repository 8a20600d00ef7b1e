"""Device resolution for the port's entry points.

Every entry point (``TorchCSP``, ``ops.ecdsa.verify_batch`` …) runs on
the card unless the caller asks for the CPU: ``None`` means ``cuda`` and
raises when no CUDA device is present, so a misconfigured host fails
loudly instead of silently verifying on the plain CPU version.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` → ``cuda`` (raises ``RuntimeError`` without CUDA); an
    explicit ``"cpu"`` is allowed; an explicit CUDA device is checked."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "bdls_tpu_torch needs a CUDA device: torch.cuda.is_available() "
            "is False (pass device='cpu' to run the plain PyTorch version)")
    if dev.type not in ("cuda", "cpu"):
        raise RuntimeError(f"unsupported device {dev}")
    return dev
