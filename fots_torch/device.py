"""Device resolution for the port's entry points."""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` means the card: ``cuda``, raising when CUDA is absent.  An
    explicit ``"cpu"`` selects the plain PyTorch versions of the kernels."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "fots_torch runs on CUDA and no CUDA device is available; pass "
            "device='cpu' to run the plain PyTorch versions on the host")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def to_device_async(t: torch.Tensor, device) -> torch.Tensor:
    """Host tensor ``t`` on ``device`` without waiting for the device: on
    CUDA through pinned memory and a non-blocking copy (a pageable copy
    would first wait for every kernel queued before it)."""
    device = torch.device(device)
    if device.type == "cuda" and t.device.type == "cpu":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)
