"""Device resolution for the port's entry points, and the transfers
between host and card that the serving engines share."""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
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


class HostCopy:
    """A device tensor on its way to the host: on CUDA a non-blocking copy
    into a pinned buffer plus an event; :meth:`numpy` waits for it."""

    def __init__(self, t: torch.Tensor):
        self._event = None
        if t.is_cuda:
            self._buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self._buf.copy_(t, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._buf = t

    def numpy(self) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
        return self._buf.numpy()
