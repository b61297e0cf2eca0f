"""The weights both sides are handed: the committed snapshot, read as a
raw file, or weights drawn on the device from the seed.

Weights are a flat dict keyed as the snapshot is (``params/<path>/<leaf>``
and ``batch_stats/<path>/<leaf>``, conv kernels HWIO).  The program loads
them through its own loader; the reference reads the same dict.
"""

from __future__ import annotations

import math
import os
import re
from typing import Dict

import numpy as np
import torch

from gpubench.common import Cell
from gpubench.inputs import ROOT

#: std of a standard normal truncated to [-2, 2]
_TRUNC_STD = 0.87962566103423978


def cell_weights(cell: Cell, seed: int, device) -> Dict[str, np.ndarray]:
    """The weights of a cell's configuration as a flat dict of f32 arrays:
    its snapshot, or drawn on the device from ``seed`` by its model
    module's ``seeded``."""
    config, model = cell.config, cell.model
    if config["weights"]["kind"] == "snapshot":
        flat = load_snapshot(os.path.join(ROOT, config["weights"]["file"]))
        if set(flat) != set(model.param_shapes(config)):
            raise RuntimeError("the snapshot's leaves differ from the configuration's")
        return flat
    return to_numpy(model.seeded(config, seed, device))


def load_snapshot(path: str) -> Dict[str, np.ndarray]:
    """The snapshot's leaves as f32 arrays (its step and config dropped)."""
    with np.load(path) as z:
        return {k: np.asarray(z[k], np.float32) for k in z.files if not k.startswith("__")}


def draw(shapes: Dict[str, tuple], seed: int, device) -> Dict[str, torch.Tensor]:
    """Fresh leaves of ``shapes`` on ``device`` from ``seed``: every
    ``/kernel`` a conv kernel (HWIO), truncated normal (+-2 std) with std
    sqrt(1 / fan_in) (fan_in = kh kw in); biases 0, norm scales 1, running
    mean 0 and variance 1.  All kernels are drawn in one call."""
    kernels = [k for k in shapes if k.endswith("/kernel")]
    sizes = [math.prod(shapes[k]) for k in kernels]
    gen = torch.Generator(device=device).manual_seed(abs(int(seed)) % (1 << 63))
    flat = torch.empty(sum(sizes), device=device)
    torch.nn.init.trunc_normal_(flat, 0.0, 1.0, -2.0, 2.0, generator=gen)
    out: Dict[str, torch.Tensor] = {}
    for k, piece in zip(kernels, torch.split(flat, sizes)):
        kh, kw, cin, _ = shapes[k]
        out[k] = piece.view(shapes[k]) * (math.sqrt(1.0 / (kh * kw * cin)) / _TRUNC_STD)
    for k, shape in shapes.items():
        if k in out:
            continue
        fill = 1.0 if re.search(r"/(scale|var)$", k) else 0.0
        out[k] = torch.full(shape, fill, device=device)
    return out


def to_numpy(flat: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    return {k: v.detach().float().cpu().numpy() for k, v in flat.items()}
