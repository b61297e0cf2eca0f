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

from gpubench.inputs import ROOT
from gpubench.reference.detector import param_shapes

#: std of a standard normal truncated to [-2, 2]
_TRUNC_STD = 0.87962566103423978


def cell_weights(config: dict, seed: int, device) -> Dict[str, np.ndarray]:
    """The weights of a cell's configuration as a flat dict of f32 arrays:
    its snapshot, or drawn on the device from ``seed``."""
    if config["weights"]["kind"] == "snapshot":
        flat = load_snapshot(os.path.join(ROOT, config["weights"]["file"]))
        if set(flat) != set(param_shapes(config["nclass"], config["attention"])):
            raise RuntimeError("the snapshot's leaves differ from the configuration's")
        return flat
    return to_numpy(seeded(config["nclass"], config["attention"], seed, device))


def load_snapshot(path: str) -> Dict[str, np.ndarray]:
    """The snapshot's leaves as f32 arrays (its step and config dropped)."""
    with np.load(path) as z:
        return {k: np.asarray(z[k], np.float32) for k in z.files if not k.startswith("__")}


def seeded(nclass: int, attention: bool, seed: int, device) -> Dict[str, torch.Tensor]:
    """Fresh weights on ``device`` from ``seed``, as the model is initialised
    from scratch: conv kernels truncated normal (+-2 std) with std
    sqrt(1 / fan_in) (fan_in = kh kw in), biases 0, norm scales 1, running
    mean 0 and variance 1.  All kernels are drawn in one call."""
    shapes = param_shapes(nclass, attention)
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


def flat_key(torch_name: str) -> str:
    """A parameter or buffer name of the program's module tree -> the
    snapshot key of the same leaf (``layer2.0.down_bn.weight`` ->
    ``params/layer2_0/down_bn/bn/scale``, a conv weight -> ``.../kernel``)."""
    parts = torch_name.split(".")
    leaf, path = parts[-1], []
    i = 0
    while i < len(parts) - 1:
        seg = parts[i]
        if re.fullmatch(r"layer\d", seg) and i + 1 < len(parts) - 1 and parts[i + 1].isdigit():
            path.append(f"{seg}_{parts[i + 1]}")
            i += 2
            continue
        path.append("in" if seg == "norm" else seg)
        i += 1
    if path and path[-1] == "down_bn":
        path.append("bn")
    if leaf in ("running_mean", "running_var"):
        return "batch_stats/" + "/".join(path) + ("/mean" if leaf == "running_mean" else "/var")
    if leaf == "bias":
        return "params/" + "/".join(path) + "/bias"
    return "params/" + "/".join(path) + "/" + leaf


def program_leaves(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """The program's parameters by snapshot key, conv kernels left OIHW
    (the reference's layout); a weight that is a conv kernel is keyed
    ``kernel``, a norm's ``scale``."""
    out = {}
    for name, p in model.named_parameters():
        key = flat_key(name)
        if key.endswith("/weight"):
            key = key[: -len("weight")] + ("kernel" if p.ndim == 4 else "scale")
        out[key] = p
    return out
