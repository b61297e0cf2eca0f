"""Weights carried across from the JAX package's serving snapshots.

A snapshot (``artifacts/serving_params.npz``, written by
``fots.checkpoint.save_serving_params``) is a flat archive of
``params/<flax path>/<leaf>`` and ``batch_stats/<flax path>/<leaf>``
arrays plus ``__step__`` and a JSON ``__config__``.  :func:`state_dict_from_flat`
maps each key onto the port's module tree:

- ``layerN_i`` -> ``layerN.i`` (the stages are ``nn.ModuleList`` s);
- flax's child ``in`` -> ``norm``; BatchNorm's inner ``bn`` is dropped
  (``down_bn/bn`` -> ``down_bn``);
- ``kernel``/``scale`` -> ``weight``; ``mean``/``var`` -> ``running_mean``/
  ``running_var``;
- conv kernels HWIO -> OIHW (``permute(3, 2, 0, 1)``; a depthwise
  ``(3, 3, 1, C)`` kernel becomes ``(C, 1, 3, 3)``).

:func:`load_flat` then requires every key accounted for both ways.
"""

from __future__ import annotations

import json
import re
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

from fots_torch.models.detector import FOTSDetector

_LEAF_NAMES = {"kernel": "weight", "scale": "weight", "bias": "bias",
               "mean": "running_mean", "var": "running_var"}
_GROUPS = ("params", "batch_stats")


def torch_key(flat_key: str) -> str:
    """``params/layer2_0/down_bn/bn/scale`` -> ``layer2.0.down_bn.weight``."""
    group, *path = flat_key.split("/")
    if group not in _GROUPS or not path or path[-1] not in _LEAF_NAMES:
        raise KeyError(f"not a params/batch_stats leaf key: {flat_key!r}")
    parts = []
    for seg in path[:-1]:
        m = re.fullmatch(r"(layer\d)_(\d+)", seg)
        if m:
            parts += [m.group(1), m.group(2)]
        elif seg == "bn":
            continue
        else:
            parts.append("norm" if seg == "in" else seg)
    return ".".join(parts + [_LEAF_NAMES[path[-1]]])


def state_dict_from_flat(flat: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """Port state dict (f32 CPU tensors) of a flat snapshot dict; raises on
    a key that maps onto nothing."""
    out = {}
    for key, arr in flat.items():
        t = torch.from_numpy(np.array(arr, dtype=np.float32))
        if t.ndim == 4:
            t = t.permute(3, 2, 0, 1).contiguous()
        name = torch_key(key)
        if name in out:
            raise KeyError(f"two snapshot keys map onto {name!r}")
        out[name] = t
    return out


def load_flat(model: torch.nn.Module, flat: Mapping[str, np.ndarray]) -> None:
    """Load a flat snapshot into ``model``; raises on a missing key, an
    unused key or a shape mismatch."""
    sd = state_dict_from_flat(flat)
    want = model.state_dict()
    missing = sorted(set(want) - set(sd))
    unused = sorted(set(sd) - set(want))
    if missing or unused:
        raise KeyError(f"snapshot does not match the model: missing "
                       f"{missing[:8]}, unused {unused[:8]}")
    bad = [(k, tuple(sd[k].shape), tuple(want[k].shape)) for k in sd
           if sd[k].shape != want[k].shape]
    if bad:
        raise ValueError(f"snapshot shapes differ from the model: {bad[:8]}")
    model.load_state_dict(sd, strict=True)


def load_serving_params(path: str) -> Tuple[Dict[str, np.ndarray], Any, Dict[str, Any]]:
    """Read a snapshot: (flat params/batch_stats dict, step or None, config
    dict, {} when absent)."""
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    step = int(flat.pop("__step__")) if "__step__" in flat else None
    cfg = flat.pop("__config__", None)
    config = json.loads(str(cfg)) if cfg is not None else {}
    return flat, step, config


def load_detector(path: str, device="cpu") -> Tuple[FOTSDetector, Any, Dict[str, Any]]:
    """(eval-mode FOTSDetector with the snapshot's weights on ``device`` in
    channels_last memory, step, config).  ``nclass`` comes from the
    snapshot's vocab head."""
    flat, step, config = load_serving_params(path)
    model = FOTSDetector(nclass=int(flat["params/ocr/conv11/bias"].shape[0]))
    load_flat(model, flat)
    model = model.eval().to(device=device, memory_format=torch.channels_last)
    return model, step, config
