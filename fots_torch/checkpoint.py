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
:func:`flat_from_state_dict` is the reverse map, and
:func:`save_serving_params` writes a model the port trained in the same
format, which ``fots.checkpoint.load_serving_params`` and
:func:`load_detector` both read.
"""

from __future__ import annotations

import json
import re
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from fots_torch.device import resolve_device
from fots_torch.models.detector import FOTSDetector

_LEAF_NAMES = {"kernel": "weight", "scale": "weight", "bias": "bias",
               "mean": "running_mean", "var": "running_var"}
_STAT_LEAVES = {"running_mean": "mean", "running_var": "var"}
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


def flat_key(torch_name: str, ndim: int, batch_norms) -> str:
    """Reverse of :func:`torch_key`: ``layer2.0.down_bn.weight`` ->
    ``params/layer2_0/down_bn/bn/scale``.  ``batch_norms``: the module
    paths that are BatchNorms (they hold running statistics); ``ndim`` the
    tensor's rank (4 => a conv kernel)."""
    *path, leaf = torch_name.split(".")
    module = ".".join(path)
    parts = []
    i = 0
    while i < len(path):
        if re.fullmatch(r"layer\d", path[i]) and i + 1 < len(path) and path[i + 1].isdigit():
            parts.append(f"{path[i]}_{path[i + 1]}")
            i += 2
            continue
        parts.append("in" if path[i] == "norm" else path[i])
        i += 1
    if module in batch_norms:
        parts.append("bn")
    if leaf in _STAT_LEAVES:
        return "/".join(["batch_stats"] + parts + [_STAT_LEAVES[leaf]])
    if leaf == "weight":
        leaf = "kernel" if ndim == 4 else "scale"
    elif leaf != "bias":
        raise KeyError(f"no snapshot leaf for {torch_name!r}")
    return "/".join(["params"] + parts + [leaf])


def flat_from_state_dict(sd: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """Flat snapshot dict (f32 numpy, flax layouts) of a port state dict:
    the reverse of :func:`state_dict_from_flat` (OIHW -> HWIO)."""
    batch_norms = {k.rsplit(".", 1)[0] for k in sd if k.endswith(".running_mean")}
    out = {}
    for name, t in sd.items():
        arr = t.detach().to("cpu", torch.float32)
        if arr.ndim == 4:
            arr = arr.permute(2, 3, 1, 0)
        key = flat_key(name, arr.ndim, batch_norms)
        if key in out:
            raise KeyError(f"two state-dict keys map onto {key!r}")
        out[key] = np.ascontiguousarray(arr.numpy())
    return out


def save_serving_params(path: str, model: torch.nn.Module, step: Optional[int] = None,
                        config: Optional[Dict[str, Any]] = None) -> str:
    """Write ``model``'s weights as a serving snapshot (``.npz`` of
    ``params/...`` and ``batch_stats/...`` arrays, plus ``__step__`` and a
    JSON ``__config__`` when given), the format of
    ``fots.checkpoint.save_serving_params``."""
    flat: Dict[str, Any] = flat_from_state_dict(model.state_dict())
    if step is not None:
        flat["__step__"] = np.asarray(step)
    if config is not None:
        flat["__config__"] = np.asarray(json.dumps(config))
    with open(path, "wb") as f:
        np.savez_compressed(f, **flat)
    return path


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


def load_detector(path: str, device=None) -> Tuple[FOTSDetector, Any, Dict[str, Any]]:
    """(eval-mode FOTSDetector with the snapshot's weights on ``device`` in
    channels_last memory, step, config).  ``nclass`` comes from the
    snapshot's vocab head.  ``device=None`` is the card (raises without
    CUDA); ``"cpu"`` runs the kernels' plain versions."""
    dev = resolve_device(device)
    flat, step, config = load_serving_params(path)
    model = FOTSDetector(nclass=int(flat["params/ocr/conv11/bias"].shape[0]))
    load_flat(model, flat)
    model = model.eval().to(device=dev, memory_format=torch.channels_last)
    return model, step, config
