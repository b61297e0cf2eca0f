"""Weights carried across from the JAX package's serving snapshots, and the
port's own training checkpoints.

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

Training checkpoints (:func:`save_checkpoint`, :func:`latest_checkpoint`,
:func:`restore_checkpoint`, after ``fots/checkpoint.py``'s orbax ones) are
``step_{N}`` directories holding one ``state.npz`` of the *payload*:
``model/<name>`` for every parameter and BatchNorm statistic of the port's
state dict, Adam's ``exp_avg/<name>``, ``exp_avg_sq/<name>`` and
``adam_step/<name>`` per parameter, and ``global_step`` (the count of
applied updates).  The format is the port's own (orbax and JAX are absent
on the card); :func:`train_state_from_fots` carries a ``fots`` TrainState
into it.
"""

from __future__ import annotations

import json
import os
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


CHECKPOINT_FILE = "state.npz"


def checkpoint_payload(model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                       global_step: int) -> Dict[str, np.ndarray]:
    """The checkpoint arrays of a model and its Adam optimizer (f32 host
    copies; Adam's step counts as f32 scalars, as torch keeps them)."""
    out: Dict[str, np.ndarray] = {}
    for name, t in model.state_dict().items():
        out[f"model/{name}"] = t.detach().cpu().numpy()
    for name, p in model.named_parameters():
        st = optimizer.state.get(p)
        if not st:
            continue
        out[f"exp_avg/{name}"] = st["exp_avg"].detach().cpu().numpy()
        out[f"exp_avg_sq/{name}"] = st["exp_avg_sq"].detach().cpu().numpy()
        out[f"adam_step/{name}"] = np.asarray(float(st["step"]), np.float32)
    out["global_step"] = np.asarray(int(global_step), np.int64)
    return out


def load_payload(model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                 payload: Mapping[str, np.ndarray]) -> int:
    """Put a payload's weights, statistics and Adam state into ``model`` and
    ``optimizer`` (on the model's device); returns the global step.  Every
    model key must be present and every payload key used."""
    want = model.state_dict()
    sd = {k[len("model/"):]: torch.from_numpy(np.array(v)) for k, v in payload.items()
          if k.startswith("model/")}
    missing, unused = sorted(set(want) - set(sd)), sorted(set(sd) - set(want))
    if missing or unused:
        raise KeyError(f"checkpoint does not match the model: missing {missing[:8]}, "
                       f"unused {unused[:8]}")
    model.load_state_dict(sd, strict=True)
    params = dict(model.named_parameters())
    used = {k for k in payload if k.startswith("model/")} | {"global_step"}
    for name, p in params.items():
        if f"exp_avg/{name}" not in payload:
            optimizer.state.pop(p, None)
            continue
        keys = [f"{g}/{name}" for g in ("exp_avg", "exp_avg_sq", "adam_step")]
        used.update(keys)
        optimizer.state[p] = {
            "step": torch.tensor(float(payload[keys[2]]), dtype=torch.float32),
            "exp_avg": torch.from_numpy(np.array(payload[keys[0]])).to(p.device),
            "exp_avg_sq": torch.from_numpy(np.array(payload[keys[1]])).to(p.device),
        }
    unused = sorted(set(payload) - used)
    if unused:
        raise KeyError(f"checkpoint keys not in the model: {unused[:8]}")
    return int(payload["global_step"])


def save_checkpoint(ckpt_dir: str, trainer, step: int) -> str:
    """Write ``trainer``'s state as ``ckpt_dir/step_{step}``; returns the path."""
    path = os.path.join(os.path.abspath(ckpt_dir), f"step_{step}")
    os.makedirs(path, exist_ok=True)
    payload = checkpoint_payload(trainer.model, trainer.optimizer, trainer.global_step)
    tmp = os.path.join(path, CHECKPOINT_FILE + ".tmp")
    with open(tmp, "wb") as f:
        np.savez(f, **payload)
    os.replace(tmp, os.path.join(path, CHECKPOINT_FILE))
    return path


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    """The ``step_N`` directory of ``ckpt_dir`` with the largest N, or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for d in os.listdir(ckpt_dir):
        if d.startswith("step_") and os.path.isfile(os.path.join(ckpt_dir, d, CHECKPOINT_FILE)):
            try:
                steps.append((int(d.split("_")[1]), d))
            except ValueError:
                continue
    return os.path.join(ckpt_dir, max(steps)[1]) if steps else None


def read_checkpoint(path: str) -> Dict[str, np.ndarray]:
    """The payload of a ``step_N`` directory (or of the latest one under a
    run directory)."""
    if not os.path.isfile(os.path.join(path, CHECKPOINT_FILE)):
        latest = latest_checkpoint(path)
        if latest is None:
            raise FileNotFoundError(f"no port checkpoint at {path!r}")
        path = latest
    with np.load(os.path.join(path, CHECKPOINT_FILE)) as z:
        return {k: z[k] for k in z.files}


def restore_checkpoint(path: str, trainer) -> int:
    """Restore ``trainer`` from a ``step_N`` directory (or the latest under
    ``path``): weights, BatchNorm statistics, Adam's state and the global
    step, which a resumed :meth:`fots_torch.train.Trainer.train` continues.
    Returns the step."""
    trainer.global_step = load_payload(trainer.model, trainer.optimizer, read_checkpoint(path))
    return trainer.global_step


def _flatten(tree, prefix: str) -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}"
        if isinstance(v, Mapping):
            out.update(_flatten(v, key))
        else:
            out[key] = np.asarray(v)
    return out


def train_state_from_fots(params, batch_stats, opt_state, step: int) -> Dict[str, np.ndarray]:
    """The port's checkpoint payload of a ``fots`` TrainState given as numpy
    trees: ``params`` and ``batch_stats`` (nested dicts), ``opt_state``
    (optax's adam state, a sequence holding the ``ScaleByAdamState``, or
    that state itself) and the step.  ``count`` becomes every parameter's
    Adam step, ``mu`` its ``exp_avg`` and ``nu`` its ``exp_avg_sq``, each
    moment in its parameter's layout (:func:`state_dict_from_flat`)."""
    adam = opt_state
    if not hasattr(adam, "mu"):
        adam = next(s for s in opt_state if hasattr(s, "mu"))
    flat = {**_flatten(params, "params"), **_flatten(batch_stats, "batch_stats")}
    out = {f"model/{k}": v.numpy() for k, v in state_dict_from_flat(flat).items()}
    count = np.asarray(float(np.asarray(adam.count)), np.float32)
    for group, tree in (("exp_avg", adam.mu), ("exp_avg_sq", adam.nu)):
        for name, t in state_dict_from_flat(_flatten(tree, "params")).items():
            out[f"{group}/{name}"] = t.numpy()
            out[f"adam_step/{name}"] = count
    out["global_step"] = np.asarray(int(step), np.int64)
    return out


def detector_from_checkpoint(path: str, device=None) -> Tuple[FOTSDetector, int, str]:
    """(eval-mode FOTSDetector with a training checkpoint's weights on
    ``device`` in channels_last memory, its global step, the ``step_N``
    directory read).  ``path`` is a ``step_N`` directory or a run directory
    (its latest checkpoint)."""
    dev = resolve_device(device)
    if not os.path.isfile(os.path.join(path, CHECKPOINT_FILE)):
        path = latest_checkpoint(path) or path
    payload = read_checkpoint(path)
    model = FOTSDetector(nclass=int(payload["model/ocr.conv11.bias"].shape[0]))
    sd = {k[len("model/"):]: torch.from_numpy(np.array(v)) for k, v in payload.items()
          if k.startswith("model/")}
    model.load_state_dict(sd, strict=True)
    model = model.eval().to(device=dev, memory_format=torch.channels_last)
    return model, int(payload["global_step"]), path
