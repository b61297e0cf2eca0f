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

The reference's own torch weights (``-h5``: :func:`load_torch_h5`,
:func:`reference_key_map`, :func:`import_torch_state_dict`) load onto the
port's module names directly; both sides are torch layout.

Training checkpoints (:func:`save_checkpoint`, :func:`latest_checkpoint`,
:func:`restore_checkpoint`, after ``fots/checkpoint.py``'s orbax ones) are
``step_{N}`` directories holding one ``state.npz`` of the *payload*:
``model/<name>`` for every parameter and BatchNorm statistic of the port's
state dict, Adam's ``exp_avg/<name>``, ``exp_avg_sq/<name>`` and
``adam_step/<name>`` per parameter, and ``global_step`` (the count of
applied updates).  The format is the port's own (orbax and JAX are absent
on the card); :func:`train_state_from_fots` carries a ``fots`` TrainState
into it, the joint trainer's or an ``OcrTrainState`` of the recognition-only
trainers (:mod:`fots_torch.train_ocr`, whose CLIs save and resume the same
``step_N`` directories).  A trainer on a mesh writes the file a single-card
run writes (the vocabulary head's rows gathered over the model axis, rank 0
writing, every rank waiting for it) and restores each rank's rows from any
such file, so runs resume across meshes.  :func:`state_dict_from_fots` maps the flax
variables of the detector, the CRNN or the OwnModel
(:func:`model_state_dict_from_flat`).
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


def load_serving_config(path: str) -> Dict[str, Any]:
    """The serving config embedded in a snapshot written by
    :func:`save_serving_params` ({} for a snapshot without one), as
    ``fots.checkpoint.load_serving_config`` reads it."""
    with np.load(path) as z:
        if "__config__" not in z.files:
            return {}
        return json.loads(str(z["__config__"]))


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


# --------------------------------------------------------------------------
# the reference's torch weights (``-h5``)
# --------------------------------------------------------------------------
#
# The reference trains ``ModelResNetSep2`` in torch and publishes
# ``torch.save({"state_dict": ...})`` files (``.h5`` by name).  Its keys map
# onto the port's module names one for one, both in torch layout (OIHW
# kernels, depthwise (C, 1, kh, kw)), so nothing is transposed.  The map is
# ``fots/checkpoint.py``'s, kept here by flax path and turned into port
# names by :func:`torch_key`.


def _reference_block_map(ref: str, path: str, sep: bool, downsample: bool = False
                         ) -> Dict[str, Tuple[str, str]]:
    """Reference key -> (flax path, kind) for one residual block."""
    m: Dict[str, Tuple[str, str]] = {}
    if not sep:  # BasicBlockIn
        m[f"{ref}.conv1.weight"] = (f"{path}/conv1/kernel", "conv")
        m[f"{ref}.bn1.weight"] = (f"{path}/in1/scale", "vec")
        m[f"{ref}.bn1.bias"] = (f"{path}/in1/bias", "vec")
        m[f"{ref}.conv2.weight"] = (f"{path}/conv2/kernel", "conv")
        m[f"{ref}.bn2.weight"] = (f"{path}/in2/scale", "vec")
        m[f"{ref}.bn2.bias"] = (f"{path}/in2/bias", "vec")
    else:  # BasicBlockSepIn (conv_sep1.2 is an InstanceNorm without affine)
        m[f"{ref}.conv_sep1.0.weight"] = (f"{path}/sep1/dw/kernel", "dw")
        m[f"{ref}.conv_sep1.1.weight"] = (f"{path}/sep1/pw/kernel", "conv")
        m[f"{ref}.conv2.0.weight"] = (f"{path}/conv2/dw/kernel", "dw")
        m[f"{ref}.conv2.1.weight"] = (f"{path}/conv2/in1/scale", "vec")
        m[f"{ref}.conv2.1.bias"] = (f"{path}/conv2/in1/bias", "vec")
        m[f"{ref}.conv2.3.weight"] = (f"{path}/conv2/pw/kernel", "conv")
        m[f"{ref}.conv2.4.weight"] = (f"{path}/conv2/in2/scale", "vec")
        m[f"{ref}.conv2.4.bias"] = (f"{path}/conv2/in2/bias", "vec")
    if downsample:  # conv1x1 + BatchNorm on a stage's first block
        m[f"{ref}.downsample.0.weight"] = (f"{path}/down_conv/kernel", "conv")
        m[f"{ref}.downsample.1.weight"] = (f"{path}/down_bn/bn/scale", "vec")
        m[f"{ref}.downsample.1.bias"] = (f"{path}/down_bn/bn/bias", "vec")
        m[f"{ref}.downsample.1.running_mean"] = (f"{path}/down_bn/bn/mean", "stat")
        m[f"{ref}.downsample.1.running_var"] = (f"{path}/down_bn/bn/var", "stat")
    return m


def _reference_flax_map() -> Dict[str, Tuple[str, str]]:
    m: Dict[str, Tuple[str, str]] = {
        "layer0.0.weight": ("stem/conv0a/kernel", "conv"),
        "layer0.1.bn.weight": ("stem/crelu0a/in/scale", "vec"),
        "layer0.1.bn.bias": ("stem/crelu0a/in/bias", "vec"),
        "layer0.2.weight": ("stem/conv0b/kernel", "conv"),
        "layer0.3.bn.weight": ("stem/crelu0b/in/scale", "vec"),
        "layer0.3.bn.bias": ("stem/crelu0b/in/bias", "vec"),
        "layer0_1.0.weight": ("stem/conv1a/kernel", "conv"),
        "layer0_1.2.weight": ("stem/conv1b/kernel", "conv"),
    }
    for stage, blocks, sep in ((1, 3, False), (2, 4, False), (3, 6, True), (4, 4, True)):
        for i in range(blocks):
            m.update(_reference_block_map(f"layer{stage}.{i}", f"layer{stage}_{i}", sep,
                                          downsample=stage > 1 and i == 0))
    for name in ("feature1", "feature2", "feature3", "feature4"):
        m[f"{name}.weight"] = (f"{name}/kernel", "conv")
    for name in ("upconv1", "upconv2"):
        m[f"{name}.0.weight"] = (f"{name}/dw/kernel", "dw")
        m[f"{name}.1.weight"] = (f"{name}/pw/kernel", "conv")
    m["conv_attenton.weight"] = ("conv_attention/kernel", "conv")
    m["conv_attenton.bias"] = ("conv_attention/bias", "vec")
    for name in ("act", "rbox", "angle"):
        m[f"{name}.weight"] = (f"{name}/kernel", "conv")
        m[f"{name}.bias"] = (f"{name}/bias", "vec")
    for idx in (5, 6, 7, 8, 9):
        m[f"conv{idx}.weight"] = (f"ocr/conv{idx}/kernel", "conv")
    m["conv10_s.weight"] = ("ocr/conv10_s/kernel", "conv")
    m["conv11.weight"] = ("ocr/conv11/kernel", "conv")
    m["conv11.bias"] = ("ocr/conv11/bias", "vec")
    for idx in (5, 7):
        m[f"batch{idx}.weight"] = (f"ocr/batch{idx}/scale", "vec")
        m[f"batch{idx}.bias"] = (f"ocr/batch{idx}/bias", "vec")
    m["batch10_s.weight"] = ("ocr/batch10_s/scale", "vec")
    m["batch10_s.bias"] = ("ocr/batch10_s/bias", "vec")
    return m


def reference_key_map() -> Dict[str, Tuple[str, str]]:
    """Reference ``ModelResNetSep2`` state-dict key -> (the port's
    :class:`FOTSDetector` state-dict name, kind: ``conv`` / ``dw`` kernel,
    ``vec``, BatchNorm ``stat``)."""
    return {key: (torch_key(("batch_stats/" if kind == "stat" else "params/") + path), kind)
            for key, (path, kind) in _reference_flax_map().items()}


def import_torch_state_dict(state_dict: Mapping[str, Any], model: torch.nn.Module,
                            skip_substrings: Tuple[str, ...] = ()) -> Tuple[list, list]:
    """Copy a reference state dict into ``model`` (in place) with
    ``fots.checkpoint.import_torch_state_dict``'s rules; returns
    ``(imported, skipped)`` reference keys.  A key holding any of
    ``skip_substrings`` is skipped (the reference's partial warm start skips
    ``conv11`` / ``rnn`` when the vocabulary differs); ``num_batches_tracked``
    is dropped silently; any other key the map does not know is skipped.
    Parameters the dict does not reach keep their values.  Raises when a
    mapped tensor's shape differs from the model's."""
    key_map = reference_key_map()
    own = model.state_dict()
    imported, skipped, update = [], [], {}
    for key, value in state_dict.items():
        if any(s in key for s in skip_substrings):
            skipped.append(key)
            continue
        if key not in key_map:
            if not key.endswith("num_batches_tracked"):
                skipped.append(key)
            continue
        name = key_map[key][0]
        t = torch.as_tensor(np.asarray(value, dtype=np.float32))
        if tuple(t.shape) != tuple(own[name].shape):
            raise ValueError(f"{key}: shape {tuple(t.shape)} does not fit {name} "
                             f"{tuple(own[name].shape)}")
        update[name] = t
        imported.append(key)
    with torch.no_grad():
        for name, t in update.items():
            own[name].copy_(t)
    return imported, skipped


def reference_state_dict(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """``model``'s weights under the reference's keys (the inverse of
    :func:`reference_key_map`): what ``torch.save({"state_dict": ...})``
    writes as a reference weight file."""
    own = model.state_dict()
    return {key: own[name].detach().to("cpu", torch.float32).clone()
            for key, (name, _kind) in reference_key_map().items()}


def load_torch_h5(path: str) -> Dict[str, np.ndarray]:
    """A reference weight file (``torch.save`` of a dict with
    ``state_dict``, or the state dict itself) as numpy arrays by key, read
    on the CPU, as ``fots.checkpoint.load_torch_h5`` reads it."""
    blob = torch.load(path, map_location="cpu", weights_only=False)
    sd = blob.get("state_dict", blob)
    return {k: v.detach().cpu().numpy() for k, v in sd.items()}


CHECKPOINT_FILE = "state.npz"


def checkpoint_payload(model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                       global_step: int, mesh=None) -> Dict[str, np.ndarray]:
    """The checkpoint arrays of a model and its Adam optimizer (f32 host
    copies; Adam's step counts as f32 scalars, as torch keeps them).  Under
    ``mesh`` the sharded vocabulary head's weights and moments are gathered
    over the model axis (every rank must call this)."""
    sharded = set()
    if mesh is not None:
        from fots_torch.parallel import mesh as pmesh

        sharded = set(pmesh.sharded_names(model))
        group, n = pmesh.model_group(mesh), pmesh.axis_size(mesh, pmesh.MODEL_AXIS)

    def host(name, t):
        t = t.detach()
        if name in sharded:
            t = pmesh.gather_rows(t, group, n)
        return t.cpu().numpy()

    out: Dict[str, np.ndarray] = {}
    for name, t in model.state_dict().items():
        out[f"model/{name}"] = host(name, t)
    for name, p in model.named_parameters():
        st = optimizer.state.get(p)
        if not st:
            continue
        out[f"exp_avg/{name}"] = host(name, st["exp_avg"])
        out[f"exp_avg_sq/{name}"] = host(name, st["exp_avg_sq"])
        out[f"adam_step/{name}"] = np.asarray(float(st["step"]), np.float32)
    out["global_step"] = np.asarray(int(global_step), np.int64)
    return out


def _local_rows(payload: Mapping[str, np.ndarray], model: torch.nn.Module, mesh
                ) -> Dict[str, np.ndarray]:
    """``payload`` with this model rank's rows of the sharded vocabulary
    head's weights and moments."""
    from fots_torch.parallel import mesh as pmesh

    n, index = pmesh.axis_size(mesh, pmesh.MODEL_AXIS), pmesh.axis_index(mesh, pmesh.MODEL_AXIS)
    out = dict(payload)
    for name in pmesh.sharded_names(model):
        for group in ("model", "exp_avg", "exp_avg_sq"):
            key = f"{group}/{name}"
            if key in out:
                out[key] = np.array_split(np.asarray(out[key]), n, axis=0)[index]
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
    """Write ``trainer``'s state as ``ckpt_dir/step_{step}``; returns the
    path.  On a mesh (``trainer.mesh``) every rank calls this: the shards
    are gathered, rank 0 writes, and every rank returns once it has."""
    mesh = getattr(trainer, "mesh", None)
    path = os.path.join(os.path.abspath(ckpt_dir), f"step_{step}")
    payload = checkpoint_payload(trainer.model, trainer.optimizer, trainer.global_step, mesh)
    if mesh is None or torch.distributed.get_rank() == 0:
        os.makedirs(path, exist_ok=True)
        tmp = os.path.join(path, CHECKPOINT_FILE + ".tmp")
        with open(tmp, "wb") as f:
            np.savez(f, **payload)
        os.replace(tmp, os.path.join(path, CHECKPOINT_FILE))
    if mesh is not None:
        from fots_torch.parallel.mesh import barrier

        barrier(mesh)
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
    step, which a resumed :meth:`fots_torch.train.Trainer.train` continues;
    on a mesh, each rank's rows of the vocabulary head.  Returns the step."""
    payload = read_checkpoint(path)
    mesh = getattr(trainer, "mesh", None)
    if mesh is not None:
        payload = _local_rows(payload, trainer.model, mesh)
    trainer.global_step = load_payload(trainer.model, trainer.optimizer, payload)
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


# --------------------------------------------------------------------------
# the recognition-only models' flax trees
# --------------------------------------------------------------------------
#
# CRNN (``fots.models.crnn``): ``conv0``..``conv6`` (kernel HWIO, bias),
# ``bn2``/``bn4``/``bn6`` (flax BatchNorm directly: scale, bias, and mean /
# var in ``batch_stats``), and per BiLSTM ``rnn0``/``rnn1`` two
# ``OptimizedLSTMCell_{0,1}`` (forward, reverse) with input kernels
# ``ii/if/ig/io`` [in, H] (no bias) and recurrent ``hi/hf/hg/ho`` [H, H] with
# biases, plus ``embedding`` (Dense kernel [2H, out], bias).  torch's LSTM
# takes ``weight_ih = cat(ii, if, ig, io).T``, ``weight_hh = cat(hi, hf, hg,
# ho).T``, ``bias_hh = cat(b_hi, .., b_ho)``; its ``bias_ih`` has no flax
# counterpart and stays zero (the port freezes it, :class:`BiLSTM`).

_CRNN_LAYERS = {f"conv{i}" for i in range(7)} | {"bn2", "bn4", "bn6"}
_GATES = ("i", "f", "g", "o")
_CELLS = {"OptimizedLSTMCell_0": "", "OptimizedLSTMCell_1": "_reverse"}


def _conv_or_dense(arr: np.ndarray, leaf: str) -> torch.Tensor:
    t = torch.from_numpy(np.array(arr, dtype=np.float32))
    if leaf == "kernel":
        t = t.permute(3, 2, 0, 1) if t.ndim == 4 else t.t()
    return t.contiguous()


def crnn_state_dict_from_flat(flat: Mapping[str, np.ndarray], moments: bool = False
                              ) -> Dict[str, torch.Tensor]:
    """Port state dict of a flat CRNN tree (``params/<path>/<leaf>`` and
    ``batch_stats/bnK/{mean,var}``); raises on a key it does not use.
    ``moments``: the tree is an Adam moment of the params (no frozen LSTM
    input biases are made)."""
    out: Dict[str, torch.Tensor] = {}
    cells: Dict[Tuple[str, str], Dict[str, np.ndarray]] = {}
    for key, arr in flat.items():
        group, *path = key.split("/")
        if (group == "batch_stats" and len(path) == 2 and path[0] in _CRNN_LAYERS
                and path[1] in _STAT_LEAVES.values()):
            out[f"{path[0]}.{'running_mean' if path[1] == 'mean' else 'running_var'}"] = \
                torch.from_numpy(np.array(arr, dtype=np.float32))
        elif group == "params" and len(path) == 2 and path[0] in _CRNN_LAYERS:
            leaf = "weight" if path[1] in ("kernel", "scale") else path[1]
            if path[1] not in ("kernel", "scale", "bias"):
                raise KeyError(f"not a CRNN leaf: {key!r}")
            out[f"{path[0]}.{leaf}"] = _conv_or_dense(arr, path[1])
        elif group == "params" and len(path) == 3 and path[1] == "embedding":
            if path[2] not in ("kernel", "bias"):
                raise KeyError(f"not a CRNN leaf: {key!r}")
            out[f"{path[0]}.embedding.{'weight' if path[2] == 'kernel' else 'bias'}"] = \
                _conv_or_dense(arr, path[2])
        elif group == "params" and len(path) == 4 and path[1] in _CELLS:
            cells.setdefault((path[0], path[1]), {})[f"{path[2]}/{path[3]}"] = arr
        else:
            raise KeyError(f"not a CRNN tree key: {key!r}")
    for (rnn, cell), leaves in cells.items():
        sfx = _CELLS[cell]
        want = ({f"i{g}/kernel" for g in _GATES} | {f"h{g}/kernel" for g in _GATES}
                | {f"h{g}/bias" for g in _GATES})
        if set(leaves) != want:
            raise KeyError(f"{rnn}/{cell}: leaves {sorted(leaves)}, expected {sorted(want)}")

        def cat(names):
            return torch.from_numpy(np.concatenate(
                [np.asarray(leaves[n], np.float32) for n in names], axis=-1))

        w_ih = cat([f"i{g}/kernel" for g in _GATES]).t().contiguous()
        out[f"{rnn}.lstm.weight_ih_l0{sfx}"] = w_ih
        out[f"{rnn}.lstm.weight_hh_l0{sfx}"] = cat([f"h{g}/kernel" for g in _GATES]).t().contiguous()
        out[f"{rnn}.lstm.bias_hh_l0{sfx}"] = cat([f"h{g}/bias" for g in _GATES])
        if not moments:
            out[f"{rnn}.lstm.bias_ih_l0{sfx}"] = torch.zeros(w_ih.shape[0])
    return out


def _split_own(flat: Mapping[str, np.ndarray]):
    """An OwnModel tree's ``detector/...`` and ``crnn/...`` halves, each
    without its prefix."""
    halves: Dict[str, Dict[str, np.ndarray]] = {"detector": {}, "crnn": {}}
    for key, arr in flat.items():
        group, branch, *rest = key.split("/")
        if branch not in halves or not rest:
            raise KeyError(f"not an OwnModel tree key: {key!r}")
        halves[branch]["/".join([group] + rest)] = arr
    return halves["detector"], halves["crnn"]


def model_state_dict_from_flat(flat: Mapping[str, np.ndarray], kind: str = "detector",
                               moments: bool = False) -> Dict[str, torch.Tensor]:
    """Port state dict of a flat ``fots`` tree of a ``kind`` model:
    ``"detector"`` (:func:`state_dict_from_flat`), ``"crnn"``
    (:func:`crnn_state_dict_from_flat`) or ``"own"`` (OwnModel: its
    ``detector/...`` keys under ``detector.``, its ``crnn/...`` under
    ``crnn.``).  Every key is used or the call raises.  ``fots``'s OwnModel
    init touches the detector's forward and the CRNN, never the recognition
    head, so an OwnModel tree has no ``detector/ocr`` keys: the port's
    ``detector.ocr.*`` entries keep their own values
    (:func:`load_own_model`)."""
    if kind == "detector":
        return state_dict_from_flat(flat)
    if kind == "crnn":
        return crnn_state_dict_from_flat(flat, moments)
    if kind == "own":
        det, crnn = _split_own(flat)
        return {**{f"detector.{k}": v for k, v in state_dict_from_flat(det).items()},
                **{f"crnn.{k}": v for k, v in crnn_state_dict_from_flat(crnn, moments).items()}}
    raise ValueError(f"unknown model kind {kind!r}")


def load_own_model(model: torch.nn.Module, sd: Mapping[str, torch.Tensor]) -> None:
    """Load an OwnModel state dict of a ``fots`` tree into ``model``: every
    entry of ``sd`` must fit, and the only ones it may lack are the
    recognition head's (``detector.ocr.*``, which ``fots``'s OwnModel never
    initialises)."""
    want = model.state_dict()
    missing = sorted(set(want) - set(sd))
    unused = sorted(set(sd) - set(want))
    if unused or any(not k.startswith("detector.ocr.") for k in missing):
        raise KeyError(f"OwnModel tree does not match: missing {missing[:8]}, "
                       f"unused {unused[:8]}")
    model.load_state_dict(dict(sd), strict=False)


def state_dict_from_fots(params, batch_stats=None, kind: str = "detector"
                         ) -> Dict[str, torch.Tensor]:
    """Port state dict of ``fots`` variables given as nested numpy trees
    (``params``, ``batch_stats``) of a ``kind`` model (see
    :func:`model_state_dict_from_flat`)."""
    flat = {**_flatten(params, "params"), **_flatten(batch_stats or {}, "batch_stats")}
    return model_state_dict_from_flat(flat, kind)


def train_state_from_fots(params, batch_stats, opt_state, step: int,
                          kind: str = "detector") -> Dict[str, np.ndarray]:
    """The port's checkpoint payload of a ``fots`` TrainState (the joint
    trainer's, or an ``OcrTrainState`` of ``kind`` "crnn", "own" or
    "detector") given as numpy trees: ``params`` and ``batch_stats`` (nested
    dicts), ``opt_state`` (optax's adam state, a sequence holding the
    ``ScaleByAdamState``, or that state itself) and the step.  ``count``
    becomes every parameter's Adam step, ``mu`` its ``exp_avg`` and ``nu``
    its ``exp_avg_sq``, each moment in its parameter's layout."""
    adam = opt_state
    if not hasattr(adam, "mu"):
        adam = next(s for s in opt_state if hasattr(s, "mu"))
    out = {f"model/{k}": v.numpy()
           for k, v in state_dict_from_fots(params, batch_stats, kind).items()}
    count = np.asarray(float(np.asarray(adam.count)), np.float32)
    for group, tree in (("exp_avg", adam.mu), ("exp_avg_sq", adam.nu)):
        moment = model_state_dict_from_flat(_flatten(tree, "params"), kind, moments=True)
        for name, t in moment.items():
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
