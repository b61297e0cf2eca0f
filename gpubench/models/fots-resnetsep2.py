"""The architecture ``ModelResNetSep2`` (E2E-MLT, FOTS.pytorch): everything
the harness needs of it, found by the name a configuration file gives
(``"model": "fots-resnetsep2"``).

A model module gives: ``program_model`` (the program's network, loaded
with a flat weight dict), ``param_shapes`` and ``seeded`` (its leaves and a
draw of them from a seed), ``program_leaves`` (the program's parameters by
flat key), ``reference`` (the plain reference net), ``MAPS`` (the first
training step's maps compared), ``POOLED_HEIGHT`` (the height RoIRotate
pools to), ``program_maps`` (the program's outputs under the reference's
names) and ``recognition`` (the program's submodule that gives the
log-probs).  It imports the program only inside the functions that build
or read the program's network, so loading it loads nothing of the program.
"""

from __future__ import annotations

import re
from typing import Dict

import numpy as np
import torch

from gpubench import weights
from gpubench.reference import detector

#: the first training step's maps compared (the reference's names; NCHW):
#: the heads at 1/4 and at 1/8 scale, and the shared features RoIRotate reads
MAPS = ("segm", "rbox", "angle", "segm2", "rbox2", "angle2", "focr")
#: the height of RoIRotate's strips: a roi's strip is 11 rows high and
#: 11 * w / h columns wide
POOLED_HEIGHT = 11


def program_model(config: dict, flat: Dict[str, np.ndarray]):
    """The program's detector of ``config``, loaded with ``flat`` by the
    program's own loader."""
    from fots_torch.checkpoint import load_flat
    from fots_torch.models.detector import FOTSDetector

    model = FOTSDetector(nclass=config["nclass"], attention=config["attention"],
                         multi_scale=config["multi_scale"])
    load_flat(model, flat)
    return model


def param_shapes(config: dict) -> Dict[str, tuple]:
    """Every leaf of the network and its shape, keyed as the snapshot is."""
    return detector.param_shapes(config["nclass"], config["attention"])


def seeded(config: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Fresh weights on ``device`` from ``seed``, as the model is initialised
    from scratch (:func:`gpubench.weights.draw`: every kernel a conv's)."""
    return weights.draw(param_shapes(config), seed, device)


def reference(config: dict, params: Dict[str, torch.Tensor], precision: str = "f32",
              train: bool = False) -> detector.Detector:
    """The plain reference over ``params`` (the flat dict, conv kernels
    OIHW), its convolutions in ``precision``; ``train``: BatchNorm over the
    batch's statistics."""
    return detector.Detector(params, config["attention"], detector.Precision(precision), train)


def program_maps(out: dict) -> Dict[str, torch.Tensor]:
    """The program's outputs under the reference's names, NCHW."""
    maps = {"focr": out["focr"]}
    for k in ("segm", "rbox", "angle"):
        maps[k], maps[k + "2"] = out[k]
    return {k: v.permute(0, 3, 1, 2) for k, v in maps.items()}


def recognition(model: torch.nn.Module) -> torch.nn.Module:
    """The program's submodule whose output is the recognition log-probs."""
    return model.ocr


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
