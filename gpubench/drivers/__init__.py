"""The drivers of the traffic kinds, found by name: a cell whose traffic
file says ``"kind": "<kind>"`` is run by ``gpubench/drivers/<kind>.py``
(its ``run`` and, for the traced run, ``model_flops``)."""

from __future__ import annotations

import importlib
from typing import Dict

import numpy as np


def driver(kind: str):
    """The module that drives traffic of ``kind``."""
    return importlib.import_module(f"gpubench.drivers.{kind}")


def program_model(config: dict, flat: Dict[str, np.ndarray]):
    """The program's detector of ``config``, loaded with ``flat`` by the
    program's own loader."""
    from fots_torch.checkpoint import load_flat
    from fots_torch.models.detector import FOTSDetector

    model = FOTSDetector(nclass=config["nclass"], attention=config["attention"],
                         multi_scale=config["multi_scale"])
    load_flat(model, flat)
    return model
