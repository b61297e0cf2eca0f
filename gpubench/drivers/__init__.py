"""The drivers of the traffic kinds, found by name: a cell whose traffic
file says ``"kind": "<kind>"`` is run by ``gpubench/drivers/<kind>.py``
(its ``run`` and, for the traced run, ``model_flops``)."""

from __future__ import annotations

import importlib


def driver(kind: str):
    """The module that drives traffic of ``kind``."""
    return importlib.import_module(f"gpubench.drivers.{kind}")
