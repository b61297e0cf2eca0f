"""What every cell shares: finding a cell's files by name, the window's
statistics, the check that no JAX-side module was loaded, and the result
line.  Nothing here imports the program under test."""

from __future__ import annotations

import importlib.util
import json
import math
import os
import sys
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

#: top-level module names that may not be loaded in a run's process: the
#: JAX stack and the JAX package the program was ported from (compared
#: whole, so the port ``fots_torch`` is not one of them)
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "optax", "fots")


@dataclass
class Cell:
    """One ``workloads`` entry of ``BENCHMARK.json`` with its configuration
    and traffic files read."""

    name: str
    config: dict
    traffic: dict
    chips: int
    end_to_end: List[dict]
    per_layer: List[dict]
    root: str = ROOT        # the checkout whose files the cell's makers come from

    @property
    def model(self):
        """The configuration's model module, ``gpubench/models/<model>.py``
        by the name under its ``"model"`` key: the program's network and the
        plain reference of that architecture (loaded anew on each read, so a
        cell stays a plain value that copies)."""
        return load_file("models", self.config["model"], self.root)


def read_benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(name: str, root: str = ROOT) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with the metrics that apply
    to it.  Raises KeyError for an unknown cell."""
    bench = read_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r}; known: {sorted(cells)}")
    w = cells[name]
    cfg_entry = next(c for c in bench["configs"] if c["name"] == w["config"])
    return cell_from_files(name, cfg_entry["file"], w["traffic"], int(w["chips"]),
                           [m for m in bench["end_to_end"] if _applies(m, name)],
                           [m for m in bench["per_layer"] if _applies(m, name)], root)


def cell_from_files(name: str, config_file: str, traffic: str, chips: int = 1,
                    end_to_end=(), per_layer=(), root: str = ROOT) -> Cell:
    """A cell from its configuration file (relative to the checkout) and its
    traffic file ``gpubench/workloads/<traffic>.json``."""
    with open(os.path.join(root, config_file)) as f:
        config = json.load(f)
    with open(os.path.join(root, "gpubench", "workloads", traffic + ".json")) as f:
        traffic_data = json.load(f)
    return Cell(name, config, traffic_data, chips, list(end_to_end), list(per_layer), root)


def load_file(folder: str, name: str, root: str = ROOT):
    """The module ``gpubench/<folder>/<name>.py`` (a name may hold dots)."""
    path = os.path.join(root, "gpubench", folder, name + ".py")
    spec = importlib.util.spec_from_file_location(f"gpubench_{folder}_{len(sys.modules)}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_reader(metric: str, root: str = ROOT) -> Callable:
    """The ``read`` function of ``gpubench/metrics/<metric>.py``."""
    return load_file("metrics", metric, root).read


def read_metrics(metrics: List[dict], run, root: str = ROOT) -> Dict[str, dict]:
    """Each metric's reader over ``run``; a reader that finds nothing to
    read returns None and its metric is left out."""
    out = {}
    for m in metrics:
        value = load_reader(m["name"], root)(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def forbidden_loaded(modules=None) -> List[str]:
    """The loaded modules whose top-level name is in
    :data:`FORBIDDEN_MODULES`."""
    names = sys.modules if modules is None else modules
    return sorted(m for m in names if m.split(".")[0] in FORBIDDEN_MODULES)


def percentile(values: List[float], q: float) -> float:
    """Nearest-rank percentile: the smallest value with at least q% of the
    values at or below it."""
    v = sorted(values)
    if not v:
        raise ValueError("no values")
    return v[max(0, math.ceil(q / 100.0 * len(v)) - 1)]


def window_rate(done_at: List[float], sizes: List[int], t0: float, seconds: float) -> float:
    """Items of the batches finished in [t0, t0 + seconds] over the window."""
    end = t0 + seconds
    return sum(n for t, n in zip(done_at, sizes) if t0 <= t <= end) / seconds


def log(msg: str) -> None:
    """A progress line on stderr."""
    print(f"gpubench: {msg}", file=sys.stderr, flush=True)


class Phases:
    """Seconds of each set-up phase, from ``t_start`` on, each logged."""

    def __init__(self, t_start: float):
        self.last = t_start
        self.seconds: Dict[str, float] = {}

    def mark(self, name: str) -> None:
        import time

        now = time.perf_counter()
        self.seconds[name] = now - self.last
        self.last = now
        log(f"set-up {name} {self.seconds[name]:.3f} s")


@dataclass
class Check:
    """The numbers compared for ``correct``, each beside its limit."""

    numbers: Dict[str, float] = field(default_factory=dict)
    limits: Dict[str, float] = field(default_factory=dict)
    notes: Dict[str, object] = field(default_factory=dict)

    def add(self, name: str, value: float, limit: float) -> None:
        self.numbers[name] = float(value)
        self.limits[name] = float(limit)

    @property
    def ok(self) -> bool:
        return bool(self.numbers) and all(
            math.isfinite(v) and v <= self.limits[k] for k, v in self.numbers.items())

    def line(self) -> Dict[str, Dict[str, float]]:
        return {k: {"value": v, "limit": self.limits[k]} for k, v in self.numbers.items()}


def emit(correct: bool, attempted: int, failed: int, metrics: dict, device: dict,
         check: Check, breakdown: Optional[dict] = None) -> None:
    """Print the check's notes and then the compared numbers as the last
    lines of stderr, and the result as the last line of stdout (the
    compared numbers last)."""
    print("check notes " + json.dumps(check.notes, default=str), file=sys.stderr)
    for k, v in check.numbers.items():
        print(f"check {k} {v!r} limit {check.limits[k]!r}", file=sys.stderr)
    line = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed),
            "metrics": metrics, "device": device}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["check"] = check.line()
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
