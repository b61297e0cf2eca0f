"""From a cell's run to its result line: the driver of the traffic's kind
(``gpubench/drivers/<kind>.py``), the end-to-end metrics (host clock), the
per-layer metrics (each from its reader in ``gpubench/metrics``), the
device and the breakdown."""

from __future__ import annotations

from types import SimpleNamespace

import torch

from gpubench import common, trace
from gpubench.drivers import driver as driver_of


def drive(cell: common.Cell, seed: int, seconds: float, traced: bool, t_start: float,
          device: str = "cuda") -> dict:
    driver = driver_of(cell.traffic["kind"])
    run = driver.run(cell, seed, seconds, traced, t_start, device)
    run["kind"] = cell.traffic["kind"]
    run["window"] = None
    span = run.get("span")
    if span is not None and span.prof is not None:
        run["window"] = trace.reduce(trace.events_of(span.prof))
        if traced and hasattr(driver, "model_flops"):
            run["model_flops"] = driver.model_flops(cell, run, device)
    return run


def view(run: dict) -> SimpleNamespace:
    """What a metric's reader sees: the run's numbers by name."""
    return SimpleNamespace(**run)


def device_info(run: dict, traced: bool) -> dict:
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1,
            "memory_peak_bytes": int(run["memory_peak_bytes"])}
    if traced and run["window"] is not None:
        info["busy_s"] = run["window"].busy_s
        info["window_s"] = run["window"].window_s
    return info


def emit_result(cell: common.Cell, run: dict, traced: bool) -> None:
    if traced:
        metrics = common.read_metrics(cell.per_layer, view(run))
    else:
        metrics = {m["name"]: {"value": float(run[m["name"]]), "unit": m["unit"]}
                   for m in cell.end_to_end}
    breakdown = None
    if traced and run["window"] is not None:
        breakdown = {"device_ops": [[n, s] for n, s in run["window"].device_ops],
                     "idle_gaps": [[n, s] for n, s in run["window"].idle_gaps]}
    span = run.get("span")
    if traced and span is not None and span.counted:
        common.log(f"the program's launch counters over the traced span of {span.spanned}: "
                   f"{span.counted}")
    check = run["check"]
    correct = check.ok and run["failed"] == 0
    common.emit(correct, run["attempted"], run["failed"], metrics, device_info(run, traced),
                check, breakdown)
