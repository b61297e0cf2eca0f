"""Run one cell of the benchmark of ``fots_torch`` once, on the card.

    python3 gpubench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Reads ``BENCHMARK.json`` (the cell's configuration and traffic files, and
its metrics), sets up and warms up the program, measures one window of
``--seconds`` and checks a sample of what the window produced against the
plain reference in ``gpubench/reference``.  The last line of standard
output is one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer metrics from a profiler span inside the window), ``device``,
``breakdown`` (``--trace 1``) and ``check`` (each number compared, with its
limit).  Exits non-zero without a result when there is no CUDA card, or
when a module of JAX or of the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def cache_env(root: str = ROOT) -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    cache = os.path.join(root, "build", "gpubench")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    cache_env()
    sys.path.insert(0, ROOT)
    import torch

    from gpubench import common, report

    cell = common.find_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"gpubench: the cell needs {cell.chips} CUDA card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    run = report.drive(cell, args.seed, args.seconds, bool(args.trace), T_START, "cuda")
    bad = common.forbidden_loaded()
    if bad:
        print(f"gpubench: modules of JAX or of the JAX package were loaded: {bad}",
              file=sys.stderr)
        return 3
    report.emit_result(cell, run, bool(args.trace))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
