"""The readings the limits of ``correct`` are set from, for one cell, in
one process: the program's numbers on many seeds (the lower readings) and
the control's on a few (the upper readings).

    python3 gpubench/control.py --workload <cell> --seeds 12 --control-seeds 3 [--seconds 3]

The control is the plain reference put in the program's place and
computed in the next precision below the configuration's: serving's bf16
backbone -> float8 (e4m3, per-tensor scales); training's float32 (TF32
convolutions) -> bfloat16 convolutions.  A training cell also reads the
planted fault "half of the batch left out" (the detection loss over the
first half of the images) on the control's seeds.  Each reading is
judged against the cell's limits (``over_limits``: the compared numbers it
fails).  Prints one JSON line a reading and a summary, and writes them to
``--out`` when given.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def serve_readings(cell, seeds, control_seeds, seconds, device):
    import numpy as np

    from gpubench import check_serve
    from gpubench.drivers import serve

    out = []
    for i, seed in enumerate(seeds):
        run = serve.run(cell, seed, seconds, False, time.perf_counter(), device)
        out.append({"seed": seed, "side": "program", **run["check"].notes,
                    "images_per_s": run["serve_images_per_s"]})
        print(json.dumps(out[-1]), flush=True)
        if i >= control_seeds:
            continue
        frames = serve.Frames(cell.traffic, seed)
        idx = np.concatenate([frames.draw() for _ in range(cell.traffic["check_batches"] + 1)])
        frames_u8 = np.stack(frames.images(idx))
        flat = serve.cell_weights(cell, seed, device)
        with serve.reference_math(device):
            params = check_serve.reference_params(flat, device)
            ctl_boxes, ctl_texts, _ = check_serve.reference_pass(cell, params, frames_u8, "fp8",
                                                                 device=device)
        keep = [[t != "" for t in ts] for ts in ctl_texts]
        ctl_boxes = [b[np.asarray(k, bool)] if len(b) else b for b, k in zip(ctl_boxes, keep)]
        ctl_texts = [[t for t in ts if t] for ts in ctl_texts]
        nums = serve.compare_to_reference(cell, flat, frames_u8, ctl_boxes, ctl_texts, device)
        out.append({"seed": seed, "side": "control_fp8", **nums,
                    "frames_checked": len(frames_u8)})
        print(json.dumps(out[-1]), flush=True)
    return out


def train_readings(cell, seeds, control_seeds, device, tf32_off_seeds=0):
    from gpubench import check_train

    out = []
    for seed in seeds[:tf32_off_seeds]:
        nums, *_ = _program_steps(cell, seed, device, tf32=False)
        out.append({"seed": seed, "side": "program_tf32_off", **nums})
        print(json.dumps(out[-1]), flush=True)
    for i, seed in enumerate(seeds):
        nums, rois, pool, flat = _program_steps(cell, seed, device)
        out.append({"seed": seed, "side": "program", **nums})
        print(json.dumps(out[-1]), flush=True)
        if i >= control_seeds:
            continue
        ref = check_train.reference_steps(cell, flat, pool, rois, seed, device)
        ctl = check_train.reference_steps(cell, flat, pool, rois, seed, device, "bf16")
        out.append({"seed": seed, "side": "control_bf16",
                    **check_train.numbers(cell.model, ctl, ref, rois[0])})
        print(json.dumps(out[-1]), flush=True)
        nums, *_ = _program_steps(cell, seed, device, fault="half_batch")
        out.append({"seed": seed, "side": "fault_half_batch", **nums})
        print(json.dumps(out[-1]), flush=True)
    return out


def _program_steps(cell, seed, device, fault=None, tf32=True):
    """The program's three checked steps and their numbers against the
    reference (``fault``: "half_batch" plants the detection loss over the
    first half of the images; ``tf32`` False turns cuDNN's TF32 off for the
    program, to see how much of its gap TF32 makes)."""
    import torch

    import fots_torch.train as program_train

    from gpubench.drivers import train

    saved = program_train.detection_loss, torch.backends.cudnn.allow_tf32
    if fault == "half_batch":
        program_train.detection_loss = half_batch(saved[0])
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        cell = _short(cell)
        run = train.run(cell, seed, 0.0, False, time.perf_counter(), device)
    finally:
        program_train.detection_loss, torch.backends.cudnn.allow_tf32 = saved
    notes = {k: v for k, v in run["check"].notes.items() if k not in ("losses", "ref_losses")}
    return notes, run["check_rois"], run["check_pool"], run["check_weights"]


def half_batch(detection_loss):
    """``detection_loss`` over the first half of the batch's images."""
    def loss(outputs, score_gt, training_mask, geo_gt, angle_gt, **kw):
        h = score_gt.shape[0] // 2
        half = {k: [t[:h] for t in v] if isinstance(v, list) else v[:h]
                for k, v in outputs.items()}
        return detection_loss(half, score_gt[:h], training_mask[:h], geo_gt[:h],
                              angle_gt[:h], **kw)
    return loss


def over_limits(cell, reading: dict) -> list:
    """The names of the cell's compared numbers that ``reading`` fails, as
    :class:`gpubench.common.Check` judges them (a number the reading lacks,
    such as a control's ``roi_start``, is not judged)."""
    from gpubench.common import Check

    over = []
    for name, limit in cell.traffic["limits"].items():
        if name not in reading:
            continue
        chk = Check()
        chk.add(name, reading[name], limit)
        if not chk.ok:
            over.append(name)
    return over


def _short(cell):
    """The cell without warm-up steps and with only the checked batches (its
    window is not measured here)."""
    import copy
    cell = copy.deepcopy(cell)
    cell.traffic.update(warmup_steps=0, pool_batches=3)
    return cell


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--first-seed", type=int, default=2_000_000_011)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--tf32-off-seeds", type=int, default=0,
                    help="also read the program with cuDNN's TF32 off on this many seeds")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from gpubench import common
    from gpubench.run import cache_env

    cache_env()
    cell = common.find_cell(args.workload)
    seeds = [args.first_seed + 7919 * i for i in range(args.seeds)]
    t0 = time.perf_counter()
    if cell.traffic["kind"] == "serve":
        out = serve_readings(cell, seeds, args.control_seeds, args.seconds, "cuda")
    else:
        out = train_readings(cell, seeds, args.control_seeds, "cuda", args.tf32_off_seeds)
    for r in out:
        r["over_limits"] = over_limits(cell, r)
    summary = {}
    for side in sorted({r["side"] for r in out}):
        rows = [r for r in out if r["side"] == side]
        summary[side] = {k: [min(r[k] for r in rows), max(r[k] for r in rows)]
                         for k in rows[0] if isinstance(rows[0][k], (int, float))
                         and k != "seed"}
        summary[side]["runs_over_limits"] = sum(bool(r["over_limits"]) for r in rows)
    print(json.dumps({"workload": args.workload, "seconds": time.perf_counter() - t0,
                      "summary": summary}), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"readings": out, "summary": summary}, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
