"""Where the serving or training time goes on the card: a torch.profiler
breakdown.

    python3 -m fots_torch.profiling [--path serve|train] [--batch N] [--batches N]

``serve`` (default batch 16): the smoke images at 704x1280, bf16, the
shipped snapshot, through ``FOTSInference.stream``.  ``train`` (default
batch 8): the training asset at 640x960, f32, the snapshot as warm start,
``Trainer.train`` (lr 1e-4; PyTorch's default math settings).  Warm-up
batches first, then a profiled window of ``--batches`` batches (steps).
Prints one JSON object: host wall time per batch, device busy time per
batch (the union of kernel intervals), the device's idle share of the
window, device time per kernel category and the top kernels by device
time.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import time
from collections import defaultdict

import numpy as np
import torch

from fots_torch.checkpoint import load_detector
from fots_torch.pipeline import FOTSInference

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# kernel-name fragments -> category, first match wins
_CATEGORIES = (("in_stats_kernel", "instance_norm (K1')"),
               ("in_apply_kernel", "instance_norm (K1')"),
               ("in_bwd_", "instance_norm_bwd (K1'-bwd)"),
               ("spatial_stats_kernel", "spatial_stats (K2')"),
               ("spatial_norm_kernel", "spatial_norm (K3')"),
               ("pack_neighbors_bwd_kernel", "pack_neighbors_bwd (K4'-bwd)"),
               ("pack_neighbors_kernel", "pack_neighbors (K4')"),
               ("ctc", "ctc"), ("adam", "optimizer"), ("foreach", "optimizer"),
               ("multi_tensor_apply", "optimizer"),
               ("conv", "convolution"), ("gemm", "convolution"),
               ("xmma", "convolution"), ("cudnn", "convolution"),
               ("Memcpy", "memcpy"), ("Memset", "memset"),
               ("topk", "topk/sort"), ("sort", "topk/sort"),
               ("index", "gather/index"), ("gather", "gather/index"),
               ("upsample", "resize"), ("reduce", "reduction"),
               ("softmax", "softmax"), ("cat", "concat"),
               ("elementwise", "elementwise"))


def _category(name: str) -> str:
    low = name.lower()
    for frag, cat in _CATEGORIES:
        if frag.lower() in low:
            return cat
    return "other"


def _union_us(intervals):
    total, end = 0.0, -1.0
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def _is_annotation(event) -> bool:
    """A record_function range mirrored onto the device timeline (such as
    ``Optimizer.step#Adam.step``): it spans the kernels launched inside it
    and the gaps between them, so it is no device work of its own.  The
    profiler flags it; the name test covers builds that do not.  (Kernel
    names hold ``#`` too, in lambdas such as ``{lambda(float)#1}``, but
    never without spaces or brackets.)"""
    return (bool(getattr(event, "is_user_annotation", False))
            or re.fullmatch(r"[\w.]+#[\w.]+", event.name) is not None)


def _profiled(run, batches: int):
    """Profile ``run()`` (which works through ``batches`` batches) and
    summarise its device activity per batch."""
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return _summary(prof.events(), wall, batches)


def _summary(events, wall: float, batches: int) -> dict:
    """Device activity per batch from profiler events over ``wall``
    seconds: kernels, copies and memsets, not the user annotations on the
    device timeline."""
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA and not _is_annotation(e)]
    if not kernels:
        raise RuntimeError("the profiler recorded no device activity")
    busy_us = _union_us([(e.time_range.start, e.time_range.end) for e in kernels])
    by_cat, by_name = defaultdict(float), defaultdict(float)
    for e in kernels:
        us = e.time_range.end - e.time_range.start
        by_cat[_category(e.name)] += us
        by_name[e.name] += us
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:15]
    per = 1e3 * batches  # us over the window -> ms per batch
    return {
        "batches": batches, "wall_ms_per_batch": 1e3 * wall / batches,
        "device_busy_ms_per_batch": busy_us / per,
        "device_idle_share": 1.0 - busy_us / (1e6 * wall),
        "kernel_launches_per_batch": len(kernels) / batches,
        "ms_per_batch_by_category": {k: v / per for k, v in
                                     sorted(by_cat.items(), key=lambda kv: -kv[1])},
        "top_kernels_ms_per_batch": [[name[:90], us / per] for name, us in top],
    }


def profile_serving(engine: FOTSInference, batch, serve_hw, batches: int,
                    warmup: int = 2) -> dict:
    for _ in engine.stream(iter([batch] * warmup), serve_hw=serve_hw):
        pass

    def run():
        for _ in engine.stream(iter([batch] * batches), serve_hw=serve_hw):
            pass

    return {"path": "serve", "batch": len(batch), "hw": list(serve_hw),
            **_profiled(run, batches)}


def _timed(obj, name: str, log: dict):
    """Wrap ``obj.name`` so each call's host time lands in ``log[name]``."""
    fn = getattr(obj, name)

    def wrapper(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            log[name].append(1e3 * (time.perf_counter() - t0))

    setattr(obj, name, wrapper)


def profile_training(trainer, batch, batches: int, warmup: int = 2) -> dict:
    """The step's device breakdown, plus the host's, ms per call: ``step``
    (main thread: upload and the dispatch of forward, backward and Adam);
    on the prefetch thread ``_prepare_maps`` (image and map packing) and
    ``_prepare_rois`` (``_build_roi_batch``, which waits for the previous
    step's candidates and samples rois, and the roi buffer)."""
    trainer.train([batch] * warmup, max_steps=warmup, log_every=0)
    log = defaultdict(list)
    for name in ("step", "_prepare_maps", "_prepare_rois", "_build_roi_batch"):
        _timed(trainer, name, log)
    out = _profiled(lambda: trainer.train([batch] * batches, max_steps=batches,
                                          log_every=0), batches)
    host = {k: sum(v) / len(v) for k, v in log.items()}
    return {"path": "train", "batch": batch.images.shape[0],
            "hw": list(batch.images.shape[1:3]), "host_ms_per_call": host, **out}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--path", choices=("serve", "train"), default="serve")
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--batches", type=int, default=3)
    args = ap.parse_args(argv)
    assets = os.path.join(_REPO, "fots_torch", "assets")
    with np.load(os.path.join(assets, "smoke_images_u8.npz")) as z:
        images = z["images"]
    model, _, config = load_detector(os.path.join(_REPO, "artifacts", "serving_params.npz"),
                                     "cuda")
    if args.path == "serve":
        batch = [images[i % len(images)] for i in range(args.batch or 16)]
        with FOTSInference(model, masked_norm=config.get("masked_norm", False),
                           mixed_precision=True, device="cuda") as eng:
            out = profile_serving(eng, batch, (704, 1280), args.batches)
    else:
        from fots_torch.train import Trainer, asset_batch

        with np.load(os.path.join(assets, "train_targets.npz")) as z:
            targets = {k: z[k] for k in z.files}
        batch = asset_batch(images, targets, [i % len(images) for i in range(args.batch or 8)])
        out = profile_training(Trainer(model, learning_rate=1e-4, device="cuda"), batch,
                               args.batches)
    out["device"] = torch.cuda.get_device_name(0)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
