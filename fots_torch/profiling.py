"""Where the serving time goes on the card: a torch.profiler breakdown.

    python3 -m fots_torch.profiling [--batch 16] [--batches 3]

Serves the smoke images (batch 16, 704x1280, bf16, the shipped snapshot)
through ``FOTSInference.stream``: warm-up batches first, then a profiled
window of ``--batches`` batches.  Prints one JSON object: host wall time
per batch, device busy time per batch (the union of kernel intervals),
the device's idle share of the window, device time per kernel category
and the top kernels by device time.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
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
               ("pack_neighbors_kernel", "pack_neighbors (K4')"),
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


def profile_serving(engine: FOTSInference, batch, serve_hw, batches: int,
                    warmup: int = 2) -> dict:
    for _ in engine.stream(iter([batch] * warmup), serve_hw=serve_hw):
        pass
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in engine.stream(iter([batch] * batches), serve_hw=serve_hw):
            pass
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
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
        "batches": batches, "batch": len(batch), "serve_hw": list(serve_hw),
        "wall_ms_per_batch": 1e3 * wall / batches,
        "device_busy_ms_per_batch": busy_us / per,
        "device_idle_share": 1.0 - busy_us / (1e6 * wall),
        "kernel_launches_per_batch": len(kernels) / batches,
        "ms_per_batch_by_category": {k: v / per for k, v in
                                     sorted(by_cat.items(), key=lambda kv: -kv[1])},
        "top_kernels_ms_per_batch": [[name[:90], us / per] for name, us in top],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--batches", type=int, default=3)
    args = ap.parse_args(argv)
    with np.load(os.path.join(_REPO, "fots_torch", "assets", "smoke_images_u8.npz")) as z:
        images = list(z["images"])
    model, _, config = load_detector(os.path.join(_REPO, "artifacts", "serving_params.npz"),
                                     "cuda")
    batch = [images[i % len(images)] for i in range(args.batch)]
    with FOTSInference(model, masked_norm=config.get("masked_norm", False),
                       mixed_precision=True, device="cuda") as eng:
        out = profile_serving(eng, batch, (704, 1280), args.batches)
    out["device"] = torch.cuda.get_device_name(0)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
