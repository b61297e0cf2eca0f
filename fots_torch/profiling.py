"""Where the serving or training time goes on the card: a torch.profiler
breakdown; and the timing of the fused residual-block kernel K5'.

    python3 -m fots_torch.profiling [--path serve|train] [--batch N] [--batches N]
    python3 -m fots_torch.profiling --path fused_block [--iters K] [--shape N,H,W,C]
    python3 -m fots_torch.profiling --path instance_norm

``serve`` (default batch 16): the smoke images at 704x1280, bf16, the
shipped snapshot, through ``FOTSInference.stream``.  ``train`` (default
batch 8): the training asset at 640x960, f32, the snapshot as warm start,
``Trainer.train`` (lr 1e-4; PyTorch's default math settings).  Warm-up
batches first, then a profiled window of ``--batches`` batches (steps).
Prints one JSON object: host wall time per batch, device busy time per
batch (the union of kernel intervals), the device's idle share of the
window, device time per kernel category and the top kernels by device
time.  ``instance_norm``: K1' and K1'-bwd on their two routes (and the
cluster route's other possible cuts) at every shape the serving, training
and evaluation paths give them, one JSON line per shape.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import time
from collections import defaultdict

import numpy as np
import torch
import torch.nn.functional as F

from fots_torch.checkpoint import load_detector
from fots_torch.pipeline import FOTSInference

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# kernel-name fragments -> category, first match wins
_CATEGORIES = (("in_bwd_", "instance_norm_bwd (K1'-bwd)"),
               ("in_cluster_kernel", "instance_norm (K1')"),
               ("in_stats_kernel", "instance_norm (K1')"),
               ("in_apply_kernel", "instance_norm (K1')"),
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


def cuda_median_ms(fn, reps=15, warmup=3):
    """Median device time of ``fn`` over ``reps`` calls, CUDA events around
    each call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in pairs]))


def cuda_busy_ms(fn, reps=10, warmup=2):
    """Device-busy time of one call of ``fn``: the union of the kernel, copy
    and memset intervals torch.profiler records over ``reps`` calls, over
    ``reps``.  Unlike :func:`cuda_median_ms` it leaves out the time the card
    waits for a slow host between the launches of one call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    spans = [(e.time_range.start, e.time_range.end) for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA and not _is_annotation(e)]
    if not spans:
        raise RuntimeError("the profiler recorded no device activity")
    return _union_us(spans) / (1e3 * reps)


#: (divisor of the image's height and width, channels) of the detector's
#: four residual stages, whose norms are K1'
IN_STAGES = ((4, 64), (8, 128), (16, 256), (32, 512))


def instance_norm_path_shapes():
    """(path, (b, h, w, c), dtype, masked, backward too) of every K1' call
    site: serving (batch 16 at 704x1280, bf16), training (batch 8 at
    640x960, f32, with K1'-bwd), per-image evaluation (one 640x960 image, f32
    and bf16) and the recognition head's masked strips."""
    from fots_torch.pipeline import FOTSInference

    out = []
    for path, b, (h, w), dtype, bwd in (("serving", 16, (704, 1280), torch.bfloat16, False),
                                        ("training", 8, (640, 960), torch.float32, True),
                                        ("evaluation", 1, (640, 960), torch.float32, False),
                                        ("evaluation", 1, (640, 960), torch.bfloat16, False)):
        out += [(path, (b, h // d, w // d, c), dtype, False, bwd) for d, c in IN_STAGES]
    strips = ((11, 128), (5, 256), (1, 256))
    for width in (32, 512):
        chunk = FOTSInference._roi_chunk(width)
        for dtype in (torch.bfloat16, torch.float32):
            out += [("serving strips", (chunk, h, width, c), dtype, True, False)
                    for h, c in strips]
    out += [("training strips", (32, h, 256, c), torch.float32, True, True) for h, c in strips]
    return out


#: equal bytes (115 MB of bf16 each way), four layouts of what one cluster
#: reads of a pixel, as (label, shape, ((channels, cluster), ...)): why the
#: plan takes 64-byte channel groups and small blocks
IN_LAYOUT_STUDY = (
    ("contiguous plane, no cluster", (1024, 44, 80, 16), ((16, 1), (16, 2))),
    ("contiguous plane, clusters", (64, 176, 320, 16), ((16, 16), (16, 8))),
    ("32 of a pixel's 128 bytes", (256, 44, 80, 64), ((16, 1), (16, 2))),
    ("32 of 128 bytes, clusters", (16, 176, 320, 64), ((16, 16), (16, 8))),
    ("64 of 128 bytes", (256, 44, 80, 64), ((32, 2), (32, 4))),
    ("64 of 128 bytes, clusters", (16, 176, 320, 64), ((32, 16),)),
    ("128 of 128 bytes", (256, 44, 80, 64), ((64, 4), (64, 8))),
)


def profile_instance_norm(device="cuda", reps=15):
    """Time K1' (and K1'-bwd where the path runs it) at every path shape:
    the two-pass route, the cluster route as :func:`in_plan` cuts it, and
    the cluster route's other cuts that fit (every cluster size; one, two
    and four 32-byte channel groups per cluster); before them the layout
    study (``IN_LAYOUT_STUDY``).  ``ms`` are event-bracketed single calls
    (they include the host's launch work); ``device_busy_ms`` is the card's
    busy time per call on the plan's route and on two passes.  Yields one
    dict per (shape, kernel)."""
    from fots_torch.ops import instance_norm as tin

    dev = torch.device(device)
    if dev.type != "cuda":
        raise RuntimeError("the instance_norm profile times CUDA kernels: it needs a card")
    gen = torch.Generator(device=dev).manual_seed(0)

    def plan_tag(plan):
        return (f"cluster {plan.held} {plan.cluster}x{plan.block_bytes}B "
                f"ch{plan.channels} t{plan.threads}")

    def variants(h, w, c, itemsize, held):
        seen = {}
        group = tin.GROUP_BYTES // itemsize
        for cluster in tin.CLUSTER_SIZES:
            for channels in (group, 2 * group, 4 * group):
                try:
                    plan = tin.in_plan(h, w, c, itemsize, 1, held, True, cluster, channels)
                except ValueError:
                    continue
                seen.setdefault(plan, plan_tag(plan))
        return seen

    for label, shape, cuts in IN_LAYOUT_STUDY:
        b, h, w, c = shape
        x = (torch.randn(shape, generator=gen, device=dev) * 3 + 1.5).to(torch.bfloat16)
        scale = torch.randn(c, generator=gen, device=dev)
        bias = torch.randn(c, generator=gen, device=dev)
        times = {"two_pass": cuda_median_ms(lambda: tin.instance_norm_cuda(
            x, scale, bias, 1e-5, 0.01, plan=tin.TWO_PASS), reps)}
        for channels, cluster in cuts:
            plan = tin.in_plan(h, w, c, 2, cluster=cluster, channels=channels)
            times[plan_tag(plan)] = cuda_median_ms(lambda: tin.instance_norm_cuda(
                x, scale, bias, 1e-5, 0.01, plan=plan), reps)
        yield {"kernel": "instance_norm", "path": f"layout study: {label}",
               "shape": list(shape), "dtype": "bfloat16", "masked": False,
               "bytes": 4 * x.numel(), "ms": times}
        del x

    for path, shape, dtype, masked, bwd in instance_norm_path_shapes():
        b, h, w, c = shape
        x = (torch.randn(shape, generator=gen, device=dev) * 3 + 1.5).to(dtype)
        scale = torch.randn(c, generator=gen, device=dev)
        bias = torch.randn(c, generator=gen, device=dev)
        vw = (torch.randint(1, w + 1, (b,), generator=gen, device=dev, dtype=torch.int32)
              if masked else None)
        default = tin.in_plan(h, w, c, x.element_size())
        times = {"two_pass": cuda_median_ms(lambda: tin.instance_norm_cuda(
            x, scale, bias, 1e-5, 0.01, vw, bwd, tin.TWO_PASS), reps)}
        for plan, tag in variants(h, w, c, x.element_size(), "x").items():
            times[tag] = cuda_median_ms(lambda: tin.instance_norm_cuda(
                x, scale, bias, 1e-5, 0.01, vw, bwd, plan), reps)
        busy = {pl.route: cuda_busy_ms(lambda: tin.instance_norm_cuda(
            x, scale, bias, 1e-5, 0.01, vw, bwd, pl)) for pl in {default, tin.TWO_PASS}}
        nbytes = 2 * x.numel() * x.element_size()
        yield {"kernel": "instance_norm", "path": path, "shape": list(shape),
               "dtype": str(dtype)[6:], "masked": masked, "bytes": nbytes,
               "plan": default._asdict(), "ms": times, "device_busy_ms": busy}
        if not bwd:
            continue
        g = torch.randn(shape, generator=gen, device=dev)
        stats = tin.instance_norm_stats_ref(x, 1e-5, vw)
        default = tin.in_bwd_plan(h, w, c)
        times = {"two_pass": cuda_median_ms(lambda: tin.instance_norm_bwd_cuda(
            x, g, stats, scale, bias, 0.01, vw, plan=tin.TWO_PASS), reps)}
        for plan, tag in variants(h, w, c, 4, "xg").items():
            times[tag] = cuda_median_ms(lambda: tin.instance_norm_bwd_cuda(
                x, g, stats, scale, bias, 0.01, vw, plan=plan), reps)
        busy = {pl.route: cuda_busy_ms(lambda: tin.instance_norm_bwd_cuda(
            x, g, stats, scale, bias, 0.01, vw, plan=pl)) for pl in {default, tin.TWO_PASS}}
        yield {"kernel": "instance_norm_bwd", "path": path, "shape": list(shape),
               "dtype": "float32", "masked": masked, "bytes": 3 * x.numel() * 4,
               "plan": default._asdict(), "ms": times, "device_busy_ms": busy}


FUSED_BLOCK_SHAPE = (16, 88, 160, 128)
#: activation-sized tensors each variant moves through device memory per
#: iteration: conv (x, y), statistics (y), apply (y, r, out) for the two
#: compositions; K5' reads x, writes and reads y, reads r, writes out
_FUSED_BLOCK_TENSORS = {"composition": 6, "library": 6, "cuda_fused": 5}


def card_name_and_power_limit() -> str:
    """``name, power.limit`` of the card as nvidia-smi prints them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip()


def fused_block_inputs(shape, device, dtype=torch.bfloat16):
    """The seeded inputs of ``tools/profile_fused_block.py``: numpy
    ``default_rng(0)``, drawn in the same order with the same scales."""
    c = shape[-1]
    rng = np.random.default_rng(0)

    def t(a, dt):
        return torch.from_numpy(np.asarray(a, np.float32)).to(device=device, dtype=dt)

    x = t(rng.standard_normal(shape), dtype)
    wk = t(rng.standard_normal((3, 3, c, c)) * 0.05, torch.float32)
    g = t(rng.standard_normal(c) * 0.3 + 1.0, torch.float32)
    b = t(rng.standard_normal(c) * 0.1, torch.float32)
    r = t(rng.standard_normal(shape), dtype)
    return x, wk, g, b, r


def profile_fused_block(shape=FUSED_BLOCK_SHAPE, iters: int = 10, device="cuda") -> dict:
    """Time K5' against the two compositions (see the module docstring)."""
    from fots_torch.ops.fused_block import conv_in_act_reference, fused_conv3x3_in_act
    from fots_torch.ops.instance_norm import instance_norm

    dev = torch.device(device)
    if dev.type != "cuda":
        raise RuntimeError("the fused_block profile times CUDA kernels: it needs a card")
    x, wk, g, b, r = fused_block_inputs(shape, dev)
    w_oihw = wk.to(x.dtype).permute(3, 2, 0, 1).contiguous()
    r_nchw = r.permute(0, 3, 1, 2)
    g_t, b_t = g.to(x.dtype), b.to(x.dtype)

    def composition(xc):  # BasicBlockIn's tail: conv2 -> in2 -> relu(y + residual)
        y = F.conv2d(xc.permute(0, 3, 1, 2), w_oihw, padding=1).permute(0, 2, 3, 1)
        return F.relu(instance_norm(y, g, b) + r)

    def library(xc):
        y = F.instance_norm(F.conv2d(xc.permute(0, 3, 1, 2), w_oihw, padding=1),
                            weight=g_t, bias=b_t, eps=1e-5)
        return F.relu(y + r_nchw).permute(0, 2, 3, 1)

    def cuda_fused(xc):
        return fused_conv3x3_in_act(xc, wk, g, b, r)

    with torch.inference_mode():
        want = conv_in_act_reference(x, wk, g, b, r).float()
        out = {"shape": list(shape), "dtype": "bf16", "iters_per_program": iters,
               "max_abs_err": float((cuda_fused(x).float() - want).abs().max()),
               "max_abs_err_composition": float((composition(x).float() - want).abs().max())}
        a_bytes = x.numel() * x.element_size()
        for name, fn in (("composition", composition), ("library", library),
                         ("cuda_fused", cuda_fused)):
            def chain():
                xc = x
                for _ in range(iters):
                    xc = fn(xc)
                return xc

            chain()  # warm-up (cuDNN picks its algorithm, the kernel builds)
            torch.cuda.synchronize()
            times = []
            for _ in range(5):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                chain()
                end.record()
                torch.cuda.synchronize()
                times.append(start.elapsed_time(end))
            ms = min(times) / iters
            n_tensors = _FUSED_BLOCK_TENSORS[name]
            out[name] = {"ms_per_iter": ms,
                         "model_bytes_per_iter_mb": n_tensors * a_bytes / 1e6,
                         "achieved_gbps_on_model_bytes": n_tensors * a_bytes / (ms / 1e3) / 1e9}
        # where K5's own time goes: device ms per call of each kernel it launches
        calls = 5
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                cuda_fused(x)
            torch.cuda.synchronize()
        by_name = defaultdict(float)
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA and not _is_annotation(e):
                by_name[e.name[:80]] += (e.time_range.end - e.time_range.start) / (1e3 * calls)
        out["cuda_fused"]["kernels_ms_per_call"] = dict(
            sorted(by_name.items(), key=lambda kv: -kv[1]))
    out["fused_speedup"] = out["composition"]["ms_per_iter"] / out["cuda_fused"]["ms_per_iter"]
    out["device"] = torch.cuda.get_device_name(dev)
    out["card_and_power_limit"] = card_name_and_power_limit()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--path", choices=("serve", "train", "fused_block", "instance_norm"),
                    default="serve")
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--batches", type=int, default=3)
    ap.add_argument("--iters", type=int, default=10,
                    help="fused_block: chained iterations per timed program")
    ap.add_argument("--shape", default=",".join(map(str, FUSED_BLOCK_SHAPE)),
                    help="fused_block: N,H,W,C")
    args = ap.parse_args(argv)
    if args.path == "fused_block":
        shape = tuple(int(v) for v in args.shape.split(","))
        print(json.dumps(profile_fused_block(shape, args.iters), indent=2))
        return 0
    if args.path == "instance_norm":
        for row in profile_instance_norm():
            print(json.dumps(row), flush=True)
        print(card_name_and_power_limit())
        return 0
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
