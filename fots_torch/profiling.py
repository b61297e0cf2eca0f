"""Where the serving or training time goes on the card: a torch.profiler
breakdown; and the timing of the fused residual-block kernel K5'.  Also the
tracing helpers of ``fots/profiling.py`` for any caller: :func:`trace` (a
torch.profiler trace that TensorBoard or Perfetto reads), :class:`StepTimer`
(wall-clock steps and their percentiles) and :class:`MetricsLogger` (an
append-only JSONL log).

    python3 -m fots_torch.profiling [--path serve|train|export] [--scratch] [--batch N]
    python3 -m fots_torch.profiling --path train --mesh   # the same step on a world-1 mesh
                                    [--batches N]
    python3 -m fots_torch.profiling --path fused_block [--iters K] [--shape N,H,W,C]
    python3 -m fots_torch.profiling --path instance_norm
    python3 -m fots_torch.profiling --path pack
    python3 -m fots_torch.profiling --path decode
    python3 -m fots_torch.profiling --path batch_rows [--batch N]

``serve`` (default batch 16): the smoke images at 704x1280, bf16, the
shipped snapshot, through ``FOTSInference.stream``.  ``train`` (default
batch 8): the training asset at 640x960, f32, the snapshot as warm start,
``Trainer.train`` (lr 1e-4; PyTorch's default math settings); with
``--scratch``, ``train_joint``'s step instead: a model from scratch (seed
0, lr 1e-3) on one augmented 512x512 batch of the smoke scenes from the
port's own data pipeline, repeated.  Warm-up
batches first, then a profiled window of ``--batches`` batches (steps).
Prints one JSON object: host wall time per batch, device busy time per
batch (the union of kernel intervals), the device's idle share of the
window, device time per kernel category and the top kernels by device
time.  ``train`` adds the spans of :mod:`fots_torch.tracing`: host ms a
step by span, self time, on the dispatching and the preparing thread, from
``--batches`` steps run before the window with the recorder on and no
profiler (the profiler slows the dispatching thread several times over);
and the share of the profiled window the card sat idle while the
dispatching thread waited for the prepared batch (``train.wait_prepared``)
and while it was inside a ``step.*`` span, readings of the profiled loop.
This is the way to see what the host does while the card idles.
``export`` (default batch 16): the shipped snapshot exported at
704x1280, bf16, into a temporary bundle; its ``ExportedEngine`` beside the
in-process engine (host letterbox), as images/s in turns on the smoke
scenes and on the same batch already letterboxed (each engine's letterbox
is then a copy, so what is left is its dispatch), the host letterbox
alone, and one profiled window of each engine on the letterboxed batch.
``instance_norm``: K1' and K1'-bwd on their two routes (and the
cluster route's other possible cuts) at every shape the serving, training
and evaluation paths give them, one JSON line per shape.  ``pack``: K4' and
K4'-bwd at the 3-channel images (narrow rows) and the 64-channel maps
(16-byte rows), device-busy and event-bracketed ms beside the bound and
``index_add_``, one JSON line per shape.  ``decode``: the host reader
``imageio.imread`` (``csrc/image_decode.cpp``) on the 640x960 scene
``img_112`` sequential, progressive, block-smoothed, CMYK and
arithmetic-coded and on the first smoke scene, colour
and grey, median, min and max ms of 15 in turns, one JSON line per file (a
file the decoder refuses would be reported with its reason).  ``batch_rows``:
where bf16 serving's results depend on the batch's row count (see
:func:`profile_batch_rows`).  To compare two
versions of the decoder, run it from two copies of the repository that
differ in ``imageio.py`` and ``csrc/image_decode.cpp``, in turns in one
call.  Every other path needs a CUDA card.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from fots_torch import tracing
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


@contextlib.contextmanager
def trace(log_dir: str = os.path.join(tempfile.gettempdir(), "fots_torch_trace")):
    """Profile the block (host, and the card when CUDA is there) with
    torch.profiler and write its trace under ``log_dir`` as TensorBoard's
    profiler plugin reads it (a ``*.pt.trace.json`` Chrome trace, which
    Perfetto opens too).  Yields ``log_dir``."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts,
                                on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)):
        yield log_dir


@dataclass
class StepTimer:
    """Wall-clock time of each ``with`` block (host clock: synchronise inside
    the block to time device work) and their percentiles."""

    times: List[float] = field(default_factory=list)
    _t0: Optional[float] = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.times.append(time.perf_counter() - self._t0)

    def summary(self) -> Dict[str, float]:
        """mean, p50, p90 and p99 seconds and steps a second ({} before a step)."""
        if not self.times:
            return {}
        a = np.asarray(self.times)
        return {"mean_s": float(a.mean()), "p50_s": float(np.percentile(a, 50)),
                "p90_s": float(np.percentile(a, 90)), "p99_s": float(np.percentile(a, 99)),
                "steps_per_s": float(1.0 / a.mean())}


class MetricsLogger:
    """Append-only JSONL metrics: one ``{"step", "time", <metric>: float}``
    record a line, flushed as it is written; close it when done."""

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "a")

    def log(self, step: int, **metrics) -> None:
        rec = {"step": step, "time": time.time()}
        rec.update({k: float(v) for k, v in metrics.items()})
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def close(self) -> None:
        self._f.close()


def _category(name: str) -> str:
    low = name.lower()
    for frag, cat in _CATEGORIES:
        if frag.lower() in low:
            return cat
    return "other"


def _merged(intervals, lo: float = -math.inf, hi: float = math.inf) -> list:
    """``intervals`` clipped to [lo, hi], sorted and merged."""
    out = []
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _union_us(intervals):
    return float(sum(e - s for s, e in _merged(intervals)))


def _is_annotation(event) -> bool:
    """A record_function range mirrored onto the device timeline (such as
    ``Optimizer.step#Adam.step``): it spans the kernels launched inside it
    and the gaps between them, so it is no device work of its own.  The
    profiler flags it; the name test covers builds that do not.  (Kernel
    names hold ``#`` too, in lambdas such as ``{lambda(float)#1}``, but
    never without spaces or brackets.)"""
    return (bool(getattr(event, "is_user_annotation", False))
            or re.fullmatch(r"[\w.]+#[\w.]+", event.name) is not None)


def _profiled(run):
    """``run()`` under torch.profiler: (the profiler, the unix ns at the
    start and at the end of ``run()`` and its last kernel)."""
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        lo = time.time_ns()
        run()
        torch.cuda.synchronize()
        hi = time.time_ns()
    return prof, lo, hi


def profile_window(run, batches: int, kernel_names: Optional[list] = None):
    """Profile ``run()`` (which works through ``batches`` batches) and
    summarise its device activity per batch; ``kernel_names`` gets the name
    of every device kernel the window ran."""
    prof, lo, hi = _profiled(run)
    wall = (hi - lo) / 1e9
    events = prof.events()
    if kernel_names is not None:
        kernel_names += [e.name for e in events
                         if e.device_type == torch.autograd.DeviceType.CUDA
                         and not _is_annotation(e)]
    return _summary(events, wall, batches)


#: the host's CUDA runtime calls that put work on the card: a kernel each
#: (``cudaLaunchKernel``; ``cudaLaunchKernelExC`` for the cluster route's
#: launches), a whole captured graph (``cudaGraphLaunch``)
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaGraphLaunch")


def _summary(events, wall: float, batches: int) -> dict:
    """Device activity per batch from profiler events over ``wall``
    seconds: kernels, copies and memsets, not the user annotations on the
    device timeline; and the host's launch calls per batch."""
    calls = defaultdict(int)
    for e in events:
        if (e.device_type == torch.autograd.DeviceType.CPU
                and e.name.startswith(LAUNCH_CALLS)):
            calls[e.name] += 1
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
    host = defaultdict(float)  # host ops by self time (a FunctionEvent's)
    for e in events:
        if e.device_type == torch.autograd.DeviceType.CPU:
            host[e.name] += getattr(e, "self_cpu_time_total", 0.0)
    top_host = sorted(host.items(), key=lambda kv: -kv[1])[:15]
    per = 1e3 * batches  # us over the window -> ms per batch
    return {
        "batches": batches, "wall_ms_per_batch": 1e3 * wall / batches,
        "device_busy_ms_per_batch": busy_us / per,
        "device_idle_share": 1.0 - busy_us / (1e6 * wall),
        "kernel_launches_per_batch": len(kernels) / batches,
        "host_launch_calls_per_batch": {name: n / batches for name, n in sorted(calls.items())},
        "ms_per_batch_by_category": {k: v / per for k, v in
                                     sorted(by_cat.items(), key=lambda kv: -kv[1])},
        "top_kernels_ms_per_batch": [[name[:90], us / per] for name, us in top],
        "top_host_ops_self_ms_per_batch": [[name[:90], us / per] for name, us in top_host],
    }


def profile_serving(engine: FOTSInference, batch, serve_hw, batches: int,
                    warmup: int = 2) -> dict:
    for _ in engine.stream(iter([batch] * warmup), serve_hw=serve_hw):
        pass

    def run():
        for _ in engine.stream(iter([batch] * batches), serve_hw=serve_hw):
            pass

    return {"path": "serve", "batch": len(batch), "hw": list(serve_hw),
            **profile_window(run, batches)}


def images_per_s(call, batch, batches: int) -> float:
    """images/s of ``call(batch)`` on the host clock over ``batches`` calls
    after one more (the card synchronised before and after)."""
    call(batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(batches):
        call(batch)
    torch.cuda.synchronize()
    return batches * len(batch) / (time.perf_counter() - t0)


def profile_export(model, config, batch, serve_hw, batches: int) -> dict:
    """The exported bundle's engine beside the in-process one (see the
    module docstring); each pair of timings in the order in-process,
    exported, exported, in-process."""
    from fots_torch.export import ExportedEngine, export_serving
    from fots_torch.serving import host_letterbox

    out = {"path": "export", "batch": len(batch), "hw": list(serve_hw)}
    with tempfile.TemporaryDirectory(prefix="fots_bundle_") as tmp, \
            FOTSInference(model, masked_norm=config.get("masked_norm", False),
                          mixed_precision=True, device="cuda",
                          device_letterbox=False) as eng:
        export_serving(eng, tmp, len(batch), *serve_hw, platforms=("cuda",))
        with ExportedEngine(tmp) as ex:
            t0 = time.perf_counter()
            for _ in range(batches):
                boxed = list(host_letterbox(batch, serve_hw)[0])
            out["host_letterbox_ms_per_batch"] = 1e3 * (time.perf_counter() - t0) / batches
            engines = {"in_process": lambda b: eng.batch_call(b, serve_hw=serve_hw),
                       "exported": ex.batch_call}
            for label, images in (("images_per_s", batch),
                                  ("letterboxed_input_images_per_s", boxed)):
                out[label] = {key: [] for key in engines}
                for key in ("in_process", "exported", "exported", "in_process"):
                    out[label][key].append(images_per_s(engines[key], images, batches))
            for key, call in engines.items():
                out[key] = profile_window(lambda: [call(boxed) for _ in range(batches)],
                                          batches)
    return out


def _idle_ns_under(busy, under, lo: int, hi: int) -> int:
    """Nanoseconds of [lo, hi] inside an interval of ``under`` and outside
    every interval of ``busy`` (both lists of (start, end))."""
    busy, under = _merged(busy, lo, hi), _merged(under, lo, hi)
    total, i = 0, 0
    for s, e in under:
        total += e - s
        while i < len(busy) and busy[i][1] <= s:
            i += 1
        j = i
        while j < len(busy) and busy[j][0] < e:
            total -= min(e, busy[j][1]) - max(s, busy[j][0])
            j += 1
    return total


def profile_training(trainer, batch, batches: int, warmup: int = 2) -> dict:
    """The step's device breakdown over a profiled window of ``batches``
    steps, and the host's from the spans of :mod:`fots_torch.tracing`.
    ``host_ms_per_step``: each span's self time, ms a step, by thread
    (``dispatch``: the thread that runs :meth:`Trainer.step`; ``prepare``:
    the prefetch thread), over ``batches`` steps run before the window
    with the recorder on and no profiler.  ``device_idle_share_prep_wait``
    and ``device_idle_share_dispatch``: the shares of the profiled window
    the card sat idle while the dispatching thread was in
    ``train.wait_prepared`` and in a ``step.*`` span; the profiler slows
    the dispatching thread, so they describe the profiled loop."""
    trainer.train([batch] * warmup, max_steps=warmup, log_every=0)
    dispatcher = threading.get_ident()

    def steps():
        first = trainer.global_step
        tracing.reset()
        trainer.train([batch] * batches, max_steps=first + batches, log_every=0)
        return [s for s in tracing.spans() if s.step is not None and s.step >= first]

    with tracing.enable():
        spans = steps()
    dropped = tracing.dropped()
    host = {"dispatch": defaultdict(float), "prepare": defaultdict(float)}
    own = tracing.self_ns(spans)
    for s in spans:
        host["dispatch" if s.thread == dispatcher else "prepare"][s.name] += own[s.id] / 1e6
    profiled = []
    prof, lo, hi = _profiled(lambda: profiled.extend(steps()))
    dropped += tracing.dropped()
    events = prof.events()
    out = _summary(events, (hi - lo) / 1e9, batches)
    origin = prof.profiler.kineto_results.trace_start_ns()
    busy = [(origin + int(1e3 * e.time_range.start), origin + int(1e3 * e.time_range.end))
            for e in events
            if e.device_type == torch.autograd.DeviceType.CUDA and not _is_annotation(e)]
    main = [s for s in profiled if s.thread == dispatcher]
    for key, pick in (("device_idle_share_prep_wait", lambda n: n == "train.wait_prepared"),
                      ("device_idle_share_dispatch", lambda n: n.startswith("step."))):
        out[key] = _idle_ns_under(busy, [(s.start_ns, s.end_ns) for s in main if pick(s.name)],
                                  lo, hi) / (hi - lo)
    return {"path": "train", "batch": batch.images.shape[0],
            "hw": list(batch.images.shape[1:3]),
            "host_ms_per_step": {k: {n: ms / batches for n, ms in
                                     sorted(v.items(), key=lambda kv: -kv[1])}
                                 for k, v in host.items()},
            "spans_dropped": dropped, **out}


def augmented_smoke_batch(batch_size: int, size: int = 512):
    """One augmented ``size`` x ``size`` batch of the smoke scenes from the
    port's data pipeline (:mod:`fots_torch.data.detection`, seed 0)."""
    import tempfile

    from fots_torch.data.detection import detection_generator

    smoke = os.path.join(_REPO, "fots_torch", "assets", "smoke_images_u8.npz")
    with np.load(smoke) as z:
        names = [str(n) for n in z["names"]]
    with tempfile.TemporaryDirectory() as tmp:
        list_path = os.path.join(tmp, "smoke.txt")
        with open(list_path, "w") as f:
            f.writelines(os.path.join(_REPO, "data", "synth", n) + "\n" for n in names)
        return next(detection_generator(list_path, smoke, input_size=size,
                                        batch_size=batch_size))


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
    waits for a slow host between the launches of one call.  A window in
    which the profiler recorded no device activity at all (seen now and then
    on the card's machine, with the kernels' results right) is profiled
    again, up to three windows, each retry reported on stderr."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for attempt in range(3):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        spans = [(e.time_range.start, e.time_range.end) for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA and not _is_annotation(e)]
        if spans:
            return _union_us(spans) / (1e3 * reps)
        print(f"cuda_busy_ms: window {attempt + 1} recorded no device activity",
              file=sys.stderr)
    raise RuntimeError("the profiler recorded no device activity in 3 windows")


#: (divisor of the image's height and width, channels) of the detector's
#: four residual stages, whose norms are K1'
IN_STAGES = ((4, 64), (8, 128), (16, 256), (32, 512))


def instance_norm_path_shapes():
    """(path, (b, h, w, c), dtype, masked, backward too) of every K1' call
    site: serving (batch 16 at 704x1280, bf16), training (batch 8 at
    640x960, f32, with K1'-bwd), training from scratch (batch 8 of
    augmented 512x512 crops, f32, with K1'-bwd), per-image evaluation (one
    640x960 image, f32 and bf16) and the recognition head's masked strips:
    the in-process engine's chunks, the exported bundle's ``ROI_PAD`` rois at
    every fine strip bucket (the shipped snapshot's masked norm) and the
    training path's."""
    from fots_torch.export import ROI_PAD
    from fots_torch.pipeline import FINE_STRIP_BUCKETS, FOTSInference

    out = []
    for path, b, (h, w), dtype, bwd in (("serving", 16, (704, 1280), torch.bfloat16, False),
                                        ("training", 8, (640, 960), torch.float32, True),
                                        ("train_joint", 8, (512, 512), torch.float32, True),
                                        ("evaluation", 1, (640, 960), torch.float32, False),
                                        ("evaluation", 1, (640, 960), torch.bfloat16, False)):
        out += [(path, (b, h // d, w // d, c), dtype, False, bwd) for d, c in IN_STAGES]
    strips = ((11, 128), (5, 256), (1, 256))
    for width in (32, 512):
        chunk = FOTSInference._roi_chunk(width)
        for dtype in (torch.bfloat16, torch.float32):
            out += [("serving strips", (chunk, h, width, c), dtype, True, False)
                    for h, c in strips]
    out += [("export strips", (ROI_PAD, h, width, c), torch.bfloat16, True, False)
            for width in FINE_STRIP_BUCKETS for h, c in strips]
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


#: (kernel, shape, dtype) K4' and K4'-bwd are timed at by ``--path pack``:
#: the 3-channel images of CRNNE2ETrainer and cli.rroi_demo (narrow rows),
#: then the focr maps of serving and training (16-byte rows)
PACK_SHAPES = (("pack_neighbors", (2, 512, 512, 3), torch.float32),
               ("pack_neighbors", (2, 512, 512, 3), torch.bfloat16),
               ("pack_neighbors", (1, 640, 960, 3), torch.float32),
               ("pack_neighbors_bwd", (2, 512, 512, 3), torch.float32),
               ("pack_neighbors_bwd", (1, 640, 960, 3), torch.float32),
               ("pack_neighbors", (16, 176, 320, 64), torch.bfloat16),
               ("pack_neighbors", (8, 160, 240, 64), torch.float32),
               ("pack_neighbors_bwd", (8, 160, 240, 64), torch.float32))


def profile_pack(device="cuda", bytes_per_s=3.35e12):
    """K4' and K4'-bwd at ``PACK_SHAPES``: device-busy ms a call
    (:func:`cuda_busy_ms`), event-bracketed ms (:func:`cuda_median_ms`), the
    bound (the map read once and its quads written once, or the reverse: 5x
    the map's bytes, at ``bytes_per_s``), the plain version's device-busy ms
    and, for the backward, ``index_add_`` of the quad rows.  Yields one dict
    per row; ``library`` names the built source, so runs of two versions of
    ``csrc/pack_neighbors.cu`` tell apart."""
    from fots_torch.kernels import build
    from fots_torch.ops import rroi_align as trr

    dev = torch.device(device)
    if dev.type != "cuda":
        raise RuntimeError("the pack profile times CUDA kernels: it needs a card")
    gen = torch.Generator(device=dev).manual_seed(0)
    library = os.path.basename(build.library_path("pack_neighbors"))
    for kernel, shape, dtype in PACK_SHAPES:
        b, h, w, c = shape
        n = b * h * w
        x = torch.randn(shape, generator=gen, device=dev).to(dtype)
        nbytes = 5 * x.numel() * x.element_size()
        row = {"kernel": kernel, "shape": list(shape), "dtype": str(dtype)[6:],
               "library": library, "bound_ms": 1e3 * nbytes / bytes_per_s}
        if kernel == "pack_neighbors":
            fns = {"kernel": lambda: trr.pack_neighbors_cuda(x),
                   "plain": lambda: trr.pack_neighbors_ref(x)}
        else:
            g = torch.randn((n, 4 * c), generator=gen, device=dev)
            index = (torch.arange(n, device=dev)[:, None]
                     + torch.tensor([0, 1, w, w + 1], device=dev)[None, :]).reshape(-1)
            acc = torch.zeros((n + w + 1, c), device=dev)
            fns = {"kernel": lambda: trr.pack_neighbors_bwd_cuda(g, shape),
                   "plain": lambda: trr.pack_neighbors_bwd_ref(g, shape),
                   "index_add_": lambda: acc.index_add_(0, index, g.view(4 * n, c))}
        for name, fn in fns.items():
            row[f"{name}_device_busy_ms"] = cuda_busy_ms(fn)
            if name != "plain":
                row[f"{name}_ms"] = cuda_median_ms(fn)
        row["share_of_bound"] = row["bound_ms"] / row["kernel_device_busy_ms"]
        yield row


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


#: ``--path decode``'s files, relative to the repository
DECODE_FILES = ("fots_torch/assets/heldout_eval_jpg/img_112.jpg",
                "fots_torch/assets/decode_ref/prog/img_112.jpg",
                "fots_torch/assets/decode_ref/scene_smoothed.jpg",
                "fots_torch/assets/decode_ref/scene_cmyk.jpg",
                "fots_torch/assets/decode_ref/scene_arith.jpg", "data/synth/img_000.jpg")


def profile_decode(reps: int = 15) -> list:
    """Host ms of ``imageio.imread`` on each of :data:`DECODE_FILES`, colour
    and grey, the files taken in turns; a file the decoder refuses is
    reported with its reason."""
    from fots_torch import imageio

    times = {(f, g): [] for f in DECODE_FILES for g in (False, True)}
    refused = {}
    for i in range(reps):
        order = list(times) if i % 2 == 0 else list(times)[::-1]
        for f, grey in order:
            t0 = time.perf_counter()
            try:
                imageio.imread(os.path.join(_REPO, f), grayscale=grey)
            except ValueError as e:
                refused[(f, grey)] = str(e)
            times[(f, grey)].append(1e3 * (time.perf_counter() - t0))
    rows = []
    for (f, grey), ts in times.items():
        row = {"file": f, "grey": grey}
        if (f, grey) in refused:
            row["refused"] = refused[(f, grey)]
        else:
            row.update(ms=statistics.median(ts), ms_min=min(ts), ms_max=max(ts), reps=reps)
        rows.append(row)
    return rows


def _row_prints(model, x, rows: int):
    """One forward of ``model`` over ``x``: [(module name, bit checksums of
    its output's first ``rows`` rows)] in call order, for every module whose
    output is a tensor with the batch's rows first."""
    calls, hooks = [], []

    def hook(name):
        def fn(_mod, _inp, out):
            if torch.is_tensor(out) and out.dim() and out.shape[0] == x.shape[0]:
                v = out[:rows].contiguous()
                bits = v.view({torch.bfloat16: torch.int16, torch.float16: torch.int16,
                               torch.float32: torch.int32}.get(v.dtype, v.dtype))
                bits = bits.reshape(-1).to(torch.int64)
                w = torch.arange(bits.numel(), device=bits.device) % 1009 + 1
                calls.append((name, (int(bits.sum()), int((bits * w).sum()))))
        return fn
    for name, mod in model.named_modules():
        hooks.append(mod.register_forward_hook(hook(name or "model")))
    try:
        with torch.inference_mode():
            model(x)
        torch.cuda.synchronize()
    finally:
        for h in hooks:
            h.remove()
    return calls


def _module_output(model, x, name: str, rows: int):
    """The first call's output of module ``name`` (its first ``rows``
    rows, f32) in one forward over ``x``."""
    got = []
    mod = dict(model.named_modules())[name] if name != "model" else model
    h = mod.register_forward_hook(lambda _m, _i, out: got.append(out[:rows].float().clone())
                                  if not got else None)
    try:
        with torch.inference_mode():
            model(x)
    finally:
        h.remove()
    return got[0]


def profile_batch_rows(batch: int = 16, serve_hw=(704, 1280), reps: int = 5,
                       rounds: int = 4) -> dict:
    """Where bf16 serving's results move with the batch's row count.  The
    smoke scenes repeated to ``batch`` rows, letterboxed on the host as
    ``cli.serve`` does, bf16 (the snapshot's masked norm), TF32 off: the
    first ``batch // 2`` rows of a ``batch``-row forward against a forward
    of those rows alone.  Two splits of each sample's pixels in the
    reduction passes (K2', the two-pass routes of K1' and K1'-bwd): by the
    forward's own row count, as ``ops.instance_norm._chunks`` splits them,
    and pinned to the split of ``batch`` rows whatever the rows (``_chunks``
    patched for the run); under each, and under PyTorch's cuDNN
    defaults and ``deterministic`` with ``benchmark`` off (the kernels take
    no other layout than cuDNN's channels-last output): the first module in
    call order whose output's bits differ between the two forwards (with
    its largest difference), how many modules differ, the texts of
    ``batch_call`` that differ and the largest corner difference.  Then the
    cost of each remedy: the detector forward at ``batch`` rows, at half,
    and at ``batch`` rows as two forwards of half (the fixed per-rank shape
    that would make one process agree with two ranks), and K2' alone on the
    stem's [half, H, W, 16] input, each event-timed (median of ``reps``),
    the two splits in turns over ``rounds``."""
    from fots_torch.ops import instance_norm as tin
    from fots_torch.serving import host_letterbox

    with np.load(os.path.join(_REPO, "fots_torch", "assets", "smoke_images_u8.npz")) as z:
        images = z["images"]
    scenes = [images[i % len(images)] for i in range(batch)]
    half = batch // 2
    chunks = tin._chunks
    model, _, config = load_detector(os.path.join(_REPO, "artifacts", "serving_params.npz"),
                                     "cuda")
    u8, _ = host_letterbox(scenes, serve_hw)
    x = torch.from_numpy(u8).cuda().float() / 128.0 - 1.0
    cudnn = {"pytorch_default": dict(enabled=True, benchmark=False, deterministic=False),
             "cudnn_deterministic": dict(enabled=True, benchmark=False, deterministic=True)}
    out = {"batch": batch, "serve_hw": list(serve_hw), "dtype": "bf16", "settings": {},
           "cost": {}}

    @contextlib.contextmanager
    def split(pin):
        """Each sample split as ``_chunks`` splits it, or (``pin``) as a
        batch of ``batch`` rows is split."""
        if pin:
            tin._chunks = lambda dev, b, npix, rows: chunks(dev, batch, npix, rows)
        try:
            yield
        finally:
            tin._chunks = chunks

    allow = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with FOTSInference(model, masked_norm=config.get("masked_norm", False),
                           mixed_precision=True, device="cuda", device_letterbox=False) as eng:
            xb = x.to(eng.compute_dtype)
            for mode in ("follows_batch", "pinned"):
                for key, flags in cudnn.items():
                    with torch.backends.cudnn.flags(**flags), split(mode == "pinned"):
                        full = _row_prints(eng.model, xb, half)
                        res_full = eng.batch_call(list(scenes), serve_hw=serve_hw)
                        part = _row_prints(eng.model, xb[:half], half)
                        res_part = eng.batch_call(list(scenes[:half]), serve_hw=serve_hw)
                        differ = [i for i, (a, b) in enumerate(zip(full, part)) if a != b]
                        row = {"modules": len(full), "modules_differ": len(differ),
                               "same_call_order": [n for n, _ in full] == [n for n, _ in part]}
                        if differ:
                            name = full[differ[0]][0]
                            a = _module_output(eng.model, xb, name, half)
                            b = _module_output(eng.model, xb[:half], name, half)
                            row["first_differing_module"] = name
                            row["its_type"] = type(dict(eng.model.named_modules()).get(
                                name, eng.model)).__name__
                            row["its_output_shape"] = list(a.shape)
                            row["max_abs_diff"] = float((a - b).abs().max())
                            row["max_abs_output"] = float(a.abs().max())
                    row["texts_differ"] = [i for i in range(half)
                                           if [e["text"] for e in res_full[i]]
                                           != [e["text"] for e in res_part[i]]]
                    row["max_corner_px"] = max(
                        (float(np.abs(np.asarray(e["box"][:8]) - np.asarray(f["box"][:8])).max())
                         for i in range(half) for e, f in zip(res_full[i], res_part[i])),
                        default=0.0)
                    out["settings"][f"{mode}/{key}"] = row
                    print(json.dumps({f"{mode}/{key}": row}), flush=True)
            # the pin's cost, the two splits in turns (the batch's own split,
            # pinned, pinned, the batch's own, ...)
            stem = torch.empty((half, *serve_hw, 16), dtype=eng.compute_dtype,
                               device="cuda").normal_()
            jobs = {f"forward_{batch}": lambda: eng.model(xb),
                    f"forward_{half}": lambda: eng.model(xb[:half]),
                    f"forward_{batch}_as_2x{half}": lambda: (eng.model(xb[:half]),
                                                            eng.model(xb[half:])),
                    f"k2_{half}x{serve_hw[0]}x{serve_hw[1]}x16":
                        lambda: torch.ops.fots_torch.spatial_stats(stem)}
            ms = {(j, m): [] for j in jobs for m in ("follows_batch", "pinned")}
            with torch.inference_mode():
                for r in range(rounds):
                    order = ("follows_batch", "pinned") if r % 2 == 0 else ("pinned",
                                                                           "follows_batch")
                    for m in order:
                        for j, fn in jobs.items():
                            with split(m == "pinned"):
                                ms[(j, m)].append(cuda_median_ms(fn, reps))
            for (j, m), v in ms.items():
                out["cost"].setdefault(j, {})[m] = {"ms_median": statistics.median(v),
                                                    "ms_min": min(v), "ms_max": max(v)}
            print(json.dumps({"cost": out["cost"]}), flush=True)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = allow
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--path", choices=("serve", "train", "export", "fused_block",
                                       "instance_norm", "pack", "decode", "batch_rows"),
                    default="serve")
    ap.add_argument("--scratch", action="store_true",
                    help="train: from scratch on an augmented 512x512 batch")
    ap.add_argument("--mesh", action="store_true",
                    help="train: Trainer(mesh=) on a world-1 NCCL mesh in this process")
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--batches", type=int, default=3)
    ap.add_argument("--iters", type=int, default=10,
                    help="fused_block: chained iterations per timed program")
    ap.add_argument("--shape", default=",".join(map(str, FUSED_BLOCK_SHAPE)),
                    help="fused_block: N,H,W,C")
    args = ap.parse_args(argv)
    if args.path == "decode":
        for row in profile_decode():
            print(json.dumps(row), flush=True)
        print(card_name_and_power_limit())
        return 0
    if args.path == "batch_rows":
        out = profile_batch_rows(args.batch or 16)
        out["card_and_power_limit"] = card_name_and_power_limit()
        print(json.dumps(out))
        return 0
    if args.path == "fused_block":
        shape = tuple(int(v) for v in args.shape.split(","))
        print(json.dumps(profile_fused_block(shape, args.iters), indent=2))
        return 0
    if args.path in ("instance_norm", "pack"):
        rows = profile_instance_norm() if args.path == "instance_norm" else profile_pack()
        for row in rows:
            print(json.dumps(row), flush=True)
        print(card_name_and_power_limit())
        return 0
    assets = os.path.join(_REPO, "fots_torch", "assets")
    with np.load(os.path.join(assets, "smoke_images_u8.npz")) as z:
        images = z["images"]
    model, _, config = load_detector(os.path.join(_REPO, "artifacts", "serving_params.npz"),
                                     "cuda")
    if args.path == "train" and args.scratch:
        from fots_torch.train import Trainer

        out = profile_training(Trainer(learning_rate=1e-3, seed=0, device="cuda"),
                               augmented_smoke_batch(args.batch or 8), args.batches)
    elif args.path == "serve":
        batch = [images[i % len(images)] for i in range(args.batch or 16)]
        with FOTSInference(model, masked_norm=config.get("masked_norm", False),
                           mixed_precision=True, device="cuda") as eng:
            out = profile_serving(eng, batch, (704, 1280), args.batches)
    elif args.path == "export":
        batch = [images[i % len(images)] for i in range(args.batch or 16)]
        out = profile_export(model, config, batch, (704, 1280), args.batches)
    else:
        from fots_torch.train import Trainer, asset_batch

        with np.load(os.path.join(assets, "train_targets.npz")) as z:
            targets = {k: z[k] for k in z.files}
        batch = asset_batch(images, targets, [i % len(images) for i in range(args.batch or 8)])
        mesh = None
        if args.mesh:
            import torch.distributed as dist

            from fots_torch.parallel import make_mesh

            dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
            mesh = make_mesh(1, 1)
        try:
            out = profile_training(Trainer(model, learning_rate=1e-4, device="cuda", mesh=mesh),
                                   batch, args.batches)
        finally:
            if mesh is not None:
                dist.destroy_process_group()
        out["mesh"] = None if mesh is None else "1x1 (nccl)"
    out["device"] = torch.cuda.get_device_name(0)
    out["card_and_power_limit"] = card_name_and_power_limit()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
