"""A serving cell: one client in a closed loop feeds
``FOTSInference.stream`` batches of seeded frames for the window, then a
sample of what came back is held against the plain reference.

Traffic keys (``gpubench/workloads/<traffic>.json``): ``kind`` "serve";
``batch``; ``frames``: the name of the frame maker
``gpubench/frames/<frames>.py`` (its ``make(traffic, seed)`` returns the
u8 BGR frames a batch draws from, all of one shape); ``serve_hw``;
``max_candidates``; ``warmup_batches``; ``check_batches`` (batches drawn
for the check, besides the one with the most boxes); ``trace_batches``
(batches in the traced window); ``limits`` (the compared numbers' limits).
Every cell serves as the program ships: a bf16 backbone and recognizer,
f32 heads, and the program's own candidate transport.
"""

from __future__ import annotations

import time
import traceback
from typing import Dict, List

import numpy as np
import torch

from gpubench import check_serve, common, inputs
from gpubench.common import Cell, Check, Phases, percentile, window_rate
from gpubench.trace import Span
from gpubench.weights import cell_weights

#: the program's bf16 serving (``FOTSInference(mixed_precision=True)``)
MIXED_PRECISION = True


class Frames:
    """The frames of a cell: a list of u8 arrays of one shape, and the
    batches of indices into it drawn from the seed."""

    def __init__(self, traffic: dict, seed: int, root: str = common.ROOT):
        self.frames = common.load_file("frames", traffic["frames"], root).make(traffic, seed)
        self.rng = inputs.seed_rng(seed, "batches")
        self.batch = traffic["batch"]

    def draw(self) -> np.ndarray:
        return self.rng.integers(len(self.frames), size=self.batch)

    def images(self, idx) -> List[np.ndarray]:
        return [self.frames[i] for i in idx]


class Hooks:
    """Timing and counting wrapped around the program's calls in the traced
    run: host ms of each box decode and NMS, and the rois recognised by
    strip width."""

    def __init__(self):
        self.nms_ms: List[float] = []
        self.roi_widths: Dict[int, int] = {}
        self._saved = []

    def install(self):
        import fots_torch.pipeline as pipeline

        nms, bucket = pipeline.get_boxes_from_candidates_batch, pipeline.bucket_rois

        def timed_nms(*a, **k):
            t0 = time.perf_counter()
            with torch.profiler.record_function("bench::nms"):
                out = nms(*a, **k)
            self.nms_ms.append(1e3 * (time.perf_counter() - t0))
            return out

        def counted_bucket(*a, **k):
            rois, keys, buckets = bucket(*a, **k)
            for w, idx in buckets.items():
                self.roi_widths[w] = self.roi_widths.get(w, 0) + len(idx)
            return rois, keys, buckets

        self._saved = [(pipeline, "get_boxes_from_candidates_batch", nms),
                       (pipeline, "bucket_rois", bucket)]
        pipeline.get_boxes_from_candidates_batch = timed_nms
        pipeline.bucket_rois = counted_bucket

    def remove(self):
        for mod, name, fn in self._saved:
            setattr(mod, name, fn)


def run(cell: Cell, seed: int, seconds: float, trace: bool, t_start: float,
        device: str = "cuda") -> dict:
    """Set up, warm up, measure one window and check.  Returns the pieces of
    the result line."""
    from fots_torch.kernels import build
    from fots_torch.pipeline import FOTSInference

    tr, cfg = cell.traffic, cell.config
    serve_hw = tuple(tr["serve_hw"])
    phases = Phases(t_start)
    build.build(["instance_norm", "spatial_norm", "pack_neighbors", "nms_core"]
                if device == "cuda" else ["nms_core"])
    phases.mark("start")  # interpreter, imports and the kernel build
    frames = Frames(tr, seed, cell.root)
    phases.mark("inputs")
    flat = cell_weights(cell, seed, device)
    engine = FOTSInference(cell.model.program_model(cfg, flat), masked_norm=cfg["masked_norm"],
                           mixed_precision=MIXED_PRECISION,
                           max_candidates=tr["max_candidates"], device=device)
    phases.mark("weights")
    warm_rng = inputs.seed_rng(seed, "warmup")
    warm = [frames.images(warm_rng.integers(len(frames.frames), size=tr["batch"]))
            for _ in range(tr["warmup_batches"])]
    for _ in engine.stream(iter(warm), serve_hw=serve_hw):
        pass
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    phases.mark("warmup")

    hooks = Hooks() if trace else None
    span = Span(2, tr["trace_batches"], build.launch_counts) if trace else None
    handed: Dict[int, float] = {}
    drawn: Dict[int, np.ndarray] = {}
    done: List[tuple] = []           # (batch id, time, images, results)
    failed = 0
    setup_s = time.perf_counter() - t_start
    t0 = time.perf_counter()
    deadline = t0 + seconds

    def feed():
        k = 0
        while time.perf_counter() < deadline:
            idx = frames.draw()
            drawn[k] = idx
            handed[k] = time.perf_counter()
            yield k, frames.images(idx)
            k += 1

    if hooks:
        hooks.install()
    try:
        for k, res in engine.stream(feed(), serve_hw=serve_hw, with_context=True):
            done.append((k, time.perf_counter(), len(res), res))
            if not well_formed(res, tr["batch"]):
                failed += 1
            if span:
                span.tick(len(done))
    except Exception:
        traceback.print_exc()
        failed += len(handed) - len(done)
    finally:
        if hooks:
            hooks.remove()
        if span:
            span.close(len(done))
    if device == "cuda":
        torch.cuda.synchronize()
    in_window = [d for d in done if d[1] <= deadline]
    lat = [1e3 * (d[1] - handed[d[0]]) for d in in_window]
    rate = window_rate([d[1] for d in done], [d[2] for d in done], t0, seconds)
    out = {
        "setup_s": setup_s, "setup_phases": phases.seconds, "window_s": seconds,
        "attempted": len(handed), "failed": failed,
        "images": sum(d[2] for d in in_window), "batches": len(in_window),
        "serve_images_per_s": rate,
        "serve_batch_p95_ms": percentile(lat, 95) if lat else float("nan"),
        "memory_peak_bytes": torch.cuda.max_memory_allocated() if device == "cuda" else 0,
        "span": span, "hooks": hooks, "batch": tr["batch"], "serve_hw": serve_hw,
    }
    engine.close()
    del engine
    if device == "cuda":
        torch.cuda.empty_cache()
    out["check"] = check(cell, seed, frames, drawn, done, deadline, flat, device)
    return out


def well_formed(res, batch: int) -> bool:
    """One result per image; every box eight finite corners and a score,
    every text a non-empty string, every confidence in (0, 1]."""
    if len(res) != batch:
        return False
    for r in res:
        for e in r:
            box = np.asarray(e.get("box"))
            if box.shape != (9,) or not np.isfinite(box).all():
                return False
            if not isinstance(e.get("text"), str) or not e["text"]:
                return False
            if not 0.0 < float(e.get("conf", 0.0)) <= 1.0:
                return False
    return True


def sample_batches(seed: int, done, deadline: float, n: int) -> List[int]:
    """Indices into ``done`` of ``n`` batches finished in the window, drawn
    from the seed, and the one with the most served boxes."""
    ok = [i for i, d in enumerate(done) if d[1] <= deadline]
    if not ok:
        return []
    rng = inputs.seed_rng(seed, "check")
    picks = [ok[int(j)] for j in rng.choice(len(ok), min(n, len(ok)), replace=False)]
    longest = max(ok, key=lambda i: sum(len(r) for r in done[i][3]))
    return sorted(set(picks + [longest]))


def served_in_serving_pixels(res, frames_u8, serve_hw):
    """The served boxes (source pixels) back in serving pixels, and texts."""
    boxes, texts = [], []
    H, W = serve_hw
    for r, f in zip(res, frames_u8):
        s = min(H / f.shape[0], W / f.shape[1])
        b = np.asarray([e["box"] for e in r], np.float64).reshape(-1, 9)
        b[:, :8] *= s
        boxes.append(b)
        texts.append([e["text"] for e in r])
    return boxes, texts


def check(cell: Cell, seed: int, frames: Frames, drawn, done, deadline, flat, device) -> Check:
    tr = cell.traffic
    chk = Check()
    picks = sample_batches(seed, done, deadline, tr["check_batches"])
    if not picks:
        chk.add("batches_checked", 0, -1)
        return chk
    frames_u8 = np.stack([frames.frames[i] for p in picks for i in drawn[done[p][0]]])
    res = [r for p in picks for r in done[p][3]]
    served_boxes, served_texts = served_in_serving_pixels(res, frames_u8, tuple(tr["serve_hw"]))
    nums = compare_to_reference(cell, flat, frames_u8, served_boxes, served_texts, device)
    for name, limit in tr["limits"].items():
        chk.add(name, nums[name], limit)
    chk.notes = {"frames_checked": len(frames_u8),
                 "boxes_served": int(sum(len(b) for b in served_boxes)), **nums}
    return chk


def compare_to_reference(cell: Cell, flat, frames_u8, served_boxes, served_texts, device):
    """The compared numbers of served boxes and texts over ``frames_u8``."""
    with reference_math(device):
        params = check_serve.reference_params(flat, device)
        ref_boxes, ref_texts, logp = check_serve.reference_pass(
            cell, params, frames_u8, extra_boxes=served_boxes, device=device)
    return check_serve.compare(served_boxes, served_texts, logp, ref_boxes, ref_texts,
                               cell.config["alphabet"])


class reference_math:
    """TF32 off for the reference, restored after."""

    def __init__(self, device):
        self.cuda = str(device).startswith("cuda")

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        return self

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self.saved


def model_flops(cell: Cell, run: dict, device) -> float:
    """Model FLOPs of the images served in the window: the detector's
    forward at the serving size for each, and the recognition head over the
    rois recognised (by strip width, scaled from every batch recognised to
    the window's images), counted over the reference at f32."""
    from torch.utils.flop_counter import FlopCounterMode

    from gpubench.reference import ops as R
    from gpubench.reference.detector import oihw

    cfg, model = cell.config, cell.model
    p = oihw({k: torch.zeros(s, device=device) for k, s in model.param_shapes(cfg).items()})
    net = model.reference(cfg, p)
    h, w = run["serve_hw"]

    def count(fn) -> float:
        counter = FlopCounterMode(display=False)
        with counter, torch.no_grad():
            fn()
        return float(counter.get_total_flops())

    out = {}
    det = count(lambda: out.update(net.forward(torch.zeros((1, h, w, 3), device=device))))
    rec = 0.0
    for width, n in run["hooks"].roi_widths.items():
        roi = torch.tensor([[0, w / 8, h / 8, 32.0, 8.0 * width, 0.0]], device=device)
        rec += n * count(lambda: net.recognize(
            R.rroi_align(out["focr"], roi, model.POOLED_HEIGHT, width)))
    seen = max(1, run["attempted"] * run["batch"])
    return run["images"] * (det + rec / seen)
