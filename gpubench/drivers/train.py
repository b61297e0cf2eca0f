"""A training cell: ``Trainer.train`` over a pool of seeded batches for the
window; its first three steps, made in set-up through the same call and
feed, are followed by the plain reference.

Traffic keys (``gpubench/workloads/<traffic>.json``): ``kind`` "train";
``batch``; ``frames``: the name of the sample maker
``gpubench/frames/<frames>.py`` (its ``make(traffic, seed)`` returns
``batch`` x ``pool_batches`` :class:`gpubench.inputs.TrainSample`, every
row distinct); ``pool_batches`` (distinct batches, cycled); ``lr`` and
``betas`` (Adam); ``warmup_steps`` (steps after the three checked ones,
before the window); ``trace_steps``; ``limits``.
"""

from __future__ import annotations

import itertools
import time
import traceback
from collections import defaultdict
from typing import Dict, List

import numpy as np
import torch

from gpubench import check_train, common
from gpubench.common import Cell, Phases
from gpubench.trace import Span
from gpubench.weights import cell_weights

CHECKED_STEPS = 3


def make_pool(traffic: dict, seed: int, root: str = common.ROOT) -> List[list]:
    """``pool_batches`` batches of :class:`gpubench.inputs.TrainSample`
    from the traffic's sample maker."""
    samples = common.load_file("frames", traffic["frames"], root).make(traffic, seed)
    b, n = traffic["batch"], traffic["pool_batches"]
    return [samples[k * b:(k + 1) * b] for k in range(n)]


def detection_batch(rows):
    """The program's host batch of ``rows``."""
    from fots_torch.data.detection import DetectionBatch

    return DetectionBatch(
        images=np.stack([r.image for r in rows]).astype(np.float32) / 128.0 - 1.0,
        score_maps=np.stack([r.score for r in rows]),
        geo_maps=np.stack([r.geo for r in rows]),
        training_masks=np.stack([r.mask for r in rows]),
        gt_idxs=np.stack([r.gt_idx for r in rows]),
        gt_quads=[list(r.gt_quads) for r in rows],
        labels=[list(r.labels) for r in rows])


def trainer_seed(seed: int) -> int:
    return abs(int(seed)) % (1 << 63)


def run(cell: Cell, seed: int, seconds: float, trace: bool, t_start: float,
        device: str = "cuda") -> dict:
    from fots_torch.codec import LabelCodec
    from fots_torch.kernels import build
    from fots_torch.train import Trainer

    tr, cfg, model = cell.traffic, cell.config, cell.model
    phases = Phases(t_start)
    if device == "cuda":
        build.build(["instance_norm", "instance_norm_bwd", "spatial_norm", "pack_neighbors"])
    phases.mark("start")  # interpreter, imports and the kernel build
    pool = make_pool(tr, seed, cell.root)
    batches = [detection_batch(rows) for rows in pool]
    phases.mark("inputs")
    flat = cell_weights(cell, seed, device)
    trainer = Trainer(model=model.program_model(cfg, flat),
                      codec=LabelCodec(alphabet=cfg["alphabet"]), learning_rate=tr["lr"],
                      seed=trainer_seed(seed), masked_norm=cfg["masked_norm"], device=device)
    phases.mark("weights")
    if tuple(tr["betas"]) != (0.5, 0.999):
        raise ValueError("the program's Adam has betas (0.5, 0.999)")
    cycle = itertools.cycle(batches)
    record: List[dict] = []
    prepare = trainer._prepare_rois

    def recording(batch, maps):
        prep = prepare(batch, maps)
        rb = prep.roi_batch
        record.append({"rois": rb.rois.copy(), "labels": rb.labels.copy(),
                       "lengths": rb.label_lengths.copy(), "mask": rb.roi_mask.copy(),
                       "width": rb.strip_width, "frames": prep.frames})
        return prep

    trainer._prepare_rois = recording
    # the checked steps: the window's own call and feed; the first step's
    # maps and log-probs kept as the program's forward gives them
    maps: Dict[str, torch.Tensor] = {}
    hooks = [trainer.model.register_forward_hook(_keep(maps, model.program_maps)),
             model.recognition(trainer.model).register_forward_hook(
                 _keep(maps, lambda o: {"logp": o}))]
    trainer.train(cycle, max_steps=1, log_every=0)
    for h in hooks:
        h.remove()
    leaves = model.program_leaves(trainer.model)
    b1 = trainer.optimizer.param_groups[0]["betas"][0]
    # a state with no first moment (a step that left it unchanged) reads 0
    grad1 = {k: (trainer.optimizer.state[p].get("exp_avg", torch.zeros_like(p)) / (1.0 - b1))
             .detach().cpu() for k, p in leaves.items()}
    trainer.train(cycle, max_steps=CHECKED_STEPS, log_every=0)
    w0 = {k: torch.tensor(flat[k], device=device) for k in leaves}
    change = {k: (p.detach() - _oihw(w0[k])).cpu() for k, p in leaves.items()}
    del w0
    trainer._prepare_rois = prepare
    losses = [dict(h) for h in trainer.history[:CHECKED_STEPS]]
    rois = record[:CHECKED_STEPS]
    phases.mark("checked_steps")
    trainer.train(cycle, max_steps=CHECKED_STEPS + tr["warmup_steps"], log_every=0)
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    phases.mark("warmup")

    host_ms: Dict[str, List[float]] = defaultdict(list)
    span = Span(2, tr["trace_steps"], build.launch_counts) if trace else None
    if trace:
        _time_calls(trainer, ("_prepare_maps", "_prepare_rois"), host_ms)
        step = trainer.step

        def counted_step(*a, **k):
            out = step(*a, **k)
            span.tick(trainer.global_step - first_step)
            return out

        trainer.step = counted_step
    fed = [0]
    setup_s = time.perf_counter() - t_start
    t0 = time.perf_counter()
    deadline = t0 + seconds

    def feed():
        while time.perf_counter() < deadline:
            fed[0] += 1
            yield next(cycle)

    first_step = trainer.global_step
    first_history = len(trainer.history)
    failed = 0
    try:
        trainer.train(feed(), max_steps=first_step + 10 ** 9, log_every=0)
    except Exception:
        traceback.print_exc()
    if device == "cuda":
        torch.cuda.synchronize()
    t1 = time.perf_counter()
    if span:
        span.close(trainer.global_step - first_step)
    steps = trainer.global_step - first_step
    failed = fed[0] - steps
    failed += sum(1 for h in trainer.history[first_history:]
                  if not all(np.isfinite(v) for k, v in h.items() if k != "step"))
    out = {
        "setup_s": setup_s, "setup_phases": phases.seconds, "window_s": t1 - t0,
        "attempted": fed[0], "failed": failed,
        "steps": steps, "batch": tr["batch"],
        "train_images_per_s": steps * tr["batch"] / (t1 - t0),
        "memory_peak_bytes": torch.cuda.max_memory_allocated() if device == "cuda" else 0,
        "span": span, "host_ms": host_ms,
        "shape": tuple(batches[0].images.shape[1:3]),
    }
    del trainer, leaves
    if device == "cuda":
        torch.cuda.empty_cache()
    out["check"] = check_train.check(cell, seed, flat, pool[:CHECKED_STEPS], rois,
                                     check_train.Steps(losses, grad1, change, maps), device)
    out.update(check_rois=rois, check_pool=pool[:CHECKED_STEPS], check_weights=flat)
    return out


def _keep(store: dict, pick):
    """A forward hook that puts ``pick(output)`` of its module's first call
    into ``store``, on the host."""
    def hook(module, args, output):
        for k, v in pick(output).items():
            if k not in store:
                store[k] = v.detach().float().cpu()
    return hook


def _oihw(w: torch.Tensor) -> torch.Tensor:
    return w.permute(3, 2, 0, 1) if w.ndim == 4 else w


def _time_calls(obj, names, log) -> None:
    """Wrap each ``obj.<name>`` so its host ms land in ``log[name]`` and its
    span carries a ``bench::<name>`` label in a trace."""
    for name in names:
        fn = getattr(obj, name)

        def wrapper(*a, _fn=fn, _name=name, **k):
            t0 = time.perf_counter()
            try:
                with torch.profiler.record_function(f"bench::{_name}"):
                    return _fn(*a, **k)
            finally:
                log[_name].append(1e3 * (time.perf_counter() - t0))

        setattr(obj, name, wrapper)


def model_flops(cell: Cell, run: dict, device) -> float:
    """Model FLOPs of one step (forward and backward) at the cell's shapes,
    counted over the reference."""
    return check_train.step_flops(cell, run, device)
