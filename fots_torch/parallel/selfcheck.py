"""Multi-rank runs of the meshed trainer and engine, held against one
process on the global batch.

The functions here import ``torch`` and ``fots_torch`` only, so spawned
ranks never import a caller's module.  :func:`start` spawns ``world`` ranks
over a ``FileStore`` in a directory (no TCP port) and :func:`finish` waits
for them and returns rank 0's result; :func:`single` runs the same cases in
the calling process without a mesh.  A case list holds

- ``("train", spec)``: a :class:`fots_torch.train.Trainer` (``spec``: the
  model, codec, batches, lr, OHEM, device, ``max_rois`` (:func:`roi_slots`)
  and for one process ``sum_shards``) steps through its batches; the
  record holds each step's metrics (every rank's), global roi batch and
  gradients, and after the last step the full checkpoint payload (the
  vocabulary head gathered) and each rank's own ``conv11`` rows;
- ``("serve", spec)``: ``FOTSInference.batch_call`` of a batch (every
  rank's results), each image's candidate pack, and (``time_batches``)
  the ms of whole batches and of this rank's letterbox;
- ``("smooth", spec)``: the losses' reductions, BatchNorm and a sharded
  ``embedding`` through a small network without kinks, one backward;
- ``("serve_cli", spec)``: :mod:`fots_torch.cli.serve` on the mesh, and
  the files each rank decoded;
- ``("fail", spec)``: ``Trainer.train`` where one rank's step raises;
- ``("save", spec)`` / ``("restore", spec)``: a trained state written with
  :func:`fots_torch.checkpoint.save_checkpoint`, or a checkpoint restored
  and read back gathered.

:func:`compare_train` and :func:`compare_serve` hold a meshed record to a
single-process one within :class:`Limits`.
"""

from __future__ import annotations

import math
import os
import pickle
import statistics
import time
import traceback
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from fots_torch.parallel import mesh as pmesh

RESULT_FILE = "rank0_result.pkl"
CASES_FILE = "cases.pkl"
ERROR_FILE = "rank{}_error.txt"  # a rank's traceback, where it raised
#: what a ``("fail", spec)`` case raises on its rank
INJECTED = "a step failure injected on one rank"


@dataclass(frozen=True)
class Limits:
    """How far a meshed run may be from one process: loss terms within
    ``loss_rel`` of their value (+ ``loss_abs``); each gradient tensor
    within ``grad_rel`` of its largest magnitude, the median tensor within
    ``grad_median``; parameters after Adam within ``param_lr`` learning rates
    where every step's gradient sign is resolved (and 2 per step anywhere);
    BatchNorm statistics within ``stat_rel`` of (1 + |value|); candidate
    values within ``cand_rel`` (+ ``cand_abs``)."""

    loss_rel: float
    loss_abs: float
    grad_rel: float
    grad_median: float
    param_lr: float
    stat_rel: float
    cand_rel: float
    cand_abs: float


#: the detector on the CPU: one f32 arithmetic on both sides, the sums over
#: the batch in another order (local sums, then the all-reduce and DDP's
#: mean).  BatchNorm's statistics so differ in the last bits, and where a
#: leaky ReLU's input lies that close to 0 its slope flips (0.01 <-> 1):
#: that element's gradient moves by 0.99 of itself and every tensor before
#: it in the network by up to ~2e-2 of its largest magnitude (one such flip
#: measured at layer3.2's output: 9.3e-3 there, 1e-6 from layer3.3 on).
#: One process whose BatchNorms add as the ranks do (:func:`sum_by_shards`)
#: is as far from one process that does not, and the meshed step is within
#: :data:`ORDER_LIMITS` of it.  Adam's step after two updates moves by under
#: 0.1 lr where each step's gradient exceeds ten times its tensor's largest
#: difference.
CPU_LIMITS = Limits(loss_rel=1e-5, loss_abs=1e-6, grad_rel=3e-2, grad_median=1e-3,
                    param_lr=0.1, stat_rel=1e-5, cand_rel=1e-4, cand_abs=1e-4)
#: the detector on the CPU against one process whose BatchNorms add as the
#: data ranks do: the same statistics bit for bit, so the same slopes, and
#: only the other sums' order differs (f32 noise, largest in the stem's
#: weight gradients, each a sum over every pixel of the batch)
ORDER_LIMITS = Limits(loss_rel=1e-5, loss_abs=1e-6, grad_rel=1e-4, grad_median=1e-5,
                      param_lr=1e-2, stat_rel=1e-5, cand_rel=1e-4, cand_abs=1e-4)
#: a network without kinks (``("smooth", spec)``): only the sums' order
SMOOTH_REL = 1e-5


def model_from_spec(spec: dict, device):
    """The detector a case trains or serves, built alike on every rank:
    flax-default weights from ``spec["seed"]`` at ``spec["nclass"]`` classes
    (default 87), over which ``spec["snapshot"]``'s weights are loaded, all
    of them, or all but the vocabulary head where the class counts differ
    (a warm start, as ``train_joint -h5`` skips ``conv11``)."""
    from fots_torch.models.detector import FOTSDetector, init_detector

    model = init_detector(FOTSDetector(nclass=spec.get("nclass", 87)),
                          torch.Generator().manual_seed(spec.get("seed", 0)))
    if spec.get("snapshot"):
        from fots_torch.checkpoint import load_serving_params, state_dict_from_flat

        flat = load_serving_params(spec["snapshot"])[0]
        sd = state_dict_from_flat(flat)
        own = model.state_dict()
        model.load_state_dict({k: v for k, v in sd.items() if own[k].shape == v.shape},
                              strict=False)
    return model.to(device)


def codec_from_spec(spec: dict):
    """The ICDAR 2015 codec, or (``spec["nclass"]`` above 87) that alphabet
    extended by CJK ideographs to ``nclass - 1`` symbols."""
    from fots_torch.codec import ICDAR15_ALPHABET, LabelCodec

    n = spec.get("nclass", len(ICDAR15_ALPHABET) + 1)
    extra = n - 1 - len(ICDAR15_ALPHABET)
    return LabelCodec(alphabet=ICDAR15_ALPHABET + "".join(chr(0x4E00 + i)
                                                          for i in range(max(extra, 0))))


def scene_batch(images_u8: np.ndarray, targets, order, scale: int = 4,
                width: Optional[int] = None):
    """A training batch of the asset scenes ``order`` (u8 [N, h, w, 3] and
    the quads and labels of ``fots_torch/assets/train_targets.npz``) shrunk
    ``scale`` times (``cv2.resize``'s arithmetic), cut to ``width`` columns,
    with the port's EAST targets.  Each scene keeps its words."""
    from fots_torch.data.detection import DetectionBatch
    from fots_torch.geometry import generate_rbox, resize_bilinear_u8

    counts = np.asarray(targets["gt_counts"])
    starts = np.concatenate([[0], np.cumsum(counts)])
    quads_all = np.asarray(targets["gt_quads"], np.float32)
    words = [str(t) for t in targets["gt_labels"]]
    cols = []
    for i in order:
        im = images_u8[i]
        h, w = im.shape[0] // scale, im.shape[1] // scale
        im = resize_bilinear_u8(im, (w, h))[:, :width or w]
        polys = quads_all[starts[i]:starts[i + 1]] / scale
        labels = words[starts[i]:starts[i + 1]]
        cols.append((im, *generate_rbox(im.shape[:2], polys, [False] * len(polys), labels)))
    return DetectionBatch(
        images=np.stack([c[0] for c in cols]).astype(np.float32) / 128.0 - 1.0,
        score_maps=np.stack([c[1] for c in cols]), geo_maps=np.stack([c[2] for c in cols]),
        training_masks=np.stack([c[3] for c in cols]), gt_idxs=np.stack([c[4] for c in cols]),
        gt_quads=[list(c[5]) for c in cols], labels=[list(c[6]) for c in cols])


def _grads(model, mesh) -> Dict[str, np.ndarray]:
    sharded = set(pmesh.sharded_names(model)) if mesh is not None else set()
    out = {}
    for name, p in model.named_parameters():
        g = p.grad.detach()
        if name in sharded:
            g = pmesh.gather_rows(g, pmesh.model_group(mesh),
                                  pmesh.axis_size(mesh, pmesh.MODEL_AXIS))
        out[name] = np.array(g.cpu())  # a copy: a CPU tensor's numpy() aliases it
    return out


def _reset_launches() -> None:
    from fots_torch.kernels import build

    build.reset_launch_counts()


def _launches() -> dict:
    """This process's kernel launches since :func:`_reset_launches`."""
    from fots_torch.kernels import build

    return {**build.launch_counts, **build.route_counts}


def timed_ms(fn, n: int, device) -> List[float]:
    """Host ms of ``n`` calls of ``fn``, each ending with the device idle."""
    out = []
    for _ in range(n):
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
        out.append(1e3 * (time.perf_counter() - t0))
    return out


def _everyone(obj, mesh) -> list:
    return [obj] if mesh is None else pmesh.all_gather_objects(obj, mesh)


def sum_by_shards(model, n: int) -> None:
    """Make ``model``'s BatchNorms add their statistics as a data axis of
    ``n`` ranks does, in this process: the sums of each of ``n`` equal
    row blocks of the batch, then those sums in rank order (gloo's sum of
    the ranks' vectors)."""
    from fots_torch.models.layers import BatchNorm, channel_sums

    def sums(x32):
        out = 0
        for part in x32.chunk(n):
            out = out + channel_sums(part)
        return out

    for mod in model.modules():
        if isinstance(mod, BatchNorm):
            mod.group, mod._sums = n, sums


@contextmanager
def roi_slots(n: Optional[int]):
    """Trainers step with ``n`` roi slots inside (None: as they are), in
    place of :data:`fots_torch.train.MAX_ROIS`, which ``fots`` reads from
    ``FOTS_MAX_ROIS``: a small check recognises fewer padded slots."""
    from fots_torch import train

    old = train.MAX_ROIS
    train.MAX_ROIS = old if n is None else n
    try:
        yield
    finally:
        train.MAX_ROIS = old


def _trainer(spec: dict, mesh):
    """The case's trainer; without a mesh and with ``spec["sum_shards"]``
    its BatchNorms add as that many data ranks do (:func:`sum_by_shards`)."""
    from fots_torch.train import Trainer

    trainer = Trainer(model_from_spec(spec, spec["device"]), codec=codec_from_spec(spec),
                      learning_rate=spec.get("lr", 1e-4), seed=spec.get("seed", 0),
                      ohem=spec.get("ohem", False), device=spec["device"], mesh=mesh)
    if mesh is None and spec.get("sum_shards"):
        sum_by_shards(trainer.model, spec["sum_shards"])
    return trainer


def run_train(spec: dict, mesh) -> dict:
    with roi_slots(spec.get("max_rois")):
        return _run_train(spec, mesh)


def _run_train(spec: dict, mesh) -> dict:
    from fots_torch.checkpoint import checkpoint_payload

    device = spec["device"]
    trainer = _trainer(spec, mesh)
    steps = []
    _reset_launches()
    for batch in spec["batches"]:
        prepared = trainer._prepare(batch)
        metrics = trainer.step(batch, prepared=prepared)
        steps.append({"metrics": _everyone(metrics, mesh), "grads": _grads(trainer.model, mesh),
                      "rois": prepared.roi_batch.rois.copy(),
                      "roi_mask": prepared.roi_batch.roi_mask.copy(),
                      "n_predicted": prepared.roi_batch.n_predicted,
                      "local_rois": _everyone(int(prepared.recognised.roi_mask.sum()), mesh)})
    launches = _launches()
    conv11 = trainer.model.ocr.conv11.weight.detach().cpu().numpy()
    payload = checkpoint_payload(trainer.model, trainer.optimizer, trainer.global_step, mesh)
    rec = {"steps": steps, "launches": launches,
           "payload": {k: np.array(v) for k, v in payload.items()},  # copies, as in _grads
           "conv11_rows": _everyone((pmesh.axis_index(mesh, pmesh.DATA_AXIS),
                                     pmesh.axis_index(mesh, pmesh.MODEL_AXIS), conv11), mesh)}
    # then ``time_steps`` more steps on the last batch, timed, not recorded
    rec["step_ms"] = timed_ms(lambda: trainer.step(spec["batches"][-1]),
                              spec.get("time_steps", 0), device)
    rec["trainer"] = trainer
    return rec


def run_serve(spec: dict, mesh) -> dict:
    from fots_torch.pipeline import FOTSInference

    device = spec["device"]
    images, hw = spec["images"], tuple(spec["serve_hw"])
    eng = FOTSInference(model_from_spec(spec, device), codec=codec_from_spec(spec),
                        masked_norm=spec.get("masked_norm", False),
                        mixed_precision=spec.get("mixed_precision", False), device=device,
                        device_letterbox=spec.get("device_letterbox", True), mesh=mesh)
    timed = spec.get("time_batches", 0)
    with eng:
        _reset_launches()
        results = eng.batch_call(list(images), serve_hw=hw)
        launches = _launches()
        batch_ms = timed_ms(lambda: eng.batch_call(list(images), serve_hw=hw), timed, device)
        mine, n_local, same = eng._my_images(list(images), hw)
        letterbox_ms = timed_ms(lambda: eng._letterbox(mine, hw, same), timed, "cpu")
        cands, _ = eng._dispatch_detect(eng._letterbox(mine, hw, same)[0], hw)
        cands = cands.numpy()[:n_local]
        if mesh is not None:
            cands = np.concatenate(pmesh.all_gather_objects(cands, mesh, pmesh.DATA_AXIS))
    return {"results": _everyone(results, mesh), "cands": cands, "launches": launches,
            "batch_ms": batch_ms, "letterbox_ms": letterbox_ms}


def run_serve_cli(spec: dict, mesh) -> dict:
    """``cli.serve`` with ``spec["argv"]`` (and the mesh's ``-n_data`` /
    ``-n_model``): the images it counted and the files each rank decoded."""
    from fots_torch import imageio
    from fots_torch.cli import serve

    read, imread = [], imageio.imread

    def counted(path, *args, **kw):
        read.append(os.path.basename(str(path)))
        return imread(path, *args, **kw)

    argv = list(spec["argv"])
    if mesh is not None:
        argv += ["-n_data", str(pmesh.axis_size(mesh, pmesh.DATA_AXIS)),
                 "-n_model", str(pmesh.axis_size(mesh, pmesh.MODEL_AXIS))]
    imageio.imread = counted
    try:
        n = serve.main(argv)
    finally:
        imageio.imread = imread
    return {"n": n, "read": _everyone(read, mesh)}


def run_fail(spec: dict, mesh) -> dict:
    """``Trainer.train`` over ``spec["batches"]``, where step ``spec["step"]``
    of rank ``spec["rank"]`` raises :data:`INJECTED` before it starts."""
    trainer = _trainer(spec, mesh)
    step = trainer.step

    def step_or_fail(batch, **kw):
        if dist.get_rank() == spec["rank"] and trainer.global_step == spec["step"]:
            raise RuntimeError(INJECTED)
        return step(batch, **kw)

    trainer.step = step_or_fail
    with roi_slots(spec.get("max_rois")):
        trainer.train(spec["batches"], max_steps=len(spec["batches"]), log_every=0)
    return {"global_step": trainer.global_step}


class _Smooth(torch.nn.Module):
    """Conv -> BatchNorm -> tanh -> 1x1 heads (score, 4 distances, sin/cos)
    at the input's size, and a linear ``embedding`` for CTC: every
    reduction the meshed loss makes, and no kink."""

    def __init__(self, nclass: int, gen: torch.Generator):
        from fots_torch.models.layers import BatchNorm, Conv

        super().__init__()
        # no bias before BatchNorm: its gradient is 0 up to rounding
        self.conv, self.bn, self.head = Conv(3, 8, 3), BatchNorm(8), Conv(8, 7, 1, bias=True)
        self.embedding = torch.nn.Linear(16, nclass)
        with torch.no_grad():
            for p in self.parameters():
                p.copy_(torch.randn(p.shape, generator=gen) * 0.3)

    def forward(self, x):
        y = self.head(torch.tanh(self.bn(self.conv(x.permute(0, 3, 1, 2))))).permute(0, 2, 3, 1)
        return {"segm": [torch.sigmoid(y[..., :1])], "rbox": [torch.sigmoid(y[..., 1:5]) * 8.0],
                "angle": [torch.tanh(y[..., 5:7])]}


def smooth_data(b: int = 4, n_rois: int = 8, nclass: int = 750, seed: int = 0) -> dict:
    """Inputs of a ``("smooth", ...)`` case: ``b`` 16x16 images and maps,
    ``n_rois`` 12-frame strips with labels (some masked)."""
    rng = np.random.default_rng(seed)
    return {"images": rng.standard_normal((b, 16, 16, 3)).astype(np.float32),
            "score": (rng.uniform(size=(b, 16, 16)) < 0.3).astype(np.float32),
            "mask": (rng.uniform(size=(b, 16, 16)) < 0.9).astype(np.float32),
            "geo": rng.uniform(0.5, 8, (b, 16, 16, 4)).astype(np.float32),
            "angle": rng.uniform(-0.5, 0.5, (b, 16, 16)).astype(np.float32),
            "strips": rng.standard_normal((n_rois, 12, 16)).astype(np.float32),
            "labels": rng.integers(1, nclass, (n_rois, 4)).astype(np.int64),
            "lengths": rng.integers(1, 5, (n_rois,)).astype(np.int64),
            "roi_mask": (np.arange(n_rois) % 3 != 2).astype(np.float32)}


def run_smooth(spec: dict, mesh) -> dict:
    """One backward of the detection loss (dice or OHEM) and CTC through
    :class:`_Smooth` on this rank's rows, DDP over the data group, the
    embedding column-parallel over 'model'."""
    from torch.nn.parallel import DistributedDataParallel

    from fots_torch.losses import ctc_loss, detection_loss
    from fots_torch.models.layers import BatchNorm

    data, nclass = spec["data"], spec["nclass"]
    net = _Smooth(nclass, torch.Generator().manual_seed(0)).train()
    group = pmesh.data_group(mesh)
    model = net
    if mesh is not None:
        pmesh.shard_init(net, mesh)
        for mod in net.modules():
            if isinstance(mod, BatchNorm):
                mod.group = group
        model = DistributedDataParallel(net, process_group=group, broadcast_buffers=False)
    shard = pmesh.batch_sharding(mesh)
    img = shard.rows(data["images"].shape[0])
    roi = shard.rows(data["strips"].shape[0])

    def t(k, rows):
        return torch.from_numpy(data[k][rows])

    out = model(t("images", img))
    det = detection_loss(out, t("score", img), t("mask", img), t("geo", img), t("angle", img),
                         multi_scale=False, ohem=spec.get("ohem", False), group=group)
    logp = torch.log_softmax(net.embedding(t("strips", roi)), dim=-1)
    frames = torch.full((logp.shape[0],), logp.shape[1], dtype=torch.int64)
    ctc = ctc_loss(logp, t("labels", roi), t("lengths", roi), frames, t("roi_mask", roi),
                   group=group)
    total = det["total"] + ctc
    total.backward()
    losses = {k: float(v.detach()) for k, v in (("loss", total), ("ctc", ctc), *det.items())}
    return {"losses": _everyone(losses, mesh), "grads": _grads(net, mesh),
            "running": {k: v.numpy().copy() for k, v in net.bn.named_buffers()}}


def compare_smooth(got: dict, want: dict, rel: float = SMOOTH_REL) -> List[str]:
    """Failures of a meshed ``("smooth", ...)`` record against one process:
    every rank's losses, each gradient tensor and the running statistics
    within ``rel`` of their largest magnitude."""
    fails = []
    for r, losses in enumerate(got["losses"]):
        for k, v in want["losses"][0].items():
            if abs(losses[k] - v) > rel * abs(v) + 1e-7:
                fails.append(f"rank {r} {k}: {losses[k]} vs {v}")
    for group in ("grads", "running"):
        for n, w in want[group].items():
            err = float(np.abs(got[group][n] - w).max())
            if err > rel * max(float(np.abs(w).max()), 1e-30):
                fails.append(f"{group} {n}: {err:.3e} of {float(np.abs(w).max()):.3e}")
    return fails


def _run_cases(cases: List[tuple], mesh) -> list:
    from fots_torch.checkpoint import (checkpoint_payload, read_checkpoint,
                                       restore_checkpoint, save_checkpoint)

    out, last = [], None
    for kind, spec in cases:
        if kind == "train":
            rec = run_train(spec, mesh)
            last = rec.pop("trainer")
            out.append(rec)
        elif kind == "serve":
            out.append(run_serve(spec, mesh))
        elif kind == "smooth":
            out.append(run_smooth(spec, mesh))
        elif kind == "serve_cli":
            out.append(run_serve_cli(spec, mesh))
        elif kind == "fail":
            out.append(run_fail(spec, mesh))
        elif kind == "save":  # the last trained state
            out.append(save_checkpoint(spec["dir"], last, last.global_step))
        elif kind == "restore":
            from fots_torch.train import Trainer

            trainer = Trainer(model_from_spec(spec, spec["device"]),
                              codec=codec_from_spec(spec), device=spec["device"], mesh=mesh)
            step = restore_checkpoint(spec["path"], trainer)
            got = checkpoint_payload(trainer.model, trainer.optimizer, step, mesh)
            want = read_checkpoint(spec["path"])
            same = (sorted(got) == sorted(want)
                    and all(np.array_equal(got[k], want[k]) for k in want))
            out.append({"step": step, "bit_equal": _everyone(same, mesh)})
        else:
            raise ValueError(f"unknown case {kind!r}")
    return out


def single(cases: List[tuple]) -> list:
    """The cases in this process, on one device."""
    return _run_cases(cases, None)


def _rank(rank: int, world: int, workdir: str, backend: str, shape: tuple):
    torch.set_num_threads(1)
    # f32 convolutions in full f32, as the single-process references run
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    store = dist.FileStore(os.path.join(workdir, "store"), world)
    dist.init_process_group(backend, store=store, rank=rank, world_size=world)
    try:
        with open(os.path.join(workdir, CASES_FILE), "rb") as f:
            cases = pickle.load(f)
        mesh = pmesh.make_mesh(*shape)
        try:
            out = _run_cases(cases, mesh)
        except BaseException:
            with open(os.path.join(workdir, ERROR_FILE.format(rank)), "w") as f:
                f.write(traceback.format_exc())
            raise
        if rank == 0:
            with open(os.path.join(workdir, RESULT_FILE), "wb") as f:
                pickle.dump(out, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def start(cases: List[tuple], workdir: str, n_data: int, n_model: int = 1,
          backend: str = "gloo"):
    """Spawn ``n_data * n_model`` ranks running ``cases`` on an (n_data,
    n_model) mesh over a ``FileStore`` in ``workdir``; returns the spawn
    context for :func:`finish`."""
    os.makedirs(workdir, exist_ok=True)
    with open(os.path.join(workdir, CASES_FILE), "wb") as f:
        pickle.dump(cases, f)
    return mp.start_processes(_rank, args=(n_data * n_model, workdir, backend,
                                           (n_data, n_model)),
                              nprocs=n_data * n_model, join=False, start_method="spawn")


def finish(ctx, workdir: str, timeout: float = 600.0) -> list:
    """Wait for the ranks of :func:`start` (raising what a rank raised) and
    return rank 0's records."""
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=max(1.0, deadline - time.monotonic())):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"ranks still running after {timeout} s")
    with open(os.path.join(workdir, RESULT_FILE), "rb") as f:
        return pickle.load(f)


# --------------------------------------------------------------------------
# comparisons
# --------------------------------------------------------------------------

def compare_train(got: dict, want: dict, limits: Limits, lr: float,
                  steps: Optional[int] = None) -> dict:
    """A meshed train record against the single-process one (both trained at
    learning rate ``lr``); returns the worst errors and ``failures`` (empty
    when it holds).  ``steps``: hold only the first so many steps' losses
    and gradients (None: every step, and the state after the last)."""
    fails: List[str] = []
    worst = {"loss": 0.0, "grad": 0.0, "grad_median": 0.0, "param": 0.0, "stat": 0.0}
    sure_all: Dict[str, np.ndarray] = {}
    for i, (g, w) in enumerate(list(zip(got["steps"], want["steps"]))[:steps]):
        ranks = g["metrics"]
        if any(m != ranks[0] for m in ranks):
            fails.append(f"step {i}: metrics differ between ranks")
        if not np.array_equal(g["rois"], w["rois"]) or g["n_predicted"] != w["n_predicted"]:
            fails.append(f"step {i}: the global roi batch differs")
        for k, v in w["metrics"][0].items():
            err = abs(ranks[0][k] - v)
            worst["loss"] = max(worst["loss"], err / max(abs(v), 1e-30))
            if not (math.isfinite(ranks[0][k]) and err <= limits.loss_rel * abs(v)
                    + limits.loss_abs):
                fails.append(f"step {i} {k}: {ranks[0][k]} vs {v}")
        rel = {}
        for n, gw in w["grads"].items():
            d = np.abs(g["grads"][n] - gw)
            rel[n] = float(d.max()) / max(float(np.abs(gw).max()), 1e-30)
            sure = np.abs(gw) > 10 * float(d.max()) + 1e-12
            sure_all[n] = sure_all.get(n, np.ones_like(sure)) & sure
            if rel[n] > limits.grad_rel:
                fails.append(f"step {i} gradient of {n}: {rel[n]:.3e} of max |g|")
        med = statistics.median(rel.values())
        worst["grad"] = max(worst["grad"], max(rel.values()))
        worst["grad_median"] = max(worst["grad_median"], med)
        if med > limits.grad_median:
            fails.append(f"step {i}: median gradient error {med:.3e}")
    if steps is not None:
        return {**worst, "failures": fails}
    steps = len(want["steps"])
    pg, pw = got["payload"], want["payload"]
    if sorted(pg) != sorted(pw):
        fails.append("checkpoint payloads hold different keys")
    for key, vw in pw.items():
        if not key.startswith("model/") or key not in pg:
            continue
        name = key[len("model/"):]
        d = np.abs(np.asarray(pg[key], np.float64) - np.asarray(vw, np.float64))
        if name in sure_all:
            sure = sure_all[name]
            d_sure = float(d[sure].max()) if sure.any() else 0.0
            worst["param"] = max(worst["param"], d_sure)
            if d_sure > limits.param_lr * lr + 1e-7 or float(d.max()) > 2 * steps * lr + 1e-7:
                fails.append(f"{name} after {steps} Adam steps: {d_sure:.3e} "
                             f"({float(d.max()):.3e})")
        elif d.size:
            rel = float((d / (1.0 + np.abs(vw))).max())
            worst["stat"] = max(worst["stat"], rel)
            if rel > limits.stat_rel:
                fails.append(f"buffer {name}: {rel:.3e}")
    return {**worst, "failures": fails}


def compare_serve(got: dict, want: dict, limits: Limits, px: float = 5e-2,
                  px_rel: float = 2e-3, candidates: bool = True) -> dict:
    """A meshed serve record against the single-process one: every rank's
    results have each image's box count and texts, corners within ``px``
    (+ ``px_rel`` of the value, the f16 candidate transport's ulp), and
    (``candidates``) the candidate packs hold the same pixels with values
    within the limits."""
    from fots_torch.ops.nms import unpack_candidates

    fails: List[str] = []
    worst_px = 0.0
    want_res = want["results"][0]
    for r, res in enumerate(got["results"]):
        if len(res) != len(want_res):
            fails.append(f"rank {r}: {len(res)} images, want {len(want_res)}")
            continue
        for i, (gi, wi) in enumerate(zip(res, want_res)):
            if [e["text"] for e in gi] != [e["text"] for e in wi]:
                fails.append(f"rank {r} image {i}: texts differ")
                continue
            for e, f in zip(gi, wi):
                d = np.abs(np.asarray(e["box"][:8]) - np.asarray(f["box"][:8]))
                worst_px = max(worst_px, float(d.max()))
                if (d > px + px_rel * np.abs(np.asarray(f["box"][:8]))).any():
                    fails.append(f"rank {r} image {i}: corners differ by {float(d.max())}")
    if not candidates:
        return {"max_corner_px": worst_px, "failures": fails}
    cg, cw = got["cands"], want["cands"]
    tol_abs, tol_rel = limits.cand_abs, limits.cand_rel
    if cg.dtype != np.float32:  # the u16 transport: values are f16, as the corners
        cg, cw = unpack_candidates(cg.view(np.uint16)), unpack_candidates(cw.view(np.uint16))
        tol_abs, tol_rel = px, px_rel
    worst_cand = 0.0
    if cg.shape != cw.shape:
        fails.append(f"candidate packs {cg.shape} vs {cw.shape}")
    else:
        for i in range(cw.shape[0]):
            og, ow = np.argsort(cg[i, 7], kind="stable"), np.argsort(cw[i, 7], kind="stable")
            if not np.array_equal(cg[i, 7, og], cw[i, 7, ow]):
                fails.append(f"image {i}: candidate pixels differ")
                continue
            d = np.abs(cg[i][:, og] - cw[i][:, ow])
            worst_cand = max(worst_cand, float(d.max()))
            if (d > tol_abs + tol_rel * np.abs(cw[i][:, ow])).any():
                fails.append(f"image {i}: candidate values differ by {float(d.max())}")
    return {"max_corner_px": worst_px, "max_candidate_diff": worst_cand, "failures": fails}


def conv11_rows_hold(got: dict, want: dict) -> Optional[str]:
    """None when each rank holds ``full / n_model`` rows of ``conv11`` and
    they are its model shard's rows of the gathered weight (which
    :func:`compare_train` holds to the single-process weight), else what
    differs."""
    full = want["payload"]["model/ocr.conv11.weight"]
    gathered = got["payload"]["model/ocr.conv11.weight"]
    n_model = 1 + max(m for _, m, _ in got["conv11_rows"])
    rows = full.shape[0] // n_model
    for d, m, w in got["conv11_rows"]:
        if w.shape != full[m * rows:(m + 1) * rows].shape:
            return f"rank ({d}, {m}): conv11 rows {w.shape}, want {rows} of {full.shape}"
        if not np.array_equal(w, gathered[m * rows:(m + 1) * rows]):
            return f"rank ({d}, {m}): conv11 rows are not its shard of the gathered weight"
    return None
