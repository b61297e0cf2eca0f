"""Deciding ``correct`` for a training cell: the program's first three
steps against the plain reference's, from the same weights, batches and
dropout draws.

The reference runs the three steps in float32 with TF32 off (or, for the
control, with bf16 convolutions): forward with the batch's BatchNorm
statistics and channel dropout (uniforms drawn on the CPU from the
trainer's seed, in the network's order), the EAST losses, RoIRotate of
the shared features over the step's rois, the recognition head with
masked instance norm, CTC over the step's frame window, backward and
Adam.  The rois of the first step come from the ground truth alone, and
the reference samples them itself; those of steps 2 and 3 are sampled by
the program from its own predictions of the step before, and the
reference takes them as the program recorded them (``PERF.md`` says why).

Numbers compared:

- ``roi_start``: entries of the first step's rois that differ from the
  reference's own sampling (exact);
- ``map_gap``: the largest, over the first step's maps (the model
  module's ``MAPS``: here segm, rbox and angle at 1/4 and 1/8 scale, and
  the shared features focr), of the norm of the program's map less the
  reference's over the reference's norm;
  ``logp_gap`` the same of the first step's recognition log-probs (the
  valid rois, the CTC frame window);
- ``loss_gap``: the largest relative gap over the four loss terms (dice,
  angle, IoU, CTC) of the three steps, and ``loss1_gap`` the first step's;
- ``grad_gap``: over leaves, the largest gap between the norms of the
  first gradient (the program's worked out from Adam's first moment after
  one step), over the larger of the reference leaf's norm and the median
  leaf's; ``grad_median_gap`` the median leaf's gap;
- ``update_gap`` and ``update_median_gap``: the same of the parameters'
  change after three steps.

Leaves whose first reference gradient is under a thousandth of the median
leaf's are left out of the leaf gaps (their change is round-off).

The architecture comes from the cell's model module (``Cell.model``): its
reference net, its maps and its pooled height.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

from gpubench.common import Cell, Check
from gpubench.reference import ops as R
from gpubench.reference.detector import Dropouts, oihw

TERMS = ("loss", "segm_loss", "angle_loss", "iou_loss", "ctc_loss")
#: the terms the loss gaps compare: the total is their weighted sum, and
#: near 0 (dice near -2 against the others) its relative gap is the noise
#: of a difference
COMPARED_TERMS = TERMS[1:]
MAX_ROIS, MAX_LABEL = 32, 64
TRAIN_BUCKETS = (256, 512)
DUMMY_ROI = (0.0, 8.0, 8.0, 8.0, 8.0, 0.0)


def gt_rois(rng: np.random.Generator, rows, alphabet: str, im_hw):
    """The first step's rois (no predictions yet): per image with words,
    one height jitter drawn in [-2, 2]; every word not marked '##' and
    inside the image, as (image, centre, height + jitter, width, angle in
    degrees), at most 32, padded with a dummy roi.  Returns (rois [32, 6]
    f32, labels [32, 64] i32, lengths [32], mask [32])."""
    H, W = im_hw
    rois, words = [], []
    for bid, r in enumerate(rows):
        if not len(r.gt_quads):
            continue
        g = np.asarray(r.gt_quads, np.float64)
        center = g.mean(axis=1)
        w_all = np.sqrt(((g[:, 2] - g[:, 1]) ** 2).sum(-1))
        h_all = np.sqrt(((g[:, 1] - g[:, 0]) ** 2).sum(-1)) + int(rng.integers(-2, 3))
        ang = (np.arctan2(g[:, 2, 1] - g[:, 1, 1], g[:, 2, 0] - g[:, 1, 0])
               + np.arctan2(g[:, 3, 1] - g[:, 0, 1], g[:, 3, 0] - g[:, 0, 0])) / 2
        for i, text in enumerate(r.labels):
            if text.startswith("##"):
                continue
            if g[i][:, 0].max() > W or g[i][:, 1].max() > H or g[i].min() < 0:
                continue
            if h_all[i] <= 0 or w_all[i] <= 0:
                continue
            rois.append([bid, center[i][0], center[i][1], h_all[i], w_all[i],
                         -ang[i] / math.pi * 180.0])
            words.append(text)
    rois, words = rois[:MAX_ROIS], words[:MAX_ROIS]
    out = np.tile(np.asarray(DUMMY_ROI, np.float32), (MAX_ROIS, 1))
    mask = np.zeros(MAX_ROIS, np.float32)
    labels = np.zeros((MAX_ROIS, MAX_LABEL), np.int32)
    lengths = np.zeros(MAX_ROIS, np.int32)
    index = {ch: i + 1 for i, ch in enumerate(alphabet)}
    for k, (roi, text) in enumerate(zip(rois, words)):
        out[k] = np.asarray(roi, np.float32)
        mask[k] = 1.0
        ids = [index[c] for c in text if c in index][:MAX_LABEL]
        labels[k, :len(ids)] = ids
        lengths[k] = len(ids)
    return out, labels, lengths, mask


def strip_width(model, rois, mask) -> int:
    """The step's strip bucket: the model's pooled height times the largest
    aspect, rounded up to 256 or 512."""
    valid = mask > 0
    ratio = (rois[valid, 4] / np.maximum(rois[valid, 3], 1e-6)).max() if valid.any() else 1.0
    need = int(math.ceil(model.POOLED_HEIGHT * float(ratio)))
    return next((b for b in TRAIN_BUCKETS if need <= b), TRAIN_BUCKETS[-1])


def frame_count(model, rois, mask, width: int) -> int:
    """The CTC frame window: ceil(the model's pooled height times the
    largest aspect of the valid rois), in [1, width] (f32 arithmetic)."""
    r = rois.astype(np.float32)
    aspect = np.where(mask > 0, r[:, 4] / np.maximum(r[:, 3], np.float32(1e-6)), np.float32(0))
    return int(np.clip(np.ceil(np.float32(model.POOLED_HEIGHT) * aspect.max()), 1.0,
                       float(width)))


class Steps(NamedTuple):
    """A side's first steps: the loss terms of each, the first gradient and
    the change after the steps by leaf, and the first step's maps (the
    model's ``MAPS`` and ``logp``, the recognition log-probs [rois, W,
    nclass]) on the host."""

    losses: list
    grad1: Dict[str, torch.Tensor]
    change: Dict[str, torch.Tensor]
    maps: Dict[str, torch.Tensor]


def step_losses(model, net, rows, roi: dict, drop: Dropouts, multi_scale: bool, device):
    """The five loss terms of one step of ``net`` (the reference of the
    model module ``model``; a dict of scalars), and its maps (the model's
    ``MAPS`` and ``logp``)."""
    images = torch.from_numpy(np.stack([r.image for r in rows])).to(device).float() / 128.0 - 1.0
    score = torch.from_numpy(np.stack([r.score for r in rows])).to(device)
    mask = torch.from_numpy(np.stack([r.mask for r in rows])).to(device).float()
    geo = torch.from_numpy(np.stack([r.geo for r in rows])).to(device)
    out = net.forward(images, drop)
    segm, angle, iou = R.detection_losses(out, score, mask, geo[..., :4].permute(0, 3, 1, 2),
                                          geo[..., 4], multi_scale)
    rois = torch.from_numpy(roi["rois"]).to(device)
    width = strip_width(model, roi["rois"], roi["mask"])
    frames = frame_count(model, roi["rois"], roi["mask"], width)
    strips = R.rroi_align(out["focr"], rois, model.POOLED_HEIGHT, width)
    logp = net.recognize(strips, R.valid_width(rois, model.POOLED_HEIGHT, width), drop)
    lengths = torch.from_numpy(roi["lengths"]).long()
    per_row = R.ctc_loss(logp, torch.from_numpy(roi["labels"]), lengths, frames)
    keep = torch.from_numpy(roi["mask"]).to(device) * (lengths <= frames).float().to(device)
    ctc = (per_row * keep).sum() / keep.sum().clamp_min(1.0)
    total = segm + 2.0 * angle + 0.5 * iou + ctc
    # the draw the program makes after the step (its roi candidates' priorities)
    torch.rand((len(rows), score.shape[1] * score.shape[2]), generator=drop.generator)
    terms = {"loss": total, "segm_loss": segm, "angle_loss": angle, "iou_loss": iou,
             "ctc_loss": ctc}
    return terms, {**{k: out[k] for k in model.MAPS}, "logp": logp}


def reference_steps(cell: Cell, flat, pool, rois, seed: int, device, precision: str = "f32",
                    steps: int = 3):
    """The reference's :class:`Steps` (CPU tensors) over the cell's
    configuration, at its traffic's learning rate."""
    cfg, model = cell.config, cell.model
    with _no_tf32():
        p = oihw({k: torch.tensor(np.asarray(v), dtype=torch.float32, device=device)
                  for k, v in flat.items()})
        trainable = {k: v.requires_grad_(True) for k, v in p.items() if k.startswith("params/")}
        start = {k: v.detach().clone() for k, v in trainable.items()}
        net = model.reference(cfg, p, precision, train=True)
        drop = Dropouts(torch.Generator().manual_seed(abs(int(seed)) % (1 << 63)))
        adam = R.Adam(trainable, cell.traffic["lr"])
        losses, grad1, maps = [], {}, {}
        for s in range(steps):
            terms, seen = step_losses(model, net, pool[s], rois[s], drop, cfg["multi_scale"],
                                      device)
            grads = torch.autograd.grad(terms["loss"], list(trainable.values()))
            grads = dict(zip(trainable, grads))
            if s == 0:
                grad1 = {k: g.detach().cpu() for k, g in grads.items()}
                maps = {k: v.detach().float().cpu() for k, v in seen.items()}
            del seen
            losses.append({k: float(v.detach()) for k, v in terms.items()})
            adam.step(trainable, grads)
        change = {k: (v.detach() - start[k]).cpu() for k, v in trainable.items()}
    return Steps(losses, grad1, change, maps)


def _norms(leaves: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(v.norm()) for k, v in leaves.items()}


def leaf_gap(prog: Dict[str, float], ref: Dict[str, float], ref_grad: Dict[str, float]):
    """(worst leaf's gap of norms, that leaf) over the leaves that count: the
    gap over the larger of the reference leaf's norm and the median leaf's."""
    med = float(np.median(list(ref_grad.values())))
    med_ref = float(np.median(list(ref.values())))
    worst, leaf = 0.0, ""
    for k, r in ref.items():
        if ref_grad[k] < 1e-3 * med:
            continue
        g = abs(prog[k] - r) / max(r, med_ref, 1e-30)
        if g > worst:
            worst, leaf = g, k
    return worst, leaf


def median_gap(prog: Dict[str, float], ref: Dict[str, float], ref_grad: Dict[str, float]):
    """The median over the leaves that count of each leaf's relative gap of
    norms."""
    med = float(np.median(list(ref_grad.values())))
    gaps = [abs(prog[k] - r) / max(r, 1e-30) for k, r in ref.items() if ref_grad[k] >= 1e-3 * med]
    return float(np.median(gaps))


def diff_median(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
                ref_grad: Dict[str, float]) -> float:
    """The median over the leaves that count of the norm of the difference
    over the larger of the reference leaf's norm and the median leaf's."""
    norms = _norms(ref)
    med, med_ref = float(np.median(list(ref_grad.values()))), float(np.median(list(norms.values())))
    return float(np.median([float((prog[k] - r).norm()) / max(norms[k], med_ref, 1e-30)
                            for k, r in ref.items() if ref_grad[k] >= 1e-3 * med]))


def _rel_norm(p: torch.Tensor, r: torch.Tensor) -> float:
    return float((p.double() - r.double()).norm() / r.double().norm().clamp_min(1e-30))


def map_gaps(model, prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor], roi1: dict):
    """Each first-step map's (the model's ``MAPS``) norm of the difference
    over the reference's norm; the log-probs over the valid rois and the
    CTC frame window of the first step's rois ``roi1``.  A map the program
    did not give reads inf."""
    gaps = {k: (_rel_norm(prog[k], ref[k]) if k in prog and prog[k].shape == ref[k].shape
                else float("inf")) for k in model.MAPS}
    rows = torch.from_numpy(roi1["mask"] > 0)
    frames = frame_count(model, roi1["rois"], roi1["mask"],
                         strip_width(model, roi1["rois"], roi1["mask"]))
    p, r = prog.get("logp"), ref["logp"]
    ok = p is not None and p.shape == r.shape
    gaps["logp"] = _rel_norm(p[rows, :frames], r[rows, :frames]) if ok else float("inf")
    return gaps


def numbers(model, prog: Steps, ref: Steps, roi1: dict):
    """The gaps of the program's (or the control's) first steps from the
    reference's (of the model module ``model``); ``roi1`` the first step's
    rois.  Beside the gaps of norms, the median leaf's norm of the
    difference."""
    def rel(p, r, t):
        return abs(p[t] - r[t]) / max(abs(r[t]), 1e-6)

    prog_losses, prog_grad, prog_change = prog.losses, prog.grad1, prog.change
    ref_losses, ref_grad, ref_change = ref.losses, ref.grad1, ref.change

    steps = min(len(prog_losses), len(ref_losses))
    loss_gap = max((rel(prog_losses[s], ref_losses[s], t) for s in range(steps)
                    for t in COMPARED_TERMS), default=float("inf"))
    if len(prog_losses) < len(ref_losses):
        loss_gap = float("inf")
    pg, rg, pc, rc = (_norms(d) for d in (prog_grad, ref_grad, prog_change, ref_change))
    grad_gap, grad_leaf = leaf_gap(pg, rg, rg)
    update_gap, update_leaf = leaf_gap(pc, rc, rg)
    loss1_gap = max((rel(prog_losses[0], ref_losses[0], t) for t in COMPARED_TERMS),
                    default=float("inf")) if steps else float("inf")
    gaps = map_gaps(model, prog.maps, ref.maps, roi1)
    logp_gap = gaps.pop("logp")
    return {"map_gap": max(gaps.values()), "logp_gap": logp_gap,
            **{f"map_gap.{k}": v for k, v in gaps.items()},
            "loss_gap": loss_gap, "grad_gap": grad_gap, "update_gap": update_gap,
            "loss1_gap": loss1_gap, "grad_median_gap": median_gap(pg, rg, rg),
            "update_median_gap": median_gap(pc, rc, rg),
            "grad_diff_median": diff_median(prog_grad, ref_grad, rg),
            "update_diff_median": diff_median(prog_change, ref_change, rg),
            "grad_leaf": grad_leaf, "update_leaf": update_leaf}


def check(cell: Cell, seed: int, flat, pool, rois, prog: Steps, device) -> Check:
    tr, cfg = cell.traffic, cell.config
    chk = Check()
    rng = np.random.default_rng(abs(int(seed)) % (1 << 63))
    start = gt_rois(rng, pool[0], cfg["alphabet"], pool[0][0].image.shape[:2])
    got = rois[0]
    roi_start = int((start[0] != got["rois"]).sum() + (start[1] != got["labels"]).sum()
                    + (start[2] != got["lengths"]).sum() + (start[3] != got["mask"]).sum())
    ref = reference_steps(cell, flat, pool, rois, seed, device)
    nums = numbers(cell.model, prog, ref, rois[0])
    nums["roi_start"] = roi_start
    for name, limit in tr["limits"].items():
        chk.add(name, nums[name], limit)
    chk.notes = {**nums, "losses": prog.losses, "ref_losses": ref.losses}
    return chk


def step_flops(cell: Cell, run: dict, device) -> float:
    """FLOPs of one training step (forward and backward) at the cell's batch,
    image size and a batch of 32 rois at the narrower strip bucket, counted
    over the reference."""
    b, (h, w) = run["batch"], run["shape"]
    cfg, model = cell.config, cell.model
    p = oihw({k: torch.zeros(s, device=device) for k, s in model.param_shapes(cfg).items()})
    for k, v in p.items():
        if k.startswith("params/"):
            v.requires_grad_(True)
    net = model.reference(cfg, p, train=True)
    counter = FlopCounterMode(display=False)
    with counter:
        out = net.forward(torch.zeros((b, h, w, 3), device=device))
        rois = torch.tensor([[0, w / 2, h / 2, 32.0, 256.0, 0.0]] * MAX_ROIS, device=device)
        logp = net.recognize(R.rroi_align(out["focr"], rois, model.POOLED_HEIGHT,
                                          TRAIN_BUCKETS[0]))
        loss = sum(t.float().mean() for t in (out["segm"], out["rbox"], out["angle"], logp))
        loss.backward()
    return float(counter.get_total_flops())


class _no_tf32:
    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self.saved
