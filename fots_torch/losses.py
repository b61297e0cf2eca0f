"""Training losses (PyTorch port of ``fots/losses.py``).

Mask-weighted reductions over fixed-shape maps, as in ``fots``:

- dice loss (negative, about -1 at perfect overlap, as the reference has it);
- angle sin/cos MSE over ground-truth text pixels;
- EAST IoU loss with separate left/right width validity masks;
- combined ``dice + 2 * angle + 0.5 * iou``, plus the 1/8-scale terms
  against align_corners bilinear-resized ground truth (``multi_scale``);
- OHEM cross-entropy in place of dice (``ohem=True``);
- CTC with blank 0, summed over valid, feasible rois and divided by their
  count.  It runs ``F.ctc_loss``; where an alignment is impossible only
  because of repeated characters (label length within the frame count,
  but not with the blanks the repeats need) ``F.ctc_loss`` returns ``inf``
  while optax returns a large finite value (its log-epsilon clamp, about
  1e5 per forbidden transition) that enters the loss.  Those rows go
  through :func:`ctc_loss_optax`, a port of optax's recursion, so the value
  and gradient are optax's.

Under a mesh each reduction takes ``group`` (the data group): every ratio
of sums (dice, the masked means, OHEM's mean over the batch, CTC's sum over
the rois divided by their count) is then formed from sums all-reduced over
the global batch (:func:`fots_torch.parallel.mesh.all_reduce_sum`, whose
gradient is the global batch's too), so each rank computes the loss one
device computes on the whole batch.  Without ``group`` the arithmetic is
unchanged.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from fots_torch.device import to_device_async
from fots_torch.parallel.mesh import all_reduce_sum


def dice_loss(pred, target, group=None):
    """Reference dice: -(2 * I + 1) / (sum + 1)."""
    if group is not None:
        inter, sp, st = all_reduce_sum(torch.stack(
            [torch.sum(pred * target), torch.sum(pred), torch.sum(target)]), group).unbind()
        return -((2.0 * inter + 1.0) / (sp + st + 1.0))
    inter = torch.sum(pred * target)
    return -((2.0 * inter + 1.0) / (torch.sum(pred) + torch.sum(target) + 1.0))


def _masked_mean(x, mask, group=None):
    if group is not None:
        num, cnt = all_reduce_sum(torch.stack([torch.sum(x * mask), torch.sum(mask)]),
                                  group).unbind()
    else:
        num, cnt = torch.sum(x * mask), torch.sum(mask)
    return torch.where(cnt > 0, num / torch.clamp_min(cnt, 1.0),
                       torch.zeros((), dtype=x.dtype, device=x.device))


def iou_loss(geo_gt, mask, geo_pred, group=None):
    """EAST IoU loss; geo [B, H, W, 4] (top, bottom, left, right), mask
    [B, H, W]; the left and right halves under validity masks d3 > 0 and
    d4 > 0."""
    d1_gt, d2_gt, d3_gt, d4_gt = geo_gt.unbind(-1)
    d1_p, d2_p, d3_p, d4_p = geo_pred.unbind(-1)

    def half(dside_gt, dside_p):
        m = mask * (dside_gt > 0).to(mask.dtype)
        area_gt = (d1_gt + d2_gt) * dside_gt
        area_p = (d1_p + d2_p) * dside_p
        w_union = torch.minimum(dside_gt, dside_p)
        h_union = torch.minimum(d1_gt, d1_p) + torch.minimum(d2_gt, d2_p)
        inter = w_union * h_union
        union = area_gt + area_p - inter
        # masked-out pixels are sanitised before the log (poisoned gt
        # distances make union + 1 <= 0 there, and 0 * nan is nan)
        ratio = torch.where(m > 0, (inter + 1.0) / (union + 1.0),
                            torch.ones((), dtype=inter.dtype, device=inter.device))
        return _masked_mean(-torch.log(torch.clamp_min(ratio, 1e-8)), m, group)

    return half(d3_gt, d3_p) + half(d4_gt, d4_p)


def resize_map(x, out_hw):
    """align_corners bilinear resize of an NHWC [B, H, W, C] or a [B, H, W]
    map (``fots.losses._resize_map`` / ``resize_bilinear``)."""
    squeeze = x.ndim == 3
    t = x[:, None] if squeeze else x.permute(0, 3, 1, 2)
    if tuple(t.shape[2:]) != tuple(out_hw):
        t = F.interpolate(t, size=tuple(out_hw), mode="bilinear", align_corners=True)
    return t[:, 0] if squeeze else t.permute(0, 2, 3, 1)


def ohem_score_loss(pred, score_gt, training_mask, n_hard_neg: int = 512, group=None):
    """Per-image OHEM: balanced BCE over every positive pixel plus the
    ``n_hard_neg`` highest-loss negatives (``torch.topk``), averaged over the
    (global) batch."""
    b = pred.shape[0]
    tgt = (score_gt > 0.5).to(pred.dtype)
    m = training_mask.to(pred.dtype)
    p = torch.clamp(pred.float(), 1e-6, 1.0 - 1e-6)
    ce = -(tgt * torch.log(p) + (1.0 - tgt) * torch.log(1.0 - p)) * m
    pos = tgt * m
    neg = (1.0 - tgt) * m
    neg_ce = (ce * neg).reshape(b, -1)
    k = min(n_hard_neg, neg_ce.shape[1])
    hard_neg = torch.topk(neg_ce, k, dim=1).values.sum(-1)
    pos_sum = (ce * pos).reshape(b, -1).sum(-1)
    n_sel = pos.reshape(b, -1).sum(-1) + torch.clamp_max(neg.reshape(b, -1).sum(-1), float(k))
    per_image = (pos_sum + hard_neg) / torch.clamp_min(n_sel, 1.0)
    if group is not None:
        total, count = all_reduce_sum(torch.stack([per_image.sum(), per_image.new_tensor(b)]),
                                      group).unbind()
        return total / count
    return torch.mean(per_image)


def detection_loss(outputs: Dict, score_gt, training_mask, geo_gt, angle_gt,
                   multi_scale: bool = True, ohem: bool = False,
                   group=None) -> Dict[str, torch.Tensor]:
    """Full EAST loss.  outputs: the detector's dict (NHWC lists);
    score_gt / training_mask / angle_gt [B, Hs, Ws]; geo_gt [B, Hs, Ws, 4].
    Returns scalars total, segm, angle, iou; with ``group``, of the global
    batch."""
    segm_p = outputs["segm"][0][..., 0]
    angle_p = outputs["angle"][0]
    geo_p = outputs["rbox"][0]

    def score_fn(p, gt, m):
        return (ohem_score_loss(p, gt, m, group=group) if ohem
                else dice_loss(p * m, gt * m, group))

    segm_loss = score_fn(segm_p, score_gt, training_mask)
    if multi_scale:
        segm_p2 = outputs["segm"][1][..., 0]
        hw2 = segm_p2.shape[1:3]
        segm_loss = segm_loss + score_fn(segm_p2, resize_map(score_gt, hw2),
                                         resize_map(training_mask, hw2))

    byte_mask = (score_gt > 0.5).to(segm_p.dtype)
    angle_loss = (_masked_mean((angle_p[..., 0] - torch.sin(angle_gt)) ** 2, byte_mask, group)
                  + _masked_mean((angle_p[..., 1] - torch.cos(angle_gt)) ** 2, byte_mask,
                                 group))
    box_loss = iou_loss(geo_gt, byte_mask, geo_p, group)

    if multi_scale:
        angle_p2 = outputs["angle"][1]
        geo_p2 = outputs["rbox"][1]
        hw2 = angle_p2.shape[1:3]
        bm2 = (resize_map(score_gt, hw2) > 0.5).to(segm_p.dtype)
        ag2 = resize_map(angle_gt, hw2)
        angle_loss = (angle_loss
                      + _masked_mean((angle_p2[..., 0] - torch.sin(ag2)) ** 2, bm2, group)
                      + _masked_mean((angle_p2[..., 1] - torch.cos(ag2)) ** 2, bm2, group))
        box_loss = box_loss + iou_loss(resize_map(geo_gt, hw2) / 2.0, bm2, geo_p2, group)

    total = segm_loss + angle_loss * 2.0 + 0.5 * box_loss
    return {"total": total, "segm": segm_loss, "angle": angle_loss, "iou": box_loss}


def ctc_loss_optax(log_probs, labels, label_lengths, logit_lengths,
                   log_epsilon: float = -1e5):
    """Per-row CTC loss as ``optax.ctc_loss`` computes it (blank 0): its
    log-space recursion with ``log_epsilon`` standing in for log 0, so an
    impossible alignment costs about ``-log_epsilon`` per forbidden
    transition instead of ``inf``.  log_probs [N, T, K] (optax re-applies
    log_softmax, as here); labels [N, L]; lengths [N].  Python loop over T:
    used only for the rows :func:`ctc_loss` hands it."""
    n, t, _ = log_probs.shape
    lmax = labels.shape[1]
    dev = log_probs.device
    logprobs = F.log_softmax(log_probs, dim=-1)
    labels = labels.long()
    repeat = F.pad((labels[:, :-1] == labels[:, 1:]).to(logprobs.dtype), (0, 1))
    lp_phi = logprobs[:, :, 0].transpose(0, 1)[..., None]                  # [T, N, 1]
    lp_emit = torch.gather(logprobs, 2, labels[:, None, :].expand(n, t, lmax))
    lp_emit = lp_emit.transpose(0, 1)                                      # [T, N, L]
    pad = (torch.arange(t, device=dev)[None, :] >= logit_lengths.to(dev)[:, None])
    pad = pad.to(logprobs.dtype).transpose(0, 1)[..., None]                # [T, N, 1]

    def update_phi(phi, added):
        return torch.cat([phi[:, :1], torch.logaddexp(phi[:, 1:], added)], dim=-1)

    phi = torch.full((n, lmax + 1), log_epsilon, dtype=logprobs.dtype, device=dev)
    phi = torch.cat([torch.zeros_like(phi[:, :1]), phi[:, 1:]], dim=-1)
    emit = torch.full((n, lmax), log_epsilon, dtype=logprobs.dtype, device=dev)
    for i in range(t):
        prev_phi_orig = phi
        prev_phi = update_phi(phi, emit + log_epsilon * repeat)
        next_emit = torch.logaddexp(prev_phi[:, :-1] + lp_emit[i], emit + lp_emit[i])
        next_phi = prev_phi + lp_phi[i]
        next_phi = update_phi(next_phi, emit + lp_phi[i] + log_epsilon * (1.0 - repeat))
        emit = pad[i] * emit + (1.0 - pad[i]) * next_emit
        phi = pad[i] * prev_phi_orig + (1.0 - pad[i]) * next_phi
    phi_last = update_phi(phi, emit)
    return -torch.gather(phi_last, 1, label_lengths.long().to(dev)[:, None])[:, 0]


def repeat_infeasible_rows(labels, label_lengths, logit_lengths) -> np.ndarray:
    """Indices of rows whose label fits the frame count (L <= T) but not
    with the blank each repeated character needs (L + repeats > T): there
    ``F.ctc_loss`` gives ``inf`` and optax a finite value.  Host arrays."""
    labels = np.asarray(labels)
    lengths = np.asarray(label_lengths)
    frames = np.asarray(logit_lengths)
    pos = np.arange(labels.shape[1] - 1)[None, :]
    reps = ((labels[:, 1:] == labels[:, :-1]) & (pos + 1 < lengths[:, None])).sum(1)
    return np.nonzero((lengths <= frames) & (lengths + reps > frames))[0]


def ctc_loss(log_probs, labels, label_lengths, logit_lengths=None, roi_mask=None,
             optax_rows: Optional[np.ndarray] = None, group=None):
    """CTC (blank 0) with warp-ctc's batch-mean reduction over valid rois
    (with ``group``: the sum over every rank's rois over their global count).

    log_probs [N, T, K]; labels [N, L] padded with 0; label_lengths [N];
    logit_lengths [N] frames per row (default T); roi_mask [N] 0/1.  Rows
    with more label symbols than frames are masked out (as ``fots`` does);
    rows impossible only through repeats take optax's value
    (``optax_rows``: their indices, computed here from the lengths when
    None, which reads them to the host)."""
    n, t, _ = log_probs.shape
    dev = log_probs.device
    if logit_lengths is None:
        logit_lengths = torch.full((n,), t, dtype=torch.int64)
    # F.ctc_loss reads the lengths on the host; lengths already there cost
    # no wait for the device
    logit_lengths = logit_lengths.cpu().long()
    label_lengths = label_lengths.cpu().long()
    labels = labels.to(dev).long()
    per_example = F.ctc_loss(log_probs.transpose(0, 1), labels, logit_lengths,
                             label_lengths, blank=0, reduction="none",
                             zero_infinity=True)
    if optax_rows is None:
        optax_rows = repeat_infeasible_rows(labels.cpu().numpy(), label_lengths.numpy(),
                                            logit_lengths.numpy())
    if len(optax_rows):
        idx = torch.as_tensor(np.asarray(optax_rows), dtype=torch.int64)
        fallback = ctc_loss_optax(log_probs[idx.to(dev)], labels[idx.to(dev)],
                                  label_lengths[idx], logit_lengths[idx])
        per_example = per_example.index_put((idx.to(dev),), fallback)
    feasible = to_device_async((label_lengths <= logit_lengths).to(log_probs.dtype), dev)
    if roi_mask is None:
        roi_mask = torch.ones((n,), dtype=log_probs.dtype, device=dev)
    roi_mask = roi_mask.to(dev).to(log_probs.dtype) * feasible
    if group is not None:
        num, cnt = all_reduce_sum(torch.stack([torch.sum(per_example * roi_mask),
                                               torch.sum(roi_mask)]), group).unbind()
        return num / torch.clamp_min(cnt, 1.0)
    cnt = torch.clamp_min(torch.sum(roi_mask), 1.0)
    return torch.sum(per_example * roi_mask) / cnt
