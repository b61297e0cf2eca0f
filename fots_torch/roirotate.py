"""Training-time RoIRotate sampling: predictions + ground truth -> one
fixed-shape roi batch (host, NumPy).

Port of ``fots/roirotate.py`` with the same filters, in the same order, and
the same draws from the caller's ``np.random.Generator`` (so one seed gives
one ``RoiBatch`` in both packages):

- up to 100 random predicted text pixels (score > 0.5 inside ground-truth
  text), from the device's candidate pack (``fots_torch.train.
  extract_roi_candidates``) or from full prediction maps;
- at most 3 crops per word; '##' words skipped; word height >= 10 px; the
  word inside the image (both axes compared with the image *width*, as the
  reference does); predicted-vs-ground-truth angle error < pi/16;
  axis-aligned IoU >= 0.9; height ratio >= 0.5;
- every valid ground-truth box appended (height jittered by -2..2 px);
  the batch capped at ``MAX_ROIS``.

``cv2.boxPoints`` / ``cv2.boundingRect`` become
:func:`fots_torch.geometry.box_points` / :func:`bounding_rect` (the card's
machine has no OpenCV): the same float32 arithmetic, so the same integer
rectangles.

Under a mesh every rank samples the same batch from the global host batch
(and the all-gathered candidates) with the same generator, then
:func:`shard_rois` keeps the rois of its own images.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np

from fots_torch.codec import LabelCodec
from fots_torch.geometry import box_points
from fots_torch.ops.rroi_align import width_bucket

MAX_ROIS = 32
MAX_LABEL_LEN = 64
POOLED_HEIGHT = 11
#: strip widths of the training step; the CTC frame window is the
#: reference's ceil(11 * max aspect) inside the bucket, so the bucket only
#: costs masked frames (see ``fots_torch.train``)
TRAIN_STRIP_BUCKETS = (256, 512)
#: padding slots of a roi batch (masked out downstream)
DUMMY_ROI = (0.0, 8.0, 8.0, 8.0, 8.0, 0.0)


@dataclass
class RoiBatch:
    rois: np.ndarray           # [MAX_ROIS, 6] float32 (padded)
    labels: np.ndarray         # [MAX_ROIS, MAX_LABEL_LEN] int32
    label_lengths: np.ndarray  # [MAX_ROIS] int32
    roi_mask: np.ndarray       # [MAX_ROIS] float32, 1 = valid
    strip_width: int           # pooled width bucket
    n_predicted: int           # rois sampled from predictions
    n_gt: int                  # rois from ground-truth quads


def bounding_rect(pts: np.ndarray):
    """``cv2.boundingRect`` of float points: (x, y, w, h) with floored
    corners and the exclusive right/bottom edge (+1)."""
    x0, y0 = (int(math.floor(v)) for v in pts.min(axis=0))
    x1, y1 = (int(math.floor(v)) for v in pts.max(axis=0))
    return x0, y0, x1 - x0 + 1, y1 - y0 + 1


def _axis_iou(a, b):
    r0, c0 = max(a[0], b[0]), max(a[1], b[1])
    r1, c1 = min(a[2], b[2]), min(a[3], b[3])
    inter = (r1 - r0) * (c1 - c0) if (r1 > r0 and c1 > c0) else 0.0
    u = (min(a[0], b[0]), min(a[1], b[1]), max(a[2], b[2]), max(a[3], b[3]))
    union = (u[2] - u[0]) * (u[3] - u[1])
    return inter / float(union) if union > 0 else 0.0


def _predicted_rois(rng, cand, gt_idxs_b, gts, lbs, W, bid, rrois, texts):
    """Walk up to 100 random candidates of image ``bid``; append the rois
    that pass every filter.  Returns how many were appended."""
    ys_c, xs_c, geo_c, sin_c, cos_c = cand
    order = rng.permutation(len(ys_c))[: min(len(ys_c), 100)]
    counts: dict = {}
    n_pred = 0
    for k in order:
        y, x = int(ys_c[k]), int(xs_c[k])
        gt_id = int(gt_idxs_b[y, x])
        if gt_id < 0 or gt_id >= len(gts):
            continue
        counts.setdefault(gt_id, 0)
        if counts[gt_id] > 2:
            continue
        gt = np.asarray(gts[gt_id])
        gt_txt = lbs[gt_id]
        if gt_txt.startswith("##"):
            continue
        dh = gt[1] - gt[0]
        h_gt = math.hypot(dh[0], dh[1])
        if h_gt < 10:
            continue
        # both axes compared with the image width, as the reference does
        if gt[:, 0].max() > W or gt[:, 1].max() > W:
            continue
        angle = math.atan2(float(sin_c[k]), float(cos_c[k]))
        angle_gt = (math.atan2(gt[2][1] - gt[1][1], gt[2][0] - gt[1][0])
                    + math.atan2(gt[3][1] - gt[0][1], gt[3][0] - gt[0][0])) / 2
        if math.fabs(angle_gt - angle) > math.pi / 16:
            continue
        off = geo_c[k]
        yp, xp = y + 0.25, x + 0.25
        pos_g = np.array([(xp - off[0] * math.sin(angle)) * 4,
                          (yp - off[0] * math.cos(angle)) * 4])
        pos_g2 = np.array([(xp + off[1] * math.sin(angle)) * 4,
                           (yp + off[1] * math.cos(angle)) * 4])
        pos_r = np.array([(xp - off[2] * math.cos(angle)) * 4,
                          (yp - off[2] * math.sin(angle)) * 4])
        pos_r2 = np.array([(xp + off[3] * math.cos(angle)) * 4,
                           (yp + off[3] * math.sin(angle)) * 4])
        center = (pos_g + pos_g2 + pos_r + pos_r2) / 2 - [4 * x, 4 * y]
        dw = pos_r - pos_r2
        dhv = pos_g - pos_g2
        w_box = math.hypot(dw[0], dw[1])
        h_box = math.hypot(dhv[0], dhv[1])
        bb = bounding_rect(box_points(center, (w_box, h_box), angle * 180 / math.pi))
        pred_bbox = [bb[0], bb[1], bb[0] + bb[2], bb[1] + bb[3]]
        gt_bbox = [gt[:, 0].min(), gt[:, 1].min(), gt[:, 0].max(), gt[:, 1].max()]
        if _axis_iou(pred_bbox, gt_bbox) < 0.9:
            continue
        if min(h_box, h_gt) / max(h_box, h_gt) < 0.5:
            continue
        rrois.append([bid, center[0], center[1], h_box, w_box, -angle / math.pi * 180.0])
        texts.append(gt_txt)
        counts[gt_id] += 1
        n_pred += 1
    return n_pred


def sample_rois(
    rng: np.random.Generator,
    score_maps: np.ndarray,       # [B, hs, ws] ground-truth score
    gt_idxs: np.ndarray,          # [B, hs, ws] pixel -> word index
    gt_quads: Sequence[Sequence[np.ndarray]],
    labels: Sequence[Sequence[str]],
    im_hw,
    codec: LabelCodec,
    segm_pred: Optional[np.ndarray] = None,   # [B, hs, ws] predictions
    geo_pred: Optional[np.ndarray] = None,    # [B, hs, ws, 4]
    angle_pred: Optional[np.ndarray] = None,  # [B, hs, ws, 2] (sin, cos)
    max_rois: int = MAX_ROIS,
    jitter: bool = True,
    pred_candidates: Optional[np.ndarray] = None,  # [B, 8, K] packed rows
    pred_map_hw=None,                              # (hs, ws) of the candidates
) -> RoiBatch:
    """One fixed-shape roi batch for the whole image batch.  Predicted
    pixels come from ``pred_candidates`` (rows ``(score, d0..d3, sin, cos,
    flat_idx)``, invalid slots with score <= 0) or from full prediction
    maps; without either, only ground-truth rois."""
    H, W = im_hw
    rrois: List[List[float]] = []
    texts: List[str] = []
    n_pred = 0
    n_gt = 0
    for bid in range(score_maps.shape[0]):
        gts = gt_quads[bid]
        lbs = labels[bid]
        cand = None  # (ys, xs, geo rows [n, 4], sin [n], cos [n])
        if pred_candidates is not None and len(gts) > 0:
            rows = np.asarray(pred_candidates[bid]).T      # [K, 8]
            rows = rows[rows[:, 0] > 0]
            if rows.shape[0]:
                flat = rows[:, 7].astype(np.int64)
                cand = (flat // pred_map_hw[1], flat % pred_map_hw[1],
                        rows[:, 1:5], rows[:, 5], rows[:, 6])
        elif (segm_pred is not None and geo_pred is not None
                and angle_pred is not None and len(gts) > 0):
            to_walk = segm_pred[bid] * score_maps[bid] * (segm_pred[bid] > 0.5)
            ys, xs = np.nonzero(to_walk > 0)
            if ys.size:
                cand = (ys, xs, geo_pred[bid, ys, xs],
                        angle_pred[bid, ys, xs, 0], angle_pred[bid, ys, xs, 1])
        if cand is not None:
            n_pred += _predicted_rois(rng, cand, gt_idxs[bid], gts, lbs, W, bid,
                                      rrois, texts)

        if len(gts) > 0:  # every valid ground-truth box
            g = np.asarray(gts, dtype=np.float64)
            center = g.mean(axis=1)
            dw = g[:, 2, :] - g[:, 1, :]
            dh = g[:, 1, :] - g[:, 0, :]
            w_all = np.sqrt((dw ** 2).sum(-1))
            h_all = np.sqrt((dh ** 2).sum(-1))
            if jitter:
                h_all = h_all + int(rng.integers(-2, 3))
            ang = (np.arctan2(g[:, 2, 1] - g[:, 1, 1], g[:, 2, 0] - g[:, 1, 0])
                   + np.arctan2(g[:, 3, 1] - g[:, 0, 1], g[:, 3, 0] - g[:, 0, 0])) / 2
            ang_deg = -ang / math.pi * 180.0
            for gi in range(len(gts)):
                if lbs[gi].startswith("##"):
                    continue
                gt = np.asarray(gts[gi])
                if gt[:, 0].max() > W or gt[:, 1].max() > H or gt.min() < 0:
                    continue
                if h_all[gi] <= 0 or w_all[gi] <= 0:
                    continue
                rrois.append([bid, center[gi][0], center[gi][1], h_all[gi], w_all[gi],
                              ang_deg[gi]])
                texts.append(lbs[gi])
                n_gt += 1

    rrois, texts = rrois[:max_rois], texts[:max_rois]
    rois_arr = np.zeros((max_rois, 6), np.float32)
    mask = np.zeros((max_rois,), np.float32)
    n = len(rrois)
    if n:
        rois_arr[:n] = np.asarray(rrois, np.float32)
        mask[:n] = 1.0
        ratio = (rois_arr[:n, 4] / np.maximum(rois_arr[:n, 3], 1e-6)).max()
        width = width_bucket(int(math.ceil(POOLED_HEIGHT * float(ratio))),
                             buckets=TRAIN_STRIP_BUCKETS)
    else:
        width = width_bucket(POOLED_HEIGHT, buckets=TRAIN_STRIP_BUCKETS)
    rois_arr[n:] = DUMMY_ROI
    labels_mat, lengths = codec.encode_padded(texts + [""] * (max_rois - n), MAX_LABEL_LEN)
    lengths[n:] = 0
    return RoiBatch(rois=rois_arr, labels=labels_mat, label_lengths=lengths, roi_mask=mask,
                    strip_width=int(width), n_predicted=n_pred, n_gt=n_gt)


def shard_rois(roi_batch: RoiBatch, rows: slice):
    """The valid rois of images ``rows`` (a rank's slice of the global batch)
    with their batch index counted from the slice's start, as a
    :class:`RoiBatch` of that many slots (``strip_width`` and the counts
    stay the global batch's), and their indices in ``roi_batch``.  A rank
    whose images hold no roi gets one masked :data:`DUMMY_ROI` (index: the
    first masked slot, or 0), so every rank runs the recognizer."""
    bid = roi_batch.rois[:, 0]
    keep = np.nonzero((roi_batch.roi_mask > 0) & (bid >= rows.start) & (bid < rows.stop))[0]
    if keep.size:
        rois = roi_batch.rois[keep].copy()
        rois[:, 0] -= rows.start
        mask = roi_batch.roi_mask[keep]
        labels, lengths = roi_batch.labels[keep], roi_batch.label_lengths[keep]
    else:
        free = np.nonzero(roi_batch.roi_mask <= 0)[0]
        keep = free[:1] if free.size else np.zeros((1,), np.int64)
        rois = np.asarray([DUMMY_ROI], np.float32)
        mask = np.zeros((1,), np.float32)
        labels = np.zeros((1, roi_batch.labels.shape[1]), roi_batch.labels.dtype)
        lengths = np.zeros((1,), roi_batch.label_lengths.dtype)
    return RoiBatch(rois=rois, labels=labels, label_lengths=lengths, roi_mask=mask,
                    strip_width=roi_batch.strip_width, n_predicted=roi_batch.n_predicted,
                    n_gt=roi_batch.n_gt), keep
