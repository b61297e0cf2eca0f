"""Deciding ``correct`` for a serving cell: the served boxes and texts of a
sample of the window's batches against the plain reference.

The reference letterboxes the same frames, runs the detector (the
reference of the cell's model module), decodes and merges the boxes and
reads each box's text, all in float32 with TF32 off (or in a lower
precision, for the control).  Three numbers are compared:

- ``text_gap``: over every served box, the log-probability of the
  reference's best frame path at that box less that of its best path that
  reads the served text (0 where the texts agree; nats);
- ``text_mismatch``: the share of served boxes whose text is not the one
  the reference reads at that box;
- ``box_unmatched``: the share of boxes, served and reference, with no box
  of the other side at IoU 0.5 or more (reference boxes count where their
  text is not empty, as served boxes do);
- ``box_iou_gap``: 1 - IoU of the worst matched pair;
- ``box_area_gap``: over frames, the mean 1 - IoU of the area the served
  boxes cover and the area the reference boxes with text cover (indifferent
  to whether a text line comes as one box or two, and 1 on a frame where one
  side has boxes and the other none).
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from gpubench.common import Cell
from gpubench.reference import ops as R
from gpubench.reference.detector import oihw


def letterbox(frames_u8: np.ndarray, serve_hw, device) -> torch.Tensor:
    """Frames [B, h, w, 3] u8 -> [B, H, W, 3] f32 (x/128 - 1): bilinear
    resize (half-pixel centres) by the smaller of the two ratios into the
    top-left corner, the rest at the background value -1."""
    H, W = serve_hw
    x = torch.from_numpy(frames_u8).to(device).permute(0, 3, 1, 2).float()
    h0, w0 = x.shape[2:]
    s = min(H / h0, W / w0)
    nh, nw = int(h0 * s), int(w0 * s)
    x = F.interpolate(x, size=(nh, nw), mode="bilinear", align_corners=False) / 128.0 - 1.0
    x = F.pad(x, (0, W - nw, 0, H - nh), value=-1.0)
    return x.permute(0, 2, 3, 1), s


def _rois_by_width(boxes: Sequence[np.ndarray], pooled_h: int, buckets) -> Dict[int, list]:
    """{strip width: [(image, box index, roi)]} of every box."""
    out: Dict[int, list] = {}
    for i, bx in enumerate(boxes):
        for j in range(len(bx)):
            roi, w, h = R.roi_of_box(bx[j], i)
            out.setdefault(R.strip_width(w, h, pooled_h, buckets), []).append((i, j, roi))
    return out


def reference_pass(cell: Cell, params: Dict[str, torch.Tensor], frames_u8: np.ndarray,
                   precision: str = "f32", extra_boxes=None, chunk: int = 8,
                   roi_chunk: int = 64, device="cuda", thresh: float = 0.5):
    """The reference of the cell's configuration over frames [N, h, w, 3]
    u8 at its traffic's serving size, ``chunk`` frames at a time.  Returns,
    per frame, its boxes [M, 9] in serving pixels and their texts, and the
    log-probs [W, K] (f64, NumPy) at each of ``extra_boxes[i]`` (boxes in
    serving pixels).  An image's NMS takes at most the traffic's
    ``max_candidates`` pixels above the threshold (0: all)."""
    cfg, model = cell.config, cell.model
    serve_hw, max_candidates = tuple(cell.traffic["serve_hw"]), cell.traffic["max_candidates"]
    buckets, alphabet, ph = tuple(cfg["strip_buckets"]), cfg["alphabet"], model.POOLED_HEIGHT
    net = model.reference(cfg, params, precision)
    n = len(frames_u8)
    boxes: List[np.ndarray] = []
    texts: List[List[str]] = []
    extra_logp: List[List[np.ndarray]] = []
    for c0 in range(0, n, chunk):
        x, _ = letterbox(frames_u8[c0:c0 + chunk], serve_hw, device)
        with torch.no_grad():
            out = net.forward(x)
            segm = out["segm"][:, 0].float().cpu().numpy()
            rbox = out["rbox"].permute(0, 2, 3, 1).float().cpu().numpy()
            angle = out["angle"].permute(0, 2, 3, 1).float().cpu().numpy()
            own = []
            for k in range(x.shape[0]):
                q, s, pr, xs, ys = R.decode_pixels(segm[k], rbox[k], angle[k], thresh,
                                                   max_candidates)
                own.append(R.locality_aware_nms(q, s, pr, xs, ys, segm.shape[2]))
            extra = [np.zeros((0, 9))] * x.shape[0] if extra_boxes is None else \
                [np.asarray(b, np.float64).reshape(-1, 9) if len(b) else np.zeros((0, 9))
                 for b in extra_boxes[c0:c0 + chunk]]
            both = [np.concatenate([own[k], extra[k]]) for k in range(x.shape[0])]
            logps: Dict[tuple, np.ndarray] = {}
            for width, items in sorted(_rois_by_width(both, ph, buckets).items()):
                for r0 in range(0, len(items), roi_chunk):
                    part = items[r0:r0 + roi_chunk]
                    rois = torch.tensor([it[2] for it in part], dtype=torch.float32, device=device)
                    strips = R.rroi_align(out["focr"], rois, ph, width)
                    lp = net.recognize(strips, R.valid_width(rois, ph, width))
                    lp = lp.double().cpu().numpy()
                    for (i, j, _), row in zip(part, lp):
                        logps[(i, j)] = row
        for k in range(x.shape[0]):
            m = len(own[k])
            boxes.append(own[k])
            texts.append([decode(logps[(k, j)], alphabet) for j in range(m)])
            extra_logp.append([logps[(k, m + j)] for j in range(len(extra[k]))])
        del out
    return boxes, texts, extra_logp


def decode(logp: np.ndarray, alphabet: str) -> str:
    """Greedy CTC text of log-probs [W, K]."""
    best = logp.argmax(-1)
    chars, prev = [], -1
    for t in best:
        if t != prev and t != 0:
            chars.append(alphabet[t - 1])
        prev = t
    return "".join(chars)


def text_gap(logp: np.ndarray, text: str, alphabet: str) -> float:
    """Best-path log-probability of ``logp`` [W, K] less that of its best
    path reading ``text`` (inf where none does)."""
    index = {ch: i + 1 for i, ch in enumerate(alphabet)}
    if any(ch not in index for ch in text):
        return float("inf")
    best = float(logp.max(-1).sum())
    return best - R.best_alignment(logp, [index[ch] for ch in text])


def _quad(b):
    return [tuple(p) for p in np.asarray(b[:8], np.float64).reshape(4, 2)]


def compare(served_boxes, served_texts, served_logp, ref_boxes, ref_texts,
            alphabet: str) -> Dict[str, float]:
    """The compared numbers of one sample (lists over frames; boxes in
    serving pixels; ``served_logp``: the reference's log-probs at each
    served box)."""
    gap, n_boxes, unmatched, worst_iou, area = 0.0, 0, 0, 0.0, []
    n_served, mismatched = 0, 0
    for sb, st, sl, rb, rt in zip(served_boxes, served_texts, served_logp, ref_boxes,
                                  ref_texts):
        for t, lp in zip(st, sl):
            g = text_gap(lp, t, alphabet)
            gap = max(gap, g)
            mismatched += int(t != decode(lp, alphabet))
            n_served += 1
        ref_q = [_quad(b) for b in rb]
        ref_text = [_quad(b) for b, t in zip(rb, rt) if t]
        served_q = [_quad(b) for b in sb]
        for q in served_q:   # a served box against every reference box
            best = max((R.quad_iou(q, r) for r in ref_q), default=0.0)
            if best < 0.5:
                unmatched += 1
            else:
                worst_iou = max(worst_iou, 1.0 - best)
        for r in ref_text:   # a reference box with text against the served ones
            best = max((R.quad_iou(r, q) for q in served_q), default=0.0)
            if best < 0.5:
                unmatched += 1
        n_boxes += len(served_q) + len(ref_text)
        area.append(1.0 - cover_iou(served_q, ref_text))
    return {"text_gap": gap, "text_mismatch": mismatched / max(n_served, 1),
            "box_unmatched": unmatched / max(n_boxes, 1),
            "box_iou_gap": worst_iou, "box_area_gap": float(np.mean(area)) if area else 0.0}


def _cover(quads, x0, y0, w, h, step):
    """The grid points (centres of ``step``-pixel cells from (x0, y0), w by
    h of them) inside any of the convex ``quads``."""
    inside = np.zeros((h, w), bool)
    for q in quads:
        p = np.asarray(q, np.float64)
        orient = np.sign(_signed_area(p)) or 1.0
        i0 = max(0, int((p[:, 0].min() - x0) / step) - 1)
        i1 = min(w, int((p[:, 0].max() - x0) / step) + 2)
        j0 = max(0, int((p[:, 1].min() - y0) / step) - 1)
        j1 = min(h, int((p[:, 1].max() - y0) / step) + 2)
        if i0 >= i1 or j0 >= j1:
            continue
        gx, gy = np.meshgrid(x0 + (np.arange(i0, i1) + 0.5) * step,
                             y0 + (np.arange(j0, j1) + 0.5) * step)
        ok = np.ones(gx.shape, bool)
        for i in range(4):
            (ax, ay), (bx, by) = p[i], p[(i + 1) % 4]
            ok &= ((bx - ax) * (gy - ay) - (by - ay) * (gx - ax)) * orient >= 0
        inside[j0:j1, i0:i1] |= ok
    return inside


def _signed_area(p) -> float:
    return 0.5 * float(np.sum(p[:, 0] * np.roll(p[:, 1], -1) - np.roll(p[:, 0], -1) * p[:, 1]))


def cover_iou(a, b, step: float = 1.0) -> float:
    """IoU of the areas two sets of quads cover, on a grid of ``step``
    pixels over their bounding box (1 when both are empty)."""
    if not a and not b:
        return 1.0
    pts = np.asarray([p for q in list(a) + list(b) for p in q], np.float64)
    x0, y0 = np.floor(pts.min(axis=0))
    x1, y1 = np.ceil(pts.max(axis=0))
    w, h = int((x1 - x0) / step) + 1, int((y1 - y0) / step) + 1
    ca, cb = _cover(a, x0, y0, w, h, step), _cover(b, x0, y0, w, h, step)
    union = np.count_nonzero(ca | cb)
    return np.count_nonzero(ca & cb) / union if union else 1.0


def reference_params(flat: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    return oihw({k: torch.tensor(np.asarray(v), dtype=torch.float32, device=device)
                 for k, v in flat.items()})
