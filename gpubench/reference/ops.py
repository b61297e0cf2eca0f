"""The plain reference of the operations around the network: RoIRotate,
the box decode and locality-aware NMS, CTC (loss, greedy decode and the
best alignment of a given text), the EAST losses and Adam.

Written from the reference's semantics (E2E-MLT ``src/rroi_align``,
``nms/nms.h``, warp-ctc and optax's CTC, ``train.py``); plain PyTorch,
NumPy and Python floats.  Nothing here imports the program under test.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

PI = 3.1415926535  # the reference kernel's literal


# --------------------------------------------------------------------------
# RoIRotate
# --------------------------------------------------------------------------

def _round_half_away(x):
    return torch.trunc(x + torch.where(x >= 0, 0.5, -0.5))


def rroi_align(features, rois, pooled_h: int, pooled_w: int, spatial_scale: float = 0.25):
    """Rotated crops of NCHW ``features`` [B, C, H, W] -> [N, C, ph, pw].

    ``rois`` [N, 6] = (batch index, cx, cy, h, w, angle in degrees).  Each
    output cell samples the centre of its source bin (bin corners rounded
    half away from zero and clamped to the map) bilinearly; a neighbour
    counts only where ``0 < index < size``; columns past the
    aspect-preserving width ``ph * w / h`` and rois with h <= 0 or w <= 0
    are zero.  float32 throughout, as the reference kernel computes."""
    _, c, height, width = features.shape
    rois = rois.float()
    cx, cy, h, w = (rois[:, i][:, None, None] for i in (1, 2, 3, 4))
    angle = rois[:, 5][:, None, None] / 180.0 * PI
    ok = (h > 0) & (w > 0)
    h = torch.where(ok, h, 1.0)
    w = torch.where(ok, w, 1.0)
    roi_pw = pooled_h * w / h
    dx, dy = -roi_pw / 2.0, -pooled_h / 2.0
    sx, sy = w * spatial_scale / roi_pw, h * spatial_scale / pooled_h
    a, b = torch.cos(angle), torch.sin(angle)
    m00, m01, m02 = a * sx, b * sy, a * sx * dx + b * sy * dy + cx * spatial_scale
    m10, m11, m12 = -b * sx, a * sy, -b * sx * dx + a * sy * dy + cy * spatial_scale
    iy = torch.arange(pooled_h, dtype=torch.float32, device=rois.device)[None, :, None]
    ix = torch.arange(pooled_w, dtype=torch.float32, device=rois.device)[None, None, :]
    xs = [m00 * (ix + u) + m01 * (iy + v) + m02 for u in (0.0, 1.0) for v in (0.0, 1.0)]
    ys = [m10 * (ix + u) + m11 * (iy + v) + m12 for u in (0.0, 1.0) for v in (0.0, 1.0)]
    left = _round_half_away(torch.stack(xs).amin(0)).clamp_min(0.0)
    right = _round_half_away(torch.stack(xs).amax(0)).clamp_max(width - 1.0)
    top = _round_half_away(torch.stack(ys).amin(0)).clamp_min(0.0)
    bottom = _round_half_away(torch.stack(ys).amax(0)).clamp_max(height - 1.0)
    bx, by = (left + right) / 2.0, (top + bottom) / 2.0
    valid = ((ix <= roi_pw) & ok).float()
    x0, y0 = torch.floor(bx), torch.floor(by)
    fx, fy = bx - x0, by - y0
    bidx = rois[:, 0].long()[:, None, None]
    flat = features.permute(0, 2, 3, 1).reshape(-1, c)
    out = 0.0
    for ddy, wy in ((0, 1.0 - fy), (1, fy)):
        for ddx, wx in ((0, 1.0 - fx), (1, fx)):
            yy, xx = y0 + ddy, x0 + ddx
            inside = ((yy > 0) & (yy < height) & (xx > 0) & (xx < width)).float()
            idx = (bidx * height + yy.long().clamp(0, height - 1)) * width \
                + xx.long().clamp(0, width - 1)
            val = flat.index_select(0, idx.reshape(-1)).reshape(idx.shape + (c,))
            out = out + val * (wy * wx * inside * valid)[..., None]
    return out.permute(0, 3, 1, 2)


def valid_width(rois, pooled_h: int, pooled_w: int):
    """Content frames of each roi's strip: ceil(pooled_h * w / h), in
    [1, pooled_w]."""
    aspect = rois[:, 4] / torch.clamp_min(rois[:, 3], 1e-6)
    return torch.clamp(torch.ceil(pooled_h * aspect), 1, pooled_w).long()


# --------------------------------------------------------------------------
# boxes: decode and locality-aware NMS
# --------------------------------------------------------------------------

def decode_pixels(segm, rbox, angle, thresh: float = 0.5, max_candidates: int = 0):
    """The quads of the pixels above ``thresh`` of one image's 1/4-scale
    maps (segm [H, W], rbox [H, W, 4] top/bottom/left/right, angle [H, W, 2]
    sin/cos; NumPy), in row-major order.  With ``max_candidates`` only that
    many pixels are kept: the highest scores, equal scores by ascending
    pixel index.  Returns (quads [N, 4, 2] in input pixels, scores [N],
    corner confidences [N, 4], xs, ys)."""
    flat = np.nonzero(segm.ravel() > thresh)[0]
    if max_candidates and len(flat) > max_candidates:
        order = np.argsort(-segm.ravel()[flat], kind="stable")[:max_candidates]
        flat = np.sort(flat[order])
    ys, xs = np.divmod(flat, segm.shape[1])
    r = rbox[ys, xs].astype(np.float64)
    s, c = angle[ys, xs, 0].astype(np.float64), angle[ys, xs, 1].astype(np.float64)
    xp, yp = xs + 0.25, ys + 0.25
    rx, ry = (xp - r[:, 2] * c) * 4, (yp - r[:, 2] * s) * 4
    r2x, r2y = (xp + r[:, 3] * c) * 4, (yp + r[:, 3] * s) * 4
    quads = np.stack([
        np.stack([rx - r[:, 1] * s * 4, ry + r[:, 1] * c * 4], -1),
        np.stack([rx + r[:, 0] * s * 4, ry - r[:, 0] * c * 4], -1),
        np.stack([r2x + r[:, 0] * s * 4, r2y - r[:, 0] * c * 4], -1),
        np.stack([r2x - r[:, 1] * s * 4, r2y + r[:, 1] * c * 4], -1)], axis=1)
    pl, pt = np.exp(-r[:, 2] / 9.0), np.exp(-r[:, 0] / 9.0)
    pr, pb = np.exp(-r[:, 3] / 9.0), np.exp(-r[:, 1] / 9.0)
    probs = np.stack([pl * pb, pl * pt, pr * pt, pr * pb], -1)
    return quads, segm[ys, xs].astype(np.float64), probs, xs, ys


def _area(pts) -> float:
    n = len(pts)
    return 0.5 * sum(pts[i][0] * pts[(i + 1) % n][1] - pts[(i + 1) % n][0] * pts[i][1]
                     for i in range(n)) if n >= 3 else 0.0


def quad_iou(a, b) -> float:
    """IoU of two convex quads (lists of 4 (x, y)): ``a`` clipped by each
    edge of ``b`` (Sutherland-Hodgman)."""
    ax, ay = [p[0] for p in a], [p[1] for p in a]
    bx, by = [p[0] for p in b], [p[1] for p in b]
    if max(ax) < min(bx) or max(bx) < min(ax) or max(ay) < min(by) or max(by) < min(ay):
        return 0.0
    area_a, area_b = _area(a), _area(b)
    orient = 1.0 if area_b >= 0 else -1.0
    poly = list(a)
    for i in range(4):
        if not poly:
            break
        (x1, y1), (x2, y2) = b[i], b[(i + 1) % 4]
        ex, ey = x2 - x1, y2 - y1
        out = []
        prev = poly[-1]
        sp = (ex * (prev[1] - y1) - ey * (prev[0] - x1)) * orient
        for cur in poly:
            sc = (ex * (cur[1] - y1) - ey * (cur[0] - x1)) * orient
            if sc >= 0:
                if sp < 0:
                    t = sp / (sp - sc)
                    out.append((prev[0] + t * (cur[0] - prev[0]), prev[1] + t * (cur[1] - prev[1])))
                out.append(cur)
            elif sp >= 0:
                t = sp / (sp - sc)
                out.append((prev[0] + t * (cur[0] - prev[0]), prev[1] + t * (cur[1] - prev[1])))
            prev, sp = cur, sc
        poly = out
    inter = abs(_area(poly))
    union = abs(area_a) + abs(area_b) - inter
    return inter / max(union, 1e-8)


class _Poly:
    """A quad being merged: corners weighted by the corner confidences
    (x0 and x1 by the first, y1 and y2 by the second, x2 and x3 by the
    third, y0 and y3 by the fourth), scores summed."""

    __slots__ = ("pts", "score", "probs")
    _WX = (0, 0, 2, 2)
    _WY = (3, 1, 1, 3)

    def __init__(self, pts, score, probs):
        self.pts, self.score, self.probs = pts, score, probs

    def merged(self, other: "_Poly") -> "_Poly":
        p, q = self.probs, other.probs
        pts = []
        for k in range(4):
            wx, wy = self._WX[k], self._WY[k]
            x = (self.pts[k][0] * p[wx] + other.pts[k][0] * q[wx]) / (p[wx] + q[wx])
            y = (self.pts[k][1] * p[wy] + other.pts[k][1] * q[wy]) / (p[wy] + q[wy])
            pts.append((x, y))
        return _Poly(pts, self.score + other.score, [p[i] + q[i] for i in range(4)])


def locality_aware_nms(quads, scores, probs, xs, ys, map_w: int,
                       th_merge: float = 0.4, th_nms: float = 0.2) -> np.ndarray:
    """The reference's NMS over one image's decoded pixels in row-major
    order: each quad merges into the last registered one, else into the
    one registered at (y-1, x), (y-1, x-1) or (y-1, x+1), where the IoU
    passes ``th_merge``; one that merges nowhere is registered twice (as
    ``nms.h`` does).  Then a greedy NMS by score at ``th_nms`` that merges
    the suppressed quads into the kept one.  Returns [M, 9]: 8 coordinates
    and the merged score."""
    polys: List[_Poly] = []
    where: Dict[Tuple[int, int], int] = {}
    for i in range(len(scores)):
        poly = _Poly([tuple(p) for p in quads[i].tolist()], float(scores[i]),
                     [float(v) for v in probs[i]])
        x, y = int(xs[i]), int(ys[i])
        target = None
        if polys and quad_iou(poly.pts, polys[-1].pts) > th_merge:
            target = len(polys) - 1
        elif polys and y > 0:
            # (y-1, x+1) is read without a column bound, as nms.h reads it:
            # past the row's end it is the next row's first pixel
            keys = [(y - 1, x)] + ([(y - 1, x - 1)] if x > 0 else []) \
                + [(y - 1, x + 1) if x + 1 < map_w else (y, 0)]
            for key in keys:
                j = where.get(key)
                if j is not None and quad_iou(poly.pts, polys[j].pts) > th_merge:
                    target = j
                    break
        if target is not None:
            polys[target] = polys[target].merged(poly)
            where[(y, x)] = target
            continue
        if polys:
            polys.append(poly)
        polys.append(poly)
        where[(y, x)] = len(polys) - 1
    order = sorted(range(len(polys)), key=lambda k: -polys[k].score)
    kept = []
    while order:
        cur, rest = order[0], []
        for j in order[1:]:
            if quad_iou(polys[cur].pts, polys[j].pts) > th_nms:
                polys[cur] = polys[j].merged(polys[cur])
            else:
                rest.append(j)
        kept.append(polys[cur])
        order = rest
    out = np.zeros((len(kept), 9), np.float64)
    for k, p in enumerate(kept):
        out[k, :8] = np.asarray(p.pts).reshape(8)
        out[k, 8] = p.score
    return out


def roi_of_box(box, batch_index: int):
    """A box's 8 coordinates -> the rotated roi (batch index, int(cx),
    int(cy), h, w, angle in degrees): height along the first edge, width
    along the second, angle of the second edge."""
    b = np.asarray(box, np.float64)[:8].reshape(4, 2)
    center = b.mean(axis=0)
    w = math.hypot(*(b[2] - b[1]))
    h = math.hypot(*(b[1] - b[0]))
    angle = -math.atan2(b[2][1] - b[1][1], b[2][0] - b[1][0]) / math.pi * 180.0
    return [batch_index, int(center[0]), int(center[1]), h, w, angle], w, h


def strip_width(w: float, h: float, pooled_h: int, buckets: Sequence[int]) -> int:
    """Strip width of a box at height ``pooled_h``: pooled_h * w / h +
    pooled_h, down to a multiple of 32 (at least 64), up to the first bucket
    that holds it."""
    gw = max(2, (int(w * pooled_h / max(1.0, h)) + pooled_h) // 32) * 32
    for b in buckets:
        if gw <= b:
            return b
    return buckets[-1]


# --------------------------------------------------------------------------
# CTC
# --------------------------------------------------------------------------

def greedy_ids(logp: torch.Tensor) -> List[List[int]]:
    """Best path of each row of log-probs [N, T, K], collapsed: repeats
    merged, blanks (0) dropped."""
    best = logp.argmax(-1).cpu().numpy()
    out = []
    for row in best:
        ids, prev = [], -1
        for t in row:
            if t != prev and t != 0:
                ids.append(int(t))
            prev = t
        out.append(ids)
    return out


def best_alignment(logp: np.ndarray, label: Sequence[int]) -> float:
    """The log-probability of the best frame path of ``logp`` [T, K] (NumPy,
    f64) that collapses to ``label`` (Viterbi over the blank-extended
    label); -inf where none does."""
    t_len = logp.shape[0]
    ext = [0]
    for c in label:
        ext += [c, 0]
    s_len = len(ext)
    neg = -np.inf
    prev = np.full(s_len, neg)
    prev[0] = logp[0, 0]
    if s_len > 1:
        prev[1] = logp[0, ext[1]]
    ext_a = np.asarray(ext)
    skip = np.zeros(s_len, bool)
    skip[2:] = (ext_a[2:] != 0) & (ext_a[2:] != ext_a[:-2])
    emit = logp[:, ext_a]
    for t in range(1, t_len):
        cur = prev.copy()
        cur[1:] = np.maximum(cur[1:], prev[:-1])
        cur[2:] = np.where(skip[2:], np.maximum(cur[2:], prev[:-2]), cur[2:])
        prev = cur + emit[t]
    return float(max(prev[-1], prev[-2] if s_len > 1 else neg))


def ctc_loss(logp, labels, lengths, frames: int, log_eps: float = -1e5):
    """Per-row CTC loss (blank 0) over the first ``frames`` frames of
    log-probs [N, T, K]; labels [N, L]; lengths [N].  A log-space forward
    pass in which an impossible transition costs ``log_eps`` (optax's
    convention), so a label that cannot be aligned gets a large finite
    loss rather than infinity."""
    n, _, _ = logp.shape
    logp = F.log_softmax(logp[:, :frames], dim=-1)
    lmax = labels.shape[1]
    dev = logp.device
    labels = labels.long().to(dev)
    s_len = 2 * lmax + 1
    ext = torch.zeros((n, s_len), dtype=torch.long, device=dev)
    ext[:, 1::2] = labels
    skip = torch.zeros((n, s_len), dtype=torch.bool, device=dev)
    skip[:, 3::2] = labels[:, 1:] != labels[:, :-1]
    emit = torch.gather(logp, 2, ext[:, None, :].expand(n, frames, s_len))
    alpha = torch.full((n, s_len), log_eps, device=dev)
    alpha[:, 0] = emit[:, 0, 0]
    alpha[:, 1] = emit[:, 0, 1]
    eps = torch.full((n, 1), log_eps, device=dev)
    eps2 = torch.full((n, 2), log_eps, device=dev)
    for t in range(1, frames):
        a1 = torch.cat([eps, alpha[:, :-1]], dim=1)
        a2 = torch.cat([eps2, alpha[:, :-2]], dim=1)
        a2 = torch.where(skip, a2, torch.full_like(a2, log_eps))
        alpha = torch.logsumexp(torch.stack([alpha, a1, a2]), dim=0) + emit[:, t]
    lengths = lengths.long().to(dev)
    end = 2 * lengths
    last = torch.gather(alpha, 1, end[:, None])[:, 0]
    prev = torch.gather(alpha, 1, torch.clamp_min(end - 1, 0)[:, None])[:, 0]
    prev = torch.where(lengths > 0, prev, torch.full_like(prev, log_eps))
    return -torch.logaddexp(last, prev)


# --------------------------------------------------------------------------
# training losses and Adam
# --------------------------------------------------------------------------

def dice(pred, gt):
    return -(2.0 * (pred * gt).sum() + 1.0) / (pred.sum() + gt.sum() + 1.0)


def masked_mean(x, m):
    cnt = m.sum()
    return torch.where(cnt > 0, (x * m).sum() / cnt.clamp_min(1.0), torch.zeros((), device=x.device))


def iou_loss(geo_gt, mask, geo_p):
    """EAST IoU loss over two halves (left distance valid where d3 > 0,
    right where d4 > 0); geo [B, 4, H, W] (top, bottom, left, right)."""
    d1, d2, d3, d4 = geo_gt.unbind(1)
    p1, p2, p3, p4 = geo_p.unbind(1)
    total = 0.0
    for dg, dp in ((d3, p3), (d4, p4)):
        m = mask * (dg > 0).float()
        area_g = (d1 + d2) * dg
        area_p = (p1 + p2) * dp
        inter = torch.minimum(dg, dp) * (torch.minimum(d1, p1) + torch.minimum(d2, p2))
        ratio = torch.where(m > 0, (inter + 1.0) / (area_g + area_p - inter + 1.0),
                            torch.ones((), device=inter.device))
        total = total + masked_mean(-torch.log(ratio.clamp_min(1e-8)), m)
    return total


def resize_map(x, hw):
    """NCHW (or [B, H, W]) bilinear resize with aligned corners."""
    squeeze = x.ndim == 3
    t = x[:, None] if squeeze else x
    t = F.interpolate(t, size=tuple(hw), mode="bilinear", align_corners=True)
    return t[:, 0] if squeeze else t


def detection_losses(out, score_gt, mask_gt, geo_gt, angle_gt, multi_scale: bool):
    """(segm, angle, iou) of the EAST loss: dice on the masked score map,
    sin/cos MSE and the IoU loss over text pixels; with ``multi_scale``
    each term adds its 1/8-scale counterpart against the resized ground
    truth (distances halved).  Maps [B, H, W]; geo_gt [B, 4, H, W]."""
    segm = dice(out["segm"][:, 0] * mask_gt, score_gt * mask_gt)
    text = (score_gt > 0.5).float()
    ang = out["angle"]
    angle = (masked_mean((ang[:, 0] - torch.sin(angle_gt)) ** 2, text)
             + masked_mean((ang[:, 1] - torch.cos(angle_gt)) ** 2, text))
    box = iou_loss(geo_gt, text, out["rbox"])
    if multi_scale:
        hw = out["segm2"].shape[2:]
        s2, m2 = resize_map(score_gt, hw), resize_map(mask_gt, hw)
        segm = segm + dice(out["segm2"][:, 0] * m2, s2 * m2)
        t2 = (s2 > 0.5).float()
        a2 = resize_map(angle_gt, hw)
        ang2 = out["angle2"]
        angle = (angle + masked_mean((ang2[:, 0] - torch.sin(a2)) ** 2, t2)
                 + masked_mean((ang2[:, 1] - torch.cos(a2)) ** 2, t2))
        box = box + iou_loss(resize_map(geo_gt, hw) / 2.0, t2, out["rbox2"])
    return segm, angle, box


class Adam:
    """Adam with bias correction (lr, betas, eps as the configuration gives
    them), over a dict of leaves."""

    def __init__(self, params: Dict[str, torch.Tensor], lr: float, betas=(0.5, 0.999),
                 eps: float = 1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, betas[0], betas[1], eps
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor]):
        self.t += 1
        c1, c2 = 1.0 - self.b1 ** self.t, 1.0 - self.b2 ** self.t
        for k, g in grads.items():
            self.m[k].mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            denom = (self.v[k] / c2).sqrt_().add_(self.eps)
            params[k].sub_(self.lr * (self.m[k] / c1) / denom)
