"""Host-side geometry (NumPy only).

The port's own copy of what it needs from ``fots/geometry.py``: the strip
width rule, the detected-box and ground-truth-quad -> rotated-roi
conversions, the per-pixel
quad decode of the NMS adaptor (over dense maps and over gathered
candidates), with the same arithmetic (f32 steps where
the reference decodes in C float), the /32 input sizing over a NumPy
bilinear u8 resize (``cv2.resize``'s ``INTER_LINEAR`` in its fixed-point
arithmetic; the port imports no OpenCV), and the EAST training targets
(:func:`generate_rbox`, :func:`generate_rbox2`) rasterised by
:func:`fots_torch.imgproc.fill_poly`, byte for byte as ``cv2.fillPoly``.

Reference quirks are reproduced deliberately and noted inline ("parity:").
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np

from fots_torch.imgproc import box_blur3, fill_poly

SCALE_FACTOR = 4  # detection targets live at 1/4 input resolution
TARGET_H = 11     # recognition strip height at 1/4 scale


def box_points(center, size, angle_deg) -> np.ndarray:
    """``cv2.boxPoints(((cx, cy), (w, h), angle))``: the 4 corners [4, 2]
    float32, in OpenCV's float32 arithmetic (``RotatedRect::points``)."""
    f = np.float32
    ang = float(f(angle_deg)) * math.pi / 180.0
    b = f(math.cos(ang)) * f(0.5)
    a = f(math.sin(ang)) * f(0.5)
    cx, cy = f(center[0]), f(center[1])
    w, h = f(size[0]), f(size[1])
    p0x = cx - a * h - b * w
    p0y = cy + b * h - a * w
    p1x = cx + a * h - b * w
    p1y = cy - b * h - a * w
    p2x = cx + a * h + b * w
    p2y = cy - b * h + a * w
    p3x = cx - a * h + b * w
    p3y = cy + b * h + a * w
    return np.array([[p0x, p0y], [p1x, p1y], [p2x, p2y], [p3x, p3y]], dtype=np.float32)


def strip_width_for_box(w: float, h: float, target_h: int = TARGET_H,
                        buckets: Sequence[int] = (256, 512)) -> int:
    """Scale to target height, add target_h, round down to /32 (min 64),
    then snap up to a bucket (the last one caps)."""
    scale = target_h / max(1.0, h)
    target_gw = int(w * scale) + target_h
    target_gw = max(2, target_gw // 32) * 32
    for b in buckets:
        if target_gw <= b:
            return b
    return buckets[-1]


def quads_to_rrois(quads: np.ndarray, batch_idx: int = 0, height_jitter: int = 0
                   ) -> np.ndarray:
    """``[N, 4, 2]`` quads -> ``[N, 6]`` rrois [bid, cx, cy, h, w, angle_deg]
    (the ground-truth rois of the recognition trainers): centre the corner
    mean, w = |p2 - p1|, h = |p1 - p0| + ``height_jitter``, angle the mean
    edge angle negated, in degrees (f64, as ``fots`` computes it)."""
    q = np.asarray(quads, dtype=np.float64).reshape(-1, 4, 2)
    center = q.mean(axis=1)
    dw = q[:, 2, :] - q[:, 1, :]
    dh = q[:, 1, :] - q[:, 0, :]
    w = np.sqrt((dw ** 2).sum(axis=1))
    h = np.sqrt((dh ** 2).sum(axis=1)) + height_jitter
    ang = (np.arctan2(q[:, 2, 1] - q[:, 1, 1], q[:, 2, 0] - q[:, 1, 0])
           + np.arctan2(q[:, 3, 1] - q[:, 0, 1], q[:, 3, 0] - q[:, 0, 0])) / 2.0
    ang_deg = -ang / math.pi * 180.0
    bid = np.full((q.shape[0],), batch_idx, dtype=np.float64)
    return np.stack([bid, center[:, 0], center[:, 1], h, w, ang_deg], axis=1)


def rroi_from_box(box8: np.ndarray, batch_idx: int = 0, expand_w_frac: float = 0.0
                  ) -> Tuple[np.ndarray, float, float]:
    """Detected box (8 coords) -> (rroi[6] = [bid, cx, cy, h, w, angle_deg],
    w, h), with the int() truncation of the centre coordinates.
    ``expand_w_frac`` widens the crop by that fraction of the box height
    (centred), the margin of the reference's accuracy harness (0.25 there)."""
    b = np.asarray(box8, dtype=np.float64)[:8].reshape(4, 2)
    center = b.mean(axis=0)
    dw = b[2] - b[1]
    dh = b[1] - b[0]
    w = math.sqrt(dw[0] ** 2 + dw[1] ** 2)
    h = math.sqrt(dh[0] ** 2 + dh[1] ** 2)
    w = w + expand_w_frac * h
    angle = math.atan2(b[2][1] - b[1][1], b[2][0] - b[1][0])
    angle = -angle / math.pi * 180.0
    return (np.array([batch_idx, int(center[0]), int(center[1]), h, w, angle],
                     dtype=np.float64), w, h)


def decode_quads_np(segm: np.ndarray, geo: np.ndarray, angle: np.ndarray,
                    segm_thresh: float = 0.5, scale_factor: float = 4.0,
                    precision: float = 10000.0):
    """The NMS adaptor's per-pixel quad decode over dense maps: segm [H, W],
    geo [H, W, 4] (top, bottom, left, right), angle [H, W, 2] (sin, cos).
    Returns (quads [N, 4, 2], scores [N], corner_probs [N, 4], xs [N], ys
    [N]) of the pixels above ``segm_thresh``, in row-major scan order."""
    ys, xs = np.nonzero(segm > segm_thresh)
    quads, probs = decode_candidates_np(geo[ys, xs], angle[ys, xs, 0], angle[ys, xs, 1],
                                        xs, ys, scale_factor, precision)
    return quads, segm[ys, xs], probs, xs, ys


def decode_candidates_np(r: np.ndarray, a_sin: np.ndarray, a_cos: np.ndarray,
                         xs: np.ndarray, ys: np.ndarray,
                         scale_factor: float = 4.0, precision: float = 10000.0):
    """Quad decode of gathered candidate pixels: r [N,4] distances (top,
    bottom, left, right), (sin, cos) angle, pixel coords.  Returns (quads
    [N,4,2] rounded to 1/precision, corner_probs [N,4]).  Every step is f32
    in the reference's association order; rounding is half away from zero
    (C ``roundf``)."""
    f32 = np.float32
    r = np.asarray(r, f32)
    a_sin = np.asarray(a_sin, f32)
    a_cos = np.asarray(a_cos, f32)
    xp = xs.astype(f32) + f32(0.25)
    yp = ys.astype(f32) + f32(0.25)
    sf = f32(scale_factor)
    prec = f32(precision)

    pos_r_x = (xp - r[:, 2] * a_cos) * sf
    pos_r_y = (yp - r[:, 2] * a_sin) * sf
    pos_r2_x = (xp + r[:, 3] * a_cos) * sf
    pos_r2_y = (yp + r[:, 3] * a_sin) * sf

    quads = np.stack(
        [
            np.stack([pos_r_x - r[:, 1] * a_sin * sf, pos_r_y + r[:, 1] * a_cos * sf], -1),
            np.stack([pos_r_x + r[:, 0] * a_sin * sf, pos_r_y - r[:, 0] * a_cos * sf], -1),
            np.stack([pos_r2_x + r[:, 0] * a_sin * sf, pos_r2_y - r[:, 0] * a_cos * sf], -1),
            np.stack([pos_r2_x - r[:, 1] * a_sin * sf, pos_r2_y + r[:, 1] * a_cos * sf], -1),
        ],
        axis=1,
    )
    fp = prec * quads
    fp = np.copysign(np.floor(np.abs(fp) + f32(0.5)), fp)
    quads = fp.astype(np.float64) / float(precision)

    # exp arguments are f32 divisions; exp in f64 rounded to f32 matches a
    # correctly rounded expf
    ph = f32(9.0)
    p_left = np.exp((-(r[:, 2]) / ph).astype(np.float64)).astype(f32)
    p_top = np.exp((-(r[:, 0]) / ph).astype(np.float64)).astype(f32)
    p_right = np.exp((-(r[:, 3]) / ph).astype(np.float64)).astype(f32)
    p_bt = np.exp((-(r[:, 1]) / ph).astype(np.float64)).astype(f32)
    probs = np.stack([p_left * p_bt, p_left * p_top, p_right * p_top,
                      p_right * p_bt], -1)
    return quads, probs


_COEF_BITS = 11  # cv2's INTER_RESIZE_COEF_BITS: taps are int16 multiples of 2^-11


def _linear_taps(src: int, dst: int, clip_weights: bool = True):
    """Half-pixel bilinear taps of ``cv2.resize(..., INTER_LINEAR)``: (lo, hi,
    a0, a1) with the weights as cv2's rounded fixed-point integers.  Past
    the edge cv2 treats the axes differently: a column clamps its source
    and weight (``clip_weights``: one tap of weight 1), a row clamps only its
    two source rows and keeps both weights, whose two truncated products
    can sum one level below the clamped column's."""
    pos = ((np.arange(dst) + 0.5) * (src / dst) - 0.5).astype(np.float32)
    lo = np.floor(pos).astype(np.int64)
    fr = pos - lo.astype(np.float32)
    if clip_weights:
        fr[lo < 0] = 0.0
        fr[lo >= src - 1] = 0.0
        lo = np.clip(lo, 0, src - 1)
        hi = np.minimum(lo + 1, src - 1)
    else:
        hi = np.clip(lo + 1, 0, src - 1)
        lo = np.clip(lo, 0, src - 1)
    one = np.float32(1 << _COEF_BITS)
    a0 = np.rint((np.float32(1.0) - fr) * one).astype(np.int32)
    a1 = np.rint(fr * one).astype(np.int32)
    return lo, hi, a0, a1


def resize_window_u8(fetch_rect, src_hw: Tuple[int, int], dsize: Tuple[int, int],
                     rows: Tuple[int, int], cols: Tuple[int, int]) -> np.ndarray:
    """Rows [r0, r1) x cols [c0, c1) of ``cv2.resize`` (``INTER_LINEAR``) of a
    u8 [h, w, c] image of size ``src_hw`` to ``dsize`` (width, height).
    ``fetch_rect(y0, y1, x0, x1)`` returns the source pixels of that
    rectangle; only the rectangle the window's taps touch is read, so the
    window's pixels equal those of the whole resize."""
    dw, dh = int(dsize[0]), int(dsize[1])
    h, w = src_hw
    xlo, xhi, xa0, xa1 = (t[cols[0]:cols[1]] for t in _linear_taps(w, dw))
    ylo, yhi, ya0, ya1 = (t[rows[0]:rows[1]] for t in _linear_taps(h, dh, clip_weights=False))
    r0, c0 = int(ylo.min()), int(xlo.min())
    src = fetch_rect(r0, int(yhi.max()) + 1, c0, int(xhi.max()) + 1).astype(np.int32)
    hor = src[:, xlo - c0] * xa0[None, :, None] + src[:, xhi - c0] * xa1[None, :, None]
    s0 = hor[ylo - r0] >> 4
    s1 = hor[yhi - r0] >> 4
    out = (((ya0[:, None, None] * s0) >> 16) + ((ya1[:, None, None] * s1) >> 16) + 2) >> 2
    return np.clip(out, 0, 255).astype(np.uint8)


def resize_bilinear_u8(im: np.ndarray, dsize: Tuple[int, int]) -> np.ndarray:
    """``cv2.resize(im, dsize)`` (``INTER_LINEAR``) of a u8 image [h, w, c]
    in NumPy; ``dsize`` is (width, height) as in cv2.  The arithmetic is
    cv2's 8-bit path: integer taps scaled by 2^11, a horizontal pass in
    int32, then ``(((b0 * (s0 >> 4)) >> 16) + ((b1 * (s1 >> 4)) >> 16) + 2) >> 2``."""
    if im.dtype != np.uint8 or im.ndim != 3:
        raise ValueError(f"expected a u8 [h, w, c] image, got {im.dtype} {im.shape}")
    dw, dh = int(dsize[0]), int(dsize[1])
    if (dh, dw) == im.shape[:2]:
        return im.copy()
    return resize_window_u8(lambda y0, y1, x0, x1: im[y0:y1, x0:x1], im.shape[:2],
                            (dw, dh), (0, dh), (0, dw))


def resize_to_multiple_of_32(im: np.ndarray, max_size: int = 1585152, scale_up: bool = True
                             ) -> Tuple[np.ndarray, Tuple[int, int]]:
    """Resize an image so both sides are /32 multiples under an area cap
    (``scale_up``: three times the source size first).  Returns (resized u8
    image, (height, width))."""
    if scale_up:
        image_size = [im.shape[1] * 3 // 32 * 32, im.shape[0] * 3 // 32 * 32]
    else:
        image_size = [im.shape[1] // 32 * 32, im.shape[0] // 32 * 32]
    while image_size[0] * image_size[1] > max_size:
        image_size[0] /= 1.2
        image_size[1] /= 1.2
        image_size[0] = int(image_size[0] // 32) * 32
        image_size[1] = int(image_size[1] // 32) * 32
    resize_h, resize_w = int(image_size[1]), int(image_size[0])
    return resize_bilinear_u8(im, (resize_w, resize_h)), (resize_h, resize_w)


def poly_angle(pts: np.ndarray) -> float:
    """Mean angle of the two long edges."""
    a1 = math.atan2(pts[2][1] - pts[1][1], pts[2][0] - pts[1][0])
    a2 = math.atan2(pts[3][1] - pts[0][1], pts[3][0] - pts[0][0])
    return (a1 + a2) / 2.0


def point_dist_to_line(p1: np.ndarray, p2: np.ndarray, p3: np.ndarray):
    """Distance from p3 (or an array of points) to the line p1-p2; the bare
    cross product when the segment is degenerate (the reference falls
    through)."""
    d = p2 - p1
    norm = np.linalg.norm(d)
    cross = np.abs(d[0] * (p1[1] - p3[..., 1]) - d[1] * (p1[0] - p3[..., 0]))
    if norm > 0.5:
        return cross / norm
    return cross


def _quad(pts) -> np.ndarray:
    """One contour as cv2.fillPoly receives it: ``np.asarray([pts], np.int32)``
    (a cast that truncates unrounded points)."""
    return np.asarray([pts], np.int32)


def _shrink(pts: np.ndarray, factor: float) -> np.ndarray:
    """Shrink a 1/4-scale quad along its two short edges by 1/factor."""
    pts = pts.copy()
    c1 = (pts[0] + pts[1]) / 2
    pts[0] = c1 + (pts[0] - c1) / factor
    pts[1] = c1 + (pts[1] - c1) / factor
    c1 = (pts[2] + pts[3]) / 2
    pts[2] = c1 + (pts[2] - c1) / factor
    pts[3] = c1 + (pts[3] - c1) / factor
    return pts


def _line_mask(pts2: np.ndarray, pts: np.ndarray, factor: float) -> np.ndarray:
    """The interior of a multi-word line that is masked out of training."""
    pts_line = pts2.copy()
    c1 = (pts[1] + pts[2]) / 2
    pts_line[2] = c1 + (pts[2] - c1) / factor
    pts_line[1] = c1 + (pts[1] - c1) / factor
    c1 = (pts[0] + pts[3]) / 2
    pts_line[3] = c1 + (pts[3] - c1) / factor
    pts_line[0] = c1 + (pts[0] - c1) / factor
    return pts_line


def _ignored(tag, poly_h, poly_w, pts, pts_orig, w, txt) -> bool:
    # parity: the y-range check also compares against the image's width
    return bool(tag or poly_h < 6 or poly_w < 6 or np.sum(pts < 0) != 0
                or pts_orig[:, 0].max() > w or pts_orig[:, 1].max() > w
                or (poly_w < poly_h and len(txt) > 3))


def _sides_bad(pts_orig: np.ndarray, w: int) -> Tuple[bool, bool]:
    """parity: side distances are poisoned to -1 when the quad pokes out of
    the image in x."""
    left = bool(pts_orig[0, 0] > w or pts_orig[1, 0] > w or pts_orig[0, 0] < 0
                or pts_orig[1, 0] < 0)
    right = bool(pts_orig[2, 0] > w or pts_orig[3, 0] > w or pts_orig[2, 0] < 0
                 or pts_orig[3, 0] < 0)
    return left, right


def _poly_sizes(pts_orig: np.ndarray) -> Tuple[int, float]:
    dh1 = np.linalg.norm(pts_orig[1] - pts_orig[0])
    # parity: the reference averages dh1 with itself
    return int((dh1 + dh1) / 2), np.linalg.norm(pts_orig[1] - pts_orig[2])


def generate_rbox(im_shape: Tuple[int, int], polys: np.ndarray, tags: Sequence[bool],
                  labels: Sequence[str]):
    """EAST targets at 1/4 scale: (score [h/4, w/4] f32, geo [..., 5] f32,
    training mask u8, gt index i64, kept quads, their labels).  Polygons are
    taken in order (overlap handling depends on it); per polygon the work
    is vectorised over its raster mask."""
    h, w = im_shape
    hs, ws = int(h / SCALE_FACTOR), int(w / SCALE_FACTOR)
    poly_mask = np.zeros((hs, ws), dtype=np.uint8)
    score_map = np.zeros((hs, ws), dtype=np.float32)
    geo_map = np.zeros((hs, ws, 5), dtype=np.float32)
    training_mask = np.ones((hs, ws), dtype=np.uint8)
    gt_idx = np.full((hs, ws), -1, dtype=np.int64)
    labels_out: List[str] = []
    gt_out: List[np.ndarray] = []

    polys = np.asarray(polys, dtype=np.float64).reshape(-1, 4, 2)
    for poly_idx in range(polys.shape[0]):
        pts_orig = polys[poly_idx]
        txt = labels[poly_idx]
        angle = poly_angle(pts_orig)
        poly_h, poly_w = _poly_sizes(pts_orig)
        pts2 = pts_orig / SCALE_FACTOR
        pts = _shrink(pts2, 1.5)
        if _ignored(tags[poly_idx], poly_h, poly_w, pts, pts_orig, w, txt):
            fill_poly(training_mask, _quad(pts2.round()), 0)
            continue
        is_line = txt.find(" ") != -1
        if is_line:
            fill_poly(training_mask, _quad(_line_mask(pts2, pts, 1.2).round()), 0)

        fill_poly(poly_mask, _quad(pts.round()), poly_idx + 1)
        ys, xs = np.nonzero(poly_mask == poly_idx + 1)
        if ys.size:
            overlap = score_map[ys, xs] != 0
            training_mask[ys[overlap], xs[overlap]] = 0
            keep = ~overlap
            ky, kx = ys[keep], xs[keep]
            if ky.size:
                pt = np.stack([kx, ky], axis=-1).astype(np.float32)
                d1 = point_dist_to_line(pts2[1], pts2[2], pt)
                d2 = point_dist_to_line(pts2[0], pts2[3], pt)
                dw1 = point_dist_to_line(pts2[0], pts2[1], pt)
                dw2 = point_dist_to_line(pts2[2], pts2[3], pt)
                geo_map[ky, kx, 0] = d1
                geo_map[ky, kx, 1] = d2
                left_bad, right_bad = _sides_bad(pts_orig, w)
                geo_map[ky, kx, 2] = -1.0 if left_bad else dw1
                geo_map[ky, kx, 3] = -1.0 if right_bad else dw2
                gt_idx[ky, kx] = len(gt_out)
                near_edge = (dw1 < 1) | (dw2 < 1)
                score_map[ky[near_edge], kx[near_edge]] = 0
                if is_line:
                    wider_left = dw1 > dw2
                    geo_map[ky[wider_left], kx[wider_left], 2] = -1
                    geo_map[ky[~wider_left], kx[~wider_left], 3] = -1
                geo_map[ky, kx, 4] = angle

        fill_poly(score_map, _quad(pts.round()), 1)
        gt_out.append(pts_orig)
        labels_out.append(txt)

    score_map[training_mask == 0] = 0
    return score_map, geo_map, training_mask, gt_idx, gt_out, labels_out


def generate_rbox2(im_shape: Tuple[int, int], polys: np.ndarray, tags: Sequence[bool],
                   labels: Sequence[str]):
    """The ``geo_type=1`` targets: height shrink by 1/2 (not 1/1.5), line
    masking by 1/1.5 (not 1/1.2), distances from the row / column extents of
    the whole polygon's raster, edge pixels (dw < 0.5) masked out of
    training rather than zeroed in the score, and a 3x3 box blur of the
    final score map."""
    h, w = im_shape
    hs, ws = int(h / SCALE_FACTOR), int(w / SCALE_FACTOR)
    poly_mask = np.zeros((hs, ws), dtype=np.uint8)
    poly_full = np.zeros((hs, ws), dtype=np.uint8)
    score_map = np.zeros((hs, ws), dtype=np.float32)
    geo_map = np.zeros((hs, ws, 5), dtype=np.float32)
    training_mask = np.ones((hs, ws), dtype=np.uint8)
    gt_idx = np.full((hs, ws), -1, dtype=np.int64)
    labels_out: List[str] = []
    gt_out: List[np.ndarray] = []

    polys = np.asarray(polys, dtype=np.float64).reshape(-1, 4, 2)
    for poly_idx in range(polys.shape[0]):
        pts_orig = polys[poly_idx]
        txt = labels[poly_idx]
        angle = poly_angle(pts_orig)
        poly_h, poly_w = _poly_sizes(pts_orig)
        pts2 = pts_orig / SCALE_FACTOR
        pts = _shrink(pts2, 2.0)
        if _ignored(tags[poly_idx], poly_h, poly_w, pts, pts_orig, w, txt):
            fill_poly(training_mask, _quad(pts2.round()), 0)
            continue
        is_line = txt.find(" ") != -1
        if is_line:
            fill_poly(training_mask, _quad(_line_mask(pts2, pts, 1.5).round()), 0)

        fill_poly(poly_mask, _quad(pts.round()), poly_idx + 1)
        fill_poly(poly_full, _quad(pts2.round()), poly_idx + 1)
        ys, xs = np.nonzero(poly_mask == poly_idx + 1)
        ysf, xsf = np.nonzero(poly_full == poly_idx + 1)
        if ys.size:
            overlap = score_map[ys, xs] != 0
            training_mask[ys[overlap], xs[overlap]] = 0
            keep = ~overlap
            ky, kx = ys[keep], xs[keep]
            if ky.size and ysf.size:
                # row / column extents of the full polygon per scanline
                min_x_of_row = np.full(hs, 1 << 30)
                max_x_of_row = np.full(hs, -(1 << 30))
                np.minimum.at(min_x_of_row, ysf, xsf)
                np.maximum.at(max_x_of_row, ysf, xsf)
                min_y_of_col = np.full(ws, 1 << 30)
                max_y_of_col = np.full(ws, -(1 << 30))
                np.minimum.at(min_y_of_col, xsf, ysf)
                np.maximum.at(max_y_of_col, xsf, ysf)
                d1 = ky - min_y_of_col[kx]
                d2 = max_y_of_col[kx] - ky
                dw1 = kx - min_x_of_row[ky]
                dw2 = max_x_of_row[ky] - kx
                left_bad, right_bad = _sides_bad(pts_orig, w)
                geo_map[ky, kx, 0] = d1
                geo_map[ky, kx, 1] = d2
                geo_map[ky, kx, 2] = -1.0 if left_bad else dw1
                geo_map[ky, kx, 3] = -1.0 if right_bad else dw2
                gt_idx[ky, kx] = len(gt_out)
                near_edge = (dw1 < 0.5) | (dw2 < 0.5)
                training_mask[ky[near_edge], kx[near_edge]] = 0
                if is_line:
                    wider_left = dw1 > dw2
                    geo_map[ky[wider_left], kx[wider_left], 2] = -1
                    geo_map[ky[~wider_left], kx[~wider_left], 3] = -1
                geo_map[ky, kx, 4] = angle

        # parity: rbox2 fills the score with unrounded points (a truncating
        # int32 cast)
        fill_poly(score_map, _quad(pts), 1)
        gt_out.append(pts_orig)
        labels_out.append(txt)

    score_map[training_mask == 0] = 0
    return box_blur3(score_map), geo_map, training_mask, gt_idx, gt_out, labels_out
