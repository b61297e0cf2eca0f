"""The benchmark's own frozen copy of the EAST training targets.

Copied from the program's host geometry (``generate_rbox`` and the
``cv2.fillPoly`` rasteriser it draws with) when the benchmark was made,
so the targets the training cells are fed cannot change with the program.
On the four smoke scenes at their own size it gives
``fots_torch/assets/train_targets.npz`` byte for byte
(``gpubench/tests/test_gpubench_reference.py``).  NumPy only.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np

SCALE_FACTOR = 4  # detection targets live at 1/4 input resolution
XY_SHIFT = 16     # drawing.cpp's fixed point
XY_ONE = 1 << XY_SHIFT


def _trunc_div(a: int, b: int) -> int:
    """C integer division: rounds toward zero."""
    q = abs(a) // abs(b)
    return -q if (a < 0) != (b < 0) else q


def clip_line(size_wh: Tuple[int, int], p1, p2):
    """``cv::clipLine`` on int64 end points: returns (inside, p1, p2) with the
    end points moved onto the image's border, in OpenCV's order (the second
    point's y clip uses the first point as already moved)."""
    right, bottom = size_wh[0] - 1, size_wh[1] - 1
    x1, y1 = int(p1[0]), int(p1[1])
    x2, y2 = int(p2[0]), int(p2[1])

    def code(x, y):
        return (x < 0) + (x > right) * 2 + (y < 0) * 4 + (y > bottom) * 8

    def tdiv(num, den):  # (int64)((double)num * d / den): truncated double
        return int(float(num[0]) * float(num[1]) / float(den))

    c1, c2 = code(x1, y1), code(x2, y2)
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += tdiv((a - y1, x2 - x1), y2 - y1)
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += tdiv((a - y2, x2 - x1), y2 - y1)
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += tdiv((a - x1, y2 - y1), x2 - x1)
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += tdiv((a - x2, y2 - y1), x2 - x1)
                x2 = a
                c2 = 0
    return (c1 | c2) == 0, (x1, y1), (x2, y2)


def line_pixels(size_wh: Tuple[int, int], p1, p2) -> Tuple[np.ndarray, np.ndarray]:
    """(xs, ys) of ``cv::Line``'s 8-connected line from p1 to p2, clipped
    to the image as ``LineIterator`` clips it and walked from its left end."""
    w, h = size_wh
    if not (0 <= p1[0] < w and 0 <= p2[0] < w and 0 <= p1[1] < h and 0 <= p2[1] < h):
        inside, p1, p2 = clip_line(size_wh, p1, p2)
        if not inside:
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
    (x1, y1), (x2, y2) = p1, p2
    dx, dy = x2 - x1, y2 - y1
    if dx < 0:  # leftToRight
        dx, dy = -dx, -dy
        x1, y1 = x2, y2
    sy = -1 if dy < 0 else 1
    dy = abs(dy)
    vert = dy > dx
    major, minor = (dy, dx) if vert else (dx, dy)
    k = np.arange(major + 1, dtype=np.int64)
    # Bresenham's err = major - 2 minor; after k steps the minor axis moved
    # max(0, ceil((2 minor k - major) / (2 major))) times
    m = np.maximum(0, -((major - 2 * minor * k) // max(2 * major, 1)))
    if vert:
        return x1 + m, y1 + sy * k
    return x1 + k, y1 + sy * m


def _poly_edges(size_wh, pts: np.ndarray):
    """``CollectPolyEdges`` (shift 0, offset 0, LINE_8) of one contour:
    (line pixels, edges as int64 rows (y0, y1, x, dx))."""
    w, h = size_wh
    lines_x, lines_y, edges = [], [], []
    n = len(pts)
    for i in range(n):
        p0 = (int(pts[i - 1][0]), int(pts[i - 1][1]))
        p1 = (int(pts[i][0]), int(pts[i][1]))
        lx, ly = line_pixels(size_wh, p0, p1)
        lines_x.append(lx)
        lines_y.append(ly)
        c0, c1 = [p0[0] << XY_SHIFT, p0[1]], [p1[0] << XY_SHIFT, p1[1]]
        if not (0 <= p0[0] < w and 0 <= p1[0] < w and 0 <= p0[1] < h and 0 <= p1[1] < h):
            # an edge that leaves the image steps from its clipped end points;
            # one clipped to a single point is vertical at that point's x
            _, t0, t1 = clip_line(size_wh, p0, p1)
            if t0[1] != t1[1]:
                c0[1], c1[1] = t0[1], t1[1]
            c0[0], c1[0] = t0[0] << XY_SHIFT, t1[0] << XY_SHIFT
        if p0[1] == p1[1]:
            continue
        ddx = _trunc_div(c1[0] - c0[0], c1[1] - c0[1])
        if p0[1] < p1[1]:
            edges.append((p0[1], p1[1], c0[0] + (p0[1] - c0[1]) * ddx, ddx))
        else:
            edges.append((p1[1], p0[1], c1[0] + (p1[1] - c1[1]) * ddx, ddx))
    return lines_x, lines_y, edges


def fill_poly(img: np.ndarray, pts, value) -> np.ndarray:
    """``cv2.fillPoly(img, pts, value)`` in place (and returned): ``pts`` is
    int32 [n_contours, n_points, 2] (or one contour [n_points, 2]) of (x, y),
    ``LINE_8``, shift 0.  Contours are filled together (even-odd over
    all of their edges), after every edge has been drawn as a line."""
    pts = np.asarray(pts)
    if pts.dtype != np.int32:
        raise TypeError(f"fill_poly takes int32 points (as cv2 does), got {pts.dtype}")
    if pts.ndim == 2:
        pts = pts[None]
    h, w = img.shape[:2]
    size = (w, h)
    lx, ly, edges = [], [], []
    for contour in pts:
        cx, cy, ce = _poly_edges(size, contour.astype(np.int64))
        lx += cx
        ly += cy
        edges += ce
    if lx:
        xs, ys = np.concatenate(lx), np.concatenate(ly)
        img[ys, xs] = value
    if len(edges) < 2:
        return img
    y0, y1, x0, dx = np.asarray(edges, dtype=np.int64).T     # edge rows (y0, y1, x, dx)
    y_lo, y_hi = max(int(y0.min()), 0), min(int(y1.max()), h)
    if y_lo >= y_hi:
        return img
    ys = np.arange(y_lo, y_hi, dtype=np.int64)
    active = (ys[:, None] >= y0[None]) & (ys[:, None] < y1[None])   # [rows, edges]
    xs = x0[None] + (ys[:, None] - y0[None]) * dx[None]
    big = np.iinfo(np.int64).max
    xs = np.sort(np.where(active, xs, big), axis=1)
    n_pairs = xs.shape[1] // 2
    left, right = xs[:, 0:2 * n_pairs:2], xs[:, 1:2 * n_pairs:2]
    ok = right != big
    x1 = (left + XY_ONE - 1) >> XY_SHIFT     # spans run from ceil(left) to floor(right)
    x2 = right >> XY_SHIFT
    ok &= (x1 < w) & (x2 >= 0)
    x1 = np.clip(x1, 0, w)
    x2 = np.clip(x2, -1, w - 1)
    ok &= x2 >= x1
    rows = np.broadcast_to(np.arange(len(ys))[:, None], ok.shape)[ok]
    span = np.zeros((len(ys), w + 1), np.int32)
    np.add.at(span, (rows, x1[ok]), 1)
    np.add.at(span, (rows, x2[ok] + 1), -1)
    fill = np.cumsum(span[:, :w], axis=1) > 0
    r, c = np.nonzero(fill)
    img[ys[r], c] = value
    return img


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
