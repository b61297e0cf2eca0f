"""NumPy versions of the OpenCV calls that training uses (the port imports no
OpenCV; the card's machine has none).

Each reproduces OpenCV's own arithmetic, vectorised over pixels:

- :func:`fill_poly` is ``cv2.fillPoly(img, pts, value)`` (``LINE_8``, shift
  0): every edge is first drawn as an 8-connected Bresenham line clipped to
  the image, then the polygon is filled over scanline spans from ceil to
  floor of the edges' 16.16 fixed-point x, edges that leave the image
  stepping from their clipped end points, as ``CollectPolyEdges`` and
  ``FillEdgeCollection`` in OpenCV's ``drawing.cpp`` (OpenCV 5) do.  The
  target masks depend on it pixel for pixel, so it is byte-exact.
- :func:`box_blur3` is ``cv2.blur(x, (3, 3))`` on f32 (``BORDER_REFLECT_101``),
  :func:`blur3_u8` the same on a u8 image (exact).
- :func:`bgr2gray_u8` is ``cv2.cvtColor`` BGR -> grey (exact: OpenCV's
  15-bit fixed-point coefficients), :func:`bgr2yuv_u8` BGR -> YUV (exact,
  14-bit); :func:`resize_area_u8` is ``cv2.resize(..., INTER_AREA)`` of a
  2-channel u8 image to a smaller size (exact), the ``yuv420`` transport's
  chroma.
- :func:`pad_constant` is ``cv2.copyMakeBorder(..., BORDER_CONSTANT)``.
- :func:`warp_affine_u8` is ``cv2.warpAffine`` (``INTER_LINEAR``, zero
  border) of a u8 image as OpenCV 5 computes it (exact): the inverse map's
  source coordinates and the bilinear lerps in f32 with fused multiply-adds,
  rounded half to even.  The coordinates are rounded differently in the
  vector body of a row (16 pixels a step) and in its scalar tail.
- :func:`bgr2hsv_u8` is ``cv2.cvtColor`` BGR->HSV on u8 with H in 0..179,
  through OpenCV's ``hsv_shift = 12`` division tables (exact);
  :func:`hsv2bgr_u8` is HSV->BGR in f32 with fused multiply-adds (exact):
  OpenCV's vector body (32 pixels a step) truncates, its scalar tail rounds.

The fused multiply-adds are :func:`fma_f32`, exact in f64 arithmetic.

Drawing, for the images the entry points write (each byte for byte):

- :func:`polylines` is ``cv2.polylines(img, [pts], True, color, 1)``
  (``LINE_8``, shift 0): every edge is the clipped 8-connected line
  :func:`line_pixels` walks;
- :func:`get_rotation_matrix_2d` is ``cv2.getRotationMatrix2D`` (its centre
  a ``Point2f``) in f64;
- :func:`apply_color_map_jet` is ``cv2.applyColorMap(g, COLORMAP_JET)`` of a
  grey u8 image, through :data:`JET_LUT`: GNU Octave's ``jet`` at 256 points
  in f64, stored as f32, interpolated at OpenCV's f32 ``linspace(0, 1, 256)``
  and scaled by 255 as OpenCV's ``ColorMap`` builds its table;
- :func:`add_weighted_u8` is ``cv2.addWeighted`` of two u8 images (gamma
  0): ``fma(a, alpha, fma(b, beta, 0))`` in f32, rounded half to even.

- :func:`put_text` is ``cv2.putText(img, text, org, FONT_HERSHEY_SIMPLEX,
  0.5, color, 1)``, the one text call of ``fots``: OpenCV 5 draws the
  Hershey faces from its built-in TrueType font (Rubik), antialiased.  Each
  glyph lands on whole pixels, so the port draws from an atlas of OpenCV's
  own coverage bitmaps and pen advances (``assets/text_glyphs/``, measured
  from ``cv2`` by ``tools/make_torch_text_refs.py``), blended glyph after
  glyph as OpenCV blends them.

The bilinear u8 resize is :func:`fots_torch.geometry.resize_bilinear_u8`.
"""

from __future__ import annotations

import functools
import math
import os
from typing import Tuple

import numpy as np

XY_SHIFT = 16            # drawing.cpp's fixed point
XY_ONE = 1 << XY_SHIFT
HSV_SHIFT = 12


# --------------------------------------------------------------------------
# polygon fill
# --------------------------------------------------------------------------

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


# --------------------------------------------------------------------------
# filters and borders
# --------------------------------------------------------------------------

def box_blur3(x: np.ndarray) -> np.ndarray:
    """``cv2.blur(x, (3, 3))`` of an f32 [h, w] map: reflect-101 border, the
    3x3 sum in f64 times 1/9, rounded to f32."""
    xp = np.pad(np.asarray(x, np.float64), 1, mode="reflect")
    rows = xp[:, :-2] + xp[:, 1:-1] + xp[:, 2:]
    s = rows[:-2] + rows[1:-1] + rows[2:]
    return (s * (1.0 / 9.0)).astype(np.float32)


def blur3_u8(im: np.ndarray) -> np.ndarray:
    """``cv2.blur(im, (3, 3))`` of a u8 image [h, w, c]: reflect-101 border,
    the 3x3 integer sum divided by 9 and rounded (no sum is a half-way
    case)."""
    p = np.pad(im.astype(np.int32), ((1, 1), (1, 1), (0, 0)), mode="reflect")
    rows = p[:, :-2] + p[:, 1:-1] + p[:, 2:]
    s = rows[:-2] + rows[1:-1] + rows[2:]
    return np.rint(s / 9.0).astype(np.uint8)


def bgr2gray_u8(im: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(im, cv2.COLOR_BGR2GRAY)`` of a u8 [h, w, 3] BGR image:
    ``0.299 R + 0.587 G + 0.114 B`` in OpenCV's 15-bit fixed point, rounded.
    Returns [h, w, 1]."""
    b, g, r = (im[..., i].astype(np.int64) for i in range(3))
    return ((b * 3735 + g * 19235 + r * 9798 + (1 << 14)) >> 15).astype(np.uint8)[..., None]


def bgr2yuv_u8(im: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(im, cv2.COLOR_BGR2YUV)`` of a u8 [h, w, 3] BGR image, in
    OpenCV's 14-bit fixed point: ``Y = (4899 R + 9617 G + 1868 B + 2^13) >>
    14``, ``U = ((B - Y) 8061 + (128 << 14) + 2^13) >> 14``, ``V = ((R - Y)
    14369 + (128 << 14) + 2^13) >> 14``, each clipped to [0, 255] (the vector
    body and the scalar tail of a row agree)."""
    b, g, r = (im[..., i].astype(np.int32) for i in range(3))
    half = 1 << 13
    y = (r * 4899 + g * 9617 + b * 1868 + half) >> 14
    u = ((b - y) * 8061 + (128 << 14) + half) >> 14
    v = ((r - y) * 14369 + (128 << 14) + half) >> 14
    return np.clip(np.stack([y, u, v], axis=-1), 0, 255).astype(np.uint8)


def _area_taps(src: int, dst: int):
    """``computeResizeAreaTab`` of OpenCV's ``resize.cpp`` for one axis,
    grouped by output pixel: (source index [dst, K], f32 weight [dst, K]) in
    the order OpenCV accumulates them (unused slots weigh 0)."""
    scale = src / dst
    taps = []
    for d in range(dst):
        f1 = d * scale
        f2 = f1 + scale
        cell = min(scale, src - f1)
        s2 = min(math.floor(f2), src - 1)
        s1 = min(math.ceil(f1), s2)
        row = []
        if s1 - f1 > 1e-3:
            row.append((s1 - 1, (s1 - f1) / cell))
        row += [(s, 1.0 / cell) for s in range(s1, s2)]
        if f2 - s2 > 1e-3:
            row.append((s2, min(f2 - s2, 1.0, cell) / cell))
        taps.append(row)
    k = max(len(row) for row in taps)
    idx = np.zeros((dst, k), np.int64)
    wt = np.zeros((dst, k), np.float32)
    for d, row in enumerate(taps):
        for j, (s, a) in enumerate(row):
            idx[d, j], wt[d, j] = s, a
    return idx, wt


def resize_area_u8(im: np.ndarray, dsize: Tuple[int, int]) -> np.ndarray:
    """``cv2.resize(im, dsize, interpolation=cv2.INTER_AREA)`` of a u8 [h, w,
    2] image to a size no larger on either axis; ``dsize`` is (width,
    height).  Integral factors on both axes average each cell as an integer
    sum times the f32 ``1 / area`` (OpenCV's ``resizeAreaFast_``); any other
    factor weighs each source pixel by its f32 overlap, a horizontal pass
    then a vertical one, accumulated in f32 without fused multiply-adds
    (``ResizeArea_Invoker``).  Both round half to even."""
    if im.dtype != np.uint8 or im.ndim != 3 or im.shape[2] != 2:
        raise ValueError(f"expected a u8 [h, w, 2] image, got {im.dtype} {im.shape}")
    dw, dh = int(dsize[0]), int(dsize[1])
    h, w = im.shape[:2]
    if not (0 < dw <= w and 0 < dh <= h):
        raise ValueError(f"INTER_AREA here only shrinks: {w}x{h} -> {dw}x{dh}")
    sx, sy = w / dw, h / dh
    if sx == int(sx) and sy == int(sy):
        sx, sy = int(sx), int(sy)
        cells = im.astype(np.int32).reshape(dh, sy, dw, sx, 2).sum(axis=(1, 3))
        out = cells.astype(np.float32) * (np.float32(1.0) / np.float32(sx * sy))
    else:
        xi, xw = _area_taps(w, dw)
        yi, yw = _area_taps(h, dh)
        src = im.astype(np.float32)
        hor = src[:, xi[:, 0]] * xw[None, :, 0, None]
        for j in range(1, xi.shape[1]):
            hor = hor + src[:, xi[:, j]] * xw[None, :, j, None]
        out = yw[:, 0, None, None] * hor[yi[:, 0]]
        for j in range(1, yi.shape[1]):
            out = out + yw[:, j, None, None] * hor[yi[:, j]]
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


def pad_constant(im: np.ndarray, top: int, bottom: int, left: int, right: int,
                 value=0) -> np.ndarray:
    """``cv2.copyMakeBorder(im, top, bottom, left, right, BORDER_CONSTANT)``."""
    widths = [(top, bottom), (left, right)] + [(0, 0)] * (im.ndim - 2)
    return np.pad(im, widths, mode="constant", constant_values=value)


# --------------------------------------------------------------------------
# affine warp
# --------------------------------------------------------------------------

def invert_affine(m) -> np.ndarray:
    """warpAffine's inverse of a forward 2x3 matrix, in its f64 arithmetic."""
    m = [float(v) for v in np.asarray(m, np.float64).reshape(6)]
    d = m[0] * m[4] - m[1] * m[3]
    d = 1.0 / d if d != 0 else 0.0
    a11, a22 = m[4] * d, m[0] * d
    m[0], m[1], m[3], m[4] = a11, m[1] * -d, m[3] * -d, a22
    b1 = -m[0] * m[2] - m[1] * m[5]
    b2 = -m[3] * m[2] - m[4] * m[5]
    m[2], m[5] = b1, b2
    return np.asarray(m, np.float64).reshape(2, 3)


WARP_VECTOR = 16   # warpAffine's u8 vector body: destination pixels a step


def fma_f32(a, b, c) -> np.ndarray:
    """``a * b + c`` of f32 values rounded once to f32, as a fused
    multiply-add computes it.  The product is exact in f64; the sum's
    rounding error comes from Knuth's two-sum, and decides the one case in
    which rounding the f64 sum to f32 would round twice: a sum halfway
    between two f32 values."""
    a64, b64, c64 = (np.asarray(v, np.float32).astype(np.float64) for v in (a, b, c))
    p = a64 * b64
    s = p + c64
    z = s - p
    err = (p - (s - z)) + (c64 - z)
    r = s.astype(np.float32)
    r64 = r.astype(np.float64)
    d = s - r64
    away = np.nextafter(r, np.where(d > 0, np.float32(np.inf), np.float32(-np.inf)))
    tie = (d != 0) & (2 * d == away.astype(np.float64) - r64)
    return np.where(tie & (err != 0) & ((err > 0) == (d > 0)), away, r)


def warp_source_coords(m, rows: np.ndarray, cols: np.ndarray, width: int):
    """f32 source coordinates (sx, sy) [len(rows), len(cols)] of destination
    pixels ``rows`` x ``cols`` of a ``width``-wide warp under forward matrix
    ``m``: the inverse map ``i0 x + i1 y + i2`` in f32, as warpAffine's u8
    kernel rounds it: ``fma(x, i0, i1 y + i2)`` in a row's vector body (the
    first ``width // 16 * 16`` pixels), ``fma(x, i0, i1 y) + i2`` in its
    scalar tail."""
    inv = invert_affine(m).astype(np.float32)
    y = np.asarray(rows, np.float32)[:, None]
    x = np.asarray(cols, np.float32)[None, :]
    body = np.asarray(cols)[None, :] < width // WARP_VECTOR * WARP_VECTOR
    out = []
    for i0, i1, i2 in inv:
        vec = fma_f32(x, i0, i1 * y + i2)
        tail = fma_f32(x, i0, i1 * y) + i2
        out.append(np.where(body, vec, tail))
    return out[0], out[1]


def bilinear_sample_u8(fetch, sx: np.ndarray, sy: np.ndarray) -> np.ndarray:
    """u8 bilinear sampling at f32 coordinates as warpAffine interpolates:
    two f32 lerps along x and one along y, each a fused multiply-add,
    rounded half to even.  ``fetch(ys, xs)`` returns the source's u8 pixels
    [..., c] at integer coordinates, zero outside."""
    ix, iy = np.floor(sx), np.floor(sy)
    a = (sx - ix)[..., None]
    b = (sy - iy)[..., None]
    ix, iy = ix.astype(np.int64), iy.astype(np.int64)
    p00 = fetch(iy, ix).astype(np.float32)
    p01 = fetch(iy, ix + 1).astype(np.float32)
    p10 = fetch(iy + 1, ix).astype(np.float32)
    p11 = fetch(iy + 1, ix + 1).astype(np.float32)
    v0 = fma_f32(a, p01 - p00, p00)
    v1 = fma_f32(a, p11 - p10, p10)
    return np.clip(np.rint(fma_f32(b, v1 - v0, v0)), 0, 255).astype(np.uint8)


def zero_border_fetch(im: np.ndarray):
    """``fetch(ys, xs)`` of ``im``'s pixels, 0 outside the image."""
    h, w = im.shape[:2]

    def fetch(ys, xs):
        inside = (ys >= 0) & (ys < h) & (xs >= 0) & (xs < w)
        out = im[np.where(inside, ys, 0), np.where(inside, xs, 0)]
        out[~inside] = 0
        return out

    return fetch


def warp_affine_u8(im: np.ndarray, m, dsize: Tuple[int, int]) -> np.ndarray:
    """``cv2.warpAffine(im, m, dsize)`` (``INTER_LINEAR``, ``BORDER_CONSTANT``
    0) of a u8 image [h, w, c]; ``dsize`` is (width, height)."""
    if im.dtype != np.uint8 or im.ndim != 3:
        raise ValueError(f"expected a u8 [h, w, c] image, got {im.dtype} {im.shape}")
    sx, sy = warp_source_coords(m, np.arange(dsize[1]), np.arange(dsize[0]), dsize[0])
    return bilinear_sample_u8(zero_border_fetch(im), sx, sy)


# --------------------------------------------------------------------------
# colour
# --------------------------------------------------------------------------

def _hsv_tables():
    i = np.arange(1, 256, dtype=np.float64)
    sdiv = np.concatenate([[0], np.rint((255 << HSV_SHIFT) / i)]).astype(np.int64)
    hdiv = np.concatenate([[0], np.rint((180 << HSV_SHIFT) / (6.0 * i))]).astype(np.int64)
    return sdiv, hdiv


_SDIV, _HDIV180 = _hsv_tables()


def bgr2hsv_u8(im: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(im, COLOR_BGR2HSV)`` of u8 BGR [..., 3]: H in 0..179."""
    src = im.astype(np.int64)
    b, g, r = src[..., 0], src[..., 1], src[..., 2]
    v = np.maximum(np.maximum(b, g), r)
    vmin = np.minimum(np.minimum(b, g), r)
    diff = v - vmin
    half = 1 << (HSV_SHIFT - 1)
    s = (diff * _SDIV[v] + half) >> HSV_SHIFT
    h = np.where(v == r, g - b, np.where(v == g, b - r + 2 * diff, r - g + 4 * diff))
    h = (h * _HDIV180[diff] + half) >> HSV_SHIFT
    h = np.where(h < 0, h + 180, h)
    return np.stack([np.clip(h, 0, 255), s, v], axis=-1).astype(np.uint8)


_SECTOR = np.array([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1], [0, 1, 3], [2, 1, 0]])
HSV_VECTOR = 32   # HSV->BGR's u8 vector body: pixels a step


def hsv2bgr_u8(im: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(im, COLOR_HSV2BGR)`` of a u8 HSV image [h, w, 3] (H in
    0..179) in f32 arithmetic, as OpenCV 5 computes it row by row: the
    sector table with ``1 - s h`` and ``1 - s (1 - h)`` as fused
    multiply-adds, times 255, truncated in a row's vector body (the first
    ``w // 32 * 32`` pixels) and rounded half to even in its tail."""
    f32 = np.float32
    one = f32(1.0)
    h = im[..., 0].astype(f32) * f32(6.0 / 180.0)
    s = im[..., 1].astype(f32) * f32(1.0 / 255.0)
    v = im[..., 2].astype(f32) * f32(1.0 / 255.0)
    h = np.fmod(h, f32(6.0))
    sector = np.floor(h).astype(np.int64)
    h = h - sector.astype(f32)
    tab = np.stack([v, v * (one - s), v * fma_f32(-s, h, one),
                    v * fma_f32(-s, one - h, one)], -1)
    bgr = np.take_along_axis(tab, _SECTOR[sector], axis=-1) * f32(255.0)
    body = np.arange(im.shape[-2]) < im.shape[-2] // HSV_VECTOR * HSV_VECTOR
    out = np.where(body[:, None], np.floor(bgr), np.rint(bgr))
    return np.clip(out, 0, 255).astype(np.uint8)


# --------------------------------------------------------------------------
# drawing and colour maps
# --------------------------------------------------------------------------

def polylines(img: np.ndarray, pts, color) -> np.ndarray:
    """``cv2.polylines(img, [pts], True, color, 1)`` in place (and
    returned): one closed polyline of int32 [n, 2] points (x, y),
    ``LINE_8``, thickness 1, shift 0."""
    pts = np.asarray(pts)
    if pts.dtype != np.int32 or pts.ndim != 2:
        raise TypeError(f"polylines takes int32 [n, 2] points (as cv2 does), got "
                        f"{pts.dtype} {pts.shape}")
    size = (img.shape[1], img.shape[0])
    pts = pts.astype(np.int64)
    for i in range(len(pts)):
        xs, ys = line_pixels(size, tuple(pts[i - 1]), tuple(pts[i]))
        img[ys, xs] = color
    return img


TEXT_ATLAS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "assets",
                          "text_glyphs", "atlas.npz")


@functools.lru_cache(maxsize=None)
def _text_atlas() -> dict:
    """{char: (dy, dx, u8 coverage bitmap, advance)} of ``TEXT_ATLAS``."""
    with np.load(TEXT_ATLAS) as z:
        a = {k: z[k] for k in z.files}
    return {chr(c): (int(dy), int(dx), a["pixels"][o:o + h * w].reshape(h, w), int(adv))
            for c, dy, dx, h, w, o, adv in zip(a["chars"], a["dy"], a["dx"], a["height"],
                                                a["width"], a["offset"], a["advance"])}


def put_text(img: np.ndarray, text: str, org, color) -> np.ndarray:
    """``cv2.putText(img, text, org, cv2.FONT_HERSHEY_SIMPLEX, 0.5, color, 1)``
    in place (and returned) on a u8 image (H, W) or (H, W, C), ``org`` the
    bottom-left of the text on its baseline.  The pen starts at ``org`` and
    moves by each character's advance; each glyph's coverage ``a`` blends
    over the image, clipped at its edges, as ``(c * a + p * (255 - a) +
    127) // 255`` per channel (colour ``c``, pixel ``p``), glyph after glyph,
    so overlapping glyphs blend twice.  Raises ``ValueError`` for a character
    outside the atlas (the ICDAR 2015 alphabet)."""
    atlas = _text_atlas()
    missing = sorted(set(text) - atlas.keys())
    if missing:
        raise ValueError(f"put_text: no glyph for {missing} (the atlas holds the ICDAR "
                         "2015 alphabet)")
    if img.dtype != np.uint8 or img.ndim not in (2, 3):
        raise TypeError(f"put_text draws on u8 (H, W) or (H, W, C) images, got "
                        f"{img.dtype} {img.shape}")
    h, w = img.shape[:2]
    col = np.asarray(color, np.int32)[:img.shape[2]] if img.ndim == 3 else np.int32(color[0])
    x, y = int(org[0]), int(org[1])
    for ch in text:
        dy, dx, m, advance = atlas[ch]
        y0, x0 = y + dy, x + dx
        ya, yb = max(y0, 0), min(y0 + m.shape[0], h)
        xa, xb = max(x0, 0), min(x0 + m.shape[1], w)
        if ya < yb and xa < xb:
            a = m[ya - y0:yb - y0, xa - x0:xb - x0].astype(np.int32)
            if img.ndim == 3:
                a = a[..., None]
            p = img[ya:yb, xa:xb].astype(np.int32)
            img[ya:yb, xa:xb] = (col * a + p * (255 - a) + 127) // 255
        x += advance
    return img


def get_rotation_matrix_2d(center, angle: float, scale: float) -> np.ndarray:
    """``cv2.getRotationMatrix2D(center, angle, scale)``: f64 [2, 3], the
    centre rounded to f32 as cv2's ``Point2f`` holds it."""
    cx, cy = (float(np.float32(v)) for v in center)
    a = float(angle) * (np.pi / 180)
    alpha = np.cos(a) * float(scale)
    beta = np.sin(a) * float(scale)
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy],
                     [-beta, alpha, beta * cx + (1 - alpha) * cy]], np.float64)


def _jet_lut() -> np.ndarray:
    f32 = np.float32
    n = 256
    x = np.arange(n) * (1.0 / (n - 1))
    x[-1] = 1.0
    r = (((x >= 3 / 8) & (x < 5 / 8)) * (4 * x - 3 / 2) + ((x >= 5 / 8) & (x < 7 / 8))
         + (x >= 7 / 8) * (-4 * x + 9 / 2))
    g = (((x >= 1 / 8) & (x < 3 / 8)) * (4 * x - 1 / 2) + ((x >= 3 / 8) & (x < 5 / 8))
         + ((x >= 5 / 8) & (x < 7 / 8)) * (-4 * x + 7 / 2))
    b = ((x < 1 / 8) * (4 * x + 1 / 2) + ((x >= 1 / 8) & (x < 3 / 8))
         + ((x >= 3 / 8) & (x < 5 / 8)) * (-4 * x + 5 / 2))
    pts = np.arange(n, dtype=f32) * (f32(1) / f32(n - 1))      # OpenCV's linspace
    hi = np.maximum(np.arange(n), 1)
    lo = hi - 1
    out = []
    for y in (b, g, r):                                       # interp1 at its own nodes
        y = y.astype(f32)
        v = y[lo] + ((pts - pts[lo]) * (y[hi] - y[lo])) / (pts[hi] - pts[lo])
        out.append(np.rint(v * f32(255)))
    return np.clip(np.stack(out, -1), 0, 255).astype(np.uint8)


#: ``COLORMAP_JET``'s table, BGR [256, 3]
JET_LUT = _jet_lut()


def apply_color_map_jet(gray: np.ndarray) -> np.ndarray:
    """``cv2.applyColorMap(gray, cv2.COLORMAP_JET)`` of a u8 [h, w] image:
    BGR [h, w, 3]."""
    gray = np.asarray(gray)
    if gray.dtype != np.uint8 or gray.ndim != 2:
        raise TypeError(f"apply_color_map_jet takes a u8 [h, w] image, got "
                        f"{gray.dtype} {gray.shape}")
    return JET_LUT[gray]


def add_weighted_u8(a: np.ndarray, alpha: float, b: np.ndarray, beta: float) -> np.ndarray:
    """``cv2.addWeighted(a, alpha, b, beta, 0)`` of two u8 images of one
    shape."""
    if a.shape != b.shape or a.dtype != np.uint8 or b.dtype != np.uint8:
        raise ValueError(f"add_weighted_u8: two u8 images of one shape, got "
                         f"{a.dtype} {a.shape} and {b.dtype} {b.shape}")
    f32 = np.float32
    v = fma_f32(a.astype(f32), f32(alpha), fma_f32(b.astype(f32), f32(beta), f32(0)))
    return np.clip(np.rint(v), 0, 255).astype(np.uint8)
