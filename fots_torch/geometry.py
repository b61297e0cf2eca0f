"""Host-side geometry helpers of the serving path (NumPy only).

The port's own copy of what it needs from ``fots/geometry.py``: the strip
width rule, the detected-box -> rotated-roi conversion, the per-pixel
quad decode of the NMS adaptor, with the same arithmetic (f32 steps where
the reference decodes in C float), and the /32 input sizing over a NumPy
bilinear u8 resize (``cv2.resize``'s ``INTER_LINEAR`` in its fixed-point
arithmetic; the port imports no OpenCV).
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np

TARGET_H = 11  # recognition strip height at 1/4 scale


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


def _linear_taps(src: int, dst: int):
    """Half-pixel bilinear taps of ``cv2.resize(..., INTER_LINEAR)``: (lo, hi,
    a0, a1) with the weights as cv2's rounded fixed-point integers."""
    pos = ((np.arange(dst) + 0.5) * (src / dst) - 0.5).astype(np.float32)
    lo = np.floor(pos).astype(np.int64)
    fr = pos - lo.astype(np.float32)
    fr[lo < 0] = 0.0
    fr[lo >= src - 1] = 0.0
    lo = np.clip(lo, 0, src - 1)
    hi = np.minimum(lo + 1, src - 1)
    one = np.float32(1 << _COEF_BITS)
    a0 = np.rint((np.float32(1.0) - fr) * one).astype(np.int32)
    a1 = np.rint(fr * one).astype(np.int32)
    return lo, hi, a0, a1


def resize_bilinear_u8(im: np.ndarray, dsize: Tuple[int, int]) -> np.ndarray:
    """``cv2.resize(im, dsize)`` (``INTER_LINEAR``) of a u8 image [h, w, c]
    in NumPy; ``dsize`` is (width, height) as in cv2.  The arithmetic is
    cv2's 8-bit path: integer taps scaled by 2^11, a horizontal pass in
    int32, then ``(((b0 * (s0 >> 4)) >> 16) + ((b1 * (s1 >> 4)) >> 16) + 2) >> 2``."""
    if im.dtype != np.uint8 or im.ndim != 3:
        raise ValueError(f"expected a u8 [h, w, c] image, got {im.dtype} {im.shape}")
    dw, dh = int(dsize[0]), int(dsize[1])
    h, w = im.shape[:2]
    if (dh, dw) == (h, w):
        return im.copy()
    xlo, xhi, xa0, xa1 = _linear_taps(w, dw)
    ylo, yhi, ya0, ya1 = _linear_taps(h, dh)
    src = im.astype(np.int32)
    hor = src[:, xlo] * xa0[None, :, None] + src[:, xhi] * xa1[None, :, None]
    s0 = hor[ylo] >> 4
    s1 = hor[yhi] >> 4
    out = (((ya0[:, None, None] * s0) >> 16) + ((ya1[:, None, None] * s1) >> 16) + 2) >> 2
    return np.clip(out, 0, 255).astype(np.uint8)


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
