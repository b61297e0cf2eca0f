"""Host-side geometry helpers of the serving path (NumPy only).

The port's own copy of what it needs from ``fots/geometry.py``: the strip
width rule, the detected-box -> rotated-roi conversion and the per-pixel
quad decode of the NMS adaptor, with the same arithmetic (f32 steps where
the reference decodes in C float).
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


def rroi_from_box(box8: np.ndarray, batch_idx: int = 0) -> Tuple[np.ndarray, float, float]:
    """Detected box (8 coords) -> (rroi[6] = [bid, cx, cy, h, w, angle_deg],
    w, h), with the int() truncation of the centre coordinates."""
    b = np.asarray(box8, dtype=np.float64)[:8].reshape(4, 2)
    center = b.mean(axis=0)
    dw = b[2] - b[1]
    dh = b[1] - b[0]
    w = math.sqrt(dw[0] ** 2 + dw[1] ** 2)
    h = math.sqrt(dh[0] ** 2 + dh[1] ** 2)
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
