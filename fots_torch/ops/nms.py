"""NMS candidates on the device, locality-aware NMS on the host.

Port of ``fots/ops/nms.py``:

1. :func:`extract_candidates` keeps the score/geometry/angle maps on the
   device and ships only the top-k above-threshold pixels, packed
   channel-first ``[B, 8, k]`` (optionally as 16-bit patterns, see
   :func:`pack_candidates_u16`);
2. :func:`get_boxes_from_candidates_batch` (and
   :func:`get_boxes_from_candidates` for one image) restores the
   reference's row-major scan order, decodes quads (NumPy) and merges them
   with the C++ locality-aware NMS (``fots_torch/csrc/nms_core.cpp`` via
   ctypes);
3. :func:`get_boxes` does the same from dense host maps (the maps of
   ``FOTSInference.detect_maps``), and :func:`quad_iou` is the merge's
   rotated-quad IoU.

The top k are chosen as ``jax.lax.top_k`` chooses them: by descending
score, equal scores by ascending pixel index (a stable descending sort;
``torch.topk`` promises no order among ties, and the shipped snapshot's
sigmoid saturates at exactly 1.0 for most text pixels).  So the candidate
set equals the JAX package's also when more than k pixels pass the
threshold, and the same on the CPU as on the card; the host re-sorts the
candidates by pixel index, so the boxes are identical.
"""

from __future__ import annotations

import ctypes
from concurrent.futures import Executor
from typing import List, Optional

import numpy as np
import torch

from fots_torch.geometry import decode_candidates_np, decode_quads_np
from fots_torch.kernels import build

PRECISION = 10000.0


def _lib() -> ctypes.CDLL:
    lib = build.load("nms_core")
    if not getattr(lib, "_fots_typed", False):
        lib.fots_nms.restype = ctypes.c_int
        lib.fots_nms.argtypes = [
            ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_float, ctypes.c_float, ctypes.POINTER(ctypes.c_longlong),
            ctypes.POINTER(ctypes.c_float), ctypes.c_int,
        ]
        lib.fots_quad_iou.restype = ctypes.c_double
        lib.fots_quad_iou.argtypes = [ctypes.POINTER(ctypes.c_double)] * 2
        lib._fots_typed = True
    return lib


def quad_iou(qa, qb) -> float:
    """Rotated-quad IoU (|I| / (|A| + |B| - |I|)) of two quads of 4 (x, y)
    corners, on the merge's 1e-4 fixed point (truncated)."""
    qa = np.ascontiguousarray(np.asarray(qa, np.float64).reshape(8))
    qb = np.ascontiguousarray(np.asarray(qb, np.float64).reshape(8))
    return float(_lib().fots_quad_iou(qa.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                                      qb.ctypes.data_as(ctypes.POINTER(ctypes.c_double))))


def locality_aware_nms(quads, scores, probs, xs, ys, map_w, map_h,
                       iou_th1=0.4, iou_th2=0.2, max_out=1024):
    """Merge decoded candidate quads [N,4,2] (image coords, row-major scan
    order).  Returns [M, 9] float32: 8 quad coords + merged score."""
    n = quads.shape[0]
    if n == 0:
        return np.zeros((0, 9), np.float32)
    quads_fp = np.round(np.asarray(quads, np.float64) * PRECISION).astype(np.int64)
    qin = np.ascontiguousarray(quads_fp.reshape(n, 8))
    scores = np.ascontiguousarray(scores, np.float32)
    probs = np.ascontiguousarray(probs, np.float32)
    xs = np.ascontiguousarray(xs, np.int32)
    ys = np.ascontiguousarray(ys, np.int32)
    out_q = np.zeros((max_out, 8), np.int64)
    out_s = np.zeros((max_out,), np.float32)
    m = _lib().fots_nms(
        qin.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
        scores.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        probs.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        xs.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        ys.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        n, map_w, map_h, iou_th1, iou_th2,
        out_q.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
        out_s.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        max_out,
    )
    m = min(m, max_out)
    ret = np.zeros((m, 9), np.float32)
    ret[:, :8] = out_q[:m].astype(np.float64) / PRECISION
    ret[:, 8] = out_s[:m]
    return ret


def extract_candidates(segm, geo, angle, k: int, segm_thresh: float = 0.5):
    """Top-k above-threshold pixels of each image.

    segm [B,Hs,Ws], geo [B,Hs,Ws,4], angle [B,Hs,Ws,2] (sin, cos), f32 ->
    [B, 8, k] f32, channels ``(score, d0..d3, sin, cos, flat_idx)``.  Slots
    with score <= ``segm_thresh`` carry score -1 (the host drops them).
    Equal scores are taken in ascending pixel order, as ``jax.lax.top_k``
    takes them."""
    b, h, w = segm.shape
    k = min(k, h * w)
    flat = segm.reshape(b, h * w)
    masked = torch.where(flat > segm_thresh, flat, torch.full_like(flat, -1.0))
    scores, idx = torch.sort(masked, dim=1, descending=True, stable=True)
    scores, idx = scores[:, :k], idx[:, :k]
    g = torch.gather(geo.reshape(b, h * w, 4), 1, idx[..., None].expand(b, k, 4))
    a = torch.gather(angle.reshape(b, h * w, 2), 1, idx[..., None].expand(b, k, 2))
    packed = torch.cat([scores[..., None], g, a, idx[..., None].float()],
                       dim=-1).float()
    return packed.transpose(1, 2).contiguous()


def pack_candidates_u16(cands):
    """The u16 candidate transport: channels 0-6 as float16 bit patterns,
    channel 7 the pixel index (< 2^16) as uint16, held in an int16 tensor
    (``.numpy().view(np.uint16)`` on the host)."""
    vals = cands[:, :7].to(torch.float16).view(torch.int16)
    idx = cands[:, 7].to(torch.int32)
    idx = torch.where(idx >= 32768, idx - 65536, idx).to(torch.int16)
    return torch.cat([vals, idx[:, None]], dim=1)


def unpack_candidates(cands: np.ndarray) -> np.ndarray:
    """Inverse of the u16 transport (uint16 packs); f32 packs pass through."""
    cands = np.asarray(cands)
    if cands.dtype != np.uint16:
        return cands
    out = np.empty(cands.shape, np.float32)
    out[..., :7, :] = cands[..., :7, :].view(np.float16)
    out[..., 7, :] = cands[..., 7, :]
    return out


def get_boxes_from_candidates(cands, map_h: int, map_w: int, segm_thresh=0.5,
                              iou_th1=0.4, iou_th2=0.2) -> np.ndarray:
    """Boxes [M, 9] of one image's candidate pack [8, k] (f32, or the u16
    transport's uint16): equal to :func:`get_boxes` over the same maps
    whenever every pixel above the threshold is among the k."""
    return get_boxes_from_candidates_batch(np.asarray(cands)[None], map_h, map_w,
                                           segm_thresh, iou_th1, iou_th2)[0]


def get_boxes_from_candidates_batch(cands, map_h: int, map_w: int,
                                    segm_thresh=0.5, iou_th1=0.4, iou_th2=0.2,
                                    pool: Optional[Executor] = None
                                    ) -> List[np.ndarray]:
    """Boxes [M, 9] of each image of a [B, 8, k] candidate pack: one
    vectorized decode over the batch, then the C++ merge per image (on
    ``pool`` when given; ctypes releases the GIL for the C pass)."""
    cands = unpack_candidates(np.asarray(cands))
    b, _, _ = cands.shape
    scores = cands[:, 0, :]
    valid = scores > segm_thresh
    counts = valid.sum(axis=1)
    idx = cands[:, 7, :].astype(np.int64)
    # row-major scan order per image; invalid slots sort to the end
    order = np.argsort(np.where(valid, idx, np.iinfo(np.int64).max),
                       axis=1, kind="stable")
    nmax = int(counts.max()) if b else 0
    order = order[:, :max(nmax, 1)]
    bi = np.arange(b)[:, None]
    s_sorted = scores[bi, order]
    rows = np.transpose(cands, (0, 2, 1))[bi, order]
    idx_s = rows[..., 7].astype(np.int64)
    ys = idx_s // map_w
    xs = idx_s % map_w
    quads, probs = decode_candidates_np(
        rows[..., 1:5].reshape(-1, 4), rows[..., 5].ravel(),
        rows[..., 6].ravel(), xs.ravel(), ys.ravel())
    quads = quads.reshape(b, -1, 4, 2)
    probs = probs.reshape(b, -1, 4)

    def merge_one(i):
        n = counts[i]
        if n == 0:
            return np.zeros((0, 9), np.float32)
        return locality_aware_nms(quads[i, :n], s_sorted[i, :n], probs[i, :n],
                                  xs[i, :n], ys[i, :n], map_w, map_h,
                                  iou_th1, iou_th2)

    if pool is None or b <= 1 or counts.sum() == 0:
        return [merge_one(i) for i in range(b)]
    return list(pool.map(merge_one, range(b)))


def get_boxes(segm, geo, angle, segm_thresh=0.5, iou_th1=0.4, iou_th2=0.2) -> np.ndarray:
    """Boxes [M, 9] of one image's dense host maps: segm [H, W], geo [H, W,
    4], angle [H, W, 2] (sin, cos), every pixel above ``segm_thresh`` decoded
    in row-major scan order and merged."""
    segm = np.asarray(segm)
    quads, scores, probs, xs, ys = decode_quads_np(segm, np.asarray(geo), np.asarray(angle),
                                                   segm_thresh)
    return locality_aware_nms(quads, scores, probs, xs, ys, segm.shape[1], segm.shape[0],
                              iou_th1, iou_th2)
