"""The host stages of batched serving, shared by the in-process engine
(:class:`fots_torch.pipeline.FOTSInference`) and the runtime of an exported
bundle (:class:`fots_torch.export.ExportedEngine`): the host letterbox (u8
BGR, or the ``yuv420`` transport's luma and half-size chroma), the
per-image box cap, bucketing the boxes' rois by strip width, fixed roi
chunks padded with a dummy roi, and the results in source-image pixels.

NumPy only (no torch, no model code), so the bundle's runtime stays free of
the model definition.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from fots_torch.codec import LabelCodec
from fots_torch.geometry import resize_bilinear_u8, rroi_from_box, strip_width_for_box
from fots_torch.imgproc import bgr2yuv_u8, resize_area_u8
from fots_torch.wordsplit import split_detection

#: the roi that pads a recognition chunk (its strip is never read back)
DUMMY_ROI = (0.0, 8.0, 8.0, 8.0, 8.0, 0.0)


def check_images(images_bgr: Sequence[np.ndarray]) -> None:
    for im in images_bgr:
        if im.dtype != np.uint8 or im.ndim != 3 or im.shape[-1] != 3:
            raise ValueError(f"expected u8 [h, w, 3] images, got {im.dtype} {im.shape}")


def letterbox_scales(images_bgr: Sequence[np.ndarray], serve_hw) -> List[float]:
    H, W = serve_hw
    return [min(H / im.shape[0], W / im.shape[1]) for im in images_bgr]


def host_letterbox(images_bgr: Sequence[np.ndarray], serve_hw,
                   batch: Optional[int] = None) -> Tuple[np.ndarray, List[float]]:
    """(u8 batch [batch, H, W, 3], per-image scale): each image resized on the
    host (bilinear, rounded to u8, as cv2's INTER_LINEAR) into the top-left
    corner of a zero canvas, which normalizes to the background value.
    ``batch`` (default: the number of images) pads the batch with blank
    canvases."""
    check_images(images_bgr)
    H, W = serve_hw
    scales = letterbox_scales(images_bgr, serve_hw)
    out = np.zeros((len(images_bgr) if batch is None else batch, H, W, 3), np.uint8)
    for i, (im, s) in enumerate(zip(images_bgr, scales)):
        nh, nw = int(im.shape[0] * s), int(im.shape[1] * s)
        out[i, :nh, :nw] = resize_bilinear_u8(im, (nw, nh))
    return out, scales


def host_letterbox_yuv420(images_bgr: Sequence[np.ndarray], serve_hw
                          ) -> Tuple[Tuple[np.ndarray, np.ndarray], List[float]]:
    """The ``yuv420`` transport's letterbox: ((Y [B, H, W], UV [B, H/2, W/2,
    2]) u8, per-image scale).  Each image is resized as :func:`host_letterbox`
    resizes it, converted to YUV (``cv2.COLOR_BGR2YUV``), its luma put in the
    top-left corner of a zero canvas and its chroma, shrunk to half size by
    area averaging (``cv2.INTER_AREA``), in that of a canvas of 128 (grey)."""
    check_images(images_bgr)
    H, W = serve_hw
    scales = letterbox_scales(images_bgr, serve_hw)
    y = np.zeros((len(images_bgr), H, W), np.uint8)
    uv = np.full((len(images_bgr), H // 2, W // 2, 2), 128, np.uint8)
    for i, (im, s) in enumerate(zip(images_bgr, scales)):
        nh, nw = int(im.shape[0] * s), int(im.shape[1] * s)
        yuv = bgr2yuv_u8(resize_bilinear_u8(im, (nw, nh)))
        y[i, :nh, :nw] = yuv[..., 0]
        ch, cw = (nh + 1) // 2, (nw + 1) // 2
        uv[i, :ch, :cw] = resize_area_u8(yuv[..., 1:], (cw, ch))
    return (y, uv), scales


def cap_boxes(per_image_boxes: List[np.ndarray], max_boxes: Optional[int]):
    """The top ``max_boxes`` by score per image, in their NMS order (None:
    every box; 0 is a valid cap)."""
    if max_boxes is None:
        return per_image_boxes
    out = []
    for b in per_image_boxes:
        if b.shape[0] > max_boxes:
            keep = np.argsort(-b[:, 8], kind="stable")[:max_boxes]
            b = b[np.sort(keep)]
        out.append(b)
    return out


def bucket_rois(per_image_boxes: List[np.ndarray], expand_w_frac: float,
                strip_buckets: Sequence[int]):
    """Every image's rois bucketed by strip width: (rois [R, 6] f32, the
    (image, box) of each roi, {width: roi indices})."""
    rois: List[np.ndarray] = []
    keys: List[Tuple[int, int]] = []
    buckets: Dict[int, List[int]] = {}
    for i, boxes in enumerate(per_image_boxes):
        for j in range(boxes.shape[0]):
            roi, w, h = rroi_from_box(boxes[j], i, expand_w_frac)
            buckets.setdefault(strip_width_for_box(w, h, buckets=tuple(strip_buckets)),
                               []).append(len(rois))
            rois.append(roi)
            keys.append((i, j))
    return np.asarray(rois, np.float32).reshape(-1, 6), keys, buckets


def roi_chunks(rois: np.ndarray, idxs, chunk: int) -> Iterator[Tuple[List[int], np.ndarray]]:
    """(index chunk, rois [chunk, 6] f32) pieces of one width bucket, the
    last one padded with :data:`DUMMY_ROI`."""
    idxs = list(idxs)
    for start in range(0, len(idxs), chunk):
        part = idxs[start:start + chunk]
        sel = np.tile(np.asarray(DUMMY_ROI, np.float32), (chunk, 1))
        sel[:len(part)] = rois[np.asarray(part)]
        yield part, sel


def assemble_results(n: int, per_image_boxes, keys, texts, ids, confs, scales,
                     codec: LabelCodec, split_words: bool = False):
    """Per image a list of {'box': [8 coords + score] in source-image pixels,
    'text', 'conf'} (plus per-word 'words' with ``split_words``); boxes whose
    text is empty are dropped."""
    results: List[List[Dict]] = [[] for _ in range(n)]
    for ridx, (i, j) in enumerate(keys):
        if not texts[ridx]:
            continue
        b = per_image_boxes[i][j].copy()
        b[:8] /= scales[i]
        entry = {"box": b, "text": texts[ridx], "conf": float(confs[ridx])}
        if split_words:
            entry["words"] = [{"quad": q / scales[i], "text": wt}
                              for q, wt in split_detection(per_image_boxes[i][j],
                                                           ids[ridx], codec)]
        results[i].append(entry)
    return results
