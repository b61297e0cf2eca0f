"""Visual-debug dumps of sampled training rois, the port of
``fots/debug_vis.py``.

Every sampled roi is cropped from the step's input image and written as a
JPEG whose name carries the step, the slot and the ground-truth
transcription, so a reader can check that RoIRotate sampled legible, upright
word strips.  The crop is one inverse-affine warp
(:func:`fots_torch.imgproc.get_rotation_matrix_2d` +
:func:`fots_torch.imgproc.warp_affine_u8`) and the file is written by
:func:`fots_torch.imageio.imwrite`; each equals its OpenCV call byte for
byte, so the files equal ``fots``'s.

Host only (NumPy and the JPEG encoder): it queues no work on the card.
"""

from __future__ import annotations

import os
import re

import numpy as np

from fots_torch.imageio import imwrite
from fots_torch.imgproc import get_rotation_matrix_2d, warp_affine_u8


def _safe(text: str, max_len: int = 24) -> str:
    """Filesystem-safe slug of a transcription."""
    return re.sub(r"[^0-9A-Za-z_-]", "_", text)[:max_len] or "_"


def crop_rroi_image(image_u8: np.ndarray, roi, norm_height: int = 44) -> np.ndarray:
    """Axis-align one rotated roi ``[_, cx, cy, h, w, angle_deg]`` of a u8
    [H, W, C] image with one inverse-affine warp: [norm_height, out_w, C]."""
    _, cx, cy, h, w, angle = [float(v) for v in roi[:6]]
    h = max(h, 1.0)
    w = max(w, 1.0)
    scale = norm_height / h
    out_w = max(int(round(w * scale)), 1)
    # rotate by -angle about the roi centre, then scale and move the roi box
    # to the origin
    m = get_rotation_matrix_2d((cx, cy), angle, scale)
    m[0, 2] += out_w / 2.0 - cx
    m[1, 2] += norm_height / 2.0 - cy
    return warp_affine_u8(image_u8, m, (out_w, norm_height))


def dump_roi_crops(images, roi_batch, codec, out_dir: str, step: int,
                   norm_height: int = 44, max_crops: int = 32) -> int:
    """Write each valid roi's image crop to ``out_dir`` as
    ``crop_<step>_<slot>_<pred|gt>_<text>.jpg``.

    images: [B, H, W, 3] normalised (im / 128 - 1) floats or u8.
    roi_batch: a :class:`fots_torch.roirotate.RoiBatch`.
    Returns the number of crops written."""
    os.makedirs(out_dir, exist_ok=True)
    images = np.asarray(images)
    if images.dtype != np.uint8:
        images = np.clip((images + 1.0) * 128.0, 0, 255).astype(np.uint8)
    n = 0
    for j in range(roi_batch.rois.shape[0]):
        if roi_batch.roi_mask[j] <= 0:
            continue
        roi = roi_batch.rois[j]
        b = int(roi[0])
        if not 0 <= b < images.shape[0]:
            continue
        crop = crop_rroi_image(images[b], roi, norm_height)
        ln = int(roi_batch.label_lengths[j])
        # raw: the ground-truth ids are labels, not CTC frames (keep doubled letters)
        text = codec.decode_ids(roi_batch.labels[j][:ln], raw=True) if ln else ""
        kind = "pred" if j < roi_batch.n_predicted else "gt"
        imwrite(os.path.join(out_dir, f"crop_{step:06d}_{j:02d}_{kind}_{_safe(text)}.jpg"),
                crop)
        n += 1
        if n >= max_crops:
            break
    return n
