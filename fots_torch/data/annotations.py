"""Ground-truth annotation parsing (host side, NumPy).

The port's own copy of ``fots/data/annotations.py``, without OpenCV
(``cv2.boxPoints`` is :func:`fots_torch.roirotate.box_points`).  Formats:
- MLT: space-separated ``cls cx cy w h angle text`` with centre and size
  normalised by the image diagonal;
- ICDAR-style: comma-separated 8 absolute corner coordinates (+ an optional
  class column) + transcription; for ICDAR2015 files the corner order is
  rolled by one point.

Ignore tags: text '*' or starting with '###'.  :func:`parse_annotation_text`
reads ground truth that is already in memory (an evaluation asset carries
the files' texts beside the decoded pixels).
"""

from __future__ import annotations

import math
import os
from typing import List, Sequence, Tuple

import numpy as np

from fots_torch.roirotate import box_points


def parse_mlt_lines(lines: Sequence[str], im_shape) -> Tuple[np.ndarray, np.ndarray, List[str]]:
    polys, tags, labels = [], [], []
    norm = math.sqrt(im_shape[0] ** 2 + im_shape[1] ** 2)
    for line in lines:
        line = line.replace("﻿", "").strip()
        if not line:
            continue
        s = line.split(" ")
        cls, x, y, w, h, angle = map(float, s[:6])
        del cls
        if angle < -50:  # parity: reference clamps wild angles (data_gen.py:61-63)
            angle = 0.0
        rect = ((x * im_shape[1], y * im_shape[0]), (w * norm, h * norm), angle * 180 / math.pi)
        pts = box_points(*rect).reshape(4, 2)
        text = " ".join(s[6:]).strip()
        polys.append(pts)
        labels.append(text)
        tags.append(text == "*" or text.startswith("###"))
    return _pack(polys, tags, labels)


def parse_icdar_lines(lines: Sequence[str], roll_icdar: bool) -> Tuple[np.ndarray, np.ndarray, List[str]]:
    polys, tags, labels = [], [], []
    for line in lines:
        line = line.replace("﻿", "").strip()
        if not line:
            continue
        s = line.split(",")
        # icdar: 8 coords then text; MLT-done: 8 coords, class, text
        rs = 8 if roll_icdar else 9
        text = ",".join(s[rs:]).strip()
        pts = np.asarray(list(map(float, s[:8])))
        if roll_icdar:
            pts = np.roll(pts, 2)
        polys.append(pts.reshape(4, 2))
        labels.append(text)
        tags.append(text == "*" or text.startswith("###"))
    return _pack(polys, tags, labels)


def _pack(polys, tags, labels):
    if polys:
        return (
            np.asarray(polys, dtype=np.float64),
            np.asarray(tags, dtype=bool),
            labels,
        )
    return np.zeros((0, 4, 2), np.float64), np.zeros((0,), bool), []


def gt_path_for_image(im_name: str) -> Tuple[str, str]:
    """Candidate annotation paths (reference data_gen.py:613-615):
    ``<img>.txt`` next to the image and ``gt_<img>.txt``."""
    base, _ext = os.path.splitext(im_name)
    txt_fn = base + ".txt"
    txt_fn_gt = os.path.join(os.path.dirname(im_name), "gt_" + os.path.basename(txt_fn))
    return txt_fn, txt_fn_gt


def parse_annotation_text(text: str, gt_name: str, im_shape
                          ) -> Tuple[np.ndarray, np.ndarray, List[str]]:
    """Parse the text of one annotation file.  ``gt_name`` is the file's
    name, which selects the format as :func:`load_annotation` does:
    ``gt_``-prefixed files are comma-separated (with the ICDAR2015 corner roll
    for icdar-2015 paths), others are comma-separated or MLT by their first
    field."""
    lines = text.splitlines(keepends=True)
    if os.path.basename(gt_name).startswith("gt_"):
        return parse_icdar_lines(lines, roll_icdar="icdar-2015" in gt_name.lower())
    first = lines[0] if lines else ""
    if "," in first.split(" ")[0]:
        return parse_icdar_lines(lines, roll_icdar=False)
    return parse_mlt_lines(lines, im_shape)


def load_annotation(im_name: str, im_shape) -> Tuple[np.ndarray, np.ndarray, List[str]]:
    """Load the ground truth of an image: ``gt_<img>.txt`` beside it, else
    ``<img>.txt``; no file gives no boxes."""
    txt_fn, txt_fn_gt = gt_path_for_image(im_name)
    for path in (txt_fn_gt, txt_fn):
        if os.path.exists(path):
            with open(path, "r", encoding="utf-8") as f:
                return parse_annotation_text(f.read(), path, im_shape)
    return _pack([], [], [])


def load_image_list(list_path: str) -> List[str]:
    """Image list file -> absolute paths (reference data_gen.py:24-37)."""
    base_dir = os.path.dirname(list_path)
    out = []
    with open(list_path) as f:
        for x in f.readlines():
            x = x.strip()
            if not x:
                continue
            if not x.startswith("/"):
                x = os.path.join(base_dir, x)
            out.append(x)
    return out
