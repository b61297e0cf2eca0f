"""ICDAR-style end-to-end evaluation (host).

The port's own copy of ``fots/evaluate.py``, without OpenCV
(``cv2.boundingRect`` is :func:`fots_torch.roirotate.bounding_rect`):
per-image matching of predicted boxes against ground truth by
axis-aligned-bounding-box IoU > 0.5, transcription comparison by edit
distance (exact and <= 1), and running precision / recall / hmean totals.
Only ground-truth entries with transcription length >= ``eval_text_length``
and not '##'-tagged count.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np

from fots_torch.codec import levenshtein
from fots_torch.roirotate import bounding_rect


def _bbox_of(quad8) -> List[float]:
    box = np.asarray(quad8, dtype="int")[:8].reshape(4, 2)
    x, y, w, h = bounding_rect(box)
    return [x, y, x + w, y + h]


def _intersect(a, b):
    r0, c0 = max(a[0], b[0]), max(a[1], b[1])
    r1, c1 = min(a[2], b[2]), min(a[3], b[3])
    return (r0, c0, r1, c1) if (r1 > r0 and c1 > c0) else (0, 0, 0, 0)


def _union(a, b):
    return (min(a[0], b[0]), min(a[1], b[1]), max(a[2], b[2]), max(a[3], b[3]))


def _area(a):
    return abs((a[2] - a[0]) * (a[3] - a[1]))


def evaluate_image(
    detections: Sequence[Tuple[np.ndarray, str]],
    gt_rect: np.ndarray,
    gt_txts: Sequence[str],
    iou_th: float = 0.5,
    iou_th_eval: float = 0.5,
    eval_text_length: int = 3,
):
    """Returns (tp, tp_e2e, gt_e2e, tp_e2e_ed1, detection_to_gt, n_dontcare).

    detections: list of (box-with->=8-coords, predicted text).
    gt_rect: [G, 8+] quad coords; gt_txts: G transcriptions.

    n_dontcare counts detections whose best GT overlap (IoU > iou_th) is an
    ineligible entry ('##'-tagged or shorter than eval_text_length): the
    ICDAR protocol excludes those from the precision denominator.  The
    reference harness does NOT (eval.py:715 counts every emitted
    detection); E2EMetrics only subtracts them under ignore_dontcare=True.
    """
    gt_to_detection: Dict[int, List] = {}
    detection_to_gt: Dict[int, List] = {}
    tp = tp_e2e = tp_e2e_ed1 = gt_e2e = 0
    gt_matches = np.zeros(len(gt_txts))
    gt_matches_ed1 = np.zeros(len(gt_txts))
    n_dontcare = 0
    gt_eligible = [len(t) >= eval_text_length and not t.startswith("##")
                   for t in gt_txts]

    for i, det in enumerate(detections):
        bbox = _bbox_of(det[0])
        det_text = det[1]
        best_elig = best_inelig = 0.0
        for gt_no in range(len(gt_txts)):
            rect_gt = _bbox_of(np.asarray(gt_rect[gt_no]))
            inter = _intersect(bbox, rect_gt)
            uni = _union(bbox, rect_gt)
            ratio = _area(inter) / float(max(_area(uni), 1e-9))
            if gt_eligible[gt_no]:
                best_elig = max(best_elig, ratio)
            else:
                best_inelig = max(best_inelig, ratio)
            if ratio > iou_th:
                if gt_no not in gt_to_detection:
                    gt_to_detection[gt_no] = [0, 0]
                edit_dist = levenshtein(det_text.lower(), gt_txts[gt_no].lower())
                if edit_dist <= 1:
                    gt_matches_ed1[gt_no] = 1
                if edit_dist == 0:
                    gt_matches[gt_no] = 1
                tupl = gt_to_detection[gt_no]
                if tupl[0] < ratio:
                    tupl[0] = ratio
                    tupl[1] = i
                    detection_to_gt[i] = [gt_no, ratio, edit_dist]
        if best_inelig > iou_th and best_inelig > best_elig:
            n_dontcare += 1

    for gt_no in range(len(gt_txts)):
        eligible = gt_eligible[gt_no]
        if eligible:
            gt_e2e += 1
            if gt_matches[gt_no] == 1:
                tp_e2e += 1
            if gt_matches_ed1[gt_no] == 1:
                tp_e2e_ed1 += 1
        if gt_no in gt_to_detection and gt_to_detection[gt_no][0] > iou_th_eval:
            if eligible:
                tp += 1

    return tp, tp_e2e, gt_e2e, tp_e2e_ed1, detection_to_gt, n_dontcare


@dataclass
class E2EMetrics:
    """Running totals (reference eval.py:708-721).

    ignore_dontcare=True applies the proper ICDAR don't-care rule:
    detections overlapping an ignored GT region leave the precision
    denominator.  Default False = byte-for-byte the reference harness'
    accounting (it penalizes them, eval.py:715).
    """

    tp_all: int = 0
    gt_all: int = 0
    tp_e2e_all: int = 0
    gt_e2e_all: int = 0
    tp_e2e_ed1_all: int = 0
    detections_all: int = 0
    ignore_dontcare: bool = False

    def add_image(self, detections, gt_rect, gt_txts, **kw):
        tp, tp_e2e, gt_e2e, tp_ed1, det2gt, n_dc = evaluate_image(
            detections, gt_rect, gt_txts, **kw
        )
        self.tp_all += tp
        self.gt_all += gt_e2e
        self.tp_e2e_all += tp_e2e
        self.gt_e2e_all += gt_e2e
        self.tp_e2e_ed1_all += tp_ed1
        self.detections_all += len(detections) - (n_dc if self.ignore_dontcare else 0)
        return tp, tp_e2e, gt_e2e, tp_ed1, det2gt

    def summary(self) -> Dict[str, float]:
        def safe(n, d):
            return n / d if d else 0.0

        recall = safe(self.tp_all, self.gt_all)
        precision = safe(self.tp_all, self.detections_all)
        recall_e2e = safe(self.tp_e2e_all, self.gt_e2e_all)
        precision_e2e = safe(self.tp_e2e_all, self.detections_all)
        return {
            "detection_recall": recall,
            "detection_precision": precision,
            "detection_hmean": safe(2 * recall * precision, recall + precision),
            "e2e_recall": recall_e2e,
            "e2e_precision": precision_e2e,
            "e2e_hmean": safe(2 * recall_e2e * precision_e2e, recall_e2e + precision_e2e),
            "e2e_recall_ed1": safe(self.tp_e2e_ed1_all, self.gt_e2e_all),
        }
