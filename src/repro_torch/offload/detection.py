"""Detection metrics: greedy IoU matching and F1 (the paper's accuracy
measure: F1 between rendered/inferred results and ground truth)."""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np


def iou(a, b) -> float:
    ax1, ay1, ax2, ay2 = a
    bx1, by1, bx2, by2 = b
    ix1, iy1 = max(ax1, bx1), max(ay1, by1)
    ix2, iy2 = min(ax2, bx2), min(ay2, by2)
    iw, ih = max(ix2 - ix1, 0.0), max(iy2 - iy1, 0.0)
    inter = iw * ih
    ua = (ax2 - ax1) * (ay2 - ay1) + (bx2 - bx1) * (by2 - by1) - inter
    return inter / ua if ua > 0 else 0.0


def match_detections(preds: List[Dict], gts: List[Dict],
                     iou_thresh: float = 0.5,
                     class_aware: bool = True) -> Tuple[int, int, int]:
    """Greedy score-ordered matching.  Returns (tp, fp, fn)."""
    preds = sorted(preds, key=lambda p: -p.get("score", 1.0))
    used = [False] * len(gts)
    tp = 0
    for p in preds:
        best, best_iou = -1, iou_thresh
        for gi, g in enumerate(gts):
            if used[gi]:
                continue
            if class_aware and int(p["cls"]) != int(g["cls"]):
                continue
            i = iou(p["box"], g["box"])
            if i >= best_iou:
                best, best_iou = gi, i
        if best >= 0:
            used[best] = True
            tp += 1
    fp = len(preds) - tp
    fn = len(gts) - tp
    return tp, fp, fn


def f1_score(tp: int, fp: int, fn: int) -> float:
    denom = 2 * tp + fp + fn
    return 2 * tp / denom if denom > 0 else 1.0


def frame_f1(preds: List[Dict], gts: List[Dict],
             iou_thresh: float = 0.5) -> float:
    return f1_score(*match_detections(preds, gts, iou_thresh))


def detections_from_arrays(boxes, scores, classes,
                           score_thresh: float = 0.3) -> List[Dict]:
    """det_head.decode_detections arrays -> list-of-dicts (one batch el)."""
    out = []
    for b, s, c in zip(np.asarray(boxes), np.asarray(scores),
                       np.asarray(classes)):
        if s > score_thresh:
            out.append({"box": tuple(float(x) for x in b),
                        "score": float(s), "cls": int(c)})
    return out
