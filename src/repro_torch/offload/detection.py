"""Detection lists from decoded head arrays (the ``repro.offload.detection``
helper the serving path uses)."""
from __future__ import annotations

from typing import Dict, List

import numpy as np


def detections_from_arrays(boxes, scores, classes,
                           score_thresh: float = 0.3) -> List[Dict]:
    """det_head.decode_detections arrays of one sample -> list of dicts."""
    out = []
    for b, s, c in zip(np.asarray(boxes), np.asarray(scores),
                       np.asarray(classes)):
        if s > score_thresh:
            out.append({"box": tuple(float(x) for x in b),
                        "score": float(s), "cls": int(c)})
    return out
