"""The numbers that decide ``correct``: what the timed path served,
against the plain reference (``reference/vitdet_ref.py``).

Detections with random weights sit in near-ties (which of two positions
ranks 32nd, which class is best at a position), so no number here asks
for the reference's own top-k.  Each reads how far a served answer lies
from what the reference would give:

  score_gap    the larger of (a) the widest gap between the served
               scores, sorted, and the reference's top scores, rank by
               rank (order statistics move no more than the scores do),
               and (b) the widest gap between a served score and the
               reference's probability of the served class at the
               position the served box matches (a served class that is
               not the reference's best there reads as the gap between
               the two classes' probabilities);
  score_gap_rel  ``score_gap`` over the mean of the reference's top
               scores: the seeded weights set how high a frame's scores
               sit, and the gaps of the program and of its control scale
               with them alike;
  box_gap_rel  the widest distance (L-infinity) from a served box to
               the nearest box the reference predicts anywhere, over the
               mean side of the reference's top boxes: how large the
               seeded weights make the boxes scales the program's gaps
               and the control's alike;
  tile_err     the widest relative L2 error, over checked offloads and
               regions, of the restoration-point tiles a session
               captured (``phones-mixed`` only).

A configuration compares the numbers it gives limits for.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch

NUMBERS = ("score_gap", "score_gap_rel", "box_gap_rel", "tile_err")


def detection_gaps(dets: List[Dict], probs: torch.Tensor,
                   boxes: torch.Tensor) -> Dict[str, float]:
    """Gaps of one frame's served detections (dicts with ``box``,
    ``score``, ``cls``) from the reference's dense ``probs`` (N, C) and
    ``boxes`` (N, 4)."""
    dev = probs.device
    if not dets:
        return {"score_gap": float("inf"), "score_gap_rel": float("inf"),
                "box_gap_rel": float("inf")}
    b = torch.tensor([d["box"] for d in dets], dtype=torch.float32,
                     device=dev)
    s = torch.tensor([d["score"] for d in dets], dtype=torch.float32,
                     device=dev)
    c = torch.tensor([d["cls"] for d in dets], dtype=torch.long, device=dev)
    best = probs.max(dim=-1).values
    top, idx = torch.topk(best, len(dets))
    rank_gap = (torch.sort(s, descending=True).values - top).abs().max()
    dist = (b[:, None, :] - boxes[None, :, :]).abs().amax(dim=-1)
    near, pos = dist.min(dim=1)
    at = probs[pos, c]
    tb = boxes[idx]
    side = ((tb[:, 2] - tb[:, 0]) + (tb[:, 3] - tb[:, 1])).mean() / 2
    gap = torch.maximum(rank_gap, (s - at).abs().max())
    return {"score_gap": float(gap), "score_gap_rel": float(gap / top.mean()),
            "box_gap_rel": float(near.max() / side)}


def tile_error(served: torch.Tensor, ref: torch.Tensor) -> float:
    """Widest relative L2 error over regions of (nR, ...) tiles."""
    a = served.float().flatten(1)
    r = ref.float().flatten(1)
    return float(((a - r).norm(dim=1) / r.norm(dim=1)).max())


def merge(into: Dict[str, float], new: Dict[str, float]) -> None:
    for k, v in new.items():
        into[k] = max(into.get(k, float("-inf")), v)


def verdict(numbers: Dict[str, float], limits: Dict[str, float]
            ) -> bool:
    """Every number the limits name, of those the cell's check reads
    (``tile_err`` only where a session captures tiles), at or under its
    limit; a number that could not be read (NaN) fails."""
    return all(numbers[k] <= limits[k] for k in limits if k in numbers)


def checks_line(numbers: Dict[str, float], limits: Dict[str, float]
                ) -> Dict[str, Dict[str, Optional[float]]]:
    return {k: {"value": numbers[k], "limit": limits[k]}
            for k in NUMBERS if k in limits and k in numbers}
