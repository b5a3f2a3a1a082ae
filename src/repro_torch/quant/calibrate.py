"""Accuracy-gated calibration: which compression point ships; port of
``repro.quant.calibrate``.

Ground truth is the float32 model's own full-resolution detections (the
paper's rendering-accuracy definition), the metric the median rendering
F1 over calibration clips, and a candidate passes when its F1 delta
against the float32 model stays within ``bound`` on EVERY calibration
scenario, on both the full-resolution workload and the mixed-resolution
serving workload (motion-derived plans at the deployment beta), so an
error that only shows under mixed-resolution packing still trips the
gate.

:func:`calibrate` walks the candidate ladder ordered by compressed
parameter bytes (most compressed first) and ships the FIRST point that
holds the bound; if none does, the deployment stays float32 (shipped is
None).  ``ServerModel(cfg, params, quant=shipped)`` then serves it.

Every rung of ``DEFAULT_CANDIDATES`` runs: ``int8+fp16-p1``,
``int8+fp16`` and ``fp16+fp16`` serve through the kernels' half entry
points, ``int8`` at float32.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import vit_backbone as vb
from repro_torch.data import synthetic_video as sv
from repro_torch.models.config import ModelConfig
from repro_torch.offload import motion as mo
from repro_torch.offload.detection import frame_f1
from repro_torch.quant import qtensor as qt
from repro_torch.quant.ptq import DEFAULT_CANDIDATES, QuantSpec, compress

F1_BOUND = 0.005
SCENARIOS = ("parkS", "driveN")


@dataclass
class CalibPoint:
    """One evaluated candidate."""
    spec: QuantSpec
    bytes: int
    ratio: float
    deltas: Dict[str, float] = field(default_factory=dict)
    passed: bool = False


@dataclass
class CalibReport:
    shipped: Optional[QuantSpec]
    points: List[CalibPoint]
    bound: float
    scenarios: Tuple[str, ...]
    bytes_fp32: int


def _median_f1(dets_a: List, dets_b: List) -> float:
    return float(np.median([frame_f1(a, b) for a, b in zip(dets_a, dets_b)]))


def _scenario_workload(cfg: ModelConfig, scenario: str, n_frames: int,
                       seed: int):
    """Calibration frames + per-frame serving masks (object-free regions
    downsampled, the fig-5 workload)."""
    part = vb.vit_partition(cfg)
    frames, gts = sv.make_clip(scenario, n_frames,
                               size=cfg.vit.img_size[0], seed=seed)
    masks = [(mo.region_density(g, part, cfg.vit.patch_size) == 0)
             .astype(np.int32) for g in gts]
    return frames, masks


def scenario_delta(ref_server, cand_server, frames, masks,
                   beta: int) -> float:
    """The largest F1 delta of the candidate against the float32
    reference server on one clip, over the full-resolution and
    mixed-resolution workloads.  Ground truth is the reference server's
    full-resolution detections."""
    gt = [ref_server.infer(f) for f in frames]

    def mixed(server):
        return [server.infer(f, m if m.sum() else None,
                             beta if m.sum() else 0)
                for f, m in zip(frames, masks)]

    ref_mixed = mixed(ref_server)
    cand_full = [cand_server.infer(f) for f in frames]
    cand_mixed = mixed(cand_server)
    d_full = _median_f1(gt, gt) - _median_f1(gt, cand_full)
    d_mixed = _median_f1(gt, ref_mixed) - _median_f1(gt, cand_mixed)
    return float(max(d_full, d_mixed))


def calibrate(cfg: ModelConfig, params,
              candidates: Sequence[QuantSpec] = DEFAULT_CANDIDATES,
              scenarios: Sequence[str] = SCENARIOS,
              bound: float = F1_BOUND, n_frames: int = 8, beta: int = 2,
              seed: int = 23, server_kw: Optional[Dict] = None,
              calib_frames: Optional[Sequence[np.ndarray]] = None
              ) -> CalibReport:
    """Walk the candidate ladder and pick the shipped point.

    ``server_kw`` forwards to ``ServerModel`` (``device``, ``top_k``,
    ``score_thresh``, buckets...); the tree is moved to that device
    first.  ``calib_frames`` feed head scoring for pruned candidates
    (default: the first scenario's first four frames).  Every candidate
    is compressed before the first server is built.
    """
    from repro_torch.offload.simulator import ServerModel
    kw = dict(server_kw or {})
    params = qt.to_device(params, kw.get("device", "cuda"))
    bytes0 = qt.tree_bytes(vb.strip_derived(params))

    workloads = [(s,) + _scenario_workload(cfg, s, n_frames, seed)
                 for s in scenarios]
    if calib_frames is None and workloads:
        calib_frames = workloads[0][1][:4]

    # most compressed first: compress every candidate, order by its
    # actual bytes, ship the first that holds the bound
    compressed = []
    for spec in candidates:
        ccfg, cparams, rep = compress(cfg, params, spec,
                                      calib_frames=calib_frames)
        compressed.append((rep["bytes"], spec, ccfg, cparams, rep))
    compressed.sort(key=lambda t: t[0])

    ref = ServerModel(cfg, params, **kw)
    points: List[CalibPoint] = []
    shipped: Optional[QuantSpec] = None
    for nbytes, spec, ccfg, cparams, rep in compressed:
        cand = ServerModel(ccfg, cparams, **kw)
        point = CalibPoint(spec=spec, bytes=nbytes, ratio=rep["ratio"])
        for sname, frames, masks in workloads:
            point.deltas[sname] = scenario_delta(ref, cand, frames, masks,
                                                 beta)
        point.passed = all(d <= bound for d in point.deltas.values())
        points.append(point)
        if point.passed:
            shipped = spec
            break                       # the most compressed passing point
    return CalibReport(shipped=shipped, points=points, bound=bound,
                       scenarios=tuple(scenarios), bytes_fp32=bytes0)
