"""Offloading policies: the paper's baselines (§VI-A) + ViTMAlis itself
(+ its ablated variants, §VI-D)."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core.partition import RegionPlan, bucket_n_low
from repro_torch.offload import motion as mo
from repro_torch.offload.optimizer import (OffloadOptimizer, SystemState,
                                     build_reuse_plan, candidate_configs)
from repro_torch.offload.simulator import Policy, Simulation

FULL_QUALITY = 95        # baselines' default JPEG quality (paper §VI-A)


def _zeros(sim: Simulation) -> np.ndarray:
    return np.zeros((sim.part.n_regions,), np.int32)


class Back2Back(Policy):
    """Offload the newest frame immediately on completion; full res; no
    tracker — stale cache results are rendered as-is."""
    name = "Back2Back"
    use_tracker = False

    def decide(self, sim: Simulation, frame_idx: int) -> Dict:
        return {"mask": _zeros(sim), "quality": FULL_QUALITY, "beta": 0}


class TrackB2B(Back2Back):
    """Accuracy-centric: Back2Back + local tracker (canonical paradigm)."""
    name = "TrackB2B"
    use_tracker = True


class TrackRoI(Policy):
    """Content-aware RoI masking: non-DOR regions are blanked before
    encoding (big bandwidth cut, same inference cost, context lost)."""
    name = "TrackRoI"
    use_tracker = True

    def decide(self, sim: Simulation, frame_idx: int) -> Dict:
        rho = sim.rho()
        phi = mo.classify_regions(sim.m, rho)
        mask = _zeros(sim)
        # non-DOR regions are blanked before encoding; the flat blanks
        # genuinely compress to almost nothing in the DCT+zlib codec
        blank = (phi != 2).astype(np.int32)
        return {"mask": mask, "quality": FULL_QUALITY, "beta": 0,
                "blank": blank}


class TrackUD(Policy):
    """Latency-adaptive: uniform downsample x2 when the last E2E latency
    exceeded 15 frame intervals (adaptive-streaming heuristic)."""
    name = "TrackUD"
    use_tracker = True
    threshold_frames = 15

    def __init__(self, fps: int = 10, n_subsets: int = 4):
        self.fps = fps
        self.n_subsets = n_subsets
        self.last_e2e: Optional[float] = None

    def observe_completion(self, e2e_latency: float) -> None:
        self.last_e2e = e2e_latency

    def decide(self, sim: Simulation, frame_idx: int) -> Dict:
        slow = (self.last_e2e is not None and
                self.last_e2e > self.threshold_frames / self.fps)
        if slow:
            mask = np.ones((sim.part.n_regions,), np.int32)
            return {"mask": mask, "quality": FULL_QUALITY,
                    "beta": self.n_subsets}
        return {"mask": _zeros(sim), "quality": FULL_QUALITY, "beta": 0}


# ---------------------------------------------------------------------------
# ViTMAlis


class ViTMAlis(Policy):
    """The full system: Algorithm 1 over the (tau_d, lambda, beta) space."""
    name = "ViTMAlis"
    use_tracker = True

    def __init__(self, optimizer: OffloadOptimizer):
        self.opt = optimizer

    def decide(self, sim: Simulation, frame_idx: int) -> Dict:
        import time as _t
        # bootstrap: before the first detections arrive, the tracker is
        # empty and rho is identically zero — outside the estimators'
        # profile distribution, so Algorithm 1's A-hats are meaningless.
        # Seed the pipeline with one full-resolution offload (what the
        # prototype's first frame does implicitly).
        if sim.cache_frame < 0 and not sim.tracker.boxes():
            return {"mask": _zeros(sim), "quality": FULL_QUALITY,
                    "beta": 0, "opt_wall": 0.0}
        self.opt.delays.net = sim.net_est
        rho = sim.rho()
        t0 = _t.perf_counter()
        choice = self.opt.select(sim.m, sim.m_f, rho, sim.state)
        wall = _t.perf_counter() - t0
        c = choice["config"]
        mask = choice["mask"].copy()
        # enforce the static bucket: trim/pad handled by region ids later
        n_d = choice["N_d"]
        if int(mask.sum()) != n_d:
            ones = np.nonzero(mask)[0]
            mask[:] = 0
            mask[ones[:n_d]] = 1
        return {"mask": mask, "quality": c.quality,
                "beta": c.beta if n_d > 0 else 0,
                "opt_wall": wall}


class ViTMAlisReuse(ViTMAlis):
    """ViTMAlis + temporal region reuse (three-state RegionPlan).

    On top of Algorithm 1's (tau_d, lambda, beta) choice, regions the
    motion analyzer reports motionless AND whose cached feature tile is
    still fresh (same restoration point, reused < K consecutive
    offloads) transmit NOTHING — the edge splices their cached tiles in
    at the restoration point.  Full-res choices still warm the cache
    (tiles captured at ``capture_beta_default``), and a full-res choice
    with a warm cache is lifted to FULL+REUSE at the cached restoration
    point so static scenes stop paying for pixels that have not changed.
    """
    name = "ViTMAlis+Reuse"

    def __init__(self, optimizer: OffloadOptimizer, reuse_k: int = 4,
                 reuse_delta_m: float = 1e-3, min_transmit: int = 1,
                 capture_beta_default: int = 2):
        super().__init__(optimizer)
        self.reuse_k = reuse_k
        self.reuse_delta_m = reuse_delta_m
        self.min_transmit = min_transmit
        self.capture_beta_default = capture_beta_default

    def decide(self, sim: Simulation, frame_idx: int) -> Dict:
        base = super().decide(sim, frame_idx)
        cache = sim.feature_cache
        mask = base["mask"]
        beta = base["beta"]
        n_d = int(mask.sum())

        if beta < 1 and n_d == 0 and cache is not None and \
                cache.eligible(cache.beta).any():
            # full-res choice, warm cache: reuse at the cached RP
            beta = cache.beta
        eligible = (cache.eligible(beta) if cache is not None
                    else np.zeros((sim.part.n_regions,), bool))
        plan = build_reuse_plan(sim.part, mask, sim.m, eligible,
                                delta_m=self.reuse_delta_m,
                                n_buckets=self.opt.n_buckets,
                                min_transmit=self.min_transmit)
        base["plan"] = plan
        base["beta"] = beta if (plan.n_reuse > 0 or n_d > 0) else 0
        base["capture_beta"] = self.capture_beta_default
        return base


class ViTMAlisNoRegType(ViTMAlis):
    """Ablation w/o RegType: downsample ALL non-DOR regions (no SBR/CMR
    distinction) — the tau_d knob collapses to {0, all-non-DOR}."""
    name = "w/o RegType"

    def __init__(self, optimizer: OffloadOptimizer):
        super().__init__(optimizer)
        self.opt.configs = [c for c in self.opt.configs
                            if c.tau_d in (0, 2)]


class ViTMAlisNoDynaRes(ViTMAlis):
    """Ablation w/o DynaRes: restoration deferred to the last subset."""
    name = "w/o DynaRes"

    def __init__(self, optimizer: OffloadOptimizer, n_subsets: int = 4):
        super().__init__(optimizer)
        self.opt.configs = [c for c in self.opt.configs
                            if c.beta in (0, n_subsets)]
