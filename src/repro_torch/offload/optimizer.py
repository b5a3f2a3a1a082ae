"""Offload Configuration Selection (paper Algorithm 1) + temporal reuse
planning.

For each frame to offload: classify regions, estimate (T-hat, A-hat) for
every candidate configuration c = (tau_d, lambda, beta), take the Pareto
frontier, and select by system state (min-latency when stale, knee point
otherwise).

:func:`build_reuse_plan` then lifts the chosen binary mask into a
three-state :class:`~repro.core.partition.RegionPlan`: regions the
RegionMotionAnalyzer reports motionless AND whose cached feature tile is
still fresh (FeatureCache.eligible — same restoration point, reused
fewer than K consecutive offloads) are promoted to REUSE and transmit
nothing.  The emitted plan is bucket-EXACT in ``n_reuse`` so the codec
and the server agree on the transmitted region set.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.partition import (FULL, LOW, REUSE, Partition, RegionPlan,
                                  bucket_n_low, bucket_set)
from repro_torch.offload import motion as mo
from repro_torch.offload.estimator import (InferenceDelayModel, ThroughputEstimator,
                                     feature_vector)


@dataclass(frozen=True)
class OffloadConfig:
    tau_d: int          # 0: none, 1: CMRs, 2: CMRs+SBRs
    quality: int        # lambda: JPEG quality 70..100 step 5
    beta: int           # restoration point 0..N

    def astuple(self):
        return (self.tau_d, self.quality, self.beta)


def candidate_configs(qualities: Sequence[int] = tuple(range(70, 101, 5)),
                      betas: Sequence[int] = (0, 1, 2, 3, 4)
                      ) -> List[OffloadConfig]:
    """The paper's config space: 7 qualities x (tau_d, beta) combos.
    tau_d = 0 fixes beta = 0 (no downsampled regions to restore)."""
    out = [OffloadConfig(0, q, 0) for q in qualities]
    for tau in (1, 2):
        for q in qualities:
            for b in betas:
                if b == 0:
                    continue          # beta=0 with downsampling = upsample
                out.append(OffloadConfig(tau, q, b))
    return out


@dataclass
class SystemState:
    eta: int = 0                 # frames since last offload
    kappa: float = 1.0           # tracking retention ratio
    delta_eta: int = 30
    delta_kappa: float = 0.7


@dataclass
class DelayModels:
    enc: "object"                # CodecDelayModel
    inf: InferenceDelayModel
    net: ThroughputEstimator


class OffloadOptimizer:
    def __init__(self, part: Partition, size_est, acc_est,
                 delays: DelayModels, configs=None,
                 delta_m: float = 0.001, delta_rho: float = 0.0,
                 n_buckets: int = 4, a_floor: float = 0.25):
        self.part = part
        self.size_est = size_est
        self.acc_est = acc_est
        self.delays = delays
        self.configs = configs or candidate_configs()
        self.delta_m = delta_m
        self.delta_rho = delta_rho
        self.n_buckets = n_buckets
        # accuracy floor (fraction of the frontier's best A-hat): configs
        # predicted to collapse accuracy are never selected while a
        # viable alternative exists.  Guards the degenerate two-point
        # frontier a fully-static scene produces (everything classifies
        # SBR -> the config space is "downsample nothing" vs "downsample
        # everything", and the <=2-point knee fallback would pick the
        # min-latency point even at A-hat ~ 0).
        self.a_floor = a_floor

    # ------------------------------------------------------------------
    def evaluate(self, m: np.ndarray, m_f: float, rho: np.ndarray
                 ) -> List[Dict]:
        """Lines 1-11: estimate (T, A) for every candidate config.

        Both MLPs run ONE batched predict over the whole config space —
        per-config dispatch costs ~50x more on the device CPU (this is
        how the prototype hits the paper's ~9 ms estimator budget)."""
        phi = mo.classify_regions(m, rho, self.delta_m, self.delta_rho)
        mu_rho = float(rho.mean())
        sigma_rho = float(rho.std())
        feats, metas = [], []
        for c in self.configs:
            mask = mo.downsample_mask(phi, c.tau_d)
            n_d_raw = int(mask.sum())
            n_d = bucket_n_low(n_d_raw, self.part.n_regions, self.n_buckets)
            m_d = float((mask * m).sum())
            feats.append(feature_vector(c.tau_d, n_d, m_d, m_f, c.quality,
                                        mu_rho, sigma_rho, c.beta))
            metas.append((c, n_d, mask))
        X = np.stack(feats)
        s_hats = np.maximum(self.size_est.predict(X), 256.0)
        a_hats = np.clip(self.acc_est.predict(X), 0.0, 1.0)
        out = []
        for (c, n_d, mask), s_hat, a_hat in zip(metas, s_hats, a_hats):
            t_hat = (self.delays.enc.encode_delay(self.part, n_d, c.quality)
                     + float(s_hat) * 8.0 / self.delays.net.throughput
                     + self.delays.enc.decode_delay(self.part, n_d)
                     + self.delays.inf(c.beta if n_d > 0 else 0, n_d)
                     + self.delays.net.rtt)
            out.append({"config": c, "T": t_hat, "A": float(a_hat),
                        "N_d": n_d, "mask": mask, "phi": phi})
        return out

    # ------------------------------------------------------------------
    def select(self, m: np.ndarray, m_f: float, rho: np.ndarray,
               state: SystemState) -> Dict:
        """Algorithm 1: returns the chosen candidate record."""
        Z = self.evaluate(m, m_f, rho)
        front = pareto_frontier(Z)
        floor = self.a_floor * max(z["A"] for z in front)
        viable = [z for z in front if z["A"] >= floor]
        if viable:
            front = viable
        if len(front) == 1:
            return front[0]
        if state.kappa < state.delta_kappa or state.eta > state.delta_eta:
            return min(front, key=lambda z: z["T"])
        return knee_point(front)


# ---------------------------------------------------------------------------
# temporal reuse planning


def build_reuse_plan(part: Partition, mask: np.ndarray, m: np.ndarray,
                     eligible: np.ndarray, delta_m: float = 1e-3,
                     n_buckets: int = 4, min_transmit: int = 1
                     ) -> RegionPlan:
    """Lift a binary downsample mask into a three-state RegionPlan.

    ``m``: per-region motion from the RegionMotionAnalyzer; ``eligible``:
    FeatureCache.eligible(beta) — regions whose cached tile matches the
    chosen restoration point and is within the staleness bound K.  A
    region becomes REUSE when it is both motionless (``m < delta_m``) and
    eligible; the stillest regions win the bucket slots.

    The returned plan is bucket-exact: exactly ``bucket_n_low(...)``
    regions are REUSE (REUSE ships zero bytes, so codec and server must
    agree on the set — rounding down at the server would read pixels
    that were never transmitted).  At least ``min_transmit`` regions stay
    transmitted so the packed sequence is never empty.
    """
    mask = np.asarray(mask).reshape(-1)
    states = np.where(mask != 0, LOW, FULL).astype(np.int8)
    cand = np.asarray(eligible, bool) & (np.asarray(m) < delta_m)
    cand_ids = np.nonzero(cand)[0]
    limit = min(len(cand_ids), part.n_regions - min_transmit)
    n_reuse = bucket_n_low(limit, part.n_regions, n_buckets)
    n_reuse = min(n_reuse, limit)
    if n_reuse > 0:
        order = cand_ids[np.argsort(np.asarray(m)[cand_ids],
                                    kind="stable")]
        states[order[:n_reuse]] = REUSE
    return RegionPlan(states)


def pareto_frontier(Z: List[Dict]) -> List[Dict]:
    """Minimize T, maximize A."""
    zs = sorted(Z, key=lambda z: (z["T"], -z["A"]))
    front = []
    best_a = -np.inf
    for z in zs:
        if z["A"] > best_a + 1e-12:
            front.append(z)
            best_a = z["A"]
    return front


def knee_point(front: List[Dict]) -> Dict:
    """Max distance to the chord between the frontier's extreme points
    (the trade-off-utility knee the paper cites [37]).

    A frontier of <= 2 points has no interior knee.  Fall back to the
    MAX-ACCURACY point: select() only reaches the knee when the system
    is healthy (stale states already take the min-latency branch), and
    on a degenerate two-point frontier — the static-scene case where
    the config space collapses to "downsample nothing" vs "downsample
    everything" — the min-latency fallback silently trades the entire
    accuracy gap for latency the healthy state doesn't need.  The
    a_floor guard only catches this when the estimator's A-hat for the
    aggressive point is honest; this fallback stays safe when it is
    not.
    """
    if len(front) <= 2:
        return front[-1]
    pts = np.array([[z["T"], z["A"]] for z in front])
    # normalise both objectives to [0, 1]
    lo, hi = pts.min(0), pts.max(0)
    span = np.maximum(hi - lo, 1e-12)
    n = (pts - lo) / span
    a, b = n[0], n[-1]
    ab = b - a
    ab /= np.linalg.norm(ab) + 1e-12
    d = (n - a) - np.outer((n - a) @ ab, ab)
    idx = int(np.argmax(np.linalg.norm(d, axis=1)))
    return front[idx]
