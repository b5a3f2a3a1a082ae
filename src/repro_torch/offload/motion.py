"""Region Motion Analyzer (paper §IV-C).

Running-average background subtraction (the OpenCV-tutorial model the
paper cites [33]) -> per-region motion values m_j = fraction of the
frame's foreground pixels falling in decision region j, plus the
normalized frame motion m^f (foreground / total pixels).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from repro_torch.core.partition import Partition


def to_gray(frame: np.ndarray) -> np.ndarray:
    return frame @ np.array([0.299, 0.587, 0.114], np.float32)


@dataclass
class MotionState:
    background: np.ndarray       # running-average gray background
    initialized: bool = False


class RegionMotionAnalyzer:
    def __init__(self, part: Partition, patch_px: int,
                 alpha: float = 0.05, thresh: float = 0.08):
        self.part = part
        self.patch_px = patch_px            # pixels per image patch
        self.alpha = alpha
        self.thresh = thresh
        self.state: Optional[MotionState] = None

    def region_px(self) -> int:
        return self.part.region * self.patch_px

    def update(self, frame: np.ndarray) -> Tuple[np.ndarray, float]:
        """-> (m (n_regions,), m_f).  frame: HxWx3 float in [0,1]."""
        gray = to_gray(frame)
        if self.state is None or not self.state.initialized:
            self.state = MotionState(background=gray.copy(),
                                     initialized=True)
            return np.zeros((self.part.n_regions,), np.float32), 0.0

        fg = np.abs(gray - self.state.background) > self.thresh
        self.state.background = ((1 - self.alpha) * self.state.background
                                 + self.alpha * gray)

        rpx = self.region_px()
        nRh, nRw = self.part.regions_h, self.part.regions_w
        fg_r = fg[:nRh * rpx, :nRw * rpx].reshape(nRh, rpx, nRw, rpx)
        counts = fg_r.sum(axis=(1, 3)).reshape(-1).astype(np.float64)
        total_fg = counts.sum()
        m = (counts / total_fg).astype(np.float32) if total_fg > 0 else \
            np.zeros((self.part.n_regions,), np.float32)
        m_f = float(total_fg / fg.size)
        return m, m_f


def classify_regions(m: np.ndarray, rho: np.ndarray, delta_m: float = 0.001,
                     delta_rho: float = 0.0) -> np.ndarray:
    """SBR/CMR/DOR classification (paper §IV-C).

    Returns int8 array: 0=SBR, 1=CMR, 2=DOR.
      m_j <  delta_m             -> SBR
      m_j >= delta_m, rho_j >  delta_rho -> DOR
      otherwise                  -> CMR
    """
    out = np.ones_like(m, dtype=np.int8)               # CMR default
    out[m < delta_m] = 0                               # SBR
    out[(m >= delta_m) & (rho > delta_rho)] = 2        # DOR
    return out


def downsample_mask(region_types: np.ndarray, tau_d: int) -> np.ndarray:
    """B = f_tau(phi): which regions are downsampled for each tau_d.

    tau_d: 0 = none, 1 = CMRs only, 2 = CMRs + SBRs.  DORs never."""
    if tau_d == 0:
        return np.zeros_like(region_types, dtype=np.int32)
    if tau_d == 1:
        return (region_types == 1).astype(np.int32)
    return (region_types <= 1).astype(np.int32)


def prediction_confidence(m: np.ndarray, states: np.ndarray,
                          m_f: float = 1.0,
                          thresh: float = 0.02) -> float:
    """Confidence that the previous decoded frame predicts the
    IN-FLIGHT (transmitted FULL/LOW) regions of a plan (paper Eq. (2)
    uplink-hiding: the speculative-REUSE admission signal).

    ``m`` is the analyzer's per-region share of the frame's foreground
    (it sums to 1 whenever ANY pixel moved, so it must be rescaled by
    ``m_f`` — foreground / total pixels — to mean absolute motion
    mass).  A transmitted region with high motion mass will diverge
    from any motion-free prediction, so confidence decays with the
    *worst* transmitted region: 1.0 when every in-flight region is
    still, 0.0 once one region holds ``thresh`` of the FRAME's pixels
    as foreground (a whole region is 1/n_regions).  Plans with nothing
    in flight (all REUSE) predict trivially.
    """
    from repro_torch.core.partition import REUSE
    states = np.asarray(states).reshape(-1)
    m = np.asarray(m, np.float64).reshape(-1)
    sel = states != REUSE
    if not sel.any():
        return 1.0
    worst = float(m[sel].max()) * float(m_f)
    return float(np.clip(1.0 - worst / max(thresh, 1e-9), 0.0, 1.0))


def region_density(boxes, part: Partition, patch_px: int) -> np.ndarray:
    """Task relevance rho_j: fraction of objects overlapping region j."""
    rpx = part.region * patch_px
    rho = np.zeros((part.n_regions,), np.float32)
    if not boxes:
        return rho
    for b in boxes:
        x1, y1, x2, y2 = b["box"] if isinstance(b, dict) else b
        rx1, ry1 = int(x1 // rpx), int(y1 // rpx)
        rx2 = min(int(np.ceil(x2 / rpx)), part.regions_w)
        ry2 = min(int(np.ceil(y2 / rpx)), part.regions_h)
        for ry in range(max(ry1, 0), ry2):
            for rx in range(max(rx1, 0), rx2):
                rho[ry * part.regions_w + rx] += 1.0
    return rho / max(len(boxes), 1)
