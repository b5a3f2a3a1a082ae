"""Local Tracker: pyramidal Lucas–Kanade optical flow box propagation
(the paper selects an optical-flow method [25] for its accuracy/speed
balance).  Pure numpy.

``LKTracker`` holds the last frame and a set of boxes; ``step(frame)``
estimates per-box translation from LK flow at Shi–Tomasi-ish corner
points inside each box and shifts the boxes.  ``retention`` reports the
fraction of initial objects still tracked (kappa in Algorithm 1).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.offload.motion import to_gray


def _pyr_down(img: np.ndarray) -> np.ndarray:
    H, W = img.shape
    H2, W2 = H // 2 * 2, W // 2 * 2
    x = img[:H2, :W2]
    return 0.25 * (x[0::2, 0::2] + x[1::2, 0::2] + x[0::2, 1::2]
                   + x[1::2, 1::2])


def _gradients(img: np.ndarray):
    gy, gx = np.gradient(img)
    return gx, gy


def _lk_point(prev, cur, gx, gy, x, y, win: int = 7, iters: int = 3
              ) -> Optional[Tuple[float, float]]:
    """One-point LK with iterative refinement.  Returns (dx, dy) or None."""
    H, W = prev.shape
    r = win // 2
    xi, yi = int(round(x)), int(round(y))
    if not (r <= xi < W - r and r <= yi < H - r):
        return None
    Ix = gx[yi - r:yi + r + 1, xi - r:xi + r + 1].ravel()
    Iy = gy[yi - r:yi + r + 1, xi - r:xi + r + 1].ravel()
    A = np.stack([Ix, Iy], axis=1)
    G = A.T @ A
    if np.linalg.det(G) < 1e-7:
        return None
    Ginv = np.linalg.inv(G)
    tpl = prev[yi - r:yi + r + 1, xi - r:xi + r + 1].ravel()
    dx = dy = 0.0
    for _ in range(iters):
        cx, cy = xi + dx, yi + dy
        x0, y0 = int(np.floor(cx)), int(np.floor(cy))
        if not (r <= x0 < W - r - 1 and r <= y0 < H - r - 1):
            return None
        ax, ay = cx - x0, cy - y0
        w = cur[y0 - r:y0 + r + 2, x0 - r:x0 + r + 2]
        interp = ((1 - ax) * (1 - ay) * w[:-1, :-1]
                  + ax * (1 - ay) * w[:-1, 1:]
                  + (1 - ax) * ay * w[1:, :-1] + ax * ay * w[1:, 1:])
        err = (interp.ravel() - tpl)
        b = -np.array([err @ Ix, err @ Iy])
        d = Ginv @ b
        dx += d[0]
        dy += d[1]
        if abs(d[0]) + abs(d[1]) < 0.03:
            break
    return dx, dy


@dataclass
class Track:
    box: Tuple[float, float, float, float]
    cls: int
    score: float
    tid: int
    alive: bool = True
    conf: float = 1.0     # decays while the box coasts without flow


class LKTracker:
    """Multi-object optical-flow tracker with catch-up tracking.

    A frame where a box yields too few surviving flow points (blackout-
    length gaps with large motion, texture-free crops) no longer kills
    the track outright: the box HOLDS position and its confidence decays
    by ``hold_decay``; only when confidence drops below ``conf_floor``
    does the track die.  ``retention`` sums confidences, so kappa in
    Algorithm 1 degrades smoothly (and stays finite) instead of
    cliff-dropping to 0 on one bad frame.
    """

    def __init__(self, levels: int = 3, grid: int = 4,
                 hold_decay: float = 0.7, conf_floor: float = 0.2):
        self.levels = levels
        self.grid = grid
        self.hold_decay = hold_decay
        self.conf_floor = conf_floor
        self.prev_gray: Optional[np.ndarray] = None
        self.tracks: List[Track] = []
        self._n_init = 0
        self._next_id = 0

    # ------------------------------------------------------------------
    def reinit(self, frame: np.ndarray, detections: List[Dict]) -> None:
        """Synchronise with a fresh remote inference result."""
        self.prev_gray = to_gray(frame)
        self.tracks = []
        for d in detections:
            self.tracks.append(Track(box=tuple(map(float, d["box"])),
                                     cls=int(d["cls"]),
                                     score=float(d.get("score", 1.0)),
                                     tid=self._next_id))
            self._next_id += 1
        self._n_init = len(self.tracks)

    @property
    def retention(self) -> float:
        """kappa: confidence-weighted fraction of objects still tracked
        since reinit (1.0 while every box keeps finding flow; a coasting
        box contributes its decayed confidence)."""
        if self._n_init == 0:
            return 1.0
        return sum(t.conf for t in self.tracks if t.alive) / self._n_init

    def boxes(self) -> List[Dict]:
        return [{"box": t.box, "cls": t.cls, "score": t.score,
                 "tid": t.tid} for t in self.tracks if t.alive]

    # ------------------------------------------------------------------
    def step(self, frame: np.ndarray) -> List[Dict]:
        """Propagate boxes to ``frame``; returns current box list."""
        gray = to_gray(frame)
        if self.prev_gray is None:
            self.prev_gray = gray
            return self.boxes()

        # build pyramids
        prev_pyr, cur_pyr = [self.prev_gray], [gray]
        for _ in range(self.levels - 1):
            prev_pyr.append(_pyr_down(prev_pyr[-1]))
            cur_pyr.append(_pyr_down(cur_pyr[-1]))
        grads = [_gradients(p) for p in prev_pyr]

        H, W = gray.shape
        for t in self.tracks:
            if not t.alive:
                continue
            x1, y1, x2, y2 = t.box
            # sample a grid of points inside the box
            xs = np.linspace(x1 + 2, x2 - 2, self.grid)
            ys = np.linspace(y1 + 2, y2 - 2, self.grid)
            flows = []
            for py in ys:
                for px in xs:
                    dx_total = dy_total = 0.0
                    ok = True
                    # coarse-to-fine; a small object can be featureless
                    # at a coarse level (its texture averages away), so a
                    # failed coarse estimate contributes zero update and
                    # the chain continues — only the finest level is
                    # allowed to reject the point
                    for lv in range(self.levels - 1, -1, -1):
                        s = 2 ** lv
                        gx, gy = grads[lv]
                        res = _lk_point(prev_pyr[lv], cur_pyr[lv], gx, gy,
                                        (px + dx_total) / s,
                                        (py + dy_total) / s)
                        if res is None:
                            if lv == 0:
                                ok = False
                            continue
                        dx_total += res[0] * s
                        dy_total += res[1] * s
                    if ok and abs(dx_total) < W * 0.2 and \
                            abs(dy_total) < H * 0.2:
                        flows.append((dx_total, dy_total))
            if len(flows) < max(2, self.grid):
                # hold position, decay confidence; die only at the floor
                t.conf *= self.hold_decay
                if t.conf < self.conf_floor:
                    t.alive = False
                continue
            f = np.median(np.asarray(flows), axis=0)
            nx1, ny1, nx2, ny2 = x1 + f[0], y1 + f[1], x2 + f[0], y2 + f[1]
            if nx2 <= 4 or ny2 <= 4 or nx1 >= W - 4 or ny1 >= H - 4:
                t.alive = False
                continue
            t.box = (nx1, ny1, nx2, ny2)
            t.conf = 1.0

        self.prev_gray = gray
        return self.boxes()

    def catch_up(self, frames: List[np.ndarray]) -> None:
        """Catch-up tracking: replay intermediate frames captured while a
        remote result was in flight (paper §V)."""
        for f in frames:
            self.step(f)
