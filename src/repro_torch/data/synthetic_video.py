"""Synthetic mobile-video generator with analytic ground truth.

Mirrors the paper's Table I scenarios: a moving camera over a textured
world with static structures (trees/buildings -> CMRs under camera
motion), a static far background (sky -> SBRs), and independently moving
objects (pedestrians/vehicles -> DORs).  Every frame comes with exact
bounding boxes, so the full detection/tracking/offloading pipeline can be
trained and evaluated end-to-end without external data.

All arrays are numpy (host-side data pipeline); frames are float32 in
[0, 1], HxWx3.
"""
from __future__ import annotations

import dataclasses
import zlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np


@dataclass
class Scenario:
    name: str
    camera_speed: float          # px/frame world scroll
    camera_jitter: float
    n_objects: int
    object_speed: float          # px/frame independent motion
    brightness: float            # illumination scale
    noise: float                 # sensor noise sigma (rain/night grain)
    texture_scale: int           # world texture feature size
    sky_fraction: float          # top fraction of frame = static background


SCENARIOS: Dict[str, Scenario] = {
    # paper Table I analogues
    "walkS": Scenario("walkS", 1.5, 0.3, 4, 1.2, 1.00, 0.005, 48, 0.35),
    "walkR": Scenario("walkR", 1.2, 0.5, 4, 1.0, 0.75, 0.030, 48, 0.30),
    "walkB": Scenario("walkB", 1.0, 0.2, 6, 1.5, 0.90, 0.010, 24, 0.15),
    "cycleS": Scenario("cycleS", 5.0, 1.0, 5, 2.5, 1.00, 0.008, 64, 0.40),
    "driveN": Scenario("driveN", 7.0, 0.8, 6, 3.5, 0.45, 0.040, 64, 0.30),
    # static surveillance camera (parked, near-stationary objects): the
    # temporal-reuse best case — almost every region is motionless
    "parkS": Scenario("parkS", 0.0, 0.0, 4, 0.0, 1.00, 0.002, 48, 0.35),
}

N_CLASSES = 8


@dataclass
class ObjectState:
    x: float
    y: float
    w: float
    h: float
    vx: float
    vy: float
    cls: int
    color: np.ndarray


class VideoGenerator:
    """Deterministic synthetic video stream."""

    def __init__(self, scenario: str, size: int = 512, seed: int = 0,
                 fps: int = 10):
        self.sc = SCENARIOS[scenario]
        self.size = size
        self.fps = fps
        # stable hash: python's hash() is salted per process, which would
        # make "deterministic" clips differ across runs
        self.rng = np.random.default_rng(
            seed * 1000 + zlib.crc32(scenario.encode()) % 1000)
        self.t = 0
        self._world = self._make_world()
        self._sky = self._make_sky()
        self.objects = [self._spawn() for _ in range(self.sc.n_objects)]
        self.cam_x = 0.0

    # ------------------------------------------------------------------
    def _make_world(self) -> np.ndarray:
        """Procedural texture strip the camera scrolls over (world map)."""
        S, ts = self.size, self.sc.texture_scale
        W = S * 8
        rng = self.rng
        coarse = rng.uniform(0.15, 0.9, (S // ts + 2, W // ts + 2, 3))
        world = np.kron(coarse, np.ones((ts, ts, 1)))[:S, :W]
        # vertical structures (trees / buildings): high-frequency columns
        for _ in range(W // 96):
            cx = rng.integers(0, W - 40)
            cw = rng.integers(16, 64)
            top = rng.integers(int(S * 0.25), int(S * 0.6))
            col = rng.uniform(0.1, 0.8, 3)
            stripes = (np.sin(np.arange(S - top) / 3.0) * 0.15)[:, None,
                                                                None]
            world[top:, cx:cx + cw] = col + stripes
        fine = rng.normal(0, 0.03, world.shape)
        return np.clip(world + fine, 0, 1).astype(np.float32)

    def _make_sky(self) -> np.ndarray:
        S = self.size
        g = np.linspace(0.9, 0.55, S)[:, None, None]
        base = np.array([0.55, 0.7, 0.95])[None, None, :]
        return (g * base).astype(np.float32)

    def _spawn(self) -> ObjectState:
        S = self.size
        rng = self.rng
        w = float(rng.uniform(S * 0.05, S * 0.16))
        h = float(rng.uniform(S * 0.07, S * 0.2))
        sky = int(S * self.sc.sky_fraction)
        return ObjectState(
            x=float(rng.uniform(0, S - w)),
            y=float(rng.uniform(sky, S - h)),
            w=w, h=h,
            vx=float(rng.normal(0, self.sc.object_speed)),
            vy=float(rng.normal(0, self.sc.object_speed * 0.3)),
            cls=int(rng.integers(0, N_CLASSES)),
            color=rng.uniform(0.2, 1.0, 3),
        )

    # ------------------------------------------------------------------
    def frame(self) -> Tuple[np.ndarray, List[Dict]]:
        """Render the next frame.  Returns (HxWx3 float32, gt boxes)."""
        S = self.size
        sc = self.sc
        self.cam_x += sc.camera_speed + self.rng.normal(0, sc.camera_jitter)
        W = self._world.shape[1]
        x0 = int(self.cam_x) % (W - S)

        img = self._world[:, x0:x0 + S].copy()
        sky_h = int(S * sc.sky_fraction)
        img[:sky_h] = self._sky[:sky_h]            # static background (SBR)

        boxes = []
        for ob in self.objects:
            ob.x += ob.vx + self.rng.normal(0, 0.2)
            ob.y += ob.vy + self.rng.normal(0, 0.1)
            if ob.x < -ob.w or ob.x > S or ob.y < sky_h * 0.5 or \
                    ob.y > S - ob.h * 0.5:
                new = self._spawn()
                ob.__dict__.update(new.__dict__)
            xi, yi = int(ob.x), int(ob.y)
            x1, y1 = max(xi, 0), max(yi, 0)
            x2, y2 = min(int(ob.x + ob.w), S), min(int(ob.y + ob.h), S)
            if x2 - x1 < 4 or y2 - y1 < 4:
                continue
            patch = img[y1:y2, x1:x2]
            yy = np.linspace(-1, 1, y2 - y1)[:, None]
            xx = np.linspace(-1, 1, x2 - x1)[None, :]
            blob = np.exp(-(yy ** 2 + xx ** 2) * 1.2)[..., None]
            img[y1:y2, x1:x2] = (patch * (1 - 0.9 * blob)
                                 + ob.color * 0.9 * blob)
            # class-identifying stripe pattern
            stripe = (np.sin(xx * (2 + ob.cls)) * 0.5 + 0.5) * 0.25
            img[y1:y2, x1:x2, ob.cls % 3] = np.clip(
                img[y1:y2, x1:x2, ob.cls % 3] + stripe * blob[..., 0], 0, 1)
            boxes.append({"box": (x1, y1, x2, y2), "cls": ob.cls})

        img = img * sc.brightness
        if sc.noise:
            img = img + self.rng.normal(0, sc.noise, img.shape)
        self.t += 1
        return np.clip(img, 0, 1).astype(np.float32), boxes


# ---------------------------------------------------------------------------
# detection targets for training the ViTDet reduced model (FCOS-lite)


def render_targets(boxes: List[Dict], size: int, strides=(8, 16, 32),
                   n_classes: int = N_CLASSES) -> List[Dict]:
    """Per-level target maps matching det_head outputs."""
    out = []
    for s in strides:
        H = W = size // s
        cls = np.zeros((H, W, n_classes), np.float32)
        box = np.zeros((H, W, 4), np.float32)
        pos = np.zeros((H, W, 1), np.float32)
        for b in boxes:
            x1, y1, x2, y2 = b["box"]
            # assign to the level whose stride matches object size; the
            # finest level takes everything below its band so small
            # objects are never left without a positive location
            scale = max(x2 - x1, y2 - y1)
            lo = 0 if s == strides[0] else 4 * s
            hi = 1e9 if s == strides[-1] else 16 * s
            if not (lo <= scale < hi):
                continue
            cx1, cy1 = int(x1 / s), int(y1 / s)
            cx2, cy2 = max(int(np.ceil(x2 / s)), cx1 + 1), \
                max(int(np.ceil(y2 / s)), cy1 + 1)
            # centre third is positive
            mx1 = cx1 + (cx2 - cx1) // 3
            mx2 = max(cx2 - (cx2 - cx1) // 3, mx1 + 1)
            my1 = cy1 + (cy2 - cy1) // 3
            my2 = max(cy2 - (cy2 - cy1) // 3, my1 + 1)
            for gy in range(max(my1, 0), min(my2, H)):
                for gx in range(max(mx1, 0), min(mx2, W)):
                    px = (gx + 0.5) * s
                    py = (gy + 0.5) * s
                    cls[gy, gx, b["cls"]] = 1.0
                    box[gy, gx] = [(px - x1) / s, (py - y1) / s,
                                   (x2 - px) / s, (y2 - py) / s]
                    pos[gy, gx] = 1.0
        out.append({"cls": cls, "box": box, "pos": pos})
    return out


def make_clip(scenario: str, n_frames: int, size: int = 512, seed: int = 0):
    """Materialise a clip: (frames (N,H,W,3), list of gt box lists)."""
    gen = VideoGenerator(scenario, size=size, seed=seed)
    frames, gts = [], []
    for _ in range(n_frames):
        f, b = gen.frame()
        frames.append(f)
        gts.append(b)
    return np.stack(frames), gts
