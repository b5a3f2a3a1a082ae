"""Inference-compatible region partitioning (paper §III-A); the numpy
host-side half of ``repro.core.partition``, copied so the port never
imports the JAX package.

The frame is tiled into *decision regions* of ``r x r`` image patches with
``r = w * d`` (w = window size, d = downsampling factor): a FULL region
contributes ``d**2`` attention windows, a LOW region exactly one, and a
REUSE region none (its cached restoration-point tile is spliced back in).
Sequences are **window-blocked**: a sequence of whole windows, each
flattened row-major to ``w*w`` tokens.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence, Tuple

import numpy as np

# RegionPlan states
FULL, LOW, REUSE = 0, 1, 2


@dataclass(frozen=True)
class Partition:
    """Static geometry of the decision-region grid."""
    grid_h: int          # patch-grid height  (e.g. 64 for 1024px / 16)
    grid_w: int          # patch-grid width
    window: int          # w: attention window size in patches
    downsample: int      # d

    @property
    def region(self) -> int:                       # r = w * d, in patches
        return self.window * self.downsample

    @property
    def regions_h(self) -> int:
        return self.grid_h // self.region

    @property
    def regions_w(self) -> int:
        return self.grid_w // self.region

    @property
    def n_regions(self) -> int:
        return self.regions_h * self.regions_w

    @property
    def tokens_full_region(self) -> int:           # r*r patches
        return self.region * self.region

    @property
    def tokens_low_region(self) -> int:            # one w*w window
        return self.window * self.window

    @property
    def windows_per_full_region(self) -> int:
        return self.downsample * self.downsample

    def validate(self) -> None:
        if self.grid_h % self.region or self.grid_w % self.region:
            raise ValueError(
                f"patch grid {self.grid_h}x{self.grid_w} not divisible by "
                f"decision region r={self.region} (= w{self.window} * "
                f"d{self.downsample})")

    # ------------------------------------------------------------------
    def n_tokens(self, n_low: int, n_reuse: int = 0) -> int:
        """Transmitted token count for ``n_low`` low + ``n_reuse`` reused
        regions (reused regions contribute NO tokens)."""
        n_full = self.n_regions - n_low - n_reuse
        return (n_full * self.tokens_full_region
                + n_low * self.tokens_low_region)

    def n_windows(self, n_low: int, n_reuse: int = 0) -> int:
        n_full = self.n_regions - n_low - n_reuse
        return n_full * self.windows_per_full_region + n_low


def make_partition(grid_h: int, grid_w: int, window: int,
                   downsample: int) -> Partition:
    p = Partition(grid_h, grid_w, window, downsample)
    p.validate()
    return p


# ---------------------------------------------------------------------------
# token bucketing (DESIGN.md: XLA cannot retrace per frame — N_d is rounded
# to a small static bucket set so the server compiles a handful of shapes)


def bucket_n_low(n_low: int, n_regions: int, n_buckets: int = 4) -> int:
    """Round ``n_low`` DOWN to the nearest bucket edge.

    Rounding down downsamples *fewer* regions than requested — the safe
    direction for accuracy (some regions selected for downsampling stay
    full-res).  Buckets: 0, R/n, 2R/n, ..., R (R = n_regions).
    """
    if n_low <= 0:
        return 0
    step = max(n_regions // n_buckets, 1)
    return min((n_low // step) * step, n_regions)


def bucket_set(n_regions: int, n_buckets: int = 4) -> Tuple[int, ...]:
    step = max(n_regions // n_buckets, 1)
    edges = list(range(0, n_regions + 1, step))
    if edges[-1] != n_regions:
        edges.append(n_regions)
    return tuple(edges)


# ---------------------------------------------------------------------------
# token-length buckets (the collapsed executable grid): instead of one
# executable per (n_low bucket, n_reuse bucket), the serving hot path
# pads the window-blocked sequence UP to one of a few LENGTH buckets and
# carries (which regions, how many are valid) as runtime i32 data.  A
# "length" is a WINDOW count — the sequence is a concatenation of
# whole w*w-token windows, so n_tokens = n_windows * w^2 exactly.

N_LENGTH_BUCKETS = 3


def length_bucket_set(part: Partition,
                      n_edges: int = N_LENGTH_BUCKETS) -> Tuple[int, ...]:
    """Window-count bucket edges over the reachable sequence lengths.

    Edges are multiples of ``d^2`` (a whole full-res region) so a bucket
    always fits an integral mix of regions; the top edge is the full-
    resolution window count, so every transmittable plan has a bucket.
    """
    dd = part.windows_per_full_region
    nw_max = part.n_regions * dd
    step = -(-nw_max // max(n_edges, 1))          # ceil
    step = -(-step // dd) * dd                    # round up to d^2 multiple
    edges = list(range(step, nw_max, step))
    edges.append(nw_max)
    return tuple(edges)


def length_bucket(n_windows: int, edges: Sequence[int]) -> int:
    """Round a window count UP to the nearest length-bucket edge.

    Padding up is the only safe direction: pad windows are inert (masked
    out of global attention, routed to the sentinel row at restoration),
    while rounding down would drop transmitted windows.
    """
    assert n_windows >= 1, f"empty sequence: n_windows={n_windows}"
    for edge in sorted(edges):
        if n_windows <= edge:
            return edge
    raise ValueError(f"sequence of {n_windows} windows exceeds largest "
                     f"length bucket {max(edges)}")


# batch-size buckets (serving hot path): waves are padded UP to the next
# edge so the compiled-executable grid is bounded in B as well — without
# this, every distinct wave size B is a fresh XLA trace at serve time.
BATCH_BUCKETS = (1, 2, 4, 8)


def batch_bucket(b: int, buckets: Sequence[int] = BATCH_BUCKETS) -> int:
    """Round a wave size UP to the nearest batch bucket.

    Padding up is the only safe direction: padded samples replicate a
    real sample and are dropped from the decoded detections, so the wave
    result is unchanged (pinned bit-exactly by tests — within one
    executable, XLA results are invariant to pad content and row order).
    """
    assert b >= 1, f"empty wave: B={b}"
    for edge in sorted(buckets):
        if b <= edge:
            return edge
    raise ValueError(f"wave size {b} exceeds largest batch bucket "
                     f"{max(buckets)}")


# ---------------------------------------------------------------------------
# RegionPlan: per-region FULL / LOW / REUSE states


@dataclass(frozen=True)
class RegionPlan:
    """Per-region transmit/compute plan for one offloaded frame.

    ``states``: (n_regions,) int8 array of FULL / LOW / REUSE.  FULL and
    LOW regions are transmitted (native / downsampled); REUSE regions
    ship zero payload bytes and are restored from the client's cached
    backbone-feature tiles (serve.request.FeatureCache).
    """
    states: np.ndarray

    @classmethod
    def from_mask(cls, mask: np.ndarray) -> "RegionPlan":
        """Binary downsample mask (the legacy region model) -> plan."""
        m = np.asarray(mask).reshape(-1)
        return cls(np.where(m != 0, LOW, FULL).astype(np.int8))

    @property
    def n_regions(self) -> int:
        return int(self.states.shape[0])

    @property
    def n_low(self) -> int:
        return int((self.states == LOW).sum())

    @property
    def n_reuse(self) -> int:
        return int((self.states == REUSE).sum())

    @property
    def n_transmit(self) -> int:
        return self.n_regions - self.n_reuse

    def low_mask(self) -> np.ndarray:
        return (self.states == LOW).astype(np.int32)

    def reuse_mask(self) -> np.ndarray:
        return (self.states == REUSE).astype(np.int32)



# ---------------------------------------------------------------------------
# mask/plan <-> region-id packing helpers (host-side, numpy: these produce
# the *data* gather indices; shapes depend only on the static buckets)


def _static_select(ids: np.ndarray, n: int) -> Tuple[np.ndarray, set]:
    """First ``n`` ids with static size; pads by repeating the last entry
    (or 0 when empty).  Returns (kept ids, the set actually selected)."""
    if len(ids) >= n:
        kept = ids[:n]
        return kept, set(kept.tolist())
    pad = np.full((n - len(ids),), ids[-1] if len(ids) else 0,
                  dtype=np.int64)
    kept = np.concatenate([ids, pad]) if len(ids) else pad
    return kept, set(ids.tolist())


def plan_to_region_ids(states: np.ndarray, n_low: int, n_reuse: int = 0
                       ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Split plan states into (full_ids, low_ids, reuse_ids), static
    sizes ``(n_regions - n_low - n_reuse, n_low, n_reuse)``.

    ``n_low`` / ``n_reuse`` are the static buckets: extra LOW/REUSE
    selections beyond them revert to FULL.  When the plan selects FEWER
    than the bucket, ids are padded by repeating the last entry.
    """
    states = np.asarray(states).reshape(-1)
    n_regions = states.shape[0]
    low = np.nonzero(states == LOW)[0]
    reuse = np.nonzero(states == REUSE)[0]
    kept_low, low_set = _static_select(low, n_low)
    kept_reuse, reuse_set = _static_select(reuse, n_reuse)
    drop = low_set | reuse_set
    full = np.array([i for i in range(n_regions) if i not in drop],
                    dtype=np.int64)
    # static size: if the plan had fewer lows/reuses than the buckets,
    # trim extras from the tail (they are covered by the padded dups)
    full = full[:n_regions - n_low - n_reuse]
    return (full.astype(np.int32), kept_low.astype(np.int32),
            kept_reuse.astype(np.int32))


def mask_to_region_ids(mask: np.ndarray, n_low: int) -> Tuple[np.ndarray,
                                                              np.ndarray]:
    """Split region ids into (full_ids, low_ids) with static sizes;
    ``mask``: (n_regions,) binary, 1 = downsample.  The two-state case of
    :func:`plan_to_region_ids`."""
    mask = np.asarray(mask).reshape(-1)
    full, low, _ = plan_to_region_ids(
        np.where(mask != 0, LOW, FULL).astype(np.int8), n_low, 0)
    return full, low


def region_ids_to_mask(low_ids: np.ndarray, n_regions: int) -> np.ndarray:
    m = np.zeros((n_regions,), np.int32)
    m[np.asarray(low_ids, np.int64)] = 1
    return m


def stack_region_ids(masks: Sequence[np.ndarray], n_low: int
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Per-sample (B, nF) / (B, nL) region ids for a same-bucket wave;
    every sample keeps its OWN layout, only the bucket is shared."""
    ids = [mask_to_region_ids(m, n_low) for m in masks]
    return (np.stack([f for f, _ in ids]).astype(np.int32),
            np.stack([l for _, l in ids]).astype(np.int32))


def stack_plan_ids(plans: Sequence["RegionPlan"], n_low: int, n_reuse: int
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-sample (B, nF) / (B, nL) / (B, nR) ids for a same-bucket wave."""
    ids = [plan_to_region_ids(p.states, n_low, n_reuse) for p in plans]
    return (np.stack([f for f, _, _ in ids]).astype(np.int32),
            np.stack([l for _, l, _ in ids]).astype(np.int32),
            np.stack([r for _, _, r in ids]).astype(np.int32))


# ---------------------------------------------------------------------------
# padded plan layouts (host-side): the mask-traced description of ONE
# RegionPlan inside a length bucket.  All shapes depend only on the
# bucket (``nw_pad``) and the partition — (n_low, n_reuse) are runtime
# data, so every plan mix at one length bucket shares one executable.


def plan_n_windows(plan: "RegionPlan", part: Partition) -> int:
    """Transmitted window count of a plan (its pre-padding length)."""
    return part.n_windows(plan.n_low, plan.n_reuse)


@dataclass(frozen=True)
class PlanLayout:
    """Padded window-level layout of one plan at a length bucket.

    Sequence convention matches the legacy exact-shape pack: full-region
    windows first (regions ascending, d^2 windows each, row-major), then
    one window per LOW region (ascending), then pad windows up to
    ``nw_pad``.  Pad windows replicate source window 0 so their content
    stays finite; every consumer routes them to a sentinel.

      win_src    (nw_pad,)     source window in the packed window bank
                               [full windows (nR*d^2) | low windows (nR)]
      win_dst    (nw_pad,)     restoration slot of a FULL window in the
                               full-res window grid; LOW and pad windows
                               carry the sentinel slot nR*d^2
      low_src    (n_regions,)  sequence position of the i-th LOW window
                               (pads read position 0, discarded)
      low_ids    (n_regions,)  destination region of the i-th LOW window
                               (pads carry the sentinel region nR)
      reuse_ids  (n_regions,)  REUSE regions (pads carry the sentinel)
      out_src    (nR*d^2,)     destination-major inverse of the scatter:
                               the SOURCE window of every full-res grid
                               slot — a packed sequence position for
                               FULL/LOW regions, or ``nw_pad + j*d^2 + k``
                               into the appended reuse-tile bank for the
                               j-th REUSE region's sub-window k (the
                               fused restore epilogue's gather indices,
                               kernels.fused_serving)
      out_map    (nR*d^2,)     token permutation per slot: 0 = identity
                               (FULL/REUSE), k+1 = upsample map of
                               sub-window k (LOW regions)
      nw         valid window count (i32 runtime input; tokens beyond
                 nw * w^2 are masked out of pre-restoration global
                 attention and zeroed by the window-attention valid flag)
      key        fingerprint bytes, computed ONCE here so downstream
                 caches (packed_positions) key in O(1)
    """
    nw: int
    n_low: int
    n_reuse: int
    win_src: np.ndarray
    win_dst: np.ndarray
    low_src: np.ndarray
    low_ids: np.ndarray
    reuse_ids: np.ndarray
    out_src: np.ndarray
    out_map: np.ndarray
    key: bytes


def plan_layout(states: np.ndarray, nw_pad: int,
                part: Partition) -> PlanLayout:
    """Build the padded layout of a plan for the ``nw_pad`` bucket."""
    states = np.asarray(states).reshape(-1)
    nR, dd = part.n_regions, part.windows_per_full_region
    assert states.shape[0] == nR
    full = np.nonzero(states == FULL)[0]
    low = np.nonzero(states == LOW)[0]
    reuse = np.nonzero(states == REUSE)[0]
    nw = len(full) * dd + len(low)
    if not 1 <= nw <= nw_pad:
        raise ValueError(f"plan needs {nw} windows; bucket holds {nw_pad}")

    sent_w = nR * dd
    win_src = np.zeros((nw_pad,), np.int32)
    win_dst = np.full((nw_pad,), sent_w, np.int32)
    slots = (full[:, None] * dd + np.arange(dd)[None, :]).reshape(-1)
    win_src[:len(slots)] = slots
    win_dst[:len(slots)] = slots
    low_src = np.zeros((nR,), np.int32)
    low_ids = np.full((nR,), nR, np.int32)
    win_src[len(slots):nw] = sent_w + low
    low_src[:len(low)] = np.arange(len(slots), nw)
    low_ids[:len(low)] = low
    win_src[nw:] = win_src[0]            # pads replicate a real window
    reuse_pad = np.full((nR,), nR, np.int32)
    reuse_pad[:len(reuse)] = reuse

    # destination-major inverse (fused restore epilogue): every grid
    # slot names its source window.  The states partition the regions,
    # so the inverse is total — no sentinel needed.
    out_src = np.zeros((nR * dd,), np.int32)
    out_map = np.zeros((nR * dd,), np.int32)
    out_src[slots] = np.arange(len(slots), dtype=np.int32)
    for j, r in enumerate(low):
        out_src[r * dd:(r + 1) * dd] = len(slots) + j
        out_map[r * dd:(r + 1) * dd] = np.arange(1, dd + 1)
    for j, r in enumerate(reuse):
        out_src[r * dd:(r + 1) * dd] = nw_pad + j * dd + np.arange(dd)

    key = b"".join((np.int64([nw, nw_pad]).tobytes(), win_src.tobytes(),
                    low_src.tobytes(), low_ids.tobytes(),
                    reuse_pad.tobytes()))
    return PlanLayout(nw=nw, n_low=len(low), n_reuse=len(reuse),
                      win_src=win_src, win_dst=win_dst, low_src=low_src,
                      low_ids=low_ids, reuse_ids=reuse_pad,
                      out_src=out_src, out_map=out_map, key=key)


def stack_plan_layouts(layouts: Sequence[PlanLayout]
                       ) -> Tuple[dict, bytes]:
    """Per-sample (B, ·) arrays + (B,) valid counts for a wave, plus the
    wave's combined layout fingerprint."""
    arrays = {
        "win_src": np.stack([l.win_src for l in layouts]),
        "win_dst": np.stack([l.win_dst for l in layouts]),
        "low_src": np.stack([l.low_src for l in layouts]),
        "low_ids": np.stack([l.low_ids for l in layouts]),
        "reuse_ids": np.stack([l.reuse_ids for l in layouts]),
        "nw": np.array([l.nw for l in layouts], np.int32),
        "out_src": np.stack([l.out_src for l in layouts]),
        "out_map": np.stack([l.out_map for l in layouts]),
    }
    return arrays, b"|".join(l.key for l in layouts)
