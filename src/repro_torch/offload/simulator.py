"""The edge server's detector: ``ServerModel``, the length-bucketed
serving path of ``repro.offload.simulator`` ported to PyTorch.

EVERY inference (solo N=1 or a batched multi-client wave) runs through
one code path, :meth:`ServerModel.infer_wave`: padded plan layouts
(core.partition.PlanLayout), the wave padded UP to a batch bucket, and a
forward keyed on the collapsed grid

    (length bucket, beta, capture point, B bucket).

Which regions are LOW/REUSE and how many windows are real are runtime
int32 data, so any plan mix at one length bucket shares one key.
PyTorch runs eagerly, so a key is not compiled ahead of time: ``warmup``
runs each key once (allocator pools, cuBLAS/cuDNN handles and algorithm
choices, kernel libraries) and ``stats.note_compile`` counts first uses;
one after warmup is a steady-state stall (``stats.steady_compiles``).

``ServerModel(cfg, params, quant=QuantSpec(...))`` compresses the tree
(``quant.ptq.compress``: head pruning, then int8 weights) before anything
runs, so the whole grid serves the compressed model and the grid keys do
not change.  Mixed waves at ``beta == 0`` restore at input (key
``(lb, 0, 0, B bucket)``): no restoration point, so no REUSE plans and
no capture.

Not ported yet: ``stage_frames``, ``infer_speculative``, ``restart``, the
host-resident cache mode, the kernel autotuner, the half-precision
quantized lanes (fp16/bf16 weights or activations) and calibration
(``quant/calibrate.py``).
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import det_head as dh
from repro_torch.core import mixed_res as mr
from repro_torch.core import partition as pt
from repro_torch.core import vit_backbone as vb
from repro_torch.core.partition import RegionPlan
from repro_torch.kernels import dispatch
from repro_torch.models.config import ModelConfig
from repro_torch.offload import detection as det
from repro_torch.quant import ptq
from repro_torch.quant import qtensor as qt
from repro_torch.serve.request import (FeatureCache, ServingStats,
                                       StaleCacheEpoch)

# the PlanLayout arrays the padded forwards read: the fused lane at
# beta >= 1 (win_src, nw, out_src, out_map) and the restore-at-input lane
# at beta == 0 (win_src, win_dst, low_src, low_ids)
_LAYOUT_ARGS = ("win_src", "win_dst", "low_src", "low_ids", "nw",
                "out_src", "out_map")


def to_device(tree, device: torch.device):
    """A parameter tree (dicts and lists of tensors and QuantTensors) on
    ``device``."""
    if isinstance(tree, (torch.Tensor, qt.QuantTensor)):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_device(v, device) for v in tree]
    return tree


@dataclass
class PendingWave:
    """An in-flight wave result: the forward is enqueued on the card,
    the blocking host-side decode has not run."""
    boxes: torch.Tensor
    scores: torch.Tensor
    classes: torch.Tensor
    B: int
    score_thresh: float

    def wait(self) -> List[List[Dict]]:
        boxes, scores, classes = (self.boxes.cpu().numpy(),
                                  self.scores.cpu().numpy(),
                                  self.classes.cpu().numpy())
        return [det.detections_from_arrays(boxes[i], scores[i], classes[i],
                                           self.score_thresh)
                for i in range(self.B)]


class ServerModel:
    """Server-side detector with a length-bucketed grid and device-resident
    feature caches.

    The transmitted window count of a plan is rounded UP to a
    ``length_edges`` bucket; mixed keys always capture restoration-point
    tiles (capture == beta; callers without a session drop them) and
    full-res keys capture at the deployment's canonical ``full_capture``
    point.  Wave sizes are padded UP to ``b_buckets`` edges with copies of
    sample 0; padded rows are dropped from the detections and never touch
    a FeatureCache.

    ``quant``: an optional ``quant.ptq.QuantSpec``; the tree is compressed
    on ``device`` before anything runs (``calib_frames`` feed head
    scoring when the spec prunes) and ``quant_report`` keeps the
    compression report.  Pre-compressed trees pass ``quant=None``.
    """

    def __init__(self, cfg: ModelConfig, params, top_k: int = 32,
                 score_thresh: float = 0.4, n_buckets: int = 4,
                 b_buckets: Tuple[int, ...] = pt.BATCH_BUCKETS,
                 n_length_buckets: int = pt.N_LENGTH_BUCKETS,
                 device: str = "cuda", quant=None, calib_frames=None):
        dispatch.disable_tf32()
        self.device = torch.device(device)
        params = to_device(params, self.device)
        self.quant_report = None
        if quant is not None:
            cfg, params, self.quant_report = ptq.compress(
                cfg, params, quant, calib_frames=calib_frames)
        self.cfg = cfg
        self.params = params
        # activation dtype of the grid, read from the tree so that
        # pre-compressed parameters work too
        self.act_dtype = params["patch_embed"]["b"].dtype
        if self.act_dtype != torch.float32:
            raise NotImplementedError(
                f"activation dtype {self.act_dtype}: only float32 is ported")
        self.part = vb.vit_partition(cfg)
        self.top_k = top_k
        self.score_thresh = score_thresh
        self.n_buckets = n_buckets
        self.b_buckets = tuple(sorted(b_buckets))
        self.length_edges = pt.length_bucket_set(self.part, n_length_buckets)
        self.full_capture = 0
        self._keys: set = set()
        self._zero_tiles: Dict[int, torch.Tensor] = {}
        self.stats = ServingStats()
        self.epoch = 0

    def batch_bucket(self, b: int) -> int:
        return pt.batch_bucket(b, self.b_buckets)

    def length_bucket(self, n_windows: int) -> int:
        return pt.length_bucket(n_windows, self.length_edges)

    def plan_length_bucket(self, plan: RegionPlan) -> int:
        """The length bucket a plan's transmitted windows land in
        (0 = the full-resolution key)."""
        if plan.n_low == 0 and plan.n_reuse == 0:
            return 0
        return self.length_bucket(pt.plan_n_windows(plan, self.part))

    # ------------------------------------------------------------------
    # the executable grid

    def _run(self, lb: int, beta: int, capture: int, imgs: torch.Tensor,
             layout: Optional[Dict[str, torch.Tensor]] = None,
             reuse_tiles: Optional[torch.Tensor] = None):
        """One forward of grid key (lb, beta, capture, imgs.shape[0]) and
        the top-k decode; returns ((boxes, scores, classes), tiles) when
        it captures."""
        key = (lb, beta, capture, imgs.shape[0])
        if key not in self._keys:
            self._keys.add(key)
            self.stats.note_compile(key)
        if lb == 0:
            out = vb.forward_det(self.cfg, self.params, imgs,
                                 capture_beta=capture)
        else:
            # beta == 0 restores at input: REUSE tiles are restoration-
            # point features and cannot splice there
            out = vb.forward_det(self.cfg, self.params, imgs, beta=beta,
                                 layout=layout,
                                 reuse_tiles=reuse_tiles if beta else None,
                                 capture_beta=capture)
        if capture:
            outs, tiles = out
            return dh.decode_detections(self.cfg, outs, self.top_k,
                                        self.score_thresh), tiles
        return dh.decode_detections(self.cfg, out, self.top_k,
                                    self.score_thresh)

    def _exec_key(self, n_low: int, n_reuse: int, beta: int,
                  cap: int) -> Tuple[int, int, int]:
        """Collapse a (n_low, n_reuse, beta, capture) plan shape onto the
        (length bucket, beta, capture) key it runs on."""
        if n_low == 0 and n_reuse == 0:
            return (0, 0, self._full_cap(cap))
        lb = self.length_bucket(self.part.n_windows(n_low, n_reuse))
        return (lb, beta, beta)

    def warmup(self, plan_space, batch_buckets: Optional[Tuple[int, ...]]
               = None) -> int:
        """Run every grid key of ``plan_space`` once, off the critical
        path.

        ``plan_space``: iterable of (n_low, n_reuse, beta, capture) tuples
        (:meth:`default_plan_space`), collapsed onto the (length bucket,
        beta, capture, B bucket) grid exactly as the reference does.
        Returns the number of keys warmed; afterwards
        ``stats.steady_compiles`` counts every further first use.
        """
        t0 = time.perf_counter()
        before = self.stats.compiles
        space = dict.fromkeys(tuple(p) for p in plan_space)
        self.full_capture = max(
            [self.full_capture] + [cap for (n_low, n_reuse, _, cap) in space
                                   if n_low == 0 and n_reuse == 0])
        keys = dict.fromkeys(self._exec_key(*p) for p in space)
        for (lb, beta, cap) in keys:
            for b in (batch_buckets or self.b_buckets):
                if (lb, beta, cap, b) not in self._keys:
                    self._warm(lb, beta, cap, b)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return self.stats.finish_warmup(t0, before, time.perf_counter())

    def _warm(self, lb: int, beta: int, cap: int, batch: int) -> None:
        H, W = self.cfg.vit.img_size
        imgs = torch.zeros((batch, H, W, 3), device=self.device)
        if lb == 0:
            self._run(0, 0, cap, imgs)
            return
        nR = self.part.n_regions
        nout = nR * self.part.windows_per_full_region

        def fill(n, v=0):
            return torch.full((batch, n), v, dtype=torch.int32,
                              device=self.device)

        # every window real at beta >= 1; at beta == 0 every scatter
        # lands on the sentinel rows, as a plan's pad entries do
        layout = {"win_src": fill(lb), "win_dst": fill(lb, nout),
                  "low_src": fill(nR), "low_ids": fill(nR, nR),
                  "nw": torch.full((batch,), lb, dtype=torch.int32,
                                   device=self.device),
                  "out_src": fill(nout), "out_map": fill(nout)}
        self._run(lb, beta, cap, imgs, layout, self._zeros_tiles(batch))

    def default_plan_space(self, betas: Sequence[int],
                           reuse_edges: Sequence[int] = (0,),
                           captures: Sequence[int] = (0,),
                           full_res: bool = True
                           ) -> List[Tuple[int, int, int, int]]:
        """The plan grid a config space induces: every n_low bucket edge
        x n_reuse edge x beta x capture point.  Beta 0 is skipped, as the
        reference skips it; a deployment that serves restore-at-input
        waves lists its (n_low, 0, 0, 0) plans itself."""
        edges = pt.bucket_set(self.part.n_regions, self.n_buckets)
        space: List[Tuple[int, int, int, int]] = []
        if full_res:
            for cap in captures:
                space.append((0, 0, 0, cap))
        for beta in betas:
            if beta < 1:
                continue
            for n_low in edges:
                for n_reuse in reuse_edges:
                    if n_low + n_reuse > self.part.n_regions:
                        continue
                    if n_low == 0 and n_reuse == 0:
                        continue
                    caps = {0}
                    if any(c > 0 for c in captures) or n_reuse > 0:
                        caps.add(beta)        # sessions capture at beta
                    for cap in sorted(caps):
                        if n_reuse > 0 and cap == 0:
                            continue          # reuse implies a session
                        space.append((n_low, n_reuse, beta, cap))
        return list(dict.fromkeys(space))

    # ------------------------------------------------------------------
    # the one serving entry point

    def _full_cap(self, want: int) -> int:
        """Canonical capture point of the full-res key: requests for no
        capture (or the deployment's point) share ``full_capture``."""
        if want == 0 or want == self.full_capture:
            return self.full_capture
        return want

    def infer_wave(self, frames, plans: Sequence[RegionPlan],
                   beta: int = 0,
                   caches: Optional[Sequence[Optional[FeatureCache]]] = None,
                   frame_ids: Optional[Sequence[int]] = None,
                   capture_beta: int = 0,
                   lb_override: Optional[int] = None,
                   defer: bool = False):
        """Serve one wave (B >= 1 frames, (B, H, W, 3) float32 numpy or
        tensor) through the collapsed grid.

        The wave runs at the length bucket of its LONGEST plan, or at
        ``lb_override``, which may only pad further (a length edge that
        holds every plan; an all-FULL wave then runs on the mixed key at
        beta max(beta, 1)).  A mixed wave at ``beta == 0`` restores at
        input: it carries no REUSE plan and captures no tiles.
        caches/frame_ids: the per-client FeatureCaches of sessionful jobs
        (entries may be None for stateless jobs); each sample splices
        from and refreshes its OWN cache.  The wave is padded up to the next batch bucket
        with copies of sample 0; padded rows are dropped from the
        detections and never touch a cache.  ``defer=True`` returns a
        :class:`PendingWave` instead of decoded detections.
        """
        B = len(frames)
        assert len(plans) == B and B >= 1
        if caches is not None:
            assert len(caches) == B
        for i, p in enumerate(plans):
            assert p.n_reuse == 0 or (caches is not None
                                      and caches[i] is not None
                                      and beta >= 1), \
                "REUSE regions need feature caches and a restoration point"
        if caches is not None:
            # epoch guard: no splice ever reads tiles from a dead replica
            for i, p in enumerate(plans):
                c = caches[i]
                if p.n_reuse > 0 and c is not None and c.epoch != self.epoch:
                    self.stats.stale_epoch_rejects += 1
                    raise StaleCacheEpoch(
                        f"sample {i}: REUSE plan carries cache epoch "
                        f"{c.epoch} but the replica is at epoch "
                        f"{self.epoch}")
            self.stats.reuse_splices += sum(
                1 for i, p in enumerate(plans)
                if p.n_reuse > 0 and caches[i] is not None)
        full_res = all(p.n_low == 0 and p.n_reuse == 0 for p in plans)

        Bp = self.batch_bucket(B)
        npad = Bp - B

        def pad_rows(a: np.ndarray) -> np.ndarray:
            if npad == 0:
                return a
            return np.concatenate([a, np.repeat(a[:1], npad, axis=0)])

        imgs = torch.as_tensor(frames, dtype=torch.float32,
                               device=self.device)
        if npad:
            imgs = torch.cat([imgs, imgs[:1].expand(npad, *imgs.shape[1:])])
        layouts: Optional[List[pt.PlanLayout]] = None
        if full_res and lb_override is None:
            store_cap = capture_beta if caches is not None else 0
            exec_cap = self._full_cap(store_cap)
            out = self._run(0, 0, exec_cap, imgs)
        else:
            beta_eff = beta if not full_res else max(beta, 1)
            nws = [pt.plan_n_windows(p, self.part) for p in plans]
            lb = (self.length_bucket(max(nws)) if lb_override is None
                  else lb_override)
            assert lb >= max(nws) and lb in self.length_edges, \
                f"lb_override {lb} cannot hold {max(nws)} windows " \
                f"(edges {self.length_edges})"
            layouts = [pt.plan_layout(p.states, lb, self.part)
                       for p in plans]
            arrays, _ = pt.stack_plan_layouts(layouts)
            layout = {k: torch.as_tensor(pad_rows(arrays[k]),
                                         device=self.device)
                      for k in _LAYOUT_ARGS}
            tiles_in = self._wave_tiles(layouts, caches, npad)
            # mixed keys always capture at their restoration point;
            # beta 0 has none, so it never captures
            exec_cap = beta_eff
            store_cap = beta_eff if caches is not None else 0
            out = self._run(lb, beta_eff, exec_cap, imgs, layout, tiles_in)

        if exec_cap:
            (boxes, scores, classes), tiles_out = out
            if store_cap and caches is not None:
                self._refresh_caches(caches, tiles_out, layouts, store_cap,
                                     frame_ids if frame_ids is not None
                                     else [-1] * B)
        else:
            boxes, scores, classes = out
        self.stats.offloads += B
        pending = PendingWave(boxes, scores, classes, B, self.score_thresh)
        return pending if defer else pending.wait()

    def _zeros_tiles(self, Bp: int) -> torch.Tensor:
        """Cached all-zero reuse-tiles input for reuse-free waves."""
        z = self._zero_tiles.get(Bp)
        if z is None:
            part = self.part
            z = torch.zeros((Bp, part.n_regions,
                             part.windows_per_full_region,
                             part.tokens_low_region, self.cfg.d_model),
                            dtype=self.act_dtype, device=self.device)
            self._zero_tiles[Bp] = z
        return z

    def _wave_tiles(self, layouts: List[pt.PlanLayout], caches,
                    npad: int) -> torch.Tensor:
        """(Bp, n_regions, d^2, w^2, D) stacked per-sample reuse tiles,
        gathered on the card.  Rows are (n_regions,)-padded: entries past
        a sample's n_reuse gather region 0, which no destination reads."""
        B = len(layouts)
        if caches is None or all(l.n_reuse == 0 for l in layouts):
            return self._zeros_tiles(B + npad)
        nR = self.part.n_regions
        zero = self._zeros_tiles(1)[0]
        rows = []
        for l, c in zip(layouts, caches):
            if l.n_reuse == 0 or c is None or c.tiles is None:
                rows.append(zero)
                continue
            rows.append(c.gather(np.where(l.reuse_ids < nR, l.reuse_ids, 0)))
        rows += [rows[0]] * npad
        return torch.stack(rows)

    def _refresh_caches(self, caches, tiles_out: torch.Tensor, layouts,
                        cap: int, frame_ids) -> None:
        """Refresh each real sessionful sample's cache with its captured
        tiles.  Padded rows and cache-less samples are never written."""
        B = len(caches)
        reuse_rows = [l.reuse_ids[:l.n_reuse] if l is not None
                      else np.zeros((0,), np.int32)
                      for l in (layouts or [None] * B)]
        for i, c in enumerate(caches[:B]):
            if c is None:
                continue
            c.update(mr.take_sample_tiles(tiles_out, i), reuse_rows[i], cap,
                     frame_ids[i], epoch=self.epoch)

    # ------------------------------------------------------------------
    # N=1 conveniences (thin wrappers over infer_wave)

    def infer(self, frame: np.ndarray, mask: Optional[np.ndarray] = None,
              beta: int = 0) -> List[Dict]:
        plan = (RegionPlan.from_mask(mask) if mask is not None
                else RegionPlan(np.zeros((self.part.n_regions,), np.int8)))
        return self.infer_wave(frame[None], [plan], beta)[0]

    def infer_plan(self, frame: np.ndarray, plan: RegionPlan,
                   beta: int = 0, cache: Optional[FeatureCache] = None,
                   frame_idx: int = -1,
                   capture_beta: int = 0) -> List[Dict]:
        """Stateful three-state inference for one client frame: splices
        the plan's REUSE tiles at the restoration point and, with a
        ``cache``, refreshes it with this forward's tiles."""
        return self.infer_wave(
            frame[None], [plan], beta,
            caches=None if cache is None else [cache],
            frame_ids=[frame_idx], capture_beta=capture_beta)[0]
