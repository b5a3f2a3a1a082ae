"""The event-driven end-to-end offloading simulator (paper §VI) and the
edge server's detector, ``ServerModel``: ``repro.offload.simulator``
ported to PyTorch.

:class:`Simulation` replays a video at a fixed FPS against a network
trace.  The client side (region motion analysis, the LK tracker,
Algorithm 1 over the estimators, the mixed-resolution codec) is the
reference's numpy code; the server side runs ``ServerModel`` on the
codec-decoded frame; delays follow Eq. (2) with the inference term from
an ``InferenceDelayModel``.  Rendering accuracy is the F1 between what
the user sees (cache or tracker output) and the ground truth of the
current frame, where ground truth is the full-resolution model's output.

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

The multi-client edge (``serve/edge.py``, ``serve/scheduler.py``) drives
the same entry point: :meth:`ServerModel.stage_frames` copies a wave's
frames to the card from pinned host memory on a side stream ahead of its
forward, ``infer_wave(defer=True)`` returns a :class:`PendingWave` whose
blocking decode the continuous scheduler runs under the next wave's
compute, and :meth:`ServerModel.infer_speculative` with
:func:`predict_canvas` / :func:`region_divergence` /
:func:`build_patch_plan` serves its speculative REUSE lane.

``ServerModel(device_cache=False)`` is the reference's host-resident
cache mode, which its benches compare against: captured tiles are copied
to host memory at every refresh and REUSE tiles are gathered there and
copied back through pinned memory, each copy counted in
``stats.tile_bytes_*``; detections and tiles are those of the default
device-resident mode, which moves no tile bytes.

A half tree (``quant=QuantSpec("int8", "fp16", 1)``, the reference's
shipped point, or fp16 / bf16 weights) serves its grid in ``act_dtype``:
activations, zero tiles and cached tiles in that type, the kernels'
half entry points, detections decoded in float32, and the same grid
keys as float32.  On the card ``warmup`` first sweeps the tiles of the
window, flash and int8 GEMM kernels at every attention and GEMM shape of
its grid (``kernels.autotune``; winners cached on disk by device kind),
as the reference's does; off the card it sweeps nothing.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import det_head as dh
from repro_torch.core import mixed_res as mr
from repro_torch.core import partition as pt
from repro_torch.core import vit_backbone as vb
from repro_torch.core.partition import LOW, REUSE, Partition, RegionPlan
from repro_torch.kernels import autotune, dispatch
from repro_torch.models.config import ModelConfig
from repro_torch.offload import detection as det
from repro_torch.offload import motion as mo
from repro_torch.offload.codec import CodecDelayModel, MixedResCodec
from repro_torch.offload.estimator import ThroughputEstimator
from repro_torch.offload.faults import (DegradationLadder, FaultInjector,
                                        RobustConfig, fresh_rstats)
from repro_torch.offload.optimizer import SystemState
from repro_torch.offload.tracker import LKTracker
from repro_torch.quant import ptq
from repro_torch.quant.qtensor import QuantTensor, _leaves, to_device
from repro_torch.serve.request import (FeatureCache, ServingStats,
                                       StaleCacheEpoch)
from repro_torch.serve.scheduler import SoloScheduler

# payload scale: our 512x512 luma codec vs the paper's 1080p YUV frames
SIZE_SCALE = (1920 * 1080) / (512 * 512)

# the PlanLayout arrays the padded forwards read: the fused lane at
# beta >= 1 (win_src, nw, out_src, out_map) and the restore-at-input lane
# at beta == 0 (win_src, win_dst, low_src, low_ids)
_LAYOUT_ARGS = ("win_src", "win_dst", "low_src", "low_ids", "nw",
                "out_src", "out_map")


@dataclass
class StagedWave:
    """A wave's decoded frames, padded to their B bucket and copied toward
    the server's device (:meth:`ServerModel.stage_frames`).  On the card
    the copy runs from pinned host memory on a side stream; ``ready`` is
    the event recorded after it, which the compute stream waits on before
    the forward reads ``imgs``."""
    B: int                   # real rows; imgs carries Bp >= B
    imgs: torch.Tensor
    ready: Optional["torch.cuda.Event"] = None


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

    ``device_cache=True`` keeps captured restoration-point tiles on the
    device end to end (reuse gathers and refreshes are device index ops,
    zero tile bytes between host and device); ``False`` is the
    host-resident mode, which copies and counts them
    (``stats.tile_bytes_*``).
    """

    def __init__(self, cfg: ModelConfig, params, top_k: int = 32,
                 score_thresh: float = 0.4, n_buckets: int = 4,
                 b_buckets: Tuple[int, ...] = pt.BATCH_BUCKETS,
                 n_length_buckets: int = pt.N_LENGTH_BUCKETS,
                 device: str = "cuda", quant=None, calib_frames=None,
                 device_cache: bool = True):
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
        self.part = vb.vit_partition(cfg)
        self.top_k = top_k
        self.score_thresh = score_thresh
        self.n_buckets = n_buckets
        self.b_buckets = tuple(sorted(b_buckets))
        self.device_cache = device_cache
        self.length_edges = pt.length_bucket_set(self.part, n_length_buckets)
        self.full_capture = 0
        self._keys: set = set()
        self._zero_tiles: Dict[int, torch.Tensor] = {}
        self.stats = ServingStats()
        self.epoch = 0
        self._stage_stream = None     # side stream of stage_frames (cuda)

    def restart(self, preserve_executables: bool = False) -> int:
        """Crash-restart this replica.

        Bumps the cache epoch, so any REUSE plan still carrying tiles
        captured before this moment is refused (StaleCacheEpoch), and,
        unless ``preserve_executables`` (the outage modelled in sim time
        only), drops the warm grid: the next use of every key counts as a
        first use of a new process, not a steady-state stall, until
        :meth:`warmup` runs again.  Returns the new epoch.
        """
        self.epoch += 1
        self.stats.restarts += 1
        if not preserve_executables:
            self._keys.clear()
            self._zero_tiles.clear()
            self.stats.warmed = False
        return self.epoch

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
        ``stats.steady_compiles`` counts every further first use.  On the
        card the kernels' tiles are swept first
        (:meth:`_autotune_kernels`), before any key runs.
        """
        t0 = time.perf_counter()
        before = self.stats.compiles
        if self.device.type == "cuda":
            self._autotune_kernels(batch_buckets or self.b_buckets)
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

    def _autotune_kernels(self, batch_buckets) -> None:
        """Sweep the window / flash tiles at every (B bucket, length
        bucket) attention shape of the grid and at full resolution, in
        the grid's ``act_dtype`` (an fp16 grid never reuses float32
        winners), and, when the tree holds ``QuantTensor``s, the int8
        GEMM's at the grid's GEMM shapes (fused QKV, w_o, the MLP at
        every sequence length): the reference's ``_autotune_kernels``.
        A bucket whose winner is on disk is not swept again."""
        part, cfg = self.part, self.cfg
        w2 = part.window * part.window
        T_full = part.grid_h * part.grid_w
        dt, dev = self.act_dtype, self.device
        for b in batch_buckets:
            for lb in self.length_edges:
                autotune.tune_window(b, lb * w2, cfg.n_heads, cfg.head_dim,
                                     w2, dtype=dt, device=dev)
            autotune.tune_window(b, T_full, cfg.n_heads, cfg.head_dim, w2,
                                 dtype=dt, device=dev)
            autotune.tune_flash(b, T_full, T_full, cfg.n_heads,
                                cfg.head_dim, dtype=dt, device=dev)
        if any(isinstance(leaf, QuantTensor)
               for leaf in _leaves(self.params)):
            qkv_n = cfg.q_dim + 2 * cfg.kv_dim
            shapes = {(cfg.d_model, qkv_n), (cfg.q_dim, cfg.d_model),
                      (cfg.d_model, cfg.d_ff), (cfg.d_ff, cfg.d_model)}
            for b in batch_buckets:
                for T in {T_full} | {lb * w2 for lb in self.length_edges}:
                    for (K, N) in sorted(shapes):
                        autotune.tune_matmul(b * T, N, K, out_dtype=dt,
                                             device=dev)

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

    def _h2d(self, a) -> torch.Tensor:
        """A host array or tensor (half tiles have no numpy type) on the
        server's device.  On the card the copy goes through pinned memory
        without blocking the host, so it never waits for the forwards
        already queued on the stream."""
        t = a if isinstance(a, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(a))
        if self.device.type != "cuda":
            return t.to(self.device)
        return t.contiguous().pin_memory().to(self.device, non_blocking=True)

    def stage_frames(self, frames) -> StagedWave:
        """Stage a wave's decoded frames ahead of its forward.

        Pads up to the B bucket on the host.  On a CUDA server the frames
        are copied into a pinned host buffer and on to the card with a
        non-blocking copy on a side stream, so called while the previous
        wave computes, the transfer overlaps it; the result's ``ready``
        event orders the forward after the copy.  A server built with
        ``device="cpu"`` stages a CPU tensor.  The result feeds
        :meth:`infer_wave` in place of the frames.
        """
        frames = np.asarray(frames, np.float32)
        B = frames.shape[0]
        npad = self.batch_bucket(B) - B
        if npad:
            frames = np.concatenate(
                [frames, np.repeat(frames[:1], npad, axis=0)])
        if self.device.type != "cuda":
            return StagedWave(B=B, imgs=torch.from_numpy(frames.copy()))
        host = torch.from_numpy(np.ascontiguousarray(frames)).pin_memory()
        if self._stage_stream is None:
            self._stage_stream = torch.cuda.Stream(device=self.device)
        with torch.cuda.stream(self._stage_stream):
            imgs = host.to(self.device, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(self._stage_stream)
        return StagedWave(B=B, imgs=imgs, ready=ready)

    def infer_wave(self, frames, plans: Sequence[RegionPlan],
                   beta: int = 0,
                   caches: Optional[Sequence[Optional[FeatureCache]]] = None,
                   frame_ids: Optional[Sequence[int]] = None,
                   capture_beta: int = 0,
                   lb_override: Optional[int] = None,
                   defer: bool = False):
        """Serve one wave (B >= 1 frames, (B, H, W, 3) float32 numpy or
        tensor, or a :class:`StagedWave`) through the collapsed grid.

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
        :class:`PendingWave` instead of decoded detections.  A
        :class:`StagedWave` from :meth:`stage_frames` arrives already
        padded; together with ``defer`` it is the continuous scheduler's
        overlapped path.
        """
        staged = frames if isinstance(frames, StagedWave) else None
        B = staged.B if staged is not None else len(frames)
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

        if staged is not None:
            imgs = staged.imgs
            assert imgs.shape[0] == Bp and imgs.device == self.device, \
                f"staged wave of {imgs.shape[0]} rows on {imgs.device}, " \
                f"but the B bucket is {Bp} on {self.device}"
            if staged.ready is not None:
                stream = torch.cuda.current_stream(self.device)
                stream.wait_event(staged.ready)
                imgs.record_stream(stream)
        else:
            imgs = torch.as_tensor(frames, dtype=torch.float32,
                                   device=self.device)
            if npad:
                imgs = torch.cat([imgs,
                                  imgs[:1].expand(npad, *imgs.shape[1:])])
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
            layout = {k: self._h2d(pad_rows(arrays[k]))
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
        """(Bp, n_regions, d^2, w^2, D) stacked per-sample reuse tiles.
        Rows are (n_regions,)-padded: entries past a sample's n_reuse
        gather region 0, which no destination reads.  Device-resident
        caches gather on the card; host caches gather on the host, and
        the wave's tiles are copied up through pinned memory, their real
        rows counted in ``stats.tile_bytes_h2d``."""
        B = len(layouts)
        if caches is None or all(l.n_reuse == 0 for l in layouts):
            return self._zeros_tiles(B + npad)
        nR = self.part.n_regions
        rows, host_bytes = [], 0
        for l, c in zip(layouts, caches):
            if l.n_reuse == 0 or c is None or c.tiles is None:
                rows.append(None)
                continue
            ids = np.where(l.reuse_ids < nR, l.reuse_ids, 0).astype(np.int64)
            if c.tiles_on_device:
                rows.append(c.gather(self._h2d(ids)))
            else:
                g = c.gather(torch.from_numpy(ids))
                # only the real rows are payload; the pad rows are an
                # artifact of the padded gather
                host_bytes += g[:l.n_reuse].nbytes
                rows.append(g)
        zero = self._zeros_tiles(1)[0]
        if host_bytes:
            self.stats.tile_bytes_h2d += host_bytes
            zero = zero.cpu()
        rows = [zero if r is None else r for r in rows]
        tiles = torch.stack(rows + [rows[0]] * npad)
        return self._h2d(tiles) if host_bytes else tiles

    def _refresh_caches(self, caches, tiles_out: torch.Tensor, layouts,
                        cap: int, frame_ids) -> None:
        """Refresh each real sessionful sample's cache with its captured
        tiles.  Padded rows and cache-less samples are never written.  A
        host-resident cache copies its sample's tiles down, counted in
        ``stats.tile_bytes_d2h``."""
        B = len(caches)
        reuse_rows = [l.reuse_ids[:l.n_reuse] if l is not None
                      else np.zeros((0,), np.int32)
                      for l in (layouts or [None] * B)]
        for i, c in enumerate(caches[:B]):
            if c is None:
                continue
            tiles = mr.take_sample_tiles(tiles_out, i)
            if not self.device_cache:
                self.stats.tile_bytes_d2h += tiles.nbytes
            c.update(tiles, reuse_rows[i], cap, frame_ids[i],
                     epoch=self.epoch, host=not self.device_cache)

    # ------------------------------------------------------------------
    # speculative REUSE execution (the spliced forward starts before the
    # payload lands; serve/scheduler.py owns admission and resolution)

    def infer_speculative(self, pred_canvas: np.ndarray, plan: RegionPlan,
                          beta: int, cache: FeatureCache,
                          frame_idx: int) -> Tuple[List[Dict],
                                                   FeatureCache]:
        """Run a plan's spliced forward on a PREDICTED canvas.

        The canvas substitutes the in-flight LOW/FULL regions' pixels
        with the session's prediction source (:func:`predict_canvas`);
        REUSE regions splice from the cache as the real forward would.
        Same plan, same length bucket, B=1: the warmed ``(lb, beta, beta,
        1)`` key, so speculation adds no grid key.  Capture goes into a
        :meth:`FeatureCache.speculative_clone`, never the live session,
        so a discarded speculation leaves the live tiles byte-identical;
        the epoch guard applies to the clone as to a real splice.
        Returns ``(dets, clone)``; the scheduler commits the clone only
        when the speculation resolves.
        """
        clone = cache.speculative_clone()
        dets = self.infer_wave(pred_canvas[None], [plan], beta,
                               caches=[clone], frame_ids=[frame_idx])
        return dets[0], clone

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


# ---------------------------------------------------------------------------
# speculative-prediction helpers (host-side numpy; the scheduler drives
# them around ServerModel.infer_speculative)


def predict_canvas(part: Partition, region_px: int,
                   pred_frame: np.ndarray,
                   plan: RegionPlan) -> np.ndarray:
    """The speculative forward's input: the session's prediction source
    standing in for the in-flight LOW/FULL regions, REUSE regions filled
    0.5 gray as the codec fills them in a real decoded canvas."""
    canvas = np.asarray(pred_frame, np.float32).copy()
    nRw = part.regions_w
    for j in np.nonzero(np.asarray(plan.states) == REUSE)[0]:
        ry, rx = divmod(int(j), nRw)
        canvas[ry * region_px:(ry + 1) * region_px,
               rx * region_px:(rx + 1) * region_px] = 0.5
    return canvas


def region_divergence(part: Partition, region_px: int,
                      decoded: np.ndarray, predicted: np.ndarray,
                      plan: RegionPlan) -> np.ndarray:
    """(n_regions,) mean |decoded - predicted| per TRANSMITTED region
    (REUSE rows stay 0: nothing was predicted there)."""
    div = np.zeros((part.n_regions,), np.float32)
    states = np.asarray(plan.states).reshape(-1)
    nRw = part.regions_w
    for j in np.nonzero(states != REUSE)[0]:
        ry, rx = divmod(int(j), nRw)
        sl = (slice(ry * region_px, (ry + 1) * region_px),
              slice(rx * region_px, (rx + 1) * region_px))
        div[j] = float(np.abs(np.asarray(decoded, np.float32)[sl]
                              - predicted[sl]).mean())
    return div


def build_patch_plan(plan: RegionPlan,
                     diverged: np.ndarray) -> RegionPlan:
    """The patch pass's plan: transmitted regions that CONVERGED flip to
    REUSE (splicing the speculative forward's captured tiles) and only
    diverged regions stay LOW/FULL, so the patch runs at an equal or
    smaller length bucket of the warmed grid.  At least one region must
    have diverged (callers serve the all-converged case without a
    patch)."""
    states = np.asarray(plan.states).copy()
    diverged = np.asarray(diverged, bool).reshape(-1)
    assert diverged.any(), "all-converged speculations need no patch"
    states[(states != REUSE) & ~diverged] = REUSE
    return RegionPlan(states.astype(np.int8))


# ---------------------------------------------------------------------------
# the single-client simulation


class Policy:
    """Decides the offload configuration for each frame to be offloaded.

    Returns dict(mask (n_regions,), quality, beta, use_tracker: bool).
    Temporal-reuse policies additionally return a three-state ``plan``
    (partition.RegionPlan, bucket-exact in n_reuse) and may return
    ``capture_beta`` (the restoration point full-res offloads capture
    feature tiles at); they must set ``reuse_k`` (the staleness bound K)
    so the Simulation provisions a per-client FeatureCache.
    """
    name = "policy"
    use_tracker = True
    reuse_k = 0                 # K > 0 enables the per-client FeatureCache

    def decide(self, sim: "Simulation", frame_idx: int) -> Dict:
        raise NotImplementedError

    def observe_completion(self, e2e_latency: float) -> None:
        pass


@dataclass
class SimResult:
    policy: str
    video: str
    trace: str
    rendering_f1: List[float] = field(default_factory=list)
    inference_f1: List[float] = field(default_factory=list)
    e2e_latency: List[float] = field(default_factory=list)
    offload_interval: List[int] = field(default_factory=list)
    delay_parts: List[Dict] = field(default_factory=list)
    overhead: Dict[str, List[float]] = field(default_factory=dict)
    sizes: List[float] = field(default_factory=list)

    def summary(self) -> Dict:
        def med(x):
            return float(np.median(x)) if len(x) else float("nan")
        return {
            "policy": self.policy, "video": self.video, "trace": self.trace,
            "median_rendering_f1": med(self.rendering_f1),
            "mean_rendering_f1": (float(np.mean(self.rendering_f1))
                                  if self.rendering_f1 else float("nan")),
            "mean_inference_f1": (float(np.mean(self.inference_f1))
                                  if self.inference_f1 else float("nan")),
            "median_e2e_latency": med(self.e2e_latency),
            "median_interval": med(self.offload_interval),
            "median_net_delay": med([d["net"] for d in self.delay_parts]),
            "median_inf_delay": med([d["inf"] for d in self.delay_parts]),
            "median_codec_delay": med([d["enc"] + d["dec"]
                                       for d in self.delay_parts]),
            "median_queue_delay": med([d.get("queue", 0.0)
                                       for d in self.delay_parts]),
        }


class Simulation:
    """One (video, trace, policy) run."""

    def __init__(self, frames: np.ndarray, gt_dets: List[List[Dict]],
                 trace, policy: Policy, server: ServerModel,
                 part: Partition, patch_px: int, fps: int = 10,
                 delay_model: Optional[CodecDelayModel] = None,
                 inf_delay=None,
                 faults: Optional[FaultInjector] = None,
                 robust: Optional[RobustConfig] = None):
        self.frames = frames
        self.gt_dets = gt_dets            # full-res model outputs per frame
        self.trace = trace
        self.policy = policy
        self.server = server
        self.part = part
        self.fps = fps
        self.dt = 1.0 / fps
        self.codec = MixedResCodec(part, patch_px, part.downsample)
        self.delay_model = delay_model or CodecDelayModel()
        self.inf_delay = inf_delay        # InferenceDelayModel
        self.analyzer = mo.RegionMotionAnalyzer(part, patch_px)
        self.tracker = LKTracker()
        self.net_est = ThroughputEstimator()
        self.state = SystemState()
        # temporal-reuse session state: one FeatureCache per client
        # stream, provisioned only for reuse-capable policies (reuse_k =
        # the staleness bound K)
        self.feature_cache: Optional[FeatureCache] = (
            FeatureCache(part.n_regions, max_age=policy.reuse_k)
            if policy.reuse_k > 0 else None)

        # failure model: fault schedule + the deadline/retry/backoff
        # state machine (both optional — None keeps the legacy
        # fault-free, deadline-free lifecycle byte-identical)
        self.faults = faults
        self.robust = robust
        self.ladder = (DegradationLadder(robust) if robust is not None
                       else None)
        self.rstats = fresh_rstats()
        self.offload_seq = 0
        # the N=1 scheduling plane: immediate dedicated execution with
        # the shared stale-epoch NACK + crash-restart semantics
        # (serve/scheduler.py — the multi-client engine swaps in a
        # WaveScheduler over the same per-frame step methods)
        self.scheduler = SoloScheduler(self)

        # runtime state
        self.cache_dets: List[Dict] = []
        self.cache_frame = -1
        self.tracker_frame = -1           # frame the tracker state is at
        self.inflight: Optional[Dict] = None
        self.last_offload_frame = -10 ** 9
        self.m = np.zeros((part.n_regions,), np.float32)
        self.m_f = 0.0

    # ------------------------------------------------------------------
    # per-frame steps.  Single-client ``run`` below and the multi-client
    # engine (serve/edge.py) drive the SAME methods; the engine replaces
    # the synchronous server call in _start_offload with batched waves.

    def rho(self) -> np.ndarray:
        return mo.region_density(self.tracker.boxes(), self.part,
                                 self.analyzer.patch_px)

    def _motion_tick(self, frame_idx: int, res: SimResult) -> None:
        t0 = time.perf_counter()
        self.m, self.m_f = self.analyzer.update(self.frames[frame_idx])
        res.overhead.setdefault("motion_wall", []).append(
            time.perf_counter() - t0)

    def _should_offload(self, frame_idx: int) -> bool:
        """Back-to-back: a new offload starts as soon as none is in
        flight (frame 0 is skipped — the motion model needs a delta).
        After a failure, the ladder's exponential backoff additionally
        holds the retry until ``retry_at`` — while it holds (and at shed
        level), rendering rides the LK tracker."""
        if self.inflight is not None or frame_idx <= 0:
            return False
        if self.ladder is not None \
                and frame_idx * self.dt < self.ladder.retry_at:
            return False
        return True

    def _note_offload_gap(self, frame_idx: int, res: SimResult) -> None:
        if self.last_offload_frame >= 0:
            # the first offload has no predecessor: recording its warm-up
            # gap as an inter-offload interval would bias the median
            res.offload_interval.append(frame_idx - self.last_offload_frame)
        self.state.eta = frame_idx - max(self.last_offload_frame, 0)
        self.state.kappa = self.tracker.retention

    def _inf_delay_s(self, beta: int, n_d: int, n_r: int) -> float:
        """Inference-delay estimate; tolerates legacy 2-arg models."""
        if self.inf_delay is None:
            return 0.05
        try:
            return self.inf_delay(beta, n_d, n_r)
        except TypeError:
            return self.inf_delay(beta, n_d)

    def _prepare_offload(self, frame_idx: int, now: float,
                         res: SimResult) -> Dict:
        """Device side of an offload: policy decision, codec encode, and
        the device-computable Eq. (2) delay terms.  Marks the client busy
        (``inflight``) but does NOT run server inference — the caller
        finishes the job via :meth:`_finish_offload` (immediately for the
        single-client path, at wave time for the batched edge)."""
        decision = self.policy.decide(self, frame_idx)
        if self.ladder is not None:
            # retries after failures go out degraded: FULL regions
            # promoted to LOW (lowest motion first), quality dropped
            decision = self.ladder.degrade(decision, self.m)
        quality = decision["quality"]
        beta = decision["beta"]
        plan: Optional[RegionPlan] = decision.get("plan")
        if plan is None:
            plan = RegionPlan.from_mask(decision["mask"])
        mask = plan.low_mask()
        n_r = plan.n_reuse
        reuse_mask = plan.reuse_mask() if n_r > 0 else None

        frame = self.frames[frame_idx]
        if decision.get("blank") is not None:       # RoI masking baselines
            frame = frame.copy()
            rpx = self.part.region * self.analyzer.patch_px
            nRw = self.part.regions_w
            for j in np.nonzero(decision["blank"])[0]:
                ry, rx = divmod(int(j), nRw)
                frame[ry * rpx:(ry + 1) * rpx, rx * rpx:(rx + 1) * rpx] = 0.5
        t0 = time.perf_counter()
        enc, decoded = self.codec.encode(frame, mask, quality,
                                         reuse_mask=reuse_mask)
        res.overhead.setdefault("codec_wall", []).append(
            time.perf_counter() - t0)
        size = enc.payload_bytes * SIZE_SCALE
        n_d = int(mask.sum())
        beta_eff = beta if (n_d > 0 or n_r > 0) else 0

        tput, rtt = self.trace.at(now)
        if self.faults is not None:
            tput, rtt = self.faults.net(now, tput, rtt)
        job = {
            "frame": frame_idx, "submit": now, "decoded": decoded,
            "mask": mask, "n_d": n_d, "beta": beta_eff,
            "plan": plan, "n_r": n_r,
            "capture_beta": decision.get("capture_beta", 0),
            "tput": tput, "rtt": rtt, "size": size,
            "t_enc": self.delay_model.encode_delay(self.part, n_d, quality,
                                                   n_reuse=n_r),
            "t_up": size * 8.0 / tput,
            "t_dec": self.delay_model.decode_delay(self.part, n_d,
                                                   n_reuse=n_r),
            "t_inf": self._inf_delay_s(beta_eff, n_d, n_r),
            "done_at": float("inf"), "dets": None,
            "seq": self.offload_seq,
            # plan-header metadata (ships ahead of the payload; the
            # continuous scheduler's speculative-REUSE admission reads
            # it before the LOW/FULL windows land): the REUSE +
            # predicted-still-LOW fraction of the plan, and the motion
            # analyzer's confidence that the previous decoded frame
            # predicts the in-flight regions
            "spec_frac": (plan.n_reuse
                          + int(((plan.states == LOW)
                                 & (self.m * self.m_f < 1e-3)).sum()))
            / self.part.n_regions,
            "spec_conf": mo.prediction_confidence(self.m, plan.states,
                                                  m_f=self.m_f),
            # SLO-derived deadline: past it the client abandons the
            # offload and the LK tracker covers the gap
            "deadline": (now + self.robust.slo_s
                         if self.robust is not None else float("inf")),
        }
        self.offload_seq += 1
        if decision.get("degraded"):
            job["degraded"] = decision["degraded"]
            job["demoted"] = decision.get("demoted")
            self.rstats["degraded_offloads"] += 1
        self.inflight = job
        self.last_offload_frame = frame_idx
        return job

    def _finish_offload(self, job: Dict, dets: List[Dict],
                        queue_delay: float = 0.0,
                        t_dec: Optional[float] = None,
                        t_inf: Optional[float] = None) -> None:
        """Server side of an offload: attach detections and finalise the
        Eq. (2) end-to-end latency.  ``queue_delay`` (and wave-amortised
        ``t_dec``/``t_inf`` overrides) come from the edge scheduler.
        The fault schedule hooks in here: edge stalls stretch the
        service time, and a dropped response (or one arriving at a
        crashed replica) marks the job LOST — its result never comes
        back, only the client-side deadline reaps it."""
        t_dec = job["t_dec"] if t_dec is None else t_dec
        t_inf = job["t_inf"] if t_inf is None else t_inf
        arrival = job["submit"] + job["t_enc"] + job["t_up"]
        if self.faults is not None:
            t_inf = t_inf + self.faults.stall_extra(arrival + queue_delay)
        e2e = (job["t_enc"] + job["t_up"] + queue_delay + t_dec + t_inf
               + job["rtt"])
        job["dets"] = dets
        job["inf_f1"] = det.frame_f1(dets, self.gt_dets[job["frame"]])
        job["e2e"] = e2e
        job["done_at"] = job["submit"] + e2e
        job["parts"] = {"enc": job["t_enc"], "net": job["t_up"] + job["rtt"],
                        "dec": t_dec, "inf": t_inf, "queue": queue_delay}
        if self.faults is not None:
            if self.faults.response_dropped(job["seq"]) \
                    or self.faults.edge_down(arrival):
                job["lost"] = True
                job["done_at"] = float("inf")
            elif self.faults.response_duplicated(job["seq"]):
                job["dup"] = True

    def _start_offload(self, frame_idx: int, now: float, res: SimResult):
        """Single-client path: prepare, then hand to the scheduling
        plane (immediate dedicated inference for N=1)."""
        job = self._prepare_offload(frame_idx, now, res)
        self.scheduler.submit(job, now)

    def _complete_offload(self, res: SimResult, now_frame: int) -> Dict:
        fl = self.inflight
        self.inflight = None
        if fl.get("stale_epoch"):
            # the edge refused the splice (tiles from a dead replica):
            # drop the dead cache and bootstrap FULL next offload — no
            # backoff, the edge is healthy, just a new generation
            self.rstats["stale_epoch_nacks"] += 1
            if self.feature_cache is not None:
                self.feature_cache.invalidate()
            return fl
        if fl.get("rejected"):
            # edge admission shed: REJECTED response — track locally,
            # retry degraded after backoff
            self.rstats["rejected"] += 1
            if self.ladder is not None:
                self.ladder.on_failure(fl["done_at"])
                self.rstats["max_ladder_level"] = max(
                    self.rstats["max_ladder_level"], self.ladder.level)
            return fl
        if fl["frame"] <= self.cache_frame:
            # stale response: older than the rendered head — discarded,
            # never rendered
            self.rstats["stale_discards"] += 1
            return fl
        if fl.get("dup"):
            # the duplicate copy arrives later, behind the (advanced)
            # rendered head, and dies on the staleness guard above
            self.rstats["dup_discards"] += 1
        res.e2e_latency.append(fl["e2e"])
        res.inference_f1.append(fl["inf_f1"])
        res.delay_parts.append(fl["parts"])
        res.sizes.append(fl["size"])
        self.net_est.observe(fl["tput"], fl["rtt"], t=fl["done_at"])
        self.policy.observe_completion(fl["e2e"])
        if self.ladder is not None:
            self.ladder.on_success()

        if self.feature_cache is not None \
                and fl.get("demoted") is not None and len(fl["demoted"]):
            # ladder-demoted regions went out LOW: their freshly captured
            # tiles are low-fidelity stopgaps, so expire them from the
            # reuse-eligible set rather than letting one degraded offload
            # poison the next K splices
            self.feature_cache.expire(fl["demoted"])
        self.cache_dets = fl["dets"]
        self.cache_frame = fl["frame"]
        if self.policy.use_tracker:
            # reinit at the offloaded frame, catch up to the present
            self.tracker.reinit(self.frames[fl["frame"]], fl["dets"])
            for fi in range(fl["frame"] + 1, now_frame):
                self.tracker.step(self.frames[fi])
            self.tracker_frame = max(now_frame - 1, fl["frame"])
        return fl

    def _poll_inflight(self, now: float, now_frame: int,
                       res: SimResult) -> Optional[Dict]:
        """Deadline-bounded completion check: deliver a response due by
        ``now`` unless its deadline passed first — a LOST job (response
        never coming) or a LATE one (arriving past the deadline, behind
        the rendered head) is abandoned and the tracker covers the gap.
        Returns the job on delivery, else None."""
        job = self.inflight
        if job is None:
            return None
        deadline = job.get("deadline", float("inf"))
        if np.isfinite(job["done_at"]) \
                and job["done_at"] <= min(now, deadline):
            return self._complete_offload(res, now_frame)
        if now >= deadline:
            self._abandon_offload(job, min(now, job["deadline"]))
        return None

    def _abandon_offload(self, job: Dict, now: float) -> None:
        """Client-side timeout: give up on the offload, climb the
        degradation ladder, and back off before retrying."""
        self.inflight = None
        job["abandoned"] = True
        if job.get("lost"):
            self.rstats["lost_responses"] += 1
        else:
            self.rstats["timeouts"] += 1
            if np.isfinite(job["done_at"]):
                # the response does arrive eventually — after the
                # deadline — and is discarded, never rendered
                self.rstats["late_discards"] += 1
        if self.ladder is not None:
            self.ladder.on_failure(now)
            self.rstats["max_ladder_level"] = max(
                self.rstats["max_ladder_level"], self.ladder.level)

    def _edge_fault_tick(self, prev: float, now: float) -> None:
        """Single-client path owns its replica: crash-restarts apply
        through the shared scheduling plane (the multi-client engine
        drives the shared replica's restarts through the same
        ``edge_restart_tick`` helper)."""
        self.scheduler.fault_tick(prev, now)

    def _render_tick(self, frame_idx: int, res: SimResult) -> None:
        # rendering for this frame: exact cache hit, else tracker
        if frame_idx == self.cache_frame or not self.policy.use_tracker:
            rendered = self.cache_dets
        else:
            t0 = time.perf_counter()
            if self.tracker_frame < frame_idx:
                self.tracker.step(self.frames[frame_idx])
                self.tracker_frame = frame_idx
            rendered = self.tracker.boxes()
            self.rstats["tracker_frames"] += 1
            res.overhead.setdefault("tracker_wall", []).append(
                time.perf_counter() - t0)
        res.rendering_f1.append(det.frame_f1(rendered,
                                             self.gt_dets[frame_idx]))

    # ------------------------------------------------------------------
    def run(self, video_name: str = "video") -> SimResult:
        res = SimResult(policy=self.policy.name, video=video_name,
                        trace=getattr(self.trace, "name", "trace"))
        n = len(self.frames)
        prev = -1.0
        for fi in range(n):
            now = fi * self.dt

            self._edge_fault_tick(prev, now)
            self._motion_tick(fi, res)
            # completions due by now (deadline-bounded)
            self._poll_inflight(now, fi, res)
            # schedule next offload (back-to-back upon completion,
            # backed off after failures)
            if self._should_offload(fi):
                self._note_offload_gap(fi, res)
                self._start_offload(fi, now, res)
            self._render_tick(fi, res)
            prev = now
        # flush the final in-flight offload: its latency / delay parts /
        # inference F1 belong in the result even though the clip ended
        # (unless its deadline already reaped it)
        self._poll_inflight(float("inf"), n, res)
        return res
