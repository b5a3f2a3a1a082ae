"""Multi-client batched edge serving, ported from ``repro.serve.edge``.

One edge replica serves N concurrent device streams:

  * :class:`BatchedServerModel` stacks decoded mixed-resolution frames
    from MANY clients into ONE batched forward.  Each frame keeps its OWN
    three-state region layout (the per-sample PlanLayout rows of
    ``ServerModel.infer_wave``), so co-batching never downsamples or
    reuses the wrong regions; each client stream owns a
    :class:`~repro_torch.serve.request.FeatureCache` whose restoration-
    point tiles are spliced in (REUSE regions) and refreshed per sample,
    never across samples.  Waves pad UP to a batch bucket, so the grid
    keys stay the warmed set.
  * :class:`MultiClientSimulation` multiplexes N (video, trace, policy)
    device streams onto that replica.  Batch formation lives in the
    scheduling plane (:mod:`repro_torch.serve.scheduler`): offloads queue
    at the edge and a :class:`~repro_torch.serve.scheduler.WaveScheduler`
    (``EdgeConfig(scheduler="barrier")`` wave-at-a-time, or
    ``"continuous"`` with decode/h2d staging overlapped under compute,
    late admission into padded B-bucket slots and, with ``speculate``,
    the speculative REUSE lane) forms waves of compatible jobs (same
    (length bucket, beta, capture point); any (n_low, n_reuse) mix
    co-batches).  The queueing delay is folded into Eq. (2)'s end-to-end
    latency (``parts["queue"]``, split into admission and slot wait).

The simulation drives the per-frame client steps of
:class:`~repro_torch.offload.simulator.Simulation` and the fault clock;
the scheduler owns the queue, admission control, the cost model and the
wave execution.  The single-client ``Simulation`` is the N=1 case over
the same step methods with the ``SoloScheduler``.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.partition import (RegionPlan, stack_plan_ids,
                                        stack_region_ids)
from repro_torch.offload.faults import FaultInjector
from repro_torch.offload.simulator import ServerModel, Simulation, SimResult
from repro_torch.serve.request import FeatureCache
from repro_torch.serve.scheduler import (EdgeConfig, EdgeStats, WaveScheduler,
                                         make_scheduler)

__all__ = ["BatchedServerModel", "EdgeConfig", "EdgeStats",
           "MultiClientSimulation", "stack_plan_ids", "stack_region_ids"]


class BatchedServerModel(ServerModel):
    """Edge replica shared by many clients.

    Both entry points are thin adapters over the inherited
    :meth:`ServerModel.infer_wave`, so solo B=1 calls and batched waves
    share one grid (and one warmup) of (length bucket, beta, capture, B
    bucket) keys.  Like ``ServerModel`` it runs on ``device="cuda"``
    unless the caller asks for the CPU.
    """

    def infer_batch(self, frames: np.ndarray,
                    masks: Sequence[Optional[np.ndarray]],
                    beta: int = 0) -> List[List[Dict]]:
        """Batched inference over frames with ARBITRARY per-frame masks.

        frames: (B, H, W, 3); masks: per-frame (n_regions,) binary masks
        (or None for full-res).  Masks may land in DIFFERENT n_low
        buckets: the wave runs at the length bucket of its longest
        plan and shorter plans are padded.  An all-full-res batch keeps
        the full-resolution key.  Returns per-frame detection lists.
        """
        B = frames.shape[0]
        assert len(masks) == B
        plans = [RegionPlan.from_mask(m) if m is not None
                 and int(np.asarray(m).sum()) > 0
                 else RegionPlan(np.zeros((self.part.n_regions,), np.int8))
                 for m in masks]
        return self.infer_wave(frames, plans, beta)

    def infer_plans(self, frames: np.ndarray,
                    plans: Sequence[RegionPlan],
                    beta: int,
                    caches: Sequence[FeatureCache],
                    frame_ids: Sequence[int],
                    capture_beta: int = 0) -> List[List[Dict]]:
        """Batched three-state inference over same-bucket frames.

        Every plan must share ONE (n_low bucket, bucket-exact n_reuse)
        pair and every frame restores at the same ``beta`` — the wave
        compatibility contract the scheduler enforces.  Each sample's
        REUSE tiles come from (and the refreshed restoration-point tiles
        go back to) its OWN client's :class:`FeatureCache`, so co-batched
        sessions never see each other's features.  Returns per-frame
        detection lists.
        """
        assert len(plans) == len(caches) == len(frame_ids) == \
            frames.shape[0]
        return self.infer_wave(frames, plans, beta, caches=caches,
                               frame_ids=frame_ids,
                               capture_beta=capture_beta)


# ---------------------------------------------------------------------------
# event-driven multi-client engine


class MultiClientSimulation:
    """N device streams -> one shared edge replica.

    clients: per-stream :class:`Simulation` objects (build them with
    this same replica as their ``server`` so a standalone N=1 run uses
    identical weights).  ``on_complete(client_idx, job)`` fires as each
    offload's result reaches its client.

    Batch formation, admission control, coalescing, and the replica's
    fault application all live in ``self.scheduler`` (a
    :class:`~repro_torch.serve.scheduler.WaveScheduler` chosen by
    ``EdgeConfig.scheduler``); the legacy ``pending`` / ``free_at`` /
    ``max_wave`` / ``_enqueue`` / ``_drain`` / ``_run_wave`` surface is
    kept as thin delegates so callers (and tests that intercept
    ``_run_wave``) keep working.
    """

    def __init__(self, clients: Sequence[Simulation],
                 server: BatchedServerModel,
                 ec: Optional[EdgeConfig] = None,
                 on_complete: Optional[Callable[[int, Dict], None]] = None,
                 faults: Optional[FaultInjector] = None):
        assert clients, "need at least one client"
        self.clients = list(clients)
        self.server = server
        self.ec = ec or EdgeConfig()
        self.on_complete = on_complete
        # edge-plane fault schedule (crash-restarts, service stalls,
        # arrivals into an outage).  Network/response-plane faults
        # belong on the CLIENTS' injectors — keep the planes on separate
        # injectors or edge stalls would be double-counted.
        self.faults = faults
        self.dt = self.clients[0].dt
        assert all(c.dt == self.dt for c in self.clients), \
            "clients must share a frame rate"
        self.scheduler: WaveScheduler = make_scheduler(
            server, self.clients, self.ec, faults=faults, host=self)
        self.stats = self.scheduler.stats

    # ------------------------------------------------------------------
    # scheduling-plane delegates (the legacy surface)

    @property
    def pending(self) -> List[Tuple[int, Dict]]:
        return self.scheduler.pending

    @pending.setter
    def pending(self, value: List[Tuple[int, Dict]]) -> None:
        self.scheduler.pending = value

    @property
    def free_at(self) -> float:
        return self.scheduler.free_at

    @free_at.setter
    def free_at(self, value: float) -> None:
        self.scheduler.free_at = value

    @property
    def max_wave(self) -> int:
        return self.scheduler.max_wave

    def _enqueue(self, ci: int, job: Dict) -> None:
        self.scheduler.enqueue(ci, job)

    def _drain(self, now: float) -> None:
        self.scheduler.drain(now)

    def _run_wave(self, wave: List[Tuple[int, Dict]], t_start: float,
                  key: Tuple[int, int, int]) -> float:
        """Execution hook the scheduler dispatches through — tests
        monkeypatch this to intercept waves."""
        return self.scheduler.execute_wave(wave, t_start, key)

    def _edge_fault_tick(self, prev: float, now: float) -> None:
        self.scheduler.fault_tick(prev, now)

    # ------------------------------------------------------------------
    def run(self, video_names: Optional[Sequence[str]] = None
            ) -> List[SimResult]:
        """Run all streams to completion.  Returns per-client results."""
        names = (list(video_names) if video_names is not None
                 else [f"client{i}" for i in range(len(self.clients))])
        results = [SimResult(policy=c.policy.name, video=names[i],
                             trace=getattr(c.trace, "name", "trace"))
                   for i, c in enumerate(self.clients)]

        n_max = max(len(c.frames) for c in self.clients)
        prev = -1.0
        for fi in range(n_max):
            now = fi * self.dt
            self._edge_fault_tick(prev, now)
            self._drain(now)
            for ci, c in enumerate(self.clients):
                if fi >= len(c.frames):
                    continue
                c._motion_tick(fi, results[ci])
                job = c._poll_inflight(now, fi, results[ci])
                if job is not None and self.on_complete:
                    self.on_complete(ci, job)
                if c._should_offload(fi):
                    c._note_offload_gap(fi, results[ci])
                    job = c._prepare_offload(fi, now, results[ci])
                    # arrival at the edge: encode + uplink transfer
                    job["arrival"] = now + job["t_enc"] + job["t_up"]
                    job["_client"] = ci
                    self._enqueue(ci, job)
                c._render_tick(fi, results[ci])
            prev = now

        # end of all clips: run the edge dry and flush in-flight
        # offloads (each client's deadline still applies)
        self._drain(float("inf"))
        for ci, c in enumerate(self.clients):
            job = c._poll_inflight(float("inf"), len(c.frames),
                                   results[ci])
            if job is not None and self.on_complete:
                self.on_complete(ci, job)
        return results
