"""The scheduling plane, ported from ``repro.serve.scheduler``: every
batch the system forms is formed here.

  * :func:`form_wave` — the one head-key grouping pass (queue order in,
    wave + remainder out) every caller uses, the LM serving engine
    included.
  * :class:`WaveScheduler` — the edge-replica scheduling interface:
    admission control (degrade -> shed), cross-bucket coalescing
    (`_try_promote` + the ``backbone_flops_windows`` cost model),
    degradation-ladder retry slotting (jobs re-enter through the same
    ``enqueue``), the Eq. (2) queue bookkeeping, and the shared
    crash-restart application (:func:`edge_restart_tick`).
  * :class:`BarrierScheduler` — wave-at-a-time: the replica serves one
    wave to completion, then forms the next from whatever has arrived.
  * :class:`ContinuousScheduler` — continuous batching + async
    overlap: the NEXT wave's codec-decode/h2d staging runs while the
    current wave computes (``ServerModel.stage_frames`` + deferred
    detection decode on the real executor; the modelled timeline
    mirrors it), a job may be admitted into a forming wave's padded
    B-bucket slot as soon as a row frees, and with
    ``EdgeConfig.speculate`` the speculative REUSE lane starts a
    REUSE-heavy job's spliced forward before its payload lands.
  * :class:`SoloScheduler` — the N=1 plane of the single-client
    ``offload.simulator.Simulation``: dedicated immediate execution
    with the same stale-epoch NACK and crash-restart semantics.

Timeline, barrier vs continuous (D = codec decode, C = compute)::

    barrier     wave1 [DDD CCCCCC]
                wave2             [DDD CCCCCC]
                job j  --arrive--^ waits out ALL of wave2 + its decode

    continuous  wave1 [DDD CCCCCC]
                wave2      [DDD]  [CCCCCC]        (decode hidden)
                job j  --arrive--[DD]^ admitted into wave2's pad row

Queueing delay is a first-class Eq. (2) term: ``parts["queue"]`` splits
into ``queue_admit`` (arrival -> bound to a wave) + ``queue_slot``
(bound -> compute start), and :attr:`EdgeStats.device_idle_frac`
integrates the replica's modelled compute busy time over the serving
horizon.  The timeline is modelled: no wall clock enters a decision.
"""
from __future__ import annotations

import bisect
import warnings
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import vit_backbone as vb
from repro_torch.core.partition import FULL, LOW, REUSE, RegionPlan
from repro_torch.offload.faults import FaultInjector
from repro_torch.serve.request import StaleCacheEpoch

__all__ = ["EdgeConfig", "EdgeStats", "WaveScheduler", "BarrierScheduler",
           "ContinuousScheduler", "SoloScheduler", "SCHEDULERS",
           "make_scheduler", "form_wave", "edge_restart_tick"]


# ---------------------------------------------------------------------------
# the one wave-formation pass


def form_wave(items: Sequence, key_fn: Callable, cap: int,
              admit: Optional[Callable] = None,
              promote: Optional[Callable] = None):
    """Form one wave from an ordered queue.

    The head item seeds the wave; each later item joins iff the wave
    has room (``cap``), the ``admit`` predicate (arrival/staging cuts)
    passes, and its key matches the head's — or the ``promote`` hook
    (cross-bucket coalescing) accepts it.  Returns ``(wave, rest,
    head_key)``; ``rest`` preserves queue order, so callers never
    re-sort.
    """
    head = items[0]
    hk = key_fn(head)
    wave, rest = [head], []
    for it in items[1:]:
        ok = len(wave) < cap and (admit is None or admit(it))
        if ok:
            k = key_fn(it)
            ok = k == hk or (promote is not None
                             and promote(it, k, hk, wave))
        if ok:
            wave.append(it)
        else:
            rest.append(it)
    return wave, rest, hk


def edge_restart_tick(server, faults: Optional[FaultInjector],
                      prev: float, now: float, *,
                      preserve_executables: bool = False
                      ) -> List[Tuple[float, float]]:
    """Apply every replica crash-restart scheduled in ``(prev, now]``.

    The one copy of the restart application both planes share (it used
    to live twice, in ``Simulation._edge_fault_tick`` and the
    multi-client engine): each event bumps the server's cache epoch —
    wiping executables unless ``preserve_executables`` keeps the bench
    shortcut — and is returned as ``(restart_time, outage_s)`` for the
    caller's plane-specific loss bookkeeping (solo: the in-flight job;
    edge: the pending queue).
    """
    if faults is None:
        return []
    events = list(faults.restarts_between(prev, now))
    for _ in events:
        server.restart(preserve_executables=preserve_executables)
    return events


# ---------------------------------------------------------------------------
# config + telemetry


@dataclass
class EdgeConfig:
    max_batch: int = 8
    # serving mode: batched waves vs. one-job-at-a-time (the sequential
    # baseline bench_multiclient.py compares against)
    batched: bool = True
    # wave-formation policy: "barrier" serves one wave to completion
    # before forming the next; "continuous" overlaps the next wave's
    # decode/h2d staging with the current compute and admits late jobs
    # into padded B-bucket slots (see SCHEDULERS)
    scheduler: str = "barrier"
    # continuous only: actually pipeline the executor — stage wave N+1
    # h2d (ServerModel.stage_frames: pinned host buffer, non-blocking copy
    # on a side stream) and defer wave N's blocking detection decode so
    # host decode hides under device compute.  Off = same modelled
    # timeline, strictly synchronous executor.
    stage_ahead: bool = True
    # marginal service time of each extra frame in a wave, as a fraction
    # of the solo inference delay: service = t_inf * (1 + alpha * (B-1)).
    # alpha < 1 is the batching win; alpha = 1 degenerates to sequential.
    # (wave compatibility buckets come from the server's n_buckets —
    # they MUST match infer_wave's bucketing, so there is no knob here)
    batch_alpha: float = 0.35
    # cross-bucket wave coalescing: promote a pending job from a larger
    # n_low bucket into the forming wave's smaller bucket when the
    # queueing delay saved exceeds the extra compute (cost model below)
    coalesce: bool = False
    # keep full per-job detection lists in EdgeStats.jobs (benchmarks
    # opt in; long simulations must not grow without bound)
    keep_dets: bool = False
    # edge-side admission control: when the queue is hot, first DEGRADE
    # incoming jobs (promote FULL regions to LOW so the job drops a
    # length bucket — the coalescing cost model's flops scaling prices
    # the new service time), then SHED with an explicit REJECTED
    # response the client handles by tracking locally
    admission: bool = False
    degrade_depth: int = 4           # pending jobs before degrading
    shed_depth: int = 10             # pending jobs before shedding
    degrade_backlog_s: float = 1.0   # or replica backlog seconds
    shed_backlog_s: float = 2.5
    degrade_beta: int = 2            # restoration point degraded
    #                                  full-res jobs restore at
    # crash-restart shortcut for benches: model the outage in sim time
    # but keep host-process executables warm (tests pin the real wipe)
    preserve_executables: bool = False
    # speculative REUSE execution (continuous scheduler only): when a
    # job's plan header — which ships ahead of the payload — shows a
    # REUSE + predicted-still-LOW fraction of at least spec_min_frac
    # AND a motion-prediction confidence of at least spec_min_conf,
    # launch the spliced forward immediately with the in-flight LOW/FULL
    # regions substituted from the session's prediction source
    # (FeatureCache.pred_frame, gated by staleness bound K + epoch).
    # On payload arrival a patch pass recomputes only regions whose
    # decoded content diverges from the prediction by more than
    # spec_patch_tol (mean |Δ| in [0,1] pixel units); when more than
    # spec_max_patch_frac of the transmitted regions diverged, the
    # speculation is discarded and the original plan reruns on the real
    # frame.  Every path reuses the warmed (lb, beta, capture, B)
    # executable grid — speculation adds zero keys.
    speculate: bool = False
    spec_min_frac: float = 0.5
    spec_min_conf: float = 0.6
    spec_patch_tol: float = 0.02
    spec_max_patch_frac: float = 0.5


@dataclass
class EdgeStats:
    """Edge-side telemetry: wave sizes, queueing, and per-job outcomes."""
    wave_sizes: List[int] = field(default_factory=list)
    queue_delays: List[float] = field(default_factory=list)
    # per-job queue-delay breakdown: admission wait (arrival -> bound to
    # a forming wave) + slot wait (bound -> compute start).  Barrier
    # binds a job only when its wave forms, so its wait is all
    # admission; continuous binds as soon as a row frees.
    queue_admit: List[float] = field(default_factory=list)
    queue_slot: List[float] = field(default_factory=list)
    jobs: List[Dict] = field(default_factory=list)
    promoted: int = 0            # jobs coalesced across length buckets
    # distinct n_low values per wave: > 1 means plans with different
    # region counts shared ONE executable (the collapsed-grid win)
    wave_n_low_mix: List[int] = field(default_factory=list)
    # robustness telemetry
    degraded: int = 0            # jobs admission control degraded
    shed: int = 0                # jobs REJECTED at admission
    restarts: int = 0            # crash-restarts of the replica
    stale_nacks: int = 0         # REUSE jobs refused on epoch mismatch
    lost_jobs: int = 0           # jobs that died with the replica
    # replica compute occupancy over the serving horizon: per-wave
    # (compute_start, compute_end) accumulated below.  Barrier idles
    # the device through every wave's codec decode; continuous hides
    # decode under the previous compute (decode_hidden_s counts the
    # seconds hidden), so its idle fraction is strictly lower under
    # load.
    compute_busy_s: float = 0.0
    compute_first: float = float("inf")
    compute_last: float = 0.0
    decode_hidden_s: float = 0.0
    # speculative-REUSE lane telemetry (mirrors the queue_admit /
    # queue_slot split): launches, how each resolved, and the uplink
    # seconds each launch hid under speculative compute — per-job in
    # ``spec_hidden`` for p50/p95, summed in ``spec_hidden_s``
    spec_launched: int = 0
    spec_patched: int = 0
    spec_discarded: int = 0
    spec_hidden_s: float = 0.0
    spec_hidden: List[float] = field(default_factory=list)

    @property
    def mean_wave_size(self) -> float:
        return float(np.mean(self.wave_sizes)) if self.wave_sizes else 0.0

    @property
    def mixed_plan_waves(self) -> int:
        """Waves that batched >= 2 distinct n_low values."""
        return sum(1 for m in self.wave_n_low_mix if m > 1)

    def note_compute(self, start: float, end: float) -> None:
        self.compute_busy_s += max(end - start, 0.0)
        self.compute_first = min(self.compute_first, start)
        self.compute_last = max(self.compute_last, end)

    @property
    def device_idle_frac(self) -> float:
        """1 - (compute busy) / (first compute start -> last compute
        end).  0.0 when fewer than two waves ran."""
        horizon = self.compute_last - self.compute_first
        if not np.isfinite(self.compute_first) or horizon <= 0.0:
            return 0.0
        return float(max(1.0 - self.compute_busy_s / horizon, 0.0))

    def queue_percentile(self, q: float) -> float:
        return (float(np.percentile(self.queue_delays, q))
                if self.queue_delays else 0.0)

    def spec_hidden_percentile(self, q: float) -> float:
        return (float(np.percentile(self.spec_hidden, q))
                if self.spec_hidden else 0.0)


# ---------------------------------------------------------------------------
# the edge-replica scheduling interface


class WaveScheduler:
    """Owns batch formation for one shared edge replica.

    ``host`` is the driving simulation (``MultiClientSimulation``);
    waves are dispatched through ``host._run_wave(wave, t_start, key)``
    so tests can intercept execution, and that method delegates right
    back to :meth:`execute_wave`.  Jobs are ``(client_idx, job_dict)``
    pairs; ``pending`` is kept sorted by edge-arrival time on insert
    and only ever consumed in order, so nothing re-sorts.
    """

    def __init__(self, server, clients: Sequence, ec: EdgeConfig,
                 faults: Optional[FaultInjector] = None, host=None):
        self.server = server
        self.clients = list(clients)
        self.ec = ec
        self.faults = faults
        self.host = host
        self.pending: List[Tuple[int, Dict]] = []   # (client_idx, job)
        self.free_at = 0.0                          # replica busy horizon
        # a wave can never exceed the largest batch bucket — padding
        # only rounds UP, so an oversized wave would have no executable
        self.max_wave = min(ec.max_batch, max(server.b_buckets))
        if self.max_wave < ec.max_batch:
            warnings.warn(
                f"EdgeConfig.max_batch={ec.max_batch} exceeds the "
                f"server's largest batch bucket "
                f"{max(server.b_buckets)}; waves are capped at "
                f"{self.max_wave} — raise b_buckets to serve bigger "
                f"waves", stacklevel=3)
        self.stats = EdgeStats()

    # ------------------------------------------------------------------
    # admission

    def enqueue(self, ci: int, job: Dict) -> None:
        """Insert a job keeping ``pending`` sorted by edge arrival time.

        Admission control happens here, at arrival: under queue pressure
        the job is first degraded (FULL -> LOW), and past the shed
        threshold it is REJECTED outright — an explicit response the
        client's completion path turns into tracker-only rendering plus
        a backed-off degraded retry (the ladder's retry re-enters
        through this same method, so retry slotting is scheduler-owned).
        """
        if self.faults is not None and self.faults.edge_down(
                job["arrival"]):
            # arrived at a crashed replica: never answered
            job["lost"] = True
            job["done_at"] = float("inf")
            self.stats.lost_jobs += 1
            return
        if self.ec.admission:
            depth = len(self.pending)
            backlog = max(self.free_at - job["arrival"], 0.0)
            if depth >= self.ec.shed_depth \
                    or backlog >= self.ec.shed_backlog_s:
                job["rejected"] = True
                job["done_at"] = job["arrival"] + job["rtt"]
                job["dets"] = []
                self.stats.shed += 1
                return
            if (depth >= self.ec.degrade_depth
                    or backlog >= self.ec.degrade_backlog_s) \
                    and self._degrade_job(ci, job):
                self.stats.degraded += 1
        bisect.insort(self.pending, (ci, job),
                      key=lambda cj: cj[1]["arrival"])

    def _degrade_job(self, ci: int, job: Dict) -> bool:
        """Promote FULL regions of an arriving job to LOW so it drops at
        least one length bucket — the payload is already uploaded, so
        this buys edge COMPUTE (shorter sequence), priced by the same
        ``backbone_flops_windows`` scaling the coalescer uses.  REUSE
        regions are untouched.  Returns True if the job changed."""
        part = self.server.part
        plan: RegionPlan = job["plan"]
        states = np.asarray(plan.states).copy()
        full_ids = np.nonzero(states == FULL)[0]
        if len(full_ids) == 0:
            return False
        dd = part.windows_per_full_region
        nw = part.n_windows(plan.n_low, plan.n_reuse)
        # current effective length: the dedicated full-res executable
        # runs the full sequence; mixed plans run at their bucket
        lb_cur = (nw if plan.n_low == 0 and plan.n_reuse == 0
                  else self.server.length_bucket(nw))
        nw_min = nw - len(full_ids) * (dd - 1)
        targets = [e for e in self.server.length_edges
                   if nw_min <= e < lb_cur]
        if not targets:
            return False
        target = max(targets)            # one bucket down: degrade least
        k = int(np.ceil((nw - target) / (dd - 1)))
        states[full_ids[:k]] = LOW
        new_plan = RegionPlan(states.astype(np.int8))
        beta = int(job["beta"]) if int(job["beta"]) >= 1 \
            else self.ec.degrade_beta
        f_own = vb.backbone_flops_windows(
            self.server.cfg, lb_cur,
            int(job["beta"]) if plan.n_low or plan.n_reuse else 0)
        f_new = vb.backbone_flops_windows(self.server.cfg, target, beta)
        job["t_inf_exec"] = job["t_inf"] * (f_new / f_own)
        job["plan"] = new_plan
        job["mask"] = new_plan.low_mask()
        job["n_d"] = int(new_plan.n_low)
        job["beta"] = beta
        job["t_dec"] = self.clients[ci].delay_model.decode_delay(
            part, new_plan.n_low, n_reuse=new_plan.n_reuse)
        job["edge_degraded"] = True
        return True

    def _job_key(self, job: Dict) -> Tuple[int, int, int]:
        """Wave compatibility: (length bucket, beta, capture point) —
        the collapsed executable key.  (n_low, n_reuse) are runtime
        data, so any plan mix at one length bucket co-batches; mixed
        executables always capture (capture == beta), so sessionful and
        stateless jobs co-batch too.  Full-res jobs (length bucket 0)
        keep the dedicated full-res executable at the deployment's
        canonical capture point."""
        plan: RegionPlan = job["plan"]
        lb = self.server.plan_length_bucket(plan)
        if lb == 0:
            want = (job.get("capture_beta", 0)
                    if self.clients[job["_client"]].feature_cache
                    is not None else 0)
            return (0, 0, self.server._full_cap(want))
        beta = job["beta"]
        return (lb, beta, beta)

    # ------------------------------------------------------------------
    # cross-bucket coalescing cost model

    def _wave_service_s(self, wave: List[Tuple[int, Dict]]) -> float:
        """Modelled service time of a wave (decode + amortised infer)."""
        B = len(wave)
        t_dec = max(j["t_dec"] for _, j in wave)
        t_inf = max(j.get("t_inf_exec", j["t_inf"]) for _, j in wave)
        if B > 1:
            t_inf = t_inf * (1.0 + self.ec.batch_alpha * (B - 1))
        return t_dec + t_inf

    def _wave_infer_s(self, wave: List[Tuple[int, Dict]],
                      stall_at: Optional[float] = None) -> float:
        """Amortised wave inference time (+ edge stall if scheduled)."""
        B = len(wave)
        t_inf = max(j.get("t_inf_exec", j["t_inf"]) for _, j in wave)
        if B > 1:
            t_inf = t_inf * (1.0 + self.ec.batch_alpha * (B - 1))
        if self.faults is not None and stall_at is not None:
            # edge service stall (GC pause / preemption) for work
            # starting inside the stall window
            t_inf = t_inf + self.faults.stall_extra(stall_at)
        return t_inf

    def _try_promote(self, job: Dict, jk: Tuple[int, int, int],
                     hk: Tuple[int, int, int],
                     wave: List[Tuple[int, Dict]]) -> bool:
        """Coalesce ``job`` (key ``jk``) into a wave of key ``hk``.

        Only padding UP is ever legal: the job's plan is untouched, its
        sequence is merely padded to the wave's LARGER length bucket —
        zero resolution changes, zero accuracy question (pad windows are
        masked/inert).  The restoration point shapes the executable, so
        beta must match outright; full-res jobs (length bucket 0) keep
        their dedicated executable and are never promoted.  Promotes iff
        the queueing delay the job avoids (waiting out this wave's
        service) exceeds the extra compute it buys: the padded-length
        flops-scaled inference-time increase plus its ``batch_alpha``
        marginal share of the wave.
        """
        lb_w, beta_w, cap_w = hk
        lb_j, beta_j, cap_j = jk
        if not (beta_j == beta_w and cap_j == cap_w
                and 0 < lb_j < lb_w):
            return False
        cfg = self.server.cfg
        f_own = vb.backbone_flops_windows(cfg, lb_j, beta_j)
        f_new = vb.backbone_flops_windows(cfg, lb_w, beta_w)
        t_inf_new = job["t_inf"] * (f_new / f_own)
        extra = (t_inf_new - job["t_inf"]) \
            + self.ec.batch_alpha * t_inf_new
        saved = self._wave_service_s(wave)
        if saved <= extra:
            return False
        job["t_inf_exec"] = t_inf_new
        job["promoted_lb"] = lb_w
        self.stats.promoted += 1
        return True

    # ------------------------------------------------------------------
    # execution

    def _dispatch_wave(self, wave, t_start: float, key) -> float:
        """Route execution through the host so tests can intercept."""
        if self.host is not None:
            return self.host._run_wave(wave, t_start, key)
        return self.execute_wave(wave, t_start, key)

    def _filter_stale(self, wave, nack_at: float):
        """Epoch guard: REUSE against tiles captured under a dead
        replica gets an instant control-plane NACK, never a splice —
        the client invalidates and bootstraps FULL at the new epoch
        (completion path handles it)."""
        live = []
        for ci, job in wave:
            cache = self.clients[ci].feature_cache
            if job["plan"].n_reuse > 0 and cache is not None \
                    and getattr(cache, "epoch", 0) != self.server.epoch:
                job["stale_epoch"] = True
                job["done_at"] = nack_at + job["rtt"]
                job["dets"] = []
                self.server.stats.stale_epoch_rejects += 1
                self.stats.stale_nacks += 1
                continue
            live.append((ci, job))
        return live

    def _wave_inputs(self, wave, key):
        """Stacked frames / plans / caches of a wave, with full-res
        per-job capture intent resolved (a sessionful job that did NOT
        ask for capture shares the canonical capturing executable but
        must not have its cache refreshed — its cache is dropped)."""
        lb, beta, cap = key
        imgs = np.stack([j["decoded"] for _, j in wave])
        plans = [j["plan"] for _, j in wave]
        caches = [self.clients[ci].feature_cache for ci, _ in wave]
        want_cap = 0
        if lb == 0:
            wants = [j.get("capture_beta", 0) if c is not None else 0
                     for c, (_, j) in zip(caches, wave)]
            want_cap = max(wants)
            caches = [c if w > 0 else None
                      for c, w in zip(caches, wants)]
        return imgs, plans, caches, want_cap

    def _infer(self, frames, wave, plans, caches, want_cap, key,
               defer: bool = False):
        lb, beta, cap = key
        if cap or any(c is not None for c in caches):
            return self.server.infer_wave(
                frames, plans, beta, caches=caches,
                frame_ids=[j["frame"] for _, j in wave],
                capture_beta=want_cap if lb == 0 else 0,
                lb_override=lb if lb > 0 else None, defer=defer)
        return self.server.infer_wave(
            frames, plans, beta,
            lb_override=lb if lb > 0 else None, defer=defer)

    def _record_job(self, ci: int, job: Dict, d, B: int, q: float,
                    admit: float, slot: float) -> None:
        self.stats.queue_delays.append(q)
        self.stats.queue_admit.append(admit)
        self.stats.queue_slot.append(slot)
        if job.get("parts") is not None:
            job["parts"]["queue_admit"] = admit
            job["parts"]["queue_slot"] = slot
        rec = {"client": ci, "frame": job["frame"], "wave_size": B,
               "queue": q, "queue_admit": admit, "queue_slot": slot,
               "e2e": job["e2e"],
               "promoted": "promoted_lb" in job}
        if self.ec.keep_dets:
            rec["dets"] = d
        self.stats.jobs.append(rec)

    def execute_wave(self, wave, t_start: float, key) -> float:
        raise NotImplementedError

    def drain(self, now: float) -> None:
        raise NotImplementedError

    def _reap_abandoned(self) -> None:
        if any(j.get("abandoned") for _, j in self.pending):
            # the client gave up on these (deadline) — don't serve them
            self.pending = [cj for cj in self.pending
                            if not cj[1].get("abandoned")]

    # ------------------------------------------------------------------
    # faults

    def fault_tick(self, prev: float, now: float) -> None:
        """Apply the shared replica's crash-restarts: bump the cache
        epoch (wiping executables unless the bench shortcut keeps them),
        hold the replica down for the outage, and lose the queue — jobs
        pending in a crashed process are never answered; their clients'
        deadlines reap them."""
        for (r, outage) in edge_restart_tick(
                self.server, self.faults, prev, now,
                preserve_executables=self.ec.preserve_executables):
            self.stats.restarts += 1
            self.free_at = max(self.free_at, r + outage)
            for ci, job in self.pending:
                job["lost"] = True
                job["done_at"] = float("inf")
            self.stats.lost_jobs += len(self.pending)
            self.pending = []


class BarrierScheduler(WaveScheduler):
    """Wave-at-a-time serving.

    The replica serves one wave to completion — codec decode, then the
    batched forward — before the next wave forms from whatever
    compatible jobs have arrived.  A job arriving just after a wave
    starts waits out the ENTIRE service, and the next wave's decode
    only starts once the replica frees: both costs the continuous
    policy removes.
    """

    def execute_wave(self, wave: List[Tuple[int, Dict]], t_start: float,
                     key: Tuple[int, int, int]) -> float:
        """Batched inference + Eq. (2) bookkeeping for one wave.
        Returns the time the replica frees up."""
        wave = self._filter_stale(wave, t_start)
        if not wave:
            return self.free_at
        imgs, plans, caches, want_cap = self._wave_inputs(wave, key)
        dets = self._infer(imgs, wave, plans, caches, want_cap, key)

        B = len(wave)
        t_dec = max(j["t_dec"] for _, j in wave)
        t_inf = self._wave_infer_s(wave, stall_at=t_start)
        done = t_start + t_dec + t_inf

        self.stats.wave_sizes.append(B)
        self.stats.wave_n_low_mix.append(
            len({p.n_low for p in plans}))
        # the replica decodes then computes, serially: the device sits
        # idle through t_dec
        self.stats.note_compute(t_start + t_dec, done)
        for (ci, job), d in zip(wave, dets):
            q = t_start - job["arrival"]
            self.clients[ci]._finish_offload(job, d, queue_delay=q,
                                             t_dec=t_dec, t_inf=t_inf)
            # barrier binds a job to a wave only at formation time, so
            # its whole wait is admission wait
            self._record_job(ci, job, d, B, q, q, 0.0)
        return done

    def drain(self, now: float) -> None:
        """Schedule every wave that can START before ``now``.

        The replica serves one wave at a time.  When it frees up, the
        earliest-arrived pending job seeds a wave; compatible jobs
        (same (n_low bucket, n_reuse bucket, beta, capture)) that have
        ALREADY arrived join it, up to ``max_batch`` — plus, with
        coalescing on, arrived jobs from LARGER n_low buckets whose
        promotion the cost model approves.  ``pending`` is kept sorted
        on insert (:meth:`enqueue`); the loop only ever removes jobs,
        and the kept remainder is a subsequence, so order is preserved
        without re-sorting.
        """
        self._reap_abandoned()
        while self.pending:
            head = self.pending[0]
            t_start = max(self.free_at, head[1]["arrival"])
            if t_start >= now:
                return
            cap = self.max_wave if self.ec.batched else 1
            wave, rest, hk = form_wave(
                self.pending, lambda cj: self._job_key(cj[1]), cap,
                admit=lambda cj: cj[1]["arrival"] <= t_start,
                promote=((lambda cj, jk, hk, w:
                          self._try_promote(cj[1], jk, hk, w))
                         if self.ec.coalesce else None))
            self.pending = rest
            self.free_at = self._dispatch_wave(wave, t_start, hk)


class ContinuousScheduler(WaveScheduler):
    """Continuous batching + async overlap.

    Two changes over the barrier, both pure scheduling (the executable
    grid is untouched — waves still pad to the warmed B buckets, so a
    steady-state run compiles NOTHING new):

      * **Overlap**: a wave's codec decode / h2d staging runs while the
        PREVIOUS wave computes, so compute starts at
        ``max(replica_free, arrival + t_dec)`` instead of
        ``max(replica_free, arrival) + t_dec``.  Under load the decode
        vanishes from the critical path (EdgeStats.decode_hidden_s).
        With ``EdgeConfig.stage_ahead`` the real executor pipelines the
        same way: frames are staged with ``ServerModel.stage_frames``
        (pinned host memory, a non-blocking copy on a side stream), the
        forward is enqueued on the card, and the blocking detection
        decode of wave N is deferred until wave N+1 has been enqueued.
      * **Slot admission**: a compatible job arriving while the wave
        waits to start is bound as soon as a row frees — fully-staged
        jobs join outright (never delaying the wave), and a job whose
        decode would finish LATE may still claim a padded B-bucket slot
        (pad rows cost nothing: they are dropped from decode and barred
        from caches) when the cost model prices the wave's wait below
        the ``t_inf`` the job would otherwise queue.

    Per-job Eq. (2) terms use the job's OWN ``t_dec`` (it overlapped,
    off the critical path): ``queue = c_start - arrival - t_dec``,
    split into admission wait (arrival -> row free) and slot wait (row
    free -> compute start).
    """

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        # one-deep executor pipeline: (wave, pending_dets, timing)
        self._exec_q: List[Tuple] = []
        # in-flight speculations: launched spliced forwards awaiting
        # their payload (patch / discard / NACK at resolution)
        self._spec: List[Dict] = []

    # -- admission ------------------------------------------------------

    def _admit_unstaged(self, job: Dict, wave, c_start: float,
                        stage_done: float) -> bool:
        """May ``job`` (arrived, but its decode outlasts ``c_start``)
        claim a padded slot?  Only into a pad row — growing the padded
        bucket would re-shape the executable mid-formation — and only
        when the wave's wait (everyone pays the stage delay) plus the
        job's ``batch_alpha`` marginal share undercuts the wave's
        compute time the job would otherwise wait out."""
        B = len(wave)
        if self.server.batch_bucket(B + 1) != self.server.batch_bucket(B):
            return False
        t_inf_j = job.get("t_inf_exec", job["t_inf"])
        extra = B * (stage_done - c_start) + self.ec.batch_alpha * t_inf_j
        saved = self._wave_infer_s(wave)
        return saved > extra

    # -- schedule -------------------------------------------------------

    def drain(self, now: float) -> None:
        """Schedule every wave whose COMPUTE can start before ``now``.

        The head job's compute start is ``max(replica_free, arrival +
        t_dec)`` — its decode staged during the previous wave's
        compute.  Fully-staged compatible jobs fill rows for free;
        late-staging jobs may claim a pad row under the cost model
        (which pushes ``c_start`` to their staging point).
        """
        self._reap_abandoned()
        try:
            # resolve speculations whose payload has landed FIRST: a
            # resolved patch frees (or occupies) the replica before the
            # regular waves below price their compute start
            self._resolve_spec(now)
            while self.pending:
                head = self.pending[0]
                hj = head[1]
                bound_at = self.free_at   # rows free when compute ends
                c_start = max(self.free_at, hj["arrival"] + hj["t_dec"])
                if c_start >= now:
                    return
                hk = self._job_key(hj)
                wave, rest = [head], []
                for cj in self.pending[1:]:
                    job = cj[1]
                    ok = self.ec.batched and len(wave) < self.max_wave \
                        and job["arrival"] <= c_start
                    if ok:
                        jk = self._job_key(job)
                        ok = jk == hk or (
                            self.ec.coalesce
                            and self._try_promote(job, jk, hk, wave))
                    if ok:
                        stage_done = job["arrival"] + job["t_dec"]
                        if stage_done > c_start:
                            ok = self._admit_unstaged(job, wave, c_start,
                                                      stage_done)
                            if ok:
                                c_start = stage_done
                    if ok:
                        wave.append(cj)
                    else:
                        rest.append(cj)
                self.pending = rest
                for _, j in wave:
                    j["_bound_at"] = max(bound_at, j["arrival"])
                self.free_at = self._dispatch_wave(wave, c_start, hk)
        finally:
            # speculation launches go LAST: every wave startable before
            # ``now`` has been priced into free_at, so speculative
            # compute only ever claims replica time that would otherwise
            # idle under the uplink
            if self.ec.speculate:
                self._launch_spec(now)
                # a payload may already be due (notably the end-of-run
                # drain at now=inf): settle what just launched rather
                # than strand it in the speculative lane
                self._resolve_spec(now)
            self._flush_exec()

    # -- speculative REUSE execution ------------------------------------
    #
    # State machine per offload (README "Speculative REUSE lane"):
    #
    #   header lands --admit--> LAUNCH (spliced forward on the predicted
    #   canvas, capture into a session clone)
    #     payload lands, diverged frac <= spec_max_patch_frac
    #         --> PATCH (recompute only diverged windows at an equal-or-
    #             smaller length bucket; commit the clone)
    #     payload lands, diverged frac >  spec_max_patch_frac
    #         --> DISCARD (rerun the original plan on the real frame;
    #             drop the clone)
    #     client deadline reaps the job mid-payload (e.g. blackout)
    #         --> ABANDON (counted discarded; the degradation ladder
    #             already engaged client-side; prediction never renders)
    #     replica restarts between launch and patch
    #         --> stale-epoch NACK (the clone's tiles died with the old
    #             generation; the client invalidates and bootstraps FULL)

    def _try_speculate(self, ci: int, job: Dict,
                       now: float) -> Optional[Dict]:
        """Admission + launch of one speculative spliced forward.

        The plan header (frac/conf metadata) is on the wire as soon as
        the encode finishes; the payload lands at ``arrival``.  Launch
        requires thresholds cleared, a live warm session whose
        prediction source passes the staleness bound K and the epoch
        invariant, and replica idle time to hide the uplink in:
        ``s_start = max(free_at, header_at)`` must fall before both
        ``now`` and the payload's arrival."""
        from repro_torch.offload import simulator as sim
        plan: RegionPlan = job["plan"]
        cache = self.clients[ci].feature_cache
        if (cache is None or job["beta"] < 1
                or self.server.plan_length_bucket(plan) == 0
                or job.get("spec_frac", 0.0) < self.ec.spec_min_frac
                or job.get("spec_conf", 0.0) < self.ec.spec_min_conf):
            return None
        if not cache.pred_ok(self.server.epoch):
            return None
        if plan.n_reuse > 0 and not (cache.warm
                                     and cache.epoch == self.server.epoch):
            return None
        header_at = job["submit"] + job["t_enc"]
        s_start = max(self.free_at, header_at)
        if s_start >= now or job["arrival"] <= s_start:
            return None
        part = self.server.part
        region_px = part.region * self.clients[ci].analyzer.patch_px
        predicted = sim.predict_canvas(part, region_px,
                                       cache.pred_frame, plan)
        dets, clone = self.server.infer_speculative(
            predicted, plan, job["beta"], cache, job["frame"])
        t_spec = self._wave_infer_s([(ci, job)], stall_at=s_start)
        s_done = s_start + t_spec
        self.free_at = max(self.free_at, s_done)
        self.stats.note_compute(s_start, s_done)
        self.stats.spec_launched += 1
        return {"ci": ci, "job": job, "dets": dets, "clone": clone,
                "predicted": predicted, "region_px": region_px,
                "epoch": self.server.epoch,
                "s_start": s_start, "s_done": s_done}

    def _launch_spec(self, now: float) -> None:
        """Move admissible pending jobs into the speculative lane."""
        keep: List[Tuple[int, Dict]] = []
        for ci, job in self.pending:
            rec = self._try_speculate(ci, job, now)
            if rec is None:
                keep.append((ci, job))
            else:
                self._spec.append(rec)
        self.pending = keep          # subsequence: arrival order kept

    def _resolve_spec(self, now: float) -> None:
        self._spec = [rec for rec in self._spec
                      if not self._resolve_one(rec, now)]

    def _resolve_one(self, rec: Dict, now: float) -> bool:
        """Patch, discard, or refuse one landed speculation.  Returns
        True once the record is settled."""
        from repro_torch.offload import simulator as sim
        ci, job = rec["ci"], rec["job"]
        if job.get("abandoned"):
            # the client's deadline reaped the offload mid-payload
            # (blackout): the speculation dies with it — the prediction
            # is never rendered, and the client already climbed the
            # degradation ladder when it abandoned
            self.stats.spec_discarded += 1
            return True
        if rec["epoch"] != self.server.epoch:
            # replica restarted between launch and patch: the clone's
            # tiles (and the speculative result spliced from them)
            # belong to a dead generation — stale-epoch refusal applies
            # to speculative splices exactly as to real ones
            if job["arrival"] >= now:
                return False
            job["stale_epoch"] = True
            job["done_at"] = job["arrival"] + job["rtt"]
            job["dets"] = []
            self.server.stats.stale_epoch_rejects += 1
            self.stats.stale_nacks += 1
            self.stats.spec_discarded += 1
            return True
        r_start = max(self.free_at, job["arrival"] + job["t_dec"])
        if r_start >= now:
            return False
        part = self.server.part
        plan: RegionPlan = job["plan"]
        cache = self.clients[ci].feature_cache
        div = sim.region_divergence(part, rec["region_px"],
                                    job["decoded"], rec["predicted"],
                                    plan)
        states = np.asarray(plan.states)
        diverged = (states != REUSE) & (div > self.ec.spec_patch_tol)
        n_tx = plan.n_regions - plan.n_reuse
        stall = (self.faults.stall_extra(r_start)
                 if self.faults is not None else 0.0)
        t_inf_j = job.get("t_inf_exec", job["t_inf"])
        if diverged.sum() / max(n_tx, 1) > self.ec.spec_max_patch_frac:
            # gross mispredict: discard and rerun the original plan on
            # the real decoded frame (the normal path — the REAL cache
            # refreshes, the clone is dropped)
            dets = self._infer(job["decoded"][None], [(ci, job)],
                               [plan], [cache], 0,
                               self._job_key(job))[0]
            t_exec = t_inf_j + stall
            job["speculation"] = "discarded"
            self.stats.spec_discarded += 1
        else:
            if diverged.any():
                # patch pass: only diverged windows recompute; converged
                # transmitted regions splice the speculative capture —
                # an equal-or-smaller length bucket on the warmed grid
                patch_plan = sim.build_patch_plan(plan, diverged)
                lb = self.server.plan_length_bucket(plan)
                lb_p = self.server.plan_length_bucket(patch_plan)
                dets = self.server.infer_wave(
                    job["decoded"][None], [patch_plan], job["beta"],
                    caches=[rec["clone"]], frame_ids=[job["frame"]])[0]
                cfg = self.server.cfg
                scale = (vb.backbone_flops_windows(cfg, lb_p, job["beta"])
                         / vb.backbone_flops_windows(cfg, lb, job["beta"]))
                t_exec = t_inf_j * scale + stall
            else:
                # every in-flight region converged: the speculative
                # forward IS the answer; the patch pass is just the
                # host-side divergence check
                dets = rec["dets"]
                t_exec = stall
            # commit the clone: every region not freshly recomputed
            # from real pixels derives from reuse/prediction and ages by
            # one against the staleness bound K
            cache.commit_speculative(rec["clone"],
                                     np.nonzero(~diverged)[0],
                                     job["beta"], job["frame"],
                                     self.server.epoch)
            job["speculation"] = "patched"
            self.stats.spec_patched += 1
        done = r_start + t_exec
        self.free_at = max(self.free_at, done)
        if t_exec > 0.0:
            self.stats.note_compute(r_start, done)
        # hidden transmission: the slice of the uplink the speculative
        # compute overlapped — the Eq. (2) seconds this lane converts
        # from queue/idle into useful work
        hidden = max(0.0, min(rec["s_done"], job["arrival"])
                     - rec["s_start"])
        self.stats.spec_hidden.append(hidden)
        self.stats.spec_hidden_s += hidden
        cache.note_pred(job["decoded"], job["frame"], self.server.epoch)
        q = max(r_start - job["arrival"] - job["t_dec"], 0.0)
        self.clients[ci]._finish_offload(job, dets, queue_delay=q,
                                         t_dec=job["t_dec"],
                                         t_inf=t_exec)
        # bound at launch, before the payload even landed: the whole
        # queue residual is slot wait
        self._record_job(ci, job, dets, 1, q, 0.0, q)
        return True

    # -- execution ------------------------------------------------------

    def execute_wave(self, wave: List[Tuple[int, Dict]], t_start: float,
                     key: Tuple[int, int, int]) -> float:
        """Dispatch one wave at compute start ``t_start``.

        With ``stage_ahead`` the call is asynchronous: frames go to the
        card through :meth:`ServerModel.stage_frames`, the forward is
        enqueued, and the PREVIOUS wave's blocking detection decode runs
        only now — under this wave's device compute.  Returns the replica's new
        busy horizon (= compute end; decode is off the critical path).
        """
        wave = self._filter_stale(wave, t_start)
        if not wave:
            return self.free_at
        imgs, plans, caches, want_cap = self._wave_inputs(wave, key)
        defer = bool(self.ec.stage_ahead)
        frames = (self.server.stage_frames(imgs) if defer else imgs)
        try:
            dets = self._infer(frames, wave, plans, caches, want_cap,
                               key, defer=defer)
        except Exception:
            # deferred-dispatch failure after staging: drop the staged
            # device buffers, flush the one-deep executor pipeline so
            # the PREVIOUS wave's deferred decode still lands (its
            # PendingWave slot must not wedge), and mark this wave's
            # jobs lost so client deadlines reap them if the caller
            # survives the re-raise
            frames = None
            self._flush_exec()
            for _, job in wave:
                job["lost"] = True
                job["done_at"] = float("inf")
            self.stats.lost_jobs += len(wave)
            raise
        if self.ec.speculate:
            # record each session's decoded canvas as its prediction
            # source AFTER the refresh inside infer_wave (note() aged
            # it; note_pred resets the staleness clock)
            for ci, job in wave:
                cache = self.clients[ci].feature_cache
                if cache is not None:
                    cache.note_pred(job["decoded"], job["frame"],
                                    self.server.epoch)

        B = len(wave)
        t_inf = self._wave_infer_s(wave, stall_at=t_start)
        done = t_start + t_inf

        self.stats.wave_sizes.append(B)
        self.stats.wave_n_low_mix.append(
            len({p.n_low for p in plans}))
        self.stats.note_compute(t_start, done)
        prev_free = self.free_at
        for _, job in wave:
            self.stats.decode_hidden_s += min(
                job["t_dec"], max(prev_free - job["arrival"], 0.0))
        self._exec_q.append((wave, dets, t_start, t_inf, B))
        if len(self._exec_q) > 1:
            self._finalize(self._exec_q.pop(0))
        return done

    def _finalize(self, rec) -> None:
        wave, dets, t_start, t_inf, B = rec
        if hasattr(dets, "wait"):        # deferred decode (stage_ahead)
            dets = dets.wait()
        for (ci, job), d in zip(wave, dets):
            q = max(t_start - job["arrival"] - job["t_dec"], 0.0)
            admit = min(max(job.get("_bound_at", job["arrival"])
                            - job["arrival"], 0.0), q)
            self.clients[ci]._finish_offload(job, d, queue_delay=q,
                                             t_dec=job["t_dec"],
                                             t_inf=t_inf)
            self._record_job(ci, job, d, B, q, admit, q - admit)

    def _flush_exec(self) -> None:
        while self._exec_q:
            self._finalize(self._exec_q.pop(0))


SCHEDULERS = {"barrier": BarrierScheduler,
              "continuous": ContinuousScheduler}


def make_scheduler(server, clients, ec: EdgeConfig,
                   faults: Optional[FaultInjector] = None,
                   host=None) -> WaveScheduler:
    try:
        cls = SCHEDULERS[ec.scheduler]
    except KeyError:
        raise ValueError(
            f"unknown EdgeConfig.scheduler {ec.scheduler!r}; "
            f"choose from {sorted(SCHEDULERS)}") from None
    return cls(server, clients, ec, faults=faults, host=host)


# ---------------------------------------------------------------------------
# the N=1 plane


class SoloScheduler:
    """Scheduling plane of the single-client simulator.

    N=1 has no wave to form: an offload executes immediately on the
    dedicated replica.  What it shares with the edge is the rest of the
    plane — the stale-epoch control-plane NACK and the crash-restart
    application (:func:`edge_restart_tick`), so solo and multi-client
    restart recovery stay behaviourally identical.
    """

    def __init__(self, sim):
        self.sim = sim

    def submit(self, job: Dict, now: float) -> None:
        """Dedicated immediate inference for one prepared offload."""
        sim = self.sim
        try:
            if sim.feature_cache is not None:
                dets = sim.server.infer_plan(
                    job["decoded"], job["plan"], job["beta"],
                    cache=sim.feature_cache, frame_idx=job["frame"],
                    capture_beta=job["capture_beta"])
            else:
                dets = sim.server.infer(
                    job["decoded"],
                    job["mask"] if job["n_d"] > 0 else None, job["beta"])
        except StaleCacheEpoch:
            # control-plane NACK from a restarted edge: the splice was
            # refused; the completion path invalidates the cache and the
            # next offload bootstraps FULL at the new epoch
            job["stale_epoch"] = True
            job["done_at"] = now + job["rtt"]
            job["dets"] = []
            return
        sim._finish_offload(job, dets)

    def fault_tick(self, prev: float, now: float) -> None:
        """Single-client path owns its replica: apply crash-restarts
        (epoch bump + executable wipe via the shared plane) and lose
        any response that died with the old process."""
        sim = self.sim
        for (r, outage) in edge_restart_tick(sim.server, sim.faults,
                                             prev, now):
            sim.rstats["edge_restarts"] += 1
            j = sim.inflight
            if j is not None and j["submit"] <= r and j["done_at"] > r:
                j["lost"] = True
                j["done_at"] = float("inf")
