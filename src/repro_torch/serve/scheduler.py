"""The scheduling plane, ported from ``repro.serve.scheduler``:

  * :func:`form_wave` — the head-key grouping pass the LM serving engine
    uses;
  * :func:`edge_restart_tick` — the crash-restart application every
    plane shares;
  * :class:`SoloScheduler` — the N=1 plane of the single-client
    ``offload.simulator.Simulation``: dedicated immediate execution with
    the stale-epoch NACK and crash-restart semantics.

The multi-client edge schedulers (``EdgeConfig``, ``WaveScheduler``,
``BarrierScheduler``, ``ContinuousScheduler``, ``make_scheduler``) are
not ported yet.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.offload.faults import FaultInjector
from repro_torch.serve.request import StaleCacheEpoch


def form_wave(items: Sequence, key_fn: Callable, cap: int):
    """Form one wave from an ordered queue.

    The head item seeds the wave; each later item joins iff the wave
    has room (``cap``) and its key matches the head's.  Returns
    ``(wave, rest, head_key)``; ``rest`` preserves queue order.  (The
    reference's ``admit`` and ``promote`` hooks come with the edge
    schedulers that pass them.)
    """
    head = items[0]
    hk = key_fn(head)
    wave, rest = [head], []
    for it in items[1:]:
        if len(wave) < cap and key_fn(it) == hk:
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
