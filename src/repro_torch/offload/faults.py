"""Deterministic fault injection + graceful degradation for the
device-to-edge offload loop (robustness spine for the fleet work).

Two layers live here:

  * :class:`FaultInjector` — a crc32-seeded (like network traces) fault
    schedule layered onto a :class:`~repro.data.network_traces.NetworkTrace`
    and the simulators: uplink blackouts, handover storms (periodic
    micro-blackouts), RTT spikes / bufferbloat, dropped and duplicated
    offload responses, edge service stalls, and edge crash-restarts.  A
    restart wipes the replica's warmed executables and bumps its cache
    epoch, invalidating every device-resident
    :class:`~repro.serve.request.FeatureCache` (see ServerModel.restart).
    :class:`FaultyTrace` wraps a trace so trace consumers see the
    impaired network without knowing about the injector.

  * :class:`DegradationLadder` — the client-side timeout/retry/backoff
    state machine of the deadline-bounded offload lifecycle.  Every
    offload carries an SLO-derived deadline (:class:`RobustConfig`); on
    timeout / loss / REJECTED the client abandons the offload, lets the
    LK tracker cover the gap, and retries at a DEGRADED config (FULL
    regions promoted to LOW, lower quality) after an exponentially
    backed-off delay.  Ladder levels:

        0  normal — the policy's decision goes out untouched
        1  half of the FULL regions (lowest-motion first) -> LOW,
           quality - 10
        2  every FULL region -> LOW, quality floored at ``min_quality``
        3  shed — offloads pause until the backed-off probe; rendering
           rides the tracker (the shed-to-tracker fallback)

    Successes walk the ladder back down one level per
    ``recover_after`` consecutive completions.  REUSE regions are never
    touched by degradation: they already ship zero bytes.
"""
from __future__ import annotations

import zlib
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.partition import FULL, LOW, RegionPlan

__all__ = ["FaultSpec", "FaultInjector", "FaultyTrace", "RobustConfig",
           "DegradationLadder", "BLACKOUT_TPUT_BPS"]

# uplink throughput during a blackout: effectively dead, but finite so
# Eq. (2) terms stay computable (the deadline, not an inf, kills the job)
BLACKOUT_TPUT_BPS = 1e3


@dataclass(frozen=True)
class FaultSpec:
    """A concrete fault schedule (all times in seconds, sim clock).

    blackouts:   ((t0, dur), ...)            uplink dead in [t0, t0+dur)
    storms:      ((t0, dur, period, duty), ...)  handover storm: within
                 [t0, t0+dur) the uplink drops for ``duty`` of every
                 ``period`` seconds (periodic micro-blackouts)
    bufferbloat: ((t0, dur, rtt_factor), ...)  RTT inflated by factor,
                 throughput dented to 70 %
    drop_responses: offload sequence numbers whose response is lost
    dup_responses:  offload sequence numbers delivered twice
    edge_stalls: ((t0, dur, extra_s), ...)   service starting within the
                 window takes ``extra_s`` longer (GC pause / preemption)
    edge_restarts: ((t, outage_s), ...)      replica crashes at ``t``,
                 back at ``t + outage_s`` with a new cache epoch and a
                 cold executable cache
    """
    blackouts: Tuple[Tuple[float, float], ...] = ()
    storms: Tuple[Tuple[float, float, float, float], ...] = ()
    bufferbloat: Tuple[Tuple[float, float, float], ...] = ()
    drop_responses: Tuple[int, ...] = ()
    dup_responses: Tuple[int, ...] = ()
    edge_stalls: Tuple[Tuple[float, float, float], ...] = ()
    edge_restarts: Tuple[Tuple[float, float], ...] = ()


class FaultInjector:
    """Evaluates a :class:`FaultSpec` against the sim clock.

    Deterministic: build one via :meth:`from_profile` (crc32-seeded per
    (profile, index), exactly like make_trace) or hand it an explicit
    spec.  Stateless — every query is a pure function of time / sequence
    number, so the single-client loop and the multi-client edge can
    share one injector without ordering hazards.
    """

    def __init__(self, spec: FaultSpec):
        self.spec = spec

    # ------------------------------------------------------------------
    @classmethod
    def from_profile(cls, profile: str, index: int = 0,
                     start_s: float = 1.5,
                     dur_s: float = 1.0) -> "FaultInjector":
        """Canonical single-fault schedules for the bench fault matrix.

        profiles: none | blackout | handover_storm | bufferbloat |
        edge_restart | response_loss.  The fault onset is jittered
        deterministically per (profile, index) — NOT hash(): str hashing
        is salted per process.
        """
        seed = zlib.crc32(f"faults-{profile}-{index}".encode())
        rng = np.random.default_rng(seed)
        t0 = start_s + float(rng.uniform(0.0, 0.3))
        if profile == "none":
            spec = FaultSpec()
        elif profile == "blackout":
            spec = FaultSpec(blackouts=((t0, dur_s),))
        elif profile == "handover_storm":
            # period deliberately NOT a multiple of typical frame ticks
            # (0.1 s): offload submits are frame-quantized, and a
            # commensurate period can phase-lock with the ~0.4 s offload
            # cadence so every submit threads the up-phases and the
            # storm leaves no trace
            spec = FaultSpec(storms=((t0, 2.0 * dur_s, 0.45, 0.5),))
        elif profile == "bufferbloat":
            spec = FaultSpec(bufferbloat=((t0, 2.0 * dur_s,
                                           float(rng.uniform(4.0, 8.0))),))
        elif profile == "edge_restart":
            spec = FaultSpec(edge_restarts=((t0, 0.5 * dur_s),))
        elif profile == "response_loss":
            first = int(rng.integers(2, 5))
            spec = FaultSpec(drop_responses=(first, first + 1),
                             dup_responses=(first + 3,))
        else:
            raise ValueError(f"unknown fault profile {profile!r}")
        return cls(spec)

    # ------------------------------------------------------------------
    # network-plane faults

    def uplink_down(self, t: float) -> bool:
        for (t0, dur) in self.spec.blackouts:
            if t0 <= t < t0 + dur:
                return True
        for (t0, dur, period, duty) in self.spec.storms:
            if t0 <= t < t0 + dur and (t - t0) % period < duty * period:
                return True
        return False

    def net(self, t: float, tput_bps: float,
            rtt_s: float) -> Tuple[float, float]:
        """Impair one (throughput, RTT) sample of the trace."""
        if self.uplink_down(t):
            tput_bps = min(tput_bps, BLACKOUT_TPUT_BPS)
        for (t0, dur, factor) in self.spec.bufferbloat:
            if t0 <= t < t0 + dur:
                rtt_s = rtt_s * factor
                tput_bps = tput_bps * 0.7
        return tput_bps, rtt_s

    # ------------------------------------------------------------------
    # response-plane faults

    def response_dropped(self, seq: int) -> bool:
        return seq in self.spec.drop_responses

    def response_duplicated(self, seq: int) -> bool:
        return seq in self.spec.dup_responses

    # ------------------------------------------------------------------
    # edge-plane faults

    def stall_extra(self, t: float) -> float:
        """Extra service seconds for work STARTING at ``t``."""
        return sum(extra for (t0, dur, extra) in self.spec.edge_stalls
                   if t0 <= t < t0 + dur)

    def restarts_between(self, t0: float,
                         t1: float) -> List[Tuple[float, float]]:
        """Restart events with t0 < t <= t1, in time order."""
        return sorted((r, o) for (r, o) in self.spec.edge_restarts
                      if t0 < r <= t1)

    def edge_down(self, t: float) -> bool:
        """True while a crashed replica has not come back yet — work
        arriving in the outage window is lost, never answered."""
        return any(r <= t < r + outage
                   for (r, outage) in self.spec.edge_restarts)


@dataclass
class FaultyTrace:
    """A NetworkTrace wrapper applying an injector's network-plane
    faults — consumers only ever call ``.at()``, so trace-level layering
    needs nothing else."""
    base: object
    injector: FaultInjector

    @property
    def name(self) -> str:
        return f"{getattr(self.base, 'name', 'trace')}+faults"

    @property
    def kind(self) -> str:
        return getattr(self.base, "kind", "?")

    def at(self, t: float) -> Tuple[float, float]:
        return self.injector.net(t, *self.base.at(t))


# ---------------------------------------------------------------------------
# deadline-bounded offload lifecycle: config + ladder


@dataclass(frozen=True)
class RobustConfig:
    """SLO + retry knobs of the deadline-bounded offload lifecycle."""
    slo_s: float = 1.2            # offload deadline past submit
    backoff_base_s: float = 0.2   # first retry delay after a failure
    backoff_max_s: float = 3.2    # exponential backoff ceiling
    ladder_max: int = 3           # level 3 == shed to tracker
    recover_after: int = 2        # consecutive successes per step down
    min_quality: int = 70
    degrade_beta: int = 2         # restoration point degraded plans use


class DegradationLadder:
    """Client-side failure state machine (see module docstring)."""

    def __init__(self, rc: Optional[RobustConfig] = None):
        self.rc = rc or RobustConfig()
        self.level = 0
        self.max_level_seen = 0
        self.retry_at = 0.0           # no offload before this sim time
        self.backoff = self.rc.backoff_base_s
        self._ok_streak = 0

    @property
    def shedding(self) -> bool:
        return self.level >= self.rc.ladder_max

    def on_failure(self, now: float) -> None:
        """Timeout, lost response, or edge REJECTED: climb one level and
        back off exponentially before the retry probe."""
        self.level = min(self.level + 1, self.rc.ladder_max)
        self.max_level_seen = max(self.max_level_seen, self.level)
        self._ok_streak = 0
        self.retry_at = now + self.backoff
        self.backoff = min(self.backoff * 2.0, self.rc.backoff_max_s)

    def on_success(self) -> None:
        """A completed, rendered offload: reset backoff; after
        ``recover_after`` in a row, step one level back down."""
        self.backoff = self.rc.backoff_base_s
        self.retry_at = 0.0
        self._ok_streak += 1
        if self.level > 0 and self._ok_streak >= self.rc.recover_after:
            self.level -= 1
            self._ok_streak = 0

    # ------------------------------------------------------------------
    def degrade(self, decision: Dict, m: Optional[np.ndarray]) -> Dict:
        """Rewrite a policy decision for the current ladder level:
        promote FULL regions to LOW (lowest motion ``m`` first — legal
        at runtime since (n_low, n_reuse) are executable DATA, not
        shape), drop quality, and force a restoration point onto mixed
        plans.  REUSE regions are untouched.  Level 0 is the identity.
        """
        lvl = min(self.level, 2)
        if lvl == 0:
            return decision
        d = dict(decision)
        plan: Optional[RegionPlan] = d.get("plan")
        if plan is not None:
            states = np.asarray(plan.states).copy()
        else:
            states = np.where(np.asarray(d["mask"]).reshape(-1) != 0,
                              LOW, FULL).astype(np.int8)
        full_ids = np.nonzero(states == FULL)[0]
        k = len(full_ids) if lvl >= 2 else (len(full_ids) + 1) // 2
        demoted = np.zeros((0,), np.int64)
        if k:
            mm = (np.asarray(m, np.float64)[full_ids] if m is not None
                  else np.zeros(len(full_ids)))
            order = full_ids[np.argsort(mm, kind="stable")]
            demoted = order[:k].astype(np.int64)
            states[demoted] = LOW
        new_plan = RegionPlan(states.astype(np.int8))
        d["plan"] = new_plan
        d["mask"] = new_plan.low_mask()
        d["quality"] = int(max(self.rc.min_quality,
                               int(d["quality"]) - 10 * lvl))
        if (new_plan.n_low > 0 or new_plan.n_reuse > 0) \
                and int(d.get("beta", 0)) < 1:
            d["beta"] = self.rc.degrade_beta
        d["degraded"] = lvl
        # regions transmitted LOW as a stopgap: their captured tiles are
        # low-fidelity and must NOT become durable splice sources — the
        # client expires them from its FeatureCache on completion, so
        # reuse of these regions resumes only after a genuine FULL
        # re-transmission (else one degraded offload poisons the next K)
        d["demoted"] = demoted
        return d


def fresh_rstats() -> Dict[str, int]:
    """Robustness counters a Simulation tracks (see Simulation.rstats)."""
    return {"timeouts": 0, "lost_responses": 0, "late_discards": 0,
            "dup_discards": 0, "stale_discards": 0, "rejected": 0,
            "stale_epoch_nacks": 0, "edge_restarts": 0,
            "degraded_offloads": 0, "tracker_frames": 0,
            "max_ladder_level": 0}
