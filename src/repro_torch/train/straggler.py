"""Straggler & failure handling for pod-scale jobs (a copy of
``repro.train.straggler``, which is pure Python and numpy).

Two mechanisms:

* ``HeartbeatMonitor`` — tracks per-host step heartbeats; hosts that miss
  ``miss_limit`` consecutive deadlines are declared failed, triggering an
  elastic restart (see train/elastic.py).  Hosts whose step time exceeds
  ``straggle_factor`` x the fleet median are flagged stragglers; the
  driver's response is a backup-step skip (the slow host's microbatch is
  covered by the others re-splitting the global batch).

* ``DeadlineDispatcher`` — serving-side: requests dispatched to a replica
  are re-dispatched to the next-fastest replica if no completion arrives
  before the p99-based deadline (tail-latency mitigation).

Deterministic, simulation-friendly: time is injected, not read from the
wall clock, so the tests drive schedules explicitly.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set

import numpy as np


@dataclass
class HostState:
    last_beat: float = 0.0
    missed: int = 0
    step_times: List[float] = field(default_factory=list)


class HeartbeatMonitor:
    def __init__(self, hosts: List[int], interval: float = 10.0,
                 miss_limit: int = 3, straggle_factor: float = 2.0):
        self.hosts = {h: HostState() for h in hosts}
        self.interval = interval
        self.miss_limit = miss_limit
        self.straggle_factor = straggle_factor
        self.failed: Set[int] = set()

    def beat(self, host: int, now: float,
             step_time: Optional[float] = None) -> None:
        st = self.hosts[host]
        st.last_beat = now
        st.missed = 0
        if step_time is not None:
            st.step_times.append(step_time)

    def check(self, now: float) -> Dict[str, List[int]]:
        """Advance deadlines; returns {"failed": [...], "stragglers": [...]}"""
        newly_failed = []
        for h, st in self.hosts.items():
            if h in self.failed:
                continue
            if now - st.last_beat > self.interval:
                st.missed = int((now - st.last_beat) / self.interval)
                if st.missed >= self.miss_limit:
                    self.failed.add(h)
                    newly_failed.append(h)

        # straggler detection on recent step times
        recents = {h: np.mean(st.step_times[-5:])
                   for h, st in self.hosts.items()
                   if st.step_times and h not in self.failed}
        stragglers = []
        if len(recents) >= 2:
            med = float(np.median(list(recents.values())))
            stragglers = [h for h, t in recents.items()
                          if t > self.straggle_factor * med]
        return {"failed": newly_failed, "stragglers": stragglers}

    def healthy_hosts(self) -> List[int]:
        return [h for h in self.hosts if h not in self.failed]


# ---------------------------------------------------------------------------


@dataclass
class Dispatch:
    request_id: int
    replica: int
    sent_at: float
    deadline: float


class DeadlineDispatcher:
    """Serving-side re-dispatch on deadline miss (tail mitigation)."""

    def __init__(self, n_replicas: int, base_deadline: float = 0.5,
                 p99_window: int = 64):
        self.n = n_replicas
        self.base_deadline = base_deadline
        self.lat: List[float] = []
        self.p99_window = p99_window
        self.inflight: Dict[int, Dispatch] = {}
        self.redispatches = 0
        self._rr = 0

    def _deadline(self) -> float:
        if len(self.lat) < 8:
            return self.base_deadline
        recent = self.lat[-self.p99_window:]
        return float(np.percentile(recent, 99) * 1.5)

    def dispatch(self, request_id: int, now: float,
                 avoid: Optional[int] = None) -> Dispatch:
        replica = self._rr % self.n
        if avoid is not None and replica == avoid and self.n > 1:
            replica = (replica + 1) % self.n
        self._rr += 1
        d = Dispatch(request_id, replica, now, now + self._deadline())
        self.inflight[request_id] = d
        return d

    def complete(self, request_id: int, now: float) -> None:
        d = self.inflight.pop(request_id, None)
        if d is not None:
            self.lat.append(now - d.sent_at)

    def poll(self, now: float) -> List[Dispatch]:
        """Re-dispatch every request past its deadline; returns the new
        dispatches."""
        out = []
        for rid, d in list(self.inflight.items()):
            if now > d.deadline:
                self.redispatches += 1
                nd = self.dispatch(rid, now, avoid=d.replica)
                out.append(nd)
        return out
