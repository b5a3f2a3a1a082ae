"""The one traffic generator: reads a mix file (``traffic/<mix>.json``)
and turns it, with ``--seed``, into each client's stream of offloads.

Every client is a closed loop: its next offload reaches the server one
uplink delay after its previous result came back.  What a client sends
is fixed by the seed alone and drawn lazily, offload by offload, from
the client's own random stream, so the n-th offload of a client is the
same in every run of a seed whatever the system's speed; only the times
depend on the system.

A mix file holds:

  clients          number of clients (closed loops)
  start_spread_s   client i starts at a seeded offset in [0, spread)
  preroll_s        the traffic runs this long before the measured
                   window opens, so the window starts in steady state
  uplink           null (a LAN: no delay) or a 4G trace process, below
  plans            "full" (every offload full resolution, no session) or
                   "mixed" (FULL / LOW / REUSE region plans, a session)
  beta             restoration point of mixed plans
  max_age          K: a region is reused at most K offloads in a row
  windows          [[lo, hi, n], ...]: a mixed plan's transmitted window
                   count is drawn in [lo, hi]; each client takes its
                   ranges from a shuffled deck holding each range n
                   times, so range i has probability n_i / sum(n) and
                   every seed sends the same mix, in another order
  reuse_prob       chance that a region cut from FULL becomes REUSE
                   (where its cached tile is young enough) and not LOW
  region_bytes     {"full", "low", "header", "reuse_header"} payload bytes
  frame_pool       frames in the seeded pool; each offload draws one
  max_wave         most frames in one wave
  batch_buckets    the wave sizes the cell warms up
  check            {"clients", "per_client"}: how many clients the
                   correctness check samples, and offloads of each

The uplink process is a frozen copy of ``data/network_traces.make_trace``
for 4G (AR(1) log-throughput around a mean in the paper's §VI-A range,
deep fades, RTT rising as throughput falls), except that the n traces
do not depend on the seed: trace k's mean is the middle of the k-th of
n equal slices of the range, and the seed only deals the traces out to
the clients, so every seed offers the fleet the same uplinks in another
order.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

FULL, LOW, REUSE = 0, 1, 2

# the stream ids under one seed: each use draws from its own stream
STREAM_START, STREAM_TRACE, STREAM_PLANS = 1, 2, 3


def load_mix(path: Path) -> Dict:
    mix = json.loads(Path(path).read_text())
    if mix["plans"] not in ("full", "mixed"):
        raise ValueError(f"{path}: plans must be 'full' or 'mixed'")
    if mix["plans"] == "mixed":
        if not all(isinstance(w[2], int) and w[2] > 0
                   for w in mix["windows"]):
            raise ValueError(f"{path}: window counts must be whole and > 0")
    return mix


def rng_for(seed: int, *stream: int) -> np.random.Generator:
    """A random stream of its own for (seed, stream...); any whole seed."""
    return np.random.default_rng([seed % 2 ** 64, *stream])


@dataclass
class UplinkTrace:
    """Per-second uplink throughput (bit/s) and RTT (s), looped."""
    tput_bps: np.ndarray
    rtt_s: np.ndarray

    def delay_s(self, nbytes: int, t: float) -> float:
        """One RTT plus the payload over that second's throughput."""
        i = int(max(t, 0.0)) % len(self.tput_bps)
        return float(self.rtt_s[i] + nbytes * 8.0 / self.tput_bps[i])


def make_4g_trace(rng: np.random.Generator, spec: Dict,
                  mean_mbps: float) -> UplinkTrace:
    """The 4G process of ``data/network_traces.make_trace``, frozen,
    around ``mean_mbps``."""
    n = int(spec["duration_s"])
    log_mu = np.log(mean_mbps)
    phi = spec["ar_phi"]
    sigma = spec["volatility"] * np.sqrt(1 - phi ** 2)
    x = np.empty(n)
    x[0] = log_mu
    for t in range(1, n):
        x[t] = log_mu + phi * (x[t - 1] - log_mu) + rng.normal(0, sigma)
    tput = np.exp(x)
    lo, hi = spec["fades"]
    for _ in range(rng.integers(lo, hi + 1)):
        t0 = rng.integers(0, n - 6)
        dur = rng.integers(*spec["fade_len_s"])
        tput[t0:t0 + dur] *= rng.uniform(*spec["fade_depth"])
    rtt = np.clip(spec["rtt_s"] * (1.0 + 0.5 * (mean_mbps / tput - 1.0)),
                  0.015, 0.5)
    return UplinkTrace(tput_bps=tput * 1e6, rtt_s=rtt)


@dataclass
class Offload:
    """One offloaded frame: who sent it, its place in the client's
    session, the pool frame it carries and its region plan."""
    client: int
    seq: int
    frame: int
    states: np.ndarray            # (n_regions,) int8 FULL / LOW / REUSE
    n_windows: int                # transmitted windows
    nbytes: int
    due: float = 0.0              # arrival at the server (host clock)
    done: float = 0.0             # detections decoded on the host
    dets: Optional[list] = None

    @property
    def full_res(self) -> bool:
        return not (self.states != FULL).any()


@dataclass
class Client:
    """One client's offload stream (plans, frames, uplink)."""
    idx: int
    mix: Dict
    n_regions: int
    windows_per_region: int
    rng: np.random.Generator
    uplink: Optional[UplinkTrace]
    start_s: float
    seq: int = 0
    age: np.ndarray = None
    warm: bool = False
    history: List[Offload] = field(default_factory=list)
    deck: List[int] = field(default_factory=list)

    def __post_init__(self):
        self.age = np.zeros((self.n_regions,), np.int32)

    def next_offload(self) -> Offload:
        mix, nR, dd = self.mix, self.n_regions, self.windows_per_region
        frame = int(self.rng.integers(mix["frame_pool"]))
        if mix["plans"] == "full" or self.seq == 0:
            states = np.zeros((nR,), np.int8)          # bootstrap: FULL
        else:
            if not self.deck:
                self.deck = self.rng.permutation(np.repeat(
                    np.arange(len(mix["windows"])),
                    [w[2] for w in mix["windows"]])).tolist()
            lo, hi, _ = mix["windows"][self.deck.pop()]
            states = draw_plan(self.rng, mix, nR, dd, lo, hi,
                               np.logical_and(self.warm,
                                              self.age < mix["max_age"]))
        if mix["plans"] == "mixed":
            reused = states == REUSE
            self.age = np.where(reused, self.age + 1, 0).astype(np.int32)
            self.warm = True
        off = Offload(client=self.idx, seq=self.seq, frame=frame,
                      states=states, n_windows=plan_windows(states, dd),
                      nbytes=payload_bytes(mix, states))
        self.seq += 1
        self.history.append(off)
        return off

    def uplink_s(self, nbytes: int, t: float) -> float:
        return 0.0 if self.uplink is None else self.uplink.delay_s(nbytes, t)


def plan_windows(states: np.ndarray, dd: int) -> int:
    return int((states == FULL).sum()) * dd + int((states == LOW).sum())


def payload_bytes(mix: Dict, states: np.ndarray) -> int:
    rb = mix.get("region_bytes")
    if rb is None:
        return 0
    n = rb["header"] + rb["full"] * int((states == FULL).sum()) \
        + rb["low"] * int((states == LOW).sum())
    return n + (rb["reuse_header"] if (states == REUSE).any() else 0)


def draw_plan(rng: np.random.Generator, mix: Dict, nR: int, dd: int,
              lo: int, hi: int, eligible: np.ndarray) -> np.ndarray:
    """A mixed plan whose window count falls in [lo, hi]: regions, in a
    seeded order, are cut from FULL to REUSE (only where ``eligible``,
    with ``reuse_prob``) or to LOW until the count reaches a target drawn
    in the range.  The target keeps 3 windows above the range's floor,
    so a last cut to LOW (3 windows) never falls below it."""
    target = int(rng.integers(min(lo + dd - 1, hi), hi + 1))
    states = np.zeros((nR,), np.int8)
    nw = nR * dd
    for r in rng.permutation(nR):
        if nw <= target:
            break
        reuse = bool(eligible[r]) and rng.random() < mix["reuse_prob"]
        if reuse and nw - dd >= max(lo, 1):
            states[r], nw = REUSE, nw - dd
        elif nw - (dd - 1) >= max(lo, 1):
            states[r], nw = LOW, nw - (dd - 1)
    return states


def make_clients(mix: Dict, n_regions: int, windows_per_region: int,
                 seed: int) -> List[Client]:
    n = mix["clients"]
    start = rng_for(seed, STREAM_START).uniform(
        0.0, max(mix["start_spread_s"], 1e-9), n)
    up = mix.get("uplink")
    traces = [None] * n
    if up:
        # the same n traces for every seed, dealt out in a seeded order
        lo, hi = up["mean_mbps"]
        traces = [make_4g_trace(np.random.default_rng([STREAM_TRACE, k]), up,
                                lo + (hi - lo) * (k + 0.5) / n)
                  for k in range(n)]
        slot = rng_for(seed, STREAM_TRACE).permutation(n)
        traces = [traces[k] for k in slot]
    clients = []
    for i, trace in enumerate(traces):
        clients.append(Client(idx=i, mix=mix, n_regions=n_regions,
                              windows_per_region=windows_per_region,
                              rng=rng_for(seed, STREAM_PLANS, i),
                              uplink=trace, start_s=float(start[i])))
    return clients


def checked_clients(mix: Dict, seed: int) -> Tuple[int, ...]:
    """The clients whose offloads the correctness check may compare."""
    n = min(mix["check"]["clients"], mix["clients"])
    pick = rng_for(seed, 4).choice(mix["clients"], n, replace=False)
    return tuple(sorted(int(c) for c in pick))
