"""Synthetic 4G/5G uplink traces matching the paper's trace statistics
(§VI-A): 300 s at 1 s resolution; 4G mean uplink 10.4–36.4 Mbps, 5G
12.2–135.5 Mbps; mean RTT ~39 ms (4G) / ~34 ms (5G).

AR(1) log-throughput with occasional deep fades (handover/blockage),
deterministic per (kind, index).  ``make_trace`` can additionally bake
deterministic impairments INTO the trace — uplink blackouts, handover
storms (alternating-second micro-blackouts), and bufferbloat RTT
inflation — seeded independently of the base process, so the base trace
is byte-identical whether or not impairments are requested.  (The
offload-side alternative is layering offload/faults.FaultInjector on an
untouched trace; the knobs here serve trace-only consumers.)
"""
from __future__ import annotations

import zlib
from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

# throughput during a baked-in blackout second (dead but finite)
BLACKOUT_TPUT_BPS = 1e3


@dataclass
class NetworkTrace:
    name: str
    kind: str                 # "4g" | "5g"
    tput_bps: np.ndarray      # (T,) per-second uplink throughput
    rtt_s: np.ndarray         # (T,) per-second RTT
    # past-end behaviour of ``at``: "hold" freezes the final second
    # (the legacy implicit behaviour, now explicit), "wrap" loops the
    # trace — long simulations over short traces pick one deliberately
    extend: str = "hold"

    def at(self, t: float) -> Tuple[float, float]:
        n = len(self.tput_bps)
        if self.extend == "wrap":
            i = int(t) % n
        else:
            i = min(int(t), n - 1)
        return float(self.tput_bps[i]), float(self.rtt_s[i])

    @property
    def mean_mbps(self) -> float:
        return float(self.tput_bps.mean() / 1e6)


def make_trace(kind: str, index: int, duration_s: int = 300, *,
               blackouts: int = 0, blackout_s: Tuple[float, float] = (2, 6),
               storms: int = 0, storm_s: Tuple[float, float] = (4, 10),
               bufferbloat: int = 0,
               bloat_s: Tuple[float, float] = (5, 15),
               bloat_factor: Tuple[float, float] = (3.0, 8.0),
               extend: str = "hold") -> NetworkTrace:
    # NOT hash(): str hashing is salted per process (PYTHONHASHSEED), so
    # trace statistics would differ from run to run
    seed = zlib.crc32(f"{kind}-{index}".encode())
    rng = np.random.default_rng(seed)
    if kind == "4g":
        mean_mbps = rng.uniform(10.4, 36.4)
        rtt_mean = 0.039
        vol = 0.25
    else:
        mean_mbps = rng.uniform(12.2, 135.5)
        rtt_mean = 0.034
        vol = 0.35

    # AR(1) in log space around the mean
    log_mu = np.log(mean_mbps)
    x = np.empty(duration_s)
    x[0] = log_mu
    phi = 0.92
    sigma = vol * np.sqrt(1 - phi ** 2)
    for t in range(1, duration_s):
        x[t] = log_mu + phi * (x[t - 1] - log_mu) + rng.normal(0, sigma)
    tput = np.exp(x)

    # deep fades: 1-4 events of 2-6 s at 10-30% capacity
    for _ in range(rng.integers(1, 5)):
        t0 = rng.integers(0, duration_s - 6)
        dur = rng.integers(2, 7)
        tput[t0:t0 + dur] *= rng.uniform(0.1, 0.3)

    rtt = np.clip(rtt_mean * (1.0 + 0.5 * (mean_mbps / tput - 1.0)),
                  0.015, 0.5)
    tput = tput * 1e6

    # impairment overlays, seeded SEPARATELY so knob-free calls return
    # the byte-identical base trace
    if blackouts or storms or bufferbloat:
        irng = np.random.default_rng(
            zlib.crc32(f"{kind}-{index}-impair".encode()))

        def window(span: Tuple[float, float]) -> Tuple[int, int]:
            dur = int(np.ceil(irng.uniform(*span)))
            t0 = int(irng.integers(0, max(duration_s - dur, 1)))
            return t0, min(t0 + dur, duration_s)

        for _ in range(blackouts):
            a, b = window(blackout_s)
            tput[a:b] = BLACKOUT_TPUT_BPS
        for _ in range(storms):
            a, b = window(storm_s)
            # handover storm: the uplink drops every other second
            tput[a:b:2] = BLACKOUT_TPUT_BPS
        for _ in range(bufferbloat):
            a, b = window(bloat_s)
            rtt[a:b] = np.clip(rtt[a:b] * irng.uniform(*bloat_factor),
                               None, 3.0)

    return NetworkTrace(name=f"{kind}-{index:02d}", kind=kind,
                        tput_bps=tput, rtt_s=rtt, extend=extend)


def trace_set(n_per_kind: int = 30, duration_s: int = 300
              ) -> List[NetworkTrace]:
    """The evaluation trace set: n 4G + n 5G traces (paper: 30 + 30)."""
    out = []
    for kind in ("4g", "5g"):
        out.extend(make_trace(kind, i, duration_s)
                   for i in range(n_per_kind))
    return out
