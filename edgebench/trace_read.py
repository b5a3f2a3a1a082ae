"""The device trace of a traced run, reduced to what the per-layer
readers and the ``breakdown`` take: device operations in the traced
interval, the device's busy time, its idle gaps and what the host was
doing in each, and the kernels of each wave.

The harness marks host phases with ``torch.profiler.record_function``
ranges: ``edgebench.wave.<id>`` around a wave's dispatch
(``stage_frames`` and ``infer_wave``), ``edgebench.wait`` around
``PendingWave.wait``, ``edgebench.complete`` around the bookkeeping
that follows, and two instants, ``edgebench.mark.start`` / ``.end``,
that bound the interval read.  A kernel belongs to the wave whose range
holds the host call that launched it (matched by the trace's
correlation ids).  Time outside every range is ``poll``: the host
waiting for an arrival or for the device.
"""
from __future__ import annotations

import bisect
import json
from collections import defaultdict
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Tuple

WAVE = "edgebench.wave."
MARK_START, MARK_END = "edgebench.mark.start", "edgebench.mark.end"
PHASES = {"edgebench.wait": "wait", "edgebench.complete": "complete"}
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
NAME_CHARS = 160


@dataclass
class DeviceOp:
    name: str
    start: float          # seconds on the trace's clock
    end: float


@dataclass
class TraceSummary:
    start: float                       # the interval read
    end: float
    ops: List[DeviceOp]                # device operations in it
    busy_s: float
    gaps: List[Tuple[float, float, str]]   # (start, seconds, host phase)
    wave_ops: Dict[int, List[DeviceOp]] = field(default_factory=dict)

    @property
    def window_s(self) -> float:
        return self.end - self.start


def load_events(path: Path) -> List[Dict]:
    data = json.loads(Path(path).read_text())
    events = data["traceEvents"] if isinstance(data, dict) else data
    return [e for e in events if e.get("ph") == "X"]


def _union(spans: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _phase(name: str) -> str:
    return "dispatch" if name.startswith(WAVE) else PHASES.get(name, "poll")


def _host_phases(a: float, b: float, ranges, starts
                 ) -> List[Tuple[float, float, str]]:
    """The device-idle span [a, b] cut by what the host was doing: the
    harness's ranges (sorted by start, not overlapping), ``poll``
    between them."""
    out, t = [], a
    for s, e, name in ranges[max(bisect.bisect_right(starts, a) - 1, 0):]:
        if s >= b:
            break
        if e <= t:
            continue
        if s > t:
            out.append((t, s - t, "poll"))
        end = min(e, b)
        out.append((max(s, t), end - max(s, t), _phase(name)))
        t = end
    if b > t:
        out.append((t, b - t, "poll"))
    return out


def summarize(events: List[Dict]) -> Optional[TraceSummary]:
    """The interval between the two marks; None when the trace holds no
    device operation there (a trace that came back empty)."""
    marks = {e["name"]: e["ts"] * 1e-6 for e in events
             if e.get("cat") == "user_annotation"
             and e["name"] in (MARK_START, MARK_END)}
    if MARK_START not in marks or MARK_END not in marks:
        return None
    t0, t1 = marks[MARK_START], marks[MARK_END]

    ranges = sorted((e["ts"] * 1e-6, (e["ts"] + e["dur"]) * 1e-6, e["name"])
                    for e in events if e.get("cat") == "user_annotation"
                    and e["name"].startswith("edgebench.")
                    and e["name"] not in (MARK_START, MARK_END))
    starts = [r[0] for r in ranges]

    def host_range(t: float) -> Optional[str]:
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and t <= ranges[i][1]:
            return ranges[i][2]
        return None

    launch = {e["args"]["correlation"]: e["ts"] * 1e-6 for e in events
              if e.get("cat") in LAUNCH_CATS
              and "correlation" in e.get("args", {})}
    wave_spans = {}
    for a, b, name in ranges:
        if name.startswith(WAVE):
            wave_spans[int(name[len(WAVE):])] = (a, b)

    ops, wave_ops = [], defaultdict(list)
    for e in events:
        if e.get("cat") not in DEVICE_CATS:
            continue
        a, b = e["ts"] * 1e-6, (e["ts"] + e["dur"]) * 1e-6
        wave = None
        t_launch = launch.get(e.get("args", {}).get("correlation"))
        if t_launch is not None:
            owner = host_range(t_launch)
            if owner and owner.startswith(WAVE):
                wave = int(owner[len(WAVE):])
        op = DeviceOp(e["name"], a, b)
        if wave is not None:
            wave_ops[wave].append(op)
        if b > t0 and a < t1:
            ops.append(op)
    if not ops:
        return None

    busy = _union([(max(o.start, t0), min(o.end, t1)) for o in ops])
    busy_s = sum(b - a for a, b in busy)
    gaps, prev = [], t0
    for a, b in busy + [(t1, t1)]:
        if a > prev:
            gaps.extend(_host_phases(prev, a, ranges, starts))
        prev = max(prev, b)
    # the waves read whole: dispatched inside the interval
    whole = {w: o for w, o in wave_ops.items()
             if t0 <= wave_spans[w][0] and wave_spans[w][1] <= t1}
    return TraceSummary(start=t0, end=t1, ops=ops, busy_s=busy_s,
                        gaps=gaps, wave_ops=whole)


def breakdown(summary: TraceSummary, n: int = 10) -> Dict[str, list]:
    """The device operations that took most time (by name, cut to its
    first ``NAME_CHARS`` characters) and the idle time by what the host
    was doing, each at most ``n`` entries."""
    by_op: Dict[str, float] = defaultdict(float)
    for o in summary.ops:
        by_op[o.name[:NAME_CHARS]] += min(o.end, summary.end) - max(o.start,
                                                       summary.start)
    by_gap: Dict[str, float] = defaultdict(float)
    for _, s, phase in summary.gaps:
        by_gap[phase] += s
    top = sorted(by_op.items(), key=lambda kv: -kv[1])[:n]
    idle = sorted(by_gap.items(), key=lambda kv: -kv[1])[:n]
    return {"device_ops": [[k, v] for k, v in top],
            "idle_gaps": [[k, v] for k, v in idle]}
