"""One run of one cell: build the program from the cell's configuration,
warm up the shapes its traffic uses, serve the traffic for a window,
check what was served against the plain reference, and report.

Everything a cell is made of is found by name: its configuration in the
file ``BENCHMARK.json`` names, its traffic in ``traffic/<mix>.json``,
each per-layer metric's reader in ``metrics/<metric>.py`` (or, for a
metric split by cell as ``<metric>.<part>``, ``metrics/<metric>.py``).

The serving loop is the benchmark's own: the program has no wall-clock
serving loop.  Arrivals queue at their due time; waves form in arrival
order, at most ``max_wave`` frames; while one wave computes, the next is
staged and dispatched ahead of it (``ServerModel.stage_frames`` and
``infer_wave(..., defer=True)``), then the older wave's
``PendingWave.wait()`` decodes its detections: the continuous
scheduler's overlapped path.  An offload's latency runs from its due
arrival at the server to its detections decoded on the host.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import heapq
import importlib.util
import json
import math
import os
import sys
import tempfile
import time
from collections import deque
from pathlib import Path
from types import SimpleNamespace
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from edgebench import compare, trace_read, weights
from edgebench import traffic_gen as tg
from edgebench.reference import vitdet_ref as ref

BENCH_DIR = Path(__file__).resolve().parent
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "repro")
TRACE_WARM_S = 0.5        # the profiler settles before the interval read
TRACE_S = 2.0             # the interval the device metrics are read over
TRACE_TRIES = 3           # traced intervals tried before giving up
DRAIN_S = 60.0            # an offload still unanswered this long after
                          # the window closed counts as failed


# ---------------------------------------------------------------------------
# the cell


@dataclasses.dataclass
class Cell:
    name: str
    config: Dict
    mix: Dict
    end_to_end: List[Dict]
    per_layer: List[Dict]
    bench_dir: Path


def load_cell(manifest_path: Path, name: str) -> Cell:
    """The cell ``name`` of a manifest, with its files found by name."""
    root = Path(manifest_path).resolve().parent
    man = json.loads(Path(manifest_path).read_text())
    bench_dir = root / man["paths"][0]
    cells = {w["name"]: w for w in man["workloads"]}
    if name not in cells:
        raise KeyError(f"no cell {name!r}; have {sorted(cells)}")
    wl = cells[name]
    cfg = {c["name"]: c for c in man["configs"]}[wl["config"]]
    config = json.loads((root / cfg["file"]).read_text())
    mix = tg.load_mix(bench_dir / "traffic" / f"{wl['traffic']}.json")
    e2e = [m for m in man["end_to_end"] if name in m.get("workloads", [name])]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in man["per_layer"]
                 if (name in m["workloads"] if "workloads" in m
                     else m["moves"] in reported)]
    return Cell(name, config, mix, e2e, per_layer, bench_dir)


def reader(bench_dir: Path, metric: str) -> Callable:
    """The ``read`` function of a per-layer metric's own file."""
    d = Path(bench_dir) / "metrics"
    path = d / f"{metric}.py"
    if not path.exists():
        path = d / f"{metric.split('.')[0]}.py"
    spec = importlib.util.spec_from_file_location(
        f"edgebench_metric_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


# ---------------------------------------------------------------------------
# the program


def prepare_environment(root: Path) -> None:
    """Put the program on the path and its caches at fixed paths inside
    the checkout (the kernels' libraries go to ``build/`` by the
    program's own rule), before any of it is imported."""
    build = Path(root) / "build"
    os.environ["REPRO_AUTOTUNE"] = "1"
    os.environ["REPRO_AUTOTUNE_CACHE"] = str(build / "autotune")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ.pop("REPRO_QUANT", None)
    if str(Path(root) / "src") not in sys.path:
        sys.path.insert(0, str(Path(root) / "src"))


def load_program() -> SimpleNamespace:
    """The port's modules that a run drives."""
    from repro_torch.configs import get_config
    from repro_torch.core import vit_backbone
    from repro_torch.core.partition import RegionPlan
    from repro_torch.offload.simulator import ServerModel
    from repro_torch.quant.ptq import QuantSpec
    from repro_torch.serve.request import FeatureCache
    return SimpleNamespace(get_config=get_config, vit_backbone=vit_backbone,
                           RegionPlan=RegionPlan, ServerModel=ServerModel,
                           QuantSpec=QuantSpec, FeatureCache=FeatureCache)


def model_config(prog, config: Dict):
    """The port's config of ``config["model"]`` at the file's sizes."""
    s = config["sizes"]
    base = prog.get_config(config["model"])
    vit = dataclasses.replace(
        base.vit, img_size=(s["img_size"], s["img_size"]),
        patch_size=s["patch_size"], window_size=s["window_size"],
        n_subsets=s["n_subsets"], out_channels=s["out_channels"],
        n_classes=s["n_classes"])
    mixed = dataclasses.replace(base.mixed_res, window=s["window_size"],
                                downsample=s["downsample"],
                                n_subsets=s["n_subsets"])
    return base.replace(
        n_layers=s["n_layers"], d_model=s["d_model"], n_heads=s["n_heads"],
        n_kv_heads=s["n_heads"], head_dim=s["head_dim"], d_ff=s["d_ff"],
        norm_eps=s["norm_eps"],
        max_seq_len=(s["img_size"] // s["patch_size"]) ** 2,
        vit=vit, mixed_res=mixed)


def sub_seed(seed: int, k: int) -> int:
    """A 63-bit seed of its own for use ``k`` of ``seed``."""
    state = np.random.SeedSequence([seed % 2 ** 64, 77, k])
    return int(state.generate_state(1, np.uint64)[0] >> np.uint64(1))


def raw_weights(sizes: Dict, seed: int, device) -> Dict:
    """The tree both sides get (``weights.draw``), from ``seed``."""
    return weights.draw(sizes, sub_seed(seed, 1), device)


def make_weights(prog, cfg, sizes: Dict, seed: int, device) -> Dict:
    """The program's tree: the raw tree, with the position layouts the
    program derives from its grid."""
    return prog.vit_backbone.add_position_banks(
        cfg, raw_weights(sizes, seed, device))


def make_frames(seed: int, n: int, size: int, device) -> List[np.ndarray]:
    """The pool of decoded frames, on the host."""
    g = torch.Generator(device=device).manual_seed(sub_seed(seed, 2))
    x = torch.rand((n, size, size, 3), generator=g, device=device)
    host = x.cpu().numpy()
    return [host[i] for i in range(n)]


def make_server(prog, cfg, params, config: Dict, quant: Optional[Dict],
                device):
    srv = config["serving"]
    q = None if quant is None else prog.QuantSpec(
        quant["weight_dtype"], quant["act_dtype"], quant["prune_heads"])
    return prog.ServerModel(
        cfg, params, top_k=srv["top_k"], score_thresh=srv["score_thresh"],
        b_buckets=tuple(srv["b_buckets"]),
        n_length_buckets=srv["n_length_buckets"], device=str(device),
        quant=q)


# ---------------------------------------------------------------------------
# the serving loop


@dataclasses.dataclass
class WaveRecord:
    wid: int
    t_dispatch: float
    offloads: List[tg.Offload]
    Bp: int
    lb: int                       # length bucket (windows); 0: full res
    rows_valid: List[int]         # windows of each computed row
    dispatch_s: float             # host seconds inside infer_wave

    @property
    def B(self) -> int:
        return len(self.offloads)

    @property
    def full_res(self) -> bool:
        return self.lb == 0


class ServingLoop:
    """Closed-loop clients against one ``ServerModel`` on one clock."""

    def __init__(self, server, prog, clients: List[tg.Client],
                 frames: List[np.ndarray], mix: Dict, seed: int,
                 clock: Callable[[], float] = time.perf_counter):
        self.server, self.prog, self.clients = server, prog, clients
        self.frames, self.mix, self.clock = frames, mix, clock
        self.mixed = mix["plans"] == "mixed"
        self.beta = mix["beta"]
        nR = server.part.n_regions
        self.caches = ([prog.FeatureCache(nR, max_age=mix["max_age"])
                        for _ in clients] if self.mixed else None)
        self.checked = set(tg.checked_clients(mix, seed)) if self.mixed \
            else set()
        self.cuda = server.device.type == "cuda"
        self.heap: List[Tuple[float, int, int]] = []
        self.ready: deque = deque()
        self.inflight: deque = deque()
        self.waves: List[WaveRecord] = []
        self.snapshots: Dict[Tuple[int, int], torch.Tensor] = {}
        self.t0 = 0.0
        self.t_stop = math.inf
        self.annotate = None          # record_function while tracing
        self._pending: Dict[Tuple[int, int], tg.Offload] = {}

    def _ann(self, name: str):
        return self.annotate(name) if self.annotate else \
            contextlib.nullcontext()

    def _send(self, off: tg.Offload, t_send: float) -> None:
        c = self.clients[off.client]
        off.due = t_send + c.uplink_s(off.nbytes, t_send - self.t0)
        if off.due < self.t_stop:
            heapq.heappush(self.heap, (off.due, off.client, off.seq))
            self._pending[(off.client, off.seq)] = off

    def start(self, t0: float) -> None:
        self.t0 = t0
        for c in self.clients:
            self._send(c.next_offload(), t0 + c.start_s)

    def restart(self, now: float) -> None:
        """Send again each client's offload that the stop held back."""
        self.t_stop = math.inf
        for c in self.clients:
            off = c.history[-1]
            if off.dets is None and (c.idx, off.seq) not in self._pending:
                self._send(off, now)

    def _dispatch(self) -> None:
        n = min(len(self.ready), self.mix["max_wave"])
        offs = [self.ready.popleft() for _ in range(n)]
        srv = self.server
        plans = [self.prog.RegionPlan(o.states) for o in offs]
        caches = None
        if self.mixed:
            caches = [self.caches[o.client] for o in offs]
            for o, c in zip(offs, caches):
                reuse = o.states == tg.REUSE
                if reuse.any() and not c.eligible(self.beta)[reuse].all():
                    raise RuntimeError(
                        f"client {o.client} offload {o.seq}: the traffic "
                        "reuses a region its session cannot serve")
        Bp = srv.batch_bucket(n)
        full = all(o.full_res for o in offs)
        lb = 0 if full else srv.length_bucket(max(o.n_windows for o in offs))
        nw_full = srv.part.n_regions * srv.part.windows_per_full_region
        rows = [(o.n_windows if lb else nw_full) for o in offs]
        rows += rows[:1] * (Bp - n)
        wid = len(self.waves)
        t_a = self.clock()
        with self._ann(f"{trace_read.WAVE}{wid}"):
            staged = srv.stage_frames([self.frames[o.frame] for o in offs])
            t_b = self.clock()
            pending = srv.infer_wave(
                staged, plans, beta=self.beta, caches=caches,
                frame_ids=[o.seq for o in offs],
                capture_beta=self.beta if self.mixed else 0, defer=True)
            t_c = self.clock()
        event = None
        if self.cuda:
            event = torch.cuda.Event()
            event.record()
        rec = WaveRecord(wid, t_a, offs, Bp, lb, rows, t_c - t_b)
        self.waves.append(rec)
        self.inflight.append((rec, pending, event))

    def _complete(self) -> None:
        rec, pending, _ = self.inflight.popleft()
        with self._ann("edgebench.wait"):
            dets = pending.wait()
        t = self.clock()
        with self._ann("edgebench.complete"):
            for off, d in zip(rec.offloads, dets):
                off.done, off.dets = t, d
                del self._pending[(off.client, off.seq)]
                if off.client in self.checked:
                    self.snapshots[(off.client, off.seq)] = \
                        self.caches[off.client].tiles.clone()
                self._send(self.clients[off.client].next_offload(), t)

    def run(self, hooks: List[Tuple[float, Callable[[], None]]]) -> None:
        """Serve until every offload sent has come back, or until
        ``DRAIN_S`` past ``t_stop``.  Each hook (a time and a function)
        runs once, when the clock passes its time; a hook may add hooks
        to the list and move ``t_stop``."""
        while self.heap or self.ready or self.inflight:
            now = self.clock()
            for h in [h for h in hooks if now >= h[0]]:
                hooks.remove(h)
                h[1]()
            if now > self.t_stop + DRAIN_S:
                break
            while self.heap and self.heap[0][0] <= now:
                _, c, s = heapq.heappop(self.heap)
                self.ready.append(self._pending[(c, s)])
            if self.ready and len(self.inflight) < 2:
                self._dispatch()
            elif self.inflight:
                _, _, event = self.inflight[0]
                if len(self.inflight) == 2 or event is None or \
                        event.query():
                    self._complete()
        while hooks:
            hooks.pop(0)[1]()


# ---------------------------------------------------------------------------
# a run


def process_start() -> float:
    """The process's start on ``time.perf_counter``'s clock."""
    now = time.perf_counter()
    try:
        ticks = os.sysconf("SC_CLK_TCK")
        up = float(Path("/proc/uptime").read_text().split()[0])
        stat = Path("/proc/self/stat").read_text()
        start = int(stat.rsplit(")", 1)[1].split()[19]) / ticks
        return now - max(up - start, 0.0)
    except (OSError, ValueError, IndexError):
        return now


def warm(server, loop: ServingLoop, mix: Dict) -> None:
    """Run every grid key the traffic uses once (``ServerModel.warmup``,
    which also sweeps the kernels' tiles on the card, winners cached on
    disk), then one wave through the serving path at each wave size, so
    the pinned host buffers and the side stream exist before the
    window."""
    beta = mix["beta"]
    if loop.mixed:
        space = server.default_plan_space(betas=[beta], captures=(beta,))
    else:
        space = [(0, 0, 0, 0)]
    buckets = tuple(mix["batch_buckets"])
    server.warmup(space, batch_buckets=buckets)
    nR = server.part.n_regions
    for b in buckets:
        plans = [loop.prog.RegionPlan(np.zeros((nR,), np.int8))] * b
        staged = server.stage_frames(
            [loop.frames[i % len(loop.frames)] for i in range(b)])
        server.infer_wave(staged, plans, defer=True).wait()
    if loop.cuda:
        torch.cuda.synchronize()


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: Optional[float] = None,
             quant: Optional[Dict] = "config",
             control_arith: Optional[ref.Arith] = None,
             clock: Callable[[], float] = time.perf_counter,
             numbers_out: Optional[Dict] = None) -> Dict:
    """One run; returns the result's fields (``checks`` last).

    ``clock`` times the serving loop (the CPU tests give one that steps
    a fixed amount a reading, so how much a window serves does not hang
    on how busy the machine is).

    ``quant`` overrides the configuration's precision lane and
    ``control_arith`` puts the reference at that arithmetic in the
    program's place in the check: both serve the lower-precision control
    (``control.py``), never a benchmark run.  ``numbers_out``, where
    given, receives every number the check read, compared or not (the
    readings a limit is set from)."""
    t_start = process_start() if t_start is None else t_start
    dev = torch.device(device)
    prog = load_program()
    cfg = model_config(prog, cell.config)
    mix = cell.mix
    params = make_weights(prog, cfg, cell.config["sizes"], seed, dev)
    server = make_server(prog, cfg, params,
                         cell.config, cell.config["quant"]
                         if quant == "config" else quant, dev)
    del params
    part = server.part
    clients = tg.make_clients(mix, part.n_regions,
                              part.windows_per_full_region, seed)
    frames = make_frames(seed, mix["frame_pool"], cfg.vit.img_size[0], dev)
    loop = ServingLoop(server, prog, clients, frames, mix, seed, clock)
    warm(server, loop, mix)
    steady_before = server.stats.steady_compiles
    # what set-up made lives on; the collector need not walk it
    gc.collect()
    gc.freeze()

    t_begin = clock()
    t0 = t_begin + mix["preroll_s"]
    t_close = t0 + seconds
    loop.t_stop = t_close
    hooks: List[Tuple[float, Callable[[], None]]] = []
    tracer = None
    if trace:
        tracer = Tracer(loop, hooks)
        loop.t_stop = math.inf
        hooks.append((t_close, tracer.start))
    loop.start(t_begin)
    loop.run(hooks)
    summary = None
    for _ in range(TRACE_TRIES if tracer else 0):
        summary = tracer.finish()
        if summary is not None or not loop.cuda:
            break
        # CUPTI handed back an empty trace: the clients send again and
        # another interval is traced
        loop.restart(clock())
        hooks.append((clock(), tracer.start))
        loop.run(hooks)
    gc.unfreeze()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)

    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": (torch.cuda.get_device_name(dev)
                            if dev.type == "cuda" else "cpu"),
                   "count": 1,
                   "memory_peak_bytes": (torch.cuda.max_memory_allocated(dev)
                                         if dev.type == "cuda" else 0)}
    offs = [o for c in clients for o in c.history if t0 <= o.due < t_close]
    answered = [o for o in offs if o.dets is not None]
    steady = server.stats.steady_compiles - steady_before
    window = [w for w in loop.waves if t0 <= w.t_dispatch < t_close]
    result = {"correct": None, "attempted": len(offs),
              "failed": len(offs) - len(answered)}
    if trace:
        readings = Readings(cell.config, mix, seconds, window, offs,
                            summary, peaks(), loop.waves)
        metrics = {}
        for m in cell.per_layer:
            v = reader(cell.bench_dir, m["name"])(readings)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        device_info["busy_s"] = summary.busy_s if summary else 0.0
        device_info["window_s"] = summary.window_s if summary else TRACE_S
    else:
        lat = np.array([o.done - o.due for o in answered]) * 1e3
        done = [o.done for c in clients for o in c.history
                if o.dets is not None]
        values = {
            "offloads_per_s": completed_between(done, t0, t_close) / seconds,
            "offload_p50_ms": float(np.percentile(lat, 50)) if len(lat)
            else math.inf,
            "offload_p95_ms": float(np.percentile(lat, 95)) if len(lat)
            else math.inf,
            "setup_s": t0 - t_start}
        # a metric split by cell (``<metric>.<part>``) is its quantity's
        metrics = {m["name"]: {"value": values[m["name"].split(".")[0]],
                               "unit": m["unit"]} for m in cell.end_to_end}
    result["metrics"] = metrics
    result["device"] = device_info
    if summary is not None:
        result["breakdown"] = trace_read.breakdown(summary)
    log(f"{cell.name}: {len(answered)}/{len(offs)} offloads answered, "
        f"{len(window)} waves, {steady} first uses of a grid key after "
        "warmup")

    # the program's state goes before the reference runs
    del server, loop.server
    loop.caches = None
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    numbers = check(prog, cfg, cell, seed, clients, loop, frames, dev,
                    control_arith, t0)
    if numbers_out is not None:
        numbers_out.update(numbers)
    limits = cell.config["limits"]
    result["correct"] = bool(compare.verdict(numbers, limits)
                             and result["failed"] == 0 and steady == 0)
    result["checks"] = compare.checks_line(numbers, limits)
    return result


def completed_between(done: List[float], t0: float, t1: float) -> float:
    """Offloads completed from ``t0`` to ``t1``, given each answered
    offload's completion time.  A wave's offloads complete together, so
    a bare count moves by a whole wave as the window's edges fall; here
    the offloads that complete at a time are done over the interval
    since the completion before it, and count by the share of that
    interval inside the window."""
    times = sorted(set(done))
    n = {t: 0 for t in times}
    for t in done:
        n[t] += 1
    total = 0.0
    for a, b in zip(times, times[1:]):
        inside = min(b, t1) - max(a, t0)
        if inside > 0:
            total += n[b] * inside / (b - a)
    return total


def check(prog, cfg, cell: Cell, seed: int, clients, loop: ServingLoop,
          frames, dev, control_arith: Optional[ref.Arith],
          t0: float) -> Dict:
    """The served detections (and, with a session, the captured tiles)
    of a seeded sample of the offloads due from ``t0`` on and answered,
    against the reference run on weights made again from the seed.  Of
    each checked client's candidates the one with most windows is
    always taken; with a session, the candidates are the offloads whose
    tiles were kept, and the reference replays the session's plans from
    its bootstrap to find each REUSE tile's source."""
    mix = cell.mix
    raw = raw_weights(cell.config["sizes"], seed, dev)
    g = ref.Geometry.from_sizes(cell.config["sizes"])
    R = ref.ViTDetRef(g, raw)
    C = ref.ViTDetRef(g, raw, control_arith) if control_arith else None
    rng = tg.rng_for(seed, 6)
    per = mix["check"]["per_client"]
    numbers: Dict[str, float] = {}
    beta = mix["beta"]
    top_k = cell.config["serving"]["top_k"]
    clients_checked = (sorted(loop.checked) if loop.mixed else
                       sorted(rng.choice(len(clients), min(
                           mix["check"]["clients"], len(clients)),
                           replace=False).tolist()))
    n_checked = 0
    with torch.no_grad():
        for ci in clients_checked:
            hist = clients[ci].history
            cand = [o.seq for o in hist if o.dets is not None
                    and o.due >= t0 and (not loop.mixed
                                         or (ci, o.seq) in loop.snapshots)]
            if not cand:
                continue
            longest = max(cand, key=lambda k: hist[k].n_windows)
            rest = [k for k in cand if k != longest]
            pick = rng.choice(rest, min(per - 1, len(rest)),
                              replace=False).tolist() if rest else []
            seqs = sorted([longest] + pick)
            plans = [o.states for o in hist]
            sources: Dict[Tuple[int, int], torch.Tensor] = {}

            def run(model, k):
                """Offload ``k`` through ``model``, its REUSE tiles from
                the offloads that last transmitted them, by ``model``."""
                reuse = {}
                for r, j in ref.reuse_sources(plans, k).items():
                    if (id(model), j) not in sources:
                        sources[id(model), j] = model.forward(
                            torch.from_numpy(frames[hist[j].frame]).to(dev),
                            plans[j], beta, stop_at_restore=True).tiles
                    reuse[r] = sources[id(model), j][r]
                img = torch.from_numpy(frames[hist[k].frame]).to(dev)
                return model.forward(img, plans[k], beta, reuse)

            for k in seqs:
                out = run(R, k)
                dets, tiles = hist[k].dets, loop.snapshots.get((ci, k))
                if C is not None:
                    served = run(C, k)
                    b, s, c = served.top_k(top_k)
                    dets = [{"box": tuple(bb.tolist()), "score": float(ss),
                             "cls": int(cc)} for bb, ss, cc in zip(b, s, c)]
                    tiles = served.tiles
                compare.merge(numbers, compare.detection_gaps(
                    dets, out.probs, out.boxes))
                if loop.mixed:
                    compare.merge(numbers, {"tile_err": compare.tile_error(
                        tiles, out.tiles)})
                n_checked += 1
    if n_checked == 0:
        numbers = {k: math.nan for k in compare.NUMBERS
                   if loop.mixed or k != "tile_err"}
    log(f"checked {n_checked} offloads of clients {clients_checked}")
    return numbers


# ---------------------------------------------------------------------------
# tracing and the per-layer readings


@dataclasses.dataclass
class Readings:
    """What a per-layer reader reads: the configuration and mix, the
    measured window's waves (host spans and the program's buckets), and
    the traced interval's device operations."""
    config: Dict
    mix: Dict
    window_s: float
    waves: List[WaveRecord]           # dispatched in the window
    offloads: List[tg.Offload]        # due in the window
    trace: Optional[trace_read.TraceSummary]
    peaks: Dict
    all_waves: List[WaveRecord]       # the run's, traced ones among them

    @property
    def sizes(self) -> Dict:
        return self.config["sizes"]

    @property
    def dtype(self) -> str:
        return self.config["precision"]

    def traced_waves(self) -> List[Tuple[WaveRecord, list]]:
        if self.trace is None:
            return []
        return [(self.all_waves[i], ops)
                for i, ops in self.trace.wave_ops.items()]


def peaks() -> Dict:
    return json.loads((BENCH_DIR / "peaks.json").read_text())


class Tracer:
    """The profiler (CPU and CUDA activity) from the window's close: it
    settles for ``TRACE_WARM_S``, then the interval read runs
    ``TRACE_S`` while the traffic goes on; the trace goes through a
    temporary file under ``TMPDIR``.  CUPTI now and then hands back an
    empty trace: the interval is then read as having none."""

    def __init__(self, loop: ServingLoop, hooks: list):
        self.loop, self.hooks = loop, hooks
        self.prof = None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile, record_function
        acts = [ProfilerActivity.CPU]
        if self.loop.cuda:
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.start()
        self.loop.annotate = record_function
        t = self.loop.clock() + TRACE_WARM_S
        self.loop.t_stop = t + TRACE_S
        self.hooks.append((t, lambda: self.mark(trace_read.MARK_START)))
        self.hooks.append((t + TRACE_S,
                           lambda: self.mark(trace_read.MARK_END)))

    def mark(self, name: str) -> None:
        with self.loop.annotate(name):
            pass

    def finish(self) -> Optional[trace_read.TraceSummary]:
        if self.prof is None:
            return None
        if self.loop.cuda:
            torch.cuda.synchronize()
        self.prof.stop()
        self.loop.annotate = None
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            events = trace_read.load_events(Path(path))
        finally:
            os.unlink(path)
        summary = trace_read.summarize(events)
        if summary is None:
            log("the trace holds no device operation in the interval")
        return summary


def log(msg: str) -> None:
    print(f"[edgebench] {msg}", file=sys.stderr, flush=True)


def forbidden_modules(names=None) -> List[str]:
    """Top-level names among ``names`` (default: the modules loaded)
    that the benchmark must not load, compared as whole words."""
    return sorted({m.split(".")[0] for m in (names or sys.modules)}
                  & set(FORBIDDEN_MODULES))
