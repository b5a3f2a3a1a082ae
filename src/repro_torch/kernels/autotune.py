"""Tile autotuner for the port's tiled CUDA kernels: the reference's
``repro.kernels.autotune`` in PyTorch.

Each of four kernels launches a tile that a formula picks from the
shape (flash: ``m_tiles`` / ``HalfTile``; window: one window a block;
decode: ``plan()``; the int8 GEMM: ``tile_n()``), derived for one
shape each.  This module sweeps a small grid of tiles at ``warmup()``
time, times each candidate on the card with CUDA events, and caches the
winner on disk keyed ``(device kind, kernel, shape bucket)``, so later
processes skip the sweep.

Knobs (the reference's):

  ``REPRO_AUTOTUNE=0``       disable: every lookup gives the kernel's
                             default tile, and sweeps do nothing.
  ``REPRO_AUTOTUNE_CACHE``   the cache directory; the file is
                             ``<device kind>.json``, laid out kernel ->
                             bucket -> ``{"params", "us"}``.  The default
                             is ``build/autotune`` at the repository's
                             root (git-ignored, beside the built
                             kernels), not the reference's
                             ``~/.cache/repro/autotune``: the port keeps
                             what it writes inside its checkout.

Shape buckets round every dynamic size up to a power of two, so the
cache stays bounded.  A lookup miss gives the kernel's default tile,
never a sweep and never the plain version: sweeps run only from the
``tune_*`` entry points that the warmups call.  Every grid holds the
default, so a sweep can only tie with it or win.

The wrappers (``kernels/*/ops.py``) resolve their tile through
:func:`resolve`, which memoises :func:`block` per exact shape: a decode
step makes ~2,000 launches, so a lookup in steady state is one dict hit
(no lock, no string, no file).  :func:`record`,
:func:`clear_memory_cache` and :func:`refresh_from_env` clear the memo.

Off the card, candidate times say nothing about the card: sweeps are
skipped there unless ``force=True`` (the CPU tests drive the machinery
that way).  A sweep times only the kernels (the ``*_cuda`` wrappers),
never a plain version.  A candidate that raises is skipped, as in the
reference, and kept in :data:`FAILURES`; the launches a sweep makes are
moved off the kernels' counts into :data:`SWEEP_LAUNCHES`, so a serving
path's launch count holds its own launches only.
"""
from __future__ import annotations

import json
import os
import re
import threading
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

ENV_VAR = "REPRO_AUTOTUNE"
CACHE_ENV = "REPRO_AUTOTUNE_CACHE"

# candidate grids per kernel (the port's own; the TPU's bq / bk / wb / bs
# / bm-bn-bk do not carry over).  Each kernel's ops.py says which are
# valid at a shape (``tile_grid``) and which is its default, always one
# of them.
FLASH_CANDIDATES = {
    # float32: 16-row m-tiles a warp, 64 mt query rows a block
    "float32": ({"mt": 1}, {"mt": 2}),
    # fp16 / bf16: keys a tile and stages of the TMA ring
    "half": ({"bn": 128, "stages": 3}, {"bn": 128, "stages": 2},
             {"bn": 64, "stages": 3}, {"bn": 64, "stages": 2}),
}
WINDOW_CANDIDATES = ({"wb": 1}, {"wb": 2}, {"wb": 4})
DECODE_CANDIDATES = ({"n_split": 1}, {"n_split": 2}, {"n_split": 4},
                     {"n_split": 8})
MATMUL_CANDIDATES = ({"bn": 128}, {"bn": 256})

_LOCK = threading.Lock()
_TABLE: Dict[str, Dict[str, Dict]] = {}     # kernel -> bucket_key -> entry
_LOADED_FOR: Optional[str] = None           # device kind the table is for
_RESOLVED: Dict[tuple, Dict] = {}           # resolve()'s memo
_KIND: Optional[str] = None

_ENABLED: bool = os.environ.get(ENV_VAR, "1") != "0"
SPIN_CYCLES = 1_000_000     # the spin kernel ahead of each timed launch
DEFAULT_CACHE_DIR = Path(__file__).resolve().parents[3] / "build" / "autotune"

# what the sweeps did in this process: sweeps run (cache misses that
# timed candidates), candidates timed, host seconds in tune() and in
# making the tune_* entry points' inputs; the launches they
# made, per kernel; every candidate that raised; and each sweep's
# candidates with their times
STATS = {"sweeps": 0, "candidates": 0, "sweep_s": 0.0, "inputs_s": 0.0}
SWEEP_LAUNCHES: Dict[str, int] = {}
FAILURES: List[Dict] = []
SWEEP_LOG: List[Dict] = []


def refresh_from_env() -> bool:
    """Re-read ``REPRO_AUTOTUNE`` (it is read once at import, as
    ``kernels.dispatch`` reads ``REPRO_QUANT``); clears the memo."""
    global _ENABLED
    _ENABLED = os.environ.get(ENV_VAR, "1") != "0"
    _RESOLVED.clear()
    return _ENABLED


def enabled() -> bool:
    return _ENABLED


def device_kind() -> str:
    """The card's name (``torch.cuda.get_device_name(0)``), or ``cpu``
    where there is none, sanitised for a file name."""
    global _KIND
    if _KIND is None:
        kind = (torch.cuda.get_device_name(0) if torch.cuda.is_available()
                else "cpu")
        _KIND = re.sub(r"[^A-Za-z0-9._-]+", "_", kind)
    return _KIND


def on_card(device=None) -> bool:
    """True where ``device`` (default: the current CUDA device) is a card
    that this process can launch on."""
    dev = torch.device("cuda" if device is None else device)
    return dev.type == "cuda" and torch.cuda.is_available()


def cache_dir() -> Path:
    env = os.environ.get(CACHE_ENV)
    if env:
        return Path(env)
    return DEFAULT_CACHE_DIR


def cache_path(kind: Optional[str] = None) -> Path:
    return cache_dir() / f"{kind or device_kind()}.json"


def bucket_key(**dims) -> str:
    """Canonical bucket string: dims sorted by name, dynamic sizes
    rounded up to the next power of two."""
    parts = []
    for name in sorted(dims):
        val = dims[name]
        if isinstance(val, (int,)) and not isinstance(val, bool):
            val = _pow2(val)
        parts.append(f"{name}={val}")
    return ",".join(parts)


def _pow2(n: int) -> int:
    p = 1
    while p < max(1, n):
        p *= 2
    return p


def _dtype_name(dtype) -> str:
    """``jnp.dtype(x).name`` for a torch dtype: float32, float16,
    bfloat16, int8."""
    return str(dtype).replace("torch.", "")


# ---------------------------------------------------------------------------
# cache table


def _load(kind: str) -> None:
    global _LOADED_FOR
    if _LOADED_FOR == kind:
        return
    _TABLE.clear()
    path = cache_path(kind)
    try:
        _TABLE.update(json.loads(path.read_text()))
    except (OSError, ValueError):
        pass
    _LOADED_FOR = kind


def _save(kind: str) -> None:
    path = cache_path(kind)
    try:
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(".tmp")
        tmp.write_text(json.dumps(_TABLE, indent=1, sort_keys=True))
        tmp.replace(path)
    except OSError:
        pass                            # cache is best-effort


def clear_memory_cache() -> None:
    """Drop the in-process table and the memo (the disk file stays)."""
    global _LOADED_FOR
    with _LOCK:
        _TABLE.clear()
        _LOADED_FOR = None
        _RESOLVED.clear()


def lookup(kernel: str, bucket: str) -> Optional[Dict]:
    """Tuned params for (kernel, bucket) or None.  Never sweeps."""
    if not enabled():
        return None
    with _LOCK:
        _load(device_kind())
        entry = _TABLE.get(kernel, {}).get(bucket)
    return dict(entry["params"]) if entry else None


def block(kernel: str, bucket: str, default: Dict) -> Dict:
    """Resolved tile params: tuned winner if cached, else ``default``."""
    tuned = lookup(kernel, bucket)
    out = dict(default)
    if tuned:
        out.update({k: v for k, v in tuned.items() if k in out})
    return out


def record(kernel: str, bucket: str, params: Dict, us: float) -> None:
    with _LOCK:
        kind = device_kind()
        _load(kind)
        _TABLE.setdefault(kernel, {})[bucket] = {
            "params": dict(params), "us": float(us)}
        _save(kind)
        _RESOLVED.clear()


def resolve(key: tuple, bucket: Callable[..., str],
            default: Callable[..., Dict],
            valid: Callable[..., bool]) -> Dict:
    """The tile a wrapper launches for ``key``, the kernel's name and its
    exact shape: :func:`block` of ``bucket(*key[1:])`` over
    ``default(*key[1:])``, or the default where a cached winner is not
    ``valid(tile, *key[1:])`` at this shape (a bucket holds other shapes
    too).  Memoised: in steady state one dict hit."""
    tile = _RESOLVED.get(key)
    if tile is None:
        args = key[1:]
        dflt = default(*args)
        tile = block(key[0], bucket(*args), dflt)
        if tile != dflt and not valid(tile, *args):
            tile = dflt
        _RESOLVED[key] = tile
    return tile


# ---------------------------------------------------------------------------
# sweeping


def _time_us(fn: Callable[[], object], reps: int = 3,
             cuda: Optional[bool] = None) -> float:
    """Best of ``reps`` runs of ``fn`` after one warm run, in us: the
    reference's timer, on the card by CUDA events (:func:`_once_us`),
    elsewhere by the host clock."""
    return time_candidates([fn], reps, cuda)[0]


def _once_us(fn: Callable[[], object], cuda: bool) -> float:
    """One run of ``fn`` in us.  On the card by CUDA events around the
    launch, queued behind a short spin kernel so that the events time
    the device, not the host's enqueue."""
    if not cuda:
        t0 = time.perf_counter()
        fn()
        return (time.perf_counter() - t0) * 1e6
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    # ~0.5 ms at the boost clock, longer than a slow host takes to enqueue
    # the events and the wrapper's launch: the launch queues behind it
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) * 1e3


def time_candidates(fns: Sequence[Callable[[], object]], reps: int = 3,
                    cuda: Optional[bool] = None) -> List[float]:
    """The best of ``reps`` runs of each of ``fns``, in us, after one warm
    run of each.  The candidates take turns, one run each a round, so a
    clock that rises or falls through the sweep favours none of them
    (timed one after another, the first ran on a card still idle)."""
    if cuda is None:
        cuda = torch.cuda.is_available()
    for fn in fns:
        fn()                            # build + warm
    if cuda:
        torch.cuda.synchronize()
    best = [float("inf")] * len(fns)
    for _ in range(reps):
        for i, fn in enumerate(fns):
            best[i] = min(best[i], _once_us(fn, cuda))
    return best


class _HeldCounts:
    """Moves the launches made inside it off the kernels' counts into
    :data:`SWEEP_LAUNCHES`."""

    def __enter__(self):
        from repro_torch.kernels import dispatch
        self.kernels = dispatch.KERNELS
        self.saved = {n: (k.launches, dict(k.by_dtype), k.copies)
                      for n, k in self.kernels.items()}
        return self

    def __exit__(self, *exc):
        for n, k in self.kernels.items():
            launches, by_dtype, copies = self.saved[n]
            if k.launches > launches:
                SWEEP_LAUNCHES[n] = (SWEEP_LAUNCHES.get(n, 0)
                                     + k.launches - launches)
            k.launches, k.copies = launches, copies
            k.by_dtype.update(by_dtype)
        return False


def tune(kernel: str, bucket: str, candidates: Sequence[Dict],
         bench: Callable[[Dict], Optional[Callable[[], object]]], *,
         force: bool = False, reps: int = 3,
         device=None) -> Optional[Dict]:
    """Sweep ``candidates`` for (kernel, bucket); cache and return the
    winner.  ``bench(params)`` returns a nullary callable running the
    kernel with those params, or None when the candidate is invalid for
    the shape.  Returns the cached/tuned params, or None when tuning is
    disabled or skipped (off the card without force)."""
    if not enabled():
        return None
    cached = lookup(kernel, bucket)
    if cached is not None:
        return cached
    cuda = on_card(device)
    if not (cuda or force):
        return None
    t0 = time.perf_counter()
    runs: List[Tuple[Dict, Callable[[], object]]] = []
    with _HeldCounts():
        for params in candidates:
            fn = bench(dict(params))
            if fn is None:
                continue
            STATS["candidates"] += 1
            try:
                fn()                    # builds, launches and warms it
                runs.append((dict(params), fn))
            except Exception as exc:    # candidate failed to build / launch
                FAILURES.append({"kernel": kernel, "bucket": bucket,
                                 "params": dict(params),
                                 "error": f"{type(exc).__name__}: {exc}"})
        times = time_candidates([fn for _, fn in runs], reps, cuda) \
            if runs else []
    results = [(us, p) for us, (p, _) in zip(times, runs)]
    STATS["sweeps"] += 1
    STATS["sweep_s"] += time.perf_counter() - t0
    won = min(results, key=lambda r: r[0]) if results else None
    SWEEP_LOG.append({"kernel": kernel, "bucket": bucket,
                      "us": [(p, us) for us, p in results],
                      "winner": won[1] if won else None})
    if won is None:
        return None
    record(kernel, bucket, won[1], won[0])
    return won[1]


# ---------------------------------------------------------------------------
# kernel-specific entry points (called from warmup paths)


def window_bucket(B: int, T: int, H: int, Dh: int, window: int,
                  dtype) -> str:
    return bucket_key(bw=B * (T // window), h=H, dh=Dh, w=window,
                      dt=_dtype_name(dtype))


def flash_bucket(B: int, T: int, S: int, H: int, KV: int, Dh: int,
                 causal: bool, dtype) -> str:
    return bucket_key(b=B, t=T, s=S, h=H, kv=KV, dh=Dh, causal=causal,
                      dt=_dtype_name(dtype))


def decode_bucket(B: int, S: int, H: int, KV: int, Dh: int, dtype) -> str:
    return bucket_key(b=B, s=S, h=H, kv=KV, dh=Dh, dt=_dtype_name(dtype))


def matmul_bucket(M: int, N: int, K: int, act_dtype, weight_dtype) -> str:
    """GEMM bucket keyed on both operand dtypes, as the reference's.  The
    int8 GEMM's is ``(int8, int8)`` whatever its output type, so an
    int8+fp16 lane and an int8+fp32 lane share winners (the reference's
    key, kept)."""
    return bucket_key(m=M, n=N, k=K, adt=_dtype_name(act_dtype),
                      wdt=_dtype_name(weight_dtype))


def _sweeps(kernel: str, bucket: str, device, force: bool) -> bool:
    """Whether a ``tune_*`` call would sweep: enabled, no cached winner,
    and on the card (or forced).  Checked before any input is made, so
    a warmup that finds its winners on disk allocates nothing."""
    return (enabled() and lookup(kernel, bucket) is None
            and (on_card(device) or force))


def _randn(gen, shape, dtype, device):
    return torch.randn(shape, generator=gen, device=device).to(dtype)


def tune_window(B: int, T: int, H: int, Dh: int, window: int, *,
                KV: Optional[int] = None, dtype=torch.float32,
                force: bool = False, device="cuda") -> Optional[Dict]:
    from repro_torch.kernels.window_attention import ops as _win
    KV = H if KV is None else KV
    bucket = window_bucket(B, T, H, Dh, window, dtype)
    if not _sweeps("window_attention", bucket, device, force):
        return lookup("window_attention", bucket) if enabled() else None
    t0 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(0)
    q = _randn(gen, (B, T, H, Dh), dtype, device)
    k = _randn(gen, (B, T, KV, Dh), dtype, device)
    v = _randn(gen, (B, T, KV, Dh), dtype, device)
    grid = _win.tile_grid(B, T, H, Dh, window)

    def bench(params):
        if params not in grid:
            return None
        return lambda: _win.window_attention_cuda(q, k, v, window, **params)

    STATS["inputs_s"] += time.perf_counter() - t0
    return tune("window_attention", bucket, WINDOW_CANDIDATES, bench,
                force=force, device=device)


def tune_flash(B: int, T: int, S: int, H: int, Dh: int, *,
               KV: Optional[int] = None, causal: bool = False,
               dtype=torch.float32, force: bool = False,
               device="cuda") -> Optional[Dict]:
    from repro_torch.kernels.flash_attention import ops as _flash
    KV = H if KV is None else KV
    bucket = flash_bucket(B, T, S, H, KV, Dh, causal, dtype)
    if not _sweeps("flash_attention", bucket, device, force):
        return lookup("flash_attention", bucket) if enabled() else None
    t0 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(0)
    q = _randn(gen, (B, T, H, Dh), dtype, device)
    k = _randn(gen, (B, S, KV, Dh), dtype, device)
    v = _randn(gen, (B, S, KV, Dh), dtype, device)
    grid = _flash.tile_grid(Dh, dtype)

    def bench(params):
        if params not in grid:
            return None
        return lambda: _flash.flash_attention_cuda(q, k, v, causal, **params)

    STATS["inputs_s"] += time.perf_counter() - t0
    return tune("flash_attention", bucket,
                FLASH_CANDIDATES[_flash.precision(dtype)], bench,
                force=force, device=device)


def tune_decode(B: int, S: int, H: int, Dh: int, *,
                KV: Optional[int] = None, dtype=torch.float32,
                force: bool = False, device="cuda") -> Optional[Dict]:
    from repro_torch.kernels.decode_attention import ops as _dec
    KV = H if KV is None else KV
    bucket = decode_bucket(B, S, H, KV, Dh, dtype)
    if not _sweeps("decode_attention", bucket, device, force):
        return lookup("decode_attention", bucket) if enabled() else None
    t0 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(0)
    q = _randn(gen, (B, 1, H, Dh), dtype, device)
    k = _randn(gen, (B, S, KV, Dh), dtype, device)
    v = _randn(gen, (B, S, KV, Dh), dtype, device)
    kv_len = torch.full((B,), S, dtype=torch.int32, device=device)
    default = _dec.default_tile(B, KV, H // KV, S, _dec.sm_count(device))
    grid = _dec.tile_grid(B, KV, H // KV, S, _dec.sm_count(device))
    # the default (plan()'s split, which may be none of the grid's) first
    cands = [default] + [c for c in DECODE_CANDIDATES if c != default]

    def bench(params):
        if params not in grid:
            return None
        return lambda: _dec.decode_attention_cuda(q, k, v, kv_len, **params)

    STATS["inputs_s"] += time.perf_counter() - t0
    return tune("decode_attention", bucket, cands, bench, force=force,
                device=device)


def tune_matmul(M: int, N: int, K: int, *, out_dtype=torch.float32,
                force: bool = False, device="cuda") -> Optional[Dict]:
    """Sweep the int8 GEMM's tile width for an (M, N, K) shape bucket."""
    from repro_torch.kernels.int8_matmul import ops as _mm
    bucket = matmul_bucket(M, N, K, torch.int8, torch.int8)
    if not _sweeps("int8_matmul", bucket, device, force):
        return lookup("int8_matmul", bucket) if enabled() else None
    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    xq = torch.as_tensor(rng.integers(-127, 128, (M, K), dtype=np.int8)
                         ).to(device)
    # K-contiguous codes, as QuantTensor keeps them
    wq = torch.as_tensor(rng.integers(-127, 128, (N, K), dtype=np.int8)
                         ).to(device).t()
    sx = torch.ones((M,), dtype=torch.float32, device=device)
    sw = torch.ones((N,), dtype=torch.float32, device=device)

    def bench(params):
        return lambda: _mm.int8_matmul_cuda(xq, wq, sx, sw, out_dtype,
                                            **params)

    STATS["inputs_s"] += time.perf_counter() - t0
    return tune("int8_matmul", bucket, MATMUL_CANDIDATES, bench,
                force=force, device=device)
