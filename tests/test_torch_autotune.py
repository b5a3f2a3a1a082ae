"""The port's kernel autotuner (``repro_torch.kernels.autotune``) against
the reference's (``repro.kernels.autotune``): the cache machinery, the
disk round trip, the ``REPRO_AUTOTUNE=0`` escape hatch, the bucket
strings character for character, and each wrapper's default tile with
an empty cache.

The reference's own autotune tests (``tests/test_autotune.py``, two of
``tests/test_quant.py``) have their counterparts here.  Off the card a
sweep times nothing unless forced, as off-TPU in the reference; where
the reference swept its Pallas kernels in interpret mode, these tests
replace the ``*_cuda`` call by a recorder (no sweep ever times a plain
version).  Every test points ``REPRO_AUTOTUNE_CACHE`` at its own
``tmp_path``.  ``tests/test_torch_autotune_card.py`` (``cuda``-marked,
no JAX) sweeps the four kernels on the card."""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import autotune as jat
from repro_torch import convert
from repro_torch.configs import get_reduced
from repro_torch.configs.vitdet_l import SIM
from repro_torch.kernels import autotune
from repro_torch.kernels.decode_attention import ops as dec
from repro_torch.kernels.flash_attention import ops as flash
from repro_torch.kernels.int8_matmul import ops as i8
from repro_torch.kernels.window_attention import ops as win
from repro_torch.models import registry
from repro_torch.offload.simulator import ServerModel
from repro_torch.serve.engine import ServeConfig, ServeEngine

torch.set_num_threads(2)
JNP = {torch.float32: jnp.float32, torch.float16: jnp.float16,
       torch.bfloat16: jnp.bfloat16, torch.int8: jnp.int8}


@pytest.fixture()
def tmp_cache(tmp_path, monkeypatch):
    monkeypatch.setenv(autotune.CACHE_ENV, str(tmp_path))
    monkeypatch.delenv(autotune.ENV_VAR, raising=False)
    autotune.refresh_from_env()
    autotune.clear_memory_cache()
    yield tmp_path
    autotune.clear_memory_cache()


# ---------------------------------------------------------------------------
# the reference's tests/test_autotune.py, ported


def test_bucket_key_rounds_to_pow2():
    assert autotune.bucket_key(b=3, h=8) == "b=4,h=8"
    assert autotune.bucket_key(t=100, dt="float32") == "dt=float32,t=128"
    # stable ordering regardless of kwarg order
    assert autotune.bucket_key(b=2, a=1) == autotune.bucket_key(a=1, b=2)


def test_block_falls_back_to_default(tmp_cache):
    out = autotune.block("window_attention", "b=1", win.DEFAULT_TILE)
    assert out == win.DEFAULT_TILE
    assert not list(tmp_cache.iterdir())        # a miss writes nothing


def test_tune_records_and_persists(tmp_cache):
    calls = []

    def bench(params):
        calls.append(params["x"])
        return lambda: torch.zeros((1,))

    won = autotune.tune("fake_kernel", "b=1", ({"x": 1}, {"x": 2}), bench,
                        force=True, reps=1, device="cpu")
    assert won in ({"x": 1}, {"x": 2})
    assert sorted(calls) == [1, 2]
    # in-memory hit
    assert autotune.lookup("fake_kernel", "b=1") == won
    # disk round trip: a fresh process (cleared memory) reloads it
    autotune.clear_memory_cache()
    assert autotune.lookup("fake_kernel", "b=1") == won
    data = json.loads(autotune.cache_path().read_text())
    assert data["fake_kernel"]["b=1"]["params"] == won
    assert set(data["fake_kernel"]["b=1"]) == {"params", "us"}
    # a second tune call is a cache hit: bench never runs again
    calls.clear()
    assert autotune.tune("fake_kernel", "b=1", ({"x": 1}, {"x": 2}), bench,
                         force=True, device="cpu") == won
    assert calls == []


def test_tune_skips_invalid_and_failing_candidates(tmp_cache):
    def bench(params):
        if params["x"] == 1:
            return None                      # invalid for the shape
        if params["x"] == 2:
            def boom():
                raise RuntimeError("launch failed")
            return boom
        return lambda: torch.zeros((1,))

    failed = len(autotune.FAILURES)
    won = autotune.tune("fake2", "b=1", ({"x": 1}, {"x": 2}, {"x": 3}),
                        bench, force=True, reps=1, device="cpu")
    assert won == {"x": 3}
    # the failing candidate is skipped, as in the reference, and recorded
    assert autotune.FAILURES[failed:] == [{
        "kernel": "fake2", "bucket": "b=1", "params": {"x": 2},
        "error": "RuntimeError: launch failed"}]
    del autotune.FAILURES[failed:]
    # all candidates invalid -> no winner, nothing cached
    assert autotune.tune("fake3", "b=1", ({"x": 1},), bench, force=True,
                         device="cpu") is None
    assert autotune.lookup("fake3", "b=1") is None


def test_autotune_disabled_env(tmp_cache, monkeypatch):
    """REPRO_AUTOTUNE is read once at import, so monkeypatching the env
    must be followed by refresh_from_env()."""
    autotune.record("fake4", "b=1", {"x": 9}, 1.0)
    monkeypatch.setenv(autotune.ENV_VAR, "0")
    assert autotune.enabled(), "cached: env flip alone must NOT apply"
    autotune.refresh_from_env()
    try:
        assert not autotune.enabled()
        # disabled: lookups miss (defaults win) and sweeps are no-ops
        assert autotune.lookup("fake4", "b=1") is None
        assert autotune.block("fake4", "b=1", {"x": 0}) == {"x": 0}
        assert autotune.tune("fake4", "b=2", ({"x": 1},),
                             lambda p: (lambda: torch.zeros((1,))),
                             force=True, device="cpu") is None
    finally:
        monkeypatch.delenv(autotune.ENV_VAR)
        autotune.refresh_from_env()
    assert autotune.enabled()


def test_tune_window_end_to_end(tmp_cache, monkeypatch):
    """The window sweep under force, its launch replaced by a recorder:
    every valid candidate reaches the kernel's wrapper, the winner lands
    under the reference's bucket string, and the wrapper's resolution
    then gives it; another shape misses and falls back."""
    seen = []

    def recorder(q, k, v, window, win_valid=None, scale=None, *, wb=None):
        seen.append((tuple(q.shape), window, wb))
        return torch.zeros_like(q)

    monkeypatch.setattr(win, "window_attention_cuda", recorder)
    sweeps = autotune.STATS["sweeps"]
    won = autotune.tune_window(1, 64, 2, 16, 16, force=True, device="cpu")
    assert autotune.STATS["sweeps"] == sweeps + 1
    assert won is not None and "wb" in won
    grid = win.tile_grid(1, 64, 2, 16, 16)
    assert [t["wb"] for t in grid] == [1, 2, 4]
    # each candidate: warm calls, then three timed ones in turns
    assert sorted({s[2] for s in seen}) == [1, 2, 4]
    assert [s[2] for s in seen[-9:]] == [1, 2, 4] * 3
    assert all(s[:2] == ((1, 64, 2, 16), 16) for s in seen)
    bucket = autotune.window_bucket(1, 64, 2, 16, 16, torch.float32)
    assert bucket == jat.window_bucket(1, 64, 2, 16, 16, jnp.float32)
    data = json.loads(autotune.cache_path().read_text())
    assert data["window_attention"][bucket]["params"] == won
    assert autotune.block("window_attention", bucket,
                          win.DEFAULT_TILE)["wb"] == won["wb"]
    assert win.tile_for(1, 64, 2, 16, 16, torch.float32) == won
    # shape-bucketed: a different shape misses and falls back
    other = autotune.window_bucket(4, 2048, 16, 64, 64, torch.float32)
    assert autotune.block("window_attention", other,
                          win.DEFAULT_TILE) == win.DEFAULT_TILE


def test_candidates_are_timed_in_turns():
    """Each candidate runs once warm, then one run a round: a clock that
    drifts through a sweep favours no candidate (timed one after
    another, the first ran on a card still idle)."""
    calls = []
    fns = [lambda n=n: calls.append(n) for n in "abc"]
    us = autotune.time_candidates(fns, reps=2, cuda=False)
    assert calls == list("abc") * 3
    assert len(us) == 3 and all(u >= 0 for u in us)
    calls.clear()
    autotune._time_us(fns[0], reps=3, cuda=False)
    assert calls == ["a"] * 4


# ---------------------------------------------------------------------------
# the reference's tests/test_quant.py autotune tests, ported


def test_matmul_bucket_separates_dtypes(tmp_cache):
    b_int8 = autotune.matmul_bucket(64, 64, 64, torch.int8, torch.int8)
    b_fp32 = autotune.matmul_bucket(64, 64, 64, torch.float32,
                                    torch.float32)
    assert b_int8 != b_fp32
    autotune.record("int8_matmul", b_int8, {"bn": 256}, 1.0)
    # an int8 winner never answers an fp32 lookup
    assert autotune.lookup("int8_matmul", b_fp32) is None
    assert autotune.lookup("int8_matmul", b_int8) == {"bn": 256}
    # window / flash buckets carry the activation dtype too
    assert autotune.window_bucket(1, 64, 4, 16, 4, torch.float16) != \
        autotune.window_bucket(1, 64, 4, 16, 4, torch.float32)
    assert autotune.flash_bucket(1, 64, 64, 4, 4, 16, False,
                                 torch.float16) != \
        autotune.flash_bucket(1, 64, 64, 4, 4, 16, False, torch.float32)


def test_tune_matmul_records_per_dtype(tmp_cache, monkeypatch):
    """The int8 GEMM sweep, its launch replaced by a recorder that checks
    the operands' layout; its bucket is the reference's (int8, int8) key,
    so an int8+fp16 lane reads the int8+fp32 lane's winner."""
    seen = []

    def recorder(xq, wq, sx, sw, out_dtype=torch.float32, *, bn=None):
        assert xq.dtype == wq.dtype == torch.int8 and wq.t().is_contiguous()
        seen.append((tuple(xq.shape), tuple(wq.shape), out_dtype, bn))
        return torch.zeros((xq.shape[0], wq.shape[1]), dtype=out_dtype)

    monkeypatch.setattr(i8, "int8_matmul_cuda", recorder)
    won = autotune.tune_matmul(32, 32, 64, force=True, device="cpu")
    assert won in i8.TILE_GRID
    assert {s[3] for s in seen} == {128, 256}
    assert {s[:3] for s in seen} == {((32, 64), (64, 32), torch.float32)}
    bucket = autotune.matmul_bucket(32, 32, 64, torch.int8, torch.int8)
    assert bucket == jat.matmul_bucket(32, 32, 64, jnp.int8, jnp.int8)
    assert autotune.lookup("int8_matmul", bucket) == won
    # the fp16-output lane shares the bucket: a hit, no second sweep
    seen.clear()
    assert autotune.tune_matmul(32, 32, 64, out_dtype=torch.float16,
                                force=True, device="cpu") == won
    assert seen == []


# ---------------------------------------------------------------------------
# the port's own


BUCKET_CASES = [
    ("window", (2, 4096, 16, 64, 64, torch.float32)),
    ("window", (1, 1536, 15, 64, 64, torch.float16)),
    ("window", (3, 448, 4, 32, 49, torch.bfloat16)),
    ("flash", (2, 4096, 4096, 16, 16, 64, False, torch.float32)),
    ("flash", (8, 128, 128, 32, 8, 128, True, torch.bfloat16)),
    ("flash", (8, 1, 1500, 16, 16, 64, False, torch.float16)),
    ("flash", (2, 3008, 3008, 32, 8, 128, True, torch.float32)),
    ("decode", (8, 152, 32, 8, 128, torch.float32)),
    ("decode", (8, 152, 48, 8, 128, torch.bfloat16)),
    ("decode", (3, 777, 8, 4, 16, torch.float16)),
    ("matmul", (8192, 2880, 1024, torch.int8, torch.int8)),
    ("matmul", (8, 9728, 2560, torch.int8, torch.int8)),
    ("matmul", (1000, 960, 100, torch.float32, torch.float32)),
    ("matmul", (64, 64, 64, torch.bfloat16, torch.float16)),
]


@pytest.mark.parametrize("fn,args", BUCKET_CASES)
def test_bucket_strings_equal_the_reference(fn, args):
    """The port's bucket strings are the reference's, character for
    character, for the same arguments (a cache file of one package's
    layout reads in the other's)."""
    got = getattr(autotune, f"{fn}_bucket")(*args)
    want = getattr(jat, f"{fn}_bucket")(
        *(JNP.get(a, a) if isinstance(a, torch.dtype) else a for a in args))
    assert got == want


def test_every_reference_name_has_a_counterpart():
    ref = {n for n in vars(jat) if not n.startswith("__")
           and getattr(vars(jat)[n], "__module__", jat.__name__)
           == jat.__name__ and not isinstance(vars(jat)[n], type(jat))}
    ref -= {"annotations"}
    port = set(vars(autotune))
    missing = {n for n in ref if n not in port} - {"on_tpu"}
    assert not missing, missing
    assert callable(autotune.on_card) and not autotune.on_card("cpu")


# today's tiles, which an empty cache resolves to
@pytest.mark.parametrize("Dh", flash.HEAD_DIMS)
@pytest.mark.parametrize("dt", [torch.float32, torch.float16,
                                torch.bfloat16])
def test_flash_empty_cache_resolves_todays_tile(tmp_cache, Dh, dt):
    tile = flash.tile_for(2, 300, 200, 8, 2, Dh, True, dt)
    if dt == torch.float32:
        assert tile == {"mt": 2 if Dh <= 64 else 1}
        assert tile == {"mt": flash.m_tiles(Dh)}
    else:   # csrc/flash_attention.cu's old HalfTile: BN 128 / 64, 3 stages
        assert tile == {"bn": 128 if Dh <= 64 else 64, "stages": 3}
    grid = flash.tile_grid(Dh, dt)
    assert grid[0] == tile and len(set(map(json.dumps, grid))) == len(grid)
    assert all(t in autotune.FLASH_CANDIDATES[flash.precision(dt)]
               for t in grid)
    assert not list(tmp_cache.iterdir())


def test_window_decode_matmul_empty_cache_resolve_todays_tiles(tmp_cache):
    assert win.tile_for(2, 4096, 16, 64, 64, torch.float32) == {"wb": 1}
    assert win.tile_for(1, 448, 4, 32, 49, torch.bfloat16) == {"wb": 1}
    for (B, S, H, KV, Dh) in ((8, 152, 32, 8, 128), (8, 152, 48, 8, 128),
                              (8, 1040, 32, 32, 64), (8, 8192, 32, 8, 128),
                              (2, 256, 8, 2, 64), (1, 0, 8, 8, 16)):
        n0, keys0 = dec.plan(B, KV, H // KV, S, 132)
        tile = dec.tile_for(B, S, H, KV, Dh, torch.float32, 132)
        assert tile == {"n_split": n0}
        assert dec.split_for(tile["n_split"], B, KV, H // KV, S, 132) == \
            (n0, keys0)
    for (M, K, N) in ((8192, 1024, 2880), (8192, 4096, 1024), (8, 2560, 9728),
                      (1000, 100, 130)):
        assert i8.tile_for(M, N, K) == {"bn": i8.tile_n(N, K)}
    assert not list(tmp_cache.iterdir())


def test_disabled_resolves_defaults_over_cached_winners(tmp_cache,
                                                        monkeypatch):
    """With winners cached that differ from every default, the wrappers
    resolve them; with REPRO_AUTOTUNE=0 (after refresh_from_env) each
    resolves its default again, and record() / clear_memory_cache()
    clear the memo that serves the steady state."""
    f_b = autotune.flash_bucket(2, 4096, 4096, 16, 16, 64, False,
                                torch.float32)
    w_b = autotune.window_bucket(2, 4096, 16, 64, 64, torch.float32)
    d_b = autotune.decode_bucket(8, 152, 32, 8, 128, torch.float32)
    m_b = autotune.matmul_bucket(8192, 1024, 4096, torch.int8, torch.int8)

    def resolved():
        return (flash.tile_for(2, 4096, 4096, 16, 16, 64, False,
                               torch.float32),
                win.tile_for(2, 4096, 16, 64, 64, torch.float32),
                dec.tile_for(8, 152, 32, 8, 128, torch.float32, 132),
                i8.tile_for(8192, 1024, 4096))

    defaults = resolved()
    assert defaults == ({"mt": 2}, {"wb": 1}, {"n_split": 5}, {"bn": 256})
    autotune.record("flash_attention", f_b, {"mt": 1}, 1.0)
    autotune.record("window_attention", w_b, {"wb": 4}, 1.0)
    autotune.record("decode_attention", d_b, {"n_split": 2}, 1.0)
    autotune.record("int8_matmul", m_b, {"bn": 128}, 1.0)
    tuned = ({"mt": 1}, {"wb": 4}, {"n_split": 2}, {"bn": 128})
    assert resolved() == tuned
    assert dec.split_for(2, 8, 8, 4, 152, 132) == (2, 80)
    monkeypatch.setenv(autotune.ENV_VAR, "0")
    autotune.refresh_from_env()
    try:
        assert resolved() == defaults
    finally:
        monkeypatch.delenv(autotune.ENV_VAR)
        autotune.refresh_from_env()
    assert resolved() == tuned
    # from disk in a fresh process
    autotune.clear_memory_cache()
    assert resolved() == tuned


def test_cached_winner_invalid_at_a_shape_gives_the_default(tmp_cache):
    """A bucket holds several shapes: a winner that is no tile of this
    shape (wb = 4 where a call has two windows; a split that leaves a
    block of the cluster without keys) resolves to the default."""
    autotune.record("window_attention",
                    autotune.window_bucket(1, 128, 4, 32, 64, torch.float32),
                    {"wb": 4}, 1.0)
    assert win.tile_for(1, 128, 4, 32, 64, torch.float32) == {"wb": 1}
    autotune.record("window_attention",
                    autotune.window_bucket(1, 256, 4, 128, 128,
                                           torch.float32), {"wb": 2}, 1.0)
    assert win.tile_for(1, 256, 4, 128, 128, torch.float32) == {"wb": 1}
    autotune.record("decode_attention",
                    autotune.decode_bucket(1, 40, 8, 8, 64, torch.float32),
                    {"n_split": 8}, 1.0)
    assert dec.tile_for(1, 40, 8, 8, 64, torch.float32, 132) == \
        {"n_split": dec.plan(1, 8, 1, 40, 132)[0]}


@pytest.mark.parametrize("S", [0, 1, 7, 31, 32, 33, 64, 100, 152, 300, 513,
                               1040, 4097, 8192, 9000])
@pytest.mark.parametrize("B,KV,G", [(8, 8, 4), (1, 8, 1), (8, 32, 1),
                                    (2, 2, 4), (8, 8, 6)])
def test_decode_grid_meets_the_kernels_terms(S, B, KV, G):
    """Every cluster size of the grid gives a (n_split, keys_per_split)
    that csrc/decode_attention.cu's entry takes: 1..8 splits covering
    [0, S) with none wholly past S, keys a multiple of 8, and a split of
    at least MIN_KEYS_PER_SPLIT slots where the cache is cut; plan()'s
    own first."""
    grid = dec.tile_grid(B, KV, G, S, 132)
    assert grid[0] == dec.default_tile(B, KV, G, S, 132)
    assert all(t in autotune.DECODE_CANDIDATES for t in grid[1:])
    for tile in grid:
        n, keys = dec.split_for(tile["n_split"], B, KV, G, S, 132)
        assert n == tile["n_split"] and 1 <= n <= dec.MAX_CLUSTER
        assert keys % dec.KEY_ALIGN == 0 and n * keys >= S
        assert S == 0 or (n - 1) * keys < S
        if tile is not grid[0] and n > 1:
            assert keys >= dec.MIN_KEYS_PER_SPLIT


def test_window_grid():
    assert win.tile_grid(2, 4096, 16, 64, 64) == ({"wb": 1}, {"wb": 2},
                                                  {"wb": 4})
    assert win.tile_grid(1, 192, 4, 32, 64) == ({"wb": 1}, {"wb": 2})
    assert win.tile_grid(1, 64, 4, 32, 64) == ({"wb": 1},)
    assert win.tile_grid(2, 1024, 4, 128, 64) == ({"wb": 1},)
    assert win.tile_grid(2, 1024, 4, 64, 128) == ({"wb": 1},)


def test_cpu_warmups_sweep_nothing_and_write_nothing(tmp_cache,
                                                     monkeypatch):
    """Off the card ServerModel.warmup and ServeEngine.warmup sweep
    nothing and write no file (the sweeps run only on the card)."""
    def no_sweep(*a, **kw):
        raise AssertionError("a sweep ran off the card")

    for name in ("tune", "tune_window", "tune_flash", "tune_decode",
                 "tune_matmul"):
        monkeypatch.setattr(autotune, name, no_sweep)
    sweeps = dict(autotune.STATS)
    params = convert.init_vitdet_params(SIM, torch.Generator().manual_seed(0),
                                        "cpu")
    srv = ServerModel(SIM, params, device="cpu", b_buckets=(1,))
    assert srv.warmup([(0, 0, 0, 0)], (1,)) >= 1
    cfg = get_reduced("qwen3-4b")
    eng = ServeEngine(cfg, registry.init_params(
        cfg, torch.Generator().manual_seed(0), device="cpu"),
        ServeConfig(device="cpu", max_batch=2, b_buckets=(1, 2),
                    max_len=40, buckets=(16,)))
    assert eng.warmup() >= 1
    assert autotune.STATS == sweeps
    assert not list(tmp_cache.iterdir())
