"""The kernel autotuner on the card (``cuda``-marked; skips without a
GPU): the four kernels swept at small shapes, then every tile of each
grid held to the plain version.  No JAX here: the CPU tests of
``tests/test_torch_autotune.py`` hold the machinery to the reference.

Run on the card: ``PYTHONPATH=src python3 -m pytest -q -m cuda
tests/test_torch_autotune_card.py``."""
import pytest
import torch

from repro_torch.kernels import autotune
from repro_torch.kernels.decode_attention import ops as dec
from repro_torch.kernels.flash_attention import ops as flash
from repro_torch.kernels.int8_matmul import ops as i8
from repro_torch.kernels.window_attention import ops as win

ATTN_TOL, DECODE_TOL, HALF_EQUAL = 1e-4, 1e-5, 0.99


def ulp(x):
    """One unit in the last place of ``x``'s half type at each |x|."""
    p, tiny = {torch.float16: (11, 2.0 ** -24),
               torch.bfloat16: (8, 2.0 ** -133)}[x.dtype]
    _, e = torch.frexp(x.float().abs())
    return torch.clamp(torch.ldexp(torch.ones_like(e, dtype=torch.float32),
                                   e - p), min=tiny)


def close(got, want, tol):
    """Within ``tol`` at float32; at half within one ULP (plus ``tol``
    near zero) and >= 99% bit-equal, as chip_smoke.py holds them."""
    assert got.dtype == want.dtype and got.shape == want.shape
    d = (got.float() - want.float()).abs()
    if got.dtype == torch.float32:
        assert float(d.max()) <= tol
    else:
        assert bool((d <= ulp(want) + tol).all())
        assert float((got == want).float().mean()) >= HALF_EQUAL


@pytest.fixture()
def card(tmp_path, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    monkeypatch.setenv(autotune.CACHE_ENV, str(tmp_path))
    monkeypatch.delenv(autotune.ENV_VAR, raising=False)
    autotune.refresh_from_env()
    autotune.clear_memory_cache()
    yield torch.device("cuda")
    autotune.clear_memory_cache()


@pytest.mark.cuda
def test_sweeps_on_the_card(card):
    """Sweep the four kernels on the card at small shapes (every valid
    candidate timed, none raising), then hold every tile of each grid to
    the plain version: window at w2 = 64, 49 (pad rows) and 16 with
    window counts off the block's and win_valid, flash causal GQA and
    not, decode at ragged kv_len, the int8 GEMM bit-equal."""
    dev = card
    g = torch.Generator(device=dev).manual_seed(0)
    failed, sweeps = len(autotune.FAILURES), autotune.STATS["sweeps"]
    assert autotune.tune_window(3, 5 * 64, 4, 64, 64) is not None
    assert autotune.tune_window(2, 3 * 49, 4, 32, 49,
                                dtype=torch.bfloat16) is not None
    assert autotune.tune_flash(2, 200, 300, 8, 64, KV=2,
                               causal=True) is not None
    assert autotune.tune_flash(2, 200, 300, 8, 128, KV=2, causal=True,
                               dtype=torch.float16) is not None
    assert autotune.tune_decode(3, 300, 8, 64, KV=2) is not None
    assert autotune.tune_matmul(300, 256, 192) is not None
    assert autotune.FAILURES[failed:] == []
    assert autotune.STATS["sweeps"] == sweeps + 6
    assert autotune.cache_path().exists()

    def rnd(*shape, dt=torch.float32):
        return torch.randn(shape, generator=g, device=dev).to(dt)

    for dt in (torch.float32, torch.float16, torch.bfloat16):
        for (B, W, H, KV, Dh, w2) in ((3, 5, 4, 4, 64, 64),
                                      (2, 3, 4, 2, 32, 49),
                                      (1, 7, 2, 1, 16, 16)):
            q, k, v = rnd(B, W * w2, H, Dh, dt=dt), \
                rnd(B, W * w2, KV, Dh, dt=dt), rnd(B, W * w2, KV, Dh, dt=dt)
            valid = torch.tensor([W, W - 2, 1][:B], dtype=torch.int32,
                                 device=dev)
            grid = win.tile_grid(B, W * w2, H, Dh, w2)
            assert [t["wb"] for t in grid] == [1, 2, 4]
            for wv in (None, valid):
                want = win.window_attention_plain(q, k, v, w2, wv)
                for t in grid:
                    close(win.window_attention_cuda(q, k, v, w2, wv, **t),
                          want, ATTN_TOL)
        for (B, T, S, H, KV, Dh, causal) in ((2, 200, 300, 8, 2, 64, True),
                                             (1, 130, 77, 4, 4, 128, False),
                                             (2, 96, 96, 8, 8, 32, True)):
            q, k, v = rnd(B, T, H, Dh, dt=dt), rnd(B, S, KV, Dh, dt=dt), \
                rnd(B, S, KV, Dh, dt=dt)
            want = flash.flash_attention_plain(q, k, v, causal)
            for t in flash.tile_grid(Dh, dt):
                close(flash.flash_attention_cuda(q, k, v, causal, **t), want,
                      ATTN_TOL)
        q, k, v = rnd(3, 1, 8, 64, dt=dt), rnd(3, 300, 2, 64, dt=dt), \
            rnd(3, 300, 2, 64, dt=dt)
        kl = torch.tensor([0, 150, 300], dtype=torch.int32, device=dev)
        want = dec.decode_attention_plain(q, k, v, kl)
        grid = dec.tile_grid(3, 2, 4, 300, dec.sm_count(dev))
        assert len(grid) >= 4
        for t in grid:
            close(dec.decode_attention_cuda(q, k, v, kl, **t), want,
                  DECODE_TOL)
    xq = torch.randint(-127, 128, (300, 192), generator=g, device=dev,
                       dtype=torch.int32).to(torch.int8)
    wq = torch.randint(-127, 128, (256, 192), generator=g, device=dev,
                       dtype=torch.int32).to(torch.int8).t()
    sx, sw = torch.rand(300, generator=g, device=dev), \
        torch.rand(256, generator=g, device=dev)
    for t in i8.TILE_GRID:
        assert torch.equal(i8.int8_matmul_cuda(xq, wq, sx, sw, **t),
                           i8.int8_matmul_plain(xq, wq, sx, sw))
