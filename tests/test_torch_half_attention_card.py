"""The fp16 / bf16 flash and window attention kernels on the card, against
their plain versions on the same inputs (skipped where there is no card;
``chip_smoke.py`` phase 2 runs the full-width shapes):

    PYTHONPATH=src python3 -m pytest -q -m cuda tests/test_torch_half_attention_card.py

Each output within one ULP of the half type of the plain value beyond the
float32 attention limit (1e-4 absolute), at least 99% of the elements
bit-equal, as ``chip_smoke.half_close`` holds them.  The shapes cover
what the kernels' tiles make hard: every head width flash builds (16 and
32 are zero-filled to a 64-column panel), T and S off the tiles, S < T,
S = 0, causal and not, GQA; windows of 49 and 81 tokens (pad keys),
a head width of 24 (a pad column block), ``win_valid``; column views of
a fused QKV product, and views whose base is not 16-byte aligned, which
the wrappers copy (counted) before the kernels' 16-byte loads.
"""
import pytest
import torch

from repro_torch.kernels import dispatch
from repro_torch.kernels.build import FLOAT_SUFFIX
from repro_torch.kernels.flash_attention import ops as tflash
from repro_torch.kernels.window_attention import ops as twin

HALF = (torch.float16, torch.bfloat16)
ATTN_TOL = 1e-4
HALF_EQUAL = 0.99


def _card() -> None:
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (chip_smoke.py runs this "
                    "check on the H100)")


def _ulp(x: torch.Tensor) -> torch.Tensor:
    p, tiny = {torch.float16: (11, 2.0 ** -24),
               torch.bfloat16: (8, 2.0 ** -133)}[x.dtype]
    _, e = torch.frexp(x.float().abs())
    return torch.clamp(torch.ldexp(torch.ones_like(e, dtype=torch.float32),
                                   e - p), min=tiny)


def _close(got: torch.Tensor, want: torch.Tensor) -> None:
    assert got.dtype == want.dtype and got.shape == want.shape
    assert bool(torch.isfinite(got).all())
    d = (got.float() - want.float()).abs()
    assert float((d - _ulp(want) - ATTN_TOL).max()) <= 0
    assert float((got == want).float().mean()) >= HALF_EQUAL


def _rnd(gen, shape, dt):
    return torch.randn(shape, generator=gen, device="cuda").to(dt)


# (B, T, S, H, KV, Dh): chip_smoke's FLASH_CASES, the LM prefill's causal
# GQA shapes and a ViT-like block
FLASH = ((2, 130, 77, 4, 4, 16), (2, 200, 300, 8, 2, 32),
         (1, 333, 200, 16, 4, 64), (2, 200, 130, 8, 2, 128),
         (8, 128, 128, 32, 8, 128), (8, 96, 96, 32, 8, 128),
         (1, 1000, 1000, 16, 4, 64), (2, 512, 512, 16, 16, 64))


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", FLASH)
@pytest.mark.parametrize("dt", HALF)
def test_flash_half_kernel_on_card(dt, shape, causal):
    _card()
    B, T, S, H, KV, Dh = shape
    gen = torch.Generator(device="cuda").manual_seed(sum(shape))
    q, k, v = (_rnd(gen, (B, n, h, Dh), dt)
               for n, h in ((T, H), (S, KV), (S, KV)))
    dispatch.reset_launch_counts()
    got = tflash.flash_attention_cuda(q, k, v, causal=causal)
    assert tflash.KERNEL.launches == 1 and tflash.KERNEL.copies == 0
    _close(got, tflash.flash_attention_plain(q, k, v, causal=causal))


@pytest.mark.cuda
@pytest.mark.parametrize("dt", HALF)
def test_flash_half_views_copies_and_no_keys_on_card(dt):
    """Column views of a fused QKV product go in as they are; views off
    16 bytes are copied (three copies counted); no key at all writes 0."""
    _card()
    gen = torch.Generator(device="cuda").manual_seed(5)
    B, T, H, Dh = 2, 300, 15, 64
    qkv = _rnd(gen, (B, T, 3 * H * Dh), dt)
    q, k, v = (t.reshape(B, T, H, Dh) for t in qkv.split(H * Dh, dim=-1))
    dispatch.reset_launch_counts()
    _close(tflash.flash_attention_cuda(q, k, v),
           tflash.flash_attention_plain(q, k, v))
    assert tflash.KERNEL.copies == 0
    flat = _rnd(gen, (3 * B * T * 4 * Dh + 1,), dt)[1:]
    q, k, v = (t.view(B, T, 4, Dh) for t in flat.split(B * T * 4 * Dh))
    _close(tflash.flash_attention_cuda(q, k, v, causal=True),
           tflash.flash_attention_plain(q, k, v, causal=True))
    assert tflash.KERNEL.copies == 3
    empty = torch.zeros((1, 0, 4, Dh), dtype=dt, device="cuda")
    got = tflash.flash_attention_cuda(q[:1], empty, empty)
    assert torch.count_nonzero(got) == 0
    assert dispatch.launch_counts(FLOAT_SUFFIX[dt])["flash_attention"] == 3


# (B, W, w2, H, KV, Dh)
WINDOW = ((2, 64, 64, 16, 16, 64), (2, 4, 64, 4, 4, 64), (1, 9, 81, 8, 8, 32),
          (2, 3, 49, 4, 2, 64), (2, 3, 16, 2, 2, 24), (1, 2, 128, 2, 1, 128),
          (2, 3, 4, 4, 4, 16))


@pytest.mark.cuda
@pytest.mark.parametrize("valid", [False, True])
@pytest.mark.parametrize("shape", WINDOW)
@pytest.mark.parametrize("dt", HALF)
def test_window_half_kernel_on_card(dt, shape, valid):
    _card()
    B, W, w2, H, KV, Dh = shape
    gen = torch.Generator(device="cuda").manual_seed(sum(shape))
    q, k, v = (_rnd(gen, (B, W * w2, h, Dh), dt) for h in (H, KV, KV))
    wv = (torch.tensor([W, max(W - 1, 1)][:B], dtype=torch.int32,
                       device="cuda") if valid else None)
    dispatch.reset_launch_counts()
    got = twin.window_attention_cuda(q, k, v, w2, wv)
    assert twin.KERNEL.launches == 1 and twin.KERNEL.copies == 0
    _close(got, twin.window_attention_plain(q, k, v, w2, wv))


@pytest.mark.cuda
@pytest.mark.parametrize("dt", HALF)
def test_window_half_views_and_copies_on_card(dt):
    _card()
    gen = torch.Generator(device="cuda").manual_seed(6)
    B, T, H, Dh = 2, 4 * 64, 15, 64
    qkv = _rnd(gen, (B, T, 3 * H * Dh), dt)
    q, k, v = (t.reshape(B, T, H, Dh) for t in qkv.split(H * Dh, dim=-1))
    dispatch.reset_launch_counts()
    _close(twin.window_attention_cuda(q, k, v, 64),
           twin.window_attention_plain(q, k, v, 64))
    assert twin.KERNEL.copies == 0
    flat = _rnd(gen, (3 * B * T * 4 * Dh + 1,), dt)[1:]
    q, k, v = (t.view(B, T, 4, Dh) for t in flat.split(B * T * 4 * Dh))
    _close(twin.window_attention_cuda(q, k, v, 64),
           twin.window_attention_plain(q, k, v, 64))
    assert twin.KERNEL.copies == 3
