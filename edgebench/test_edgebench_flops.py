"""The benchmark's operation and byte counts against values worked out
by hand for ViTDet-L (D 1024, d_ff 4096, 16 heads of 64, 64 x 64
patches in windows of 8 x 8, 4 subsets of 6 blocks)."""
from __future__ import annotations

import json
from pathlib import Path

import pytest

from edgebench import flops

CONFIGS = Path(__file__).resolve().parent / "configs"


@pytest.fixture(scope="module")
def sz():
    return json.loads((CONFIGS / "vitdet-l.fp32.json").read_text())["sizes"]


# one block at T tokens: 8 T D^2 (q, k, v, o) + 4 T D F (MLP), plus
# window attention 4 n_win w^4 D or global 4 T^2 D
WINDOW_BLOCK = 34_359_738_368 + 68_719_476_736 + 1_073_741_824
GLOBAL_BLOCK = 34_359_738_368 + 68_719_476_736 + 68_719_476_736
FULL_RES = 20 * WINDOW_BLOCK + 4 * GLOBAL_BLOCK


def test_full_resolution_backbone(sz):
    assert FULL_RES == 2_770_253_905_920          # 2.77 TFLOP a frame
    assert flops.backbone_flops_windows(sz, 64, 0) == FULL_RES
    assert flops.backbone_flops_windows(sz, 64, 2) == FULL_RES


def test_mixed_backbone_at_24_windows(sz):
    # beta 2: blocks 0-10 at 24 windows (1536 tokens), then full length
    win24 = 12_884_901_888 + 25_769_803_776 + 402_653_184
    glob24 = 12_884_901_888 + 25_769_803_776 + 9_663_676_416
    want = 10 * win24 + glob24 + 10 * WINDOW_BLOCK + 3 * GLOBAL_BLOCK
    assert want == 1_995_817_615_360
    assert flops.backbone_flops_windows(sz, 24, 2) == want


def test_embed_head_and_frame(sz):
    assert flops.embed_flops(sz, 16, 0) == 2 * 4096 * 768 * 1024
    assert flops.embed_flops(sz, 0, 16) == 2 * 1024 * 768 * 1024
    # 128^2 + 64^2 + 32^2 positions; 1x1 D->256, two 3x3 256->256,
    # 3x3 256 -> 80 + 4 + 1
    assert flops.head_flops(sz) == 70_431_277_056
    assert flops.frame_flops(sz, 16, 0, 64, 0) == \
        FULL_RES + 6_442_450_944 + 70_431_277_056


def test_attention_counts(sz):
    f, b = flops.attention_cost([2], 4096, 4096, sz, "fp16")
    assert f == 4 * 4096 * 4096 * 64 * 16 * 2 == 137_438_953_472
    assert b == 4 * 2 * 4096 * 16 * 64 * 2 == 67_108_864
    f, b = flops.attention_cost([64], 64, 64, sz, "fp32")
    assert f == 1_073_741_824 and b == 67_108_864


def test_wave_attention_calls(sz):
    full = flops.wave_attention(sz, 8, 2, True, [64] * 8, "fp16")
    assert len(full["flash"]) == 4 and len(full["window"]) == 20
    assert full["flash"][0] == flops.attention_cost([8], 4096, 4096, sz,
                                                    "fp16")
    rows = [20, 24, 7, 20]
    mixed = flops.wave_attention(sz, 4, 2, False, rows, "fp16")
    # the global block of subset 1 runs masked, off these kernels
    assert len(mixed["flash"]) == 3 and len(mixed["window"]) == 20
    pre = flops.attention_cost(rows, 64, 64, sz, "fp16")
    assert mixed["window"][:10] == [pre] * 10
    assert mixed["window"][10:] == [flops.attention_cost(
        [4 * 64], 64, 64, sz, "fp16")] * 10


def test_roofline_share(sz):
    class W:
        Bp, full_res, rows_valid = 2, True, [64, 64]

    class Op:
        def __init__(self, name, s):
            self.name, self.start, self.end = name, 0.0, s

    peaks = {"flops": {"fp16": 1e15}, "bytes_per_s": 1e12}
    f, _ = flops.attention_cost([2], 4096, 4096, sz, "fp16")
    spent = 4 * f / 1e15 * 2           # the kernel at half the peak
    ops = [Op("void flash_attention_kernel_half<64>", spent),
           Op("sm90_gemm", 1.0)]
    share = flops.attention_roofline([(W, ops)], sz, "fp16", 0, peaks,
                                     "flash_attention_kernel", "flash")
    assert share == pytest.approx(50.0)
    assert flops.attention_roofline([(W, ops[1:])], sz, "fp16", 0, peaks,
                                    "flash_attention_kernel",
                                    "flash") is None
