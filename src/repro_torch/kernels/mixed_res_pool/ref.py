"""Plain PyTorch oracles of ``csrc/avg_pool.cu`` and
``csrc/nn_upsample.cu``."""
from __future__ import annotations

import torch


def avg_pool_plain(x: torch.Tensor, d: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, H/d, W/d, C) mean over each d x d block,
    accumulated in float32."""
    B, H, W, C = x.shape
    x6 = x.reshape(B, H // d, d, W // d, d, C)
    return x6.float().mean(dim=(2, 4)).to(x.dtype)


def nn_upsample_plain(x: torch.Tensor, d: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, H*d, W*d, C): every pixel repeated over a
    d x d block."""
    return x.repeat_interleave(d, dim=1).repeat_interleave(d, dim=2)
