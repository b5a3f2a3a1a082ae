"""d x d average pool (mixed-resolution downsampling, paper §III-A).

``avg_pool_cuda`` launches ``csrc/avg_pool.cu``, the port of
``repro/kernels/mixed_res_pool/kernel.py:avg_pool_kernel``;
``avg_pool_plain`` is the same function in plain PyTorch, which the CPU
path and the tests use.  ``kernels.dispatch.avg_pool`` picks between
them by device.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.build import I, P, CudaKernel, check_cuda, stream_of

KERNEL = CudaKernel("avg_pool", "avg_pool_f32", [P, P, I, I, I, I, I, I, P])


def avg_pool_plain(x: torch.Tensor, d: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, H/d, W/d, C) mean over each d x d block,
    accumulated in float32."""
    B, H, W, C = x.shape
    x6 = x.reshape(B, H // d, d, W // d, d, C)
    return x6.float().mean(dim=(2, 4)).to(x.dtype)


def avg_pool_cuda(x: torch.Tensor, d: int) -> torch.Tensor:
    check_cuda("avg_pool", x)
    if x.dtype != torch.float32 or x.dim() != 4:
        raise ValueError(f"avg_pool: (B, H, W, C) float32, got "
                         f"{tuple(x.shape)} {x.dtype}")
    B, H, W, C = x.shape
    if H % d or W % d:
        raise ValueError(f"avg_pool: {H}x{W} not divisible by d={d}")
    x = x.contiguous()
    out = torch.empty((B, H // d, W // d, C), dtype=x.dtype, device=x.device)
    KERNEL(x, out, B, H, W, C, d, x.device.index,
           stream_of(x))
    return out
