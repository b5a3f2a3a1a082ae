"""d x d average pool (mixed-resolution downsampling, paper §III-A) and
d x d nearest-neighbour upsample (restoration at beta = 0, §III-B).

``avg_pool_cuda`` / ``nn_upsample_cuda`` launch ``csrc/avg_pool.cu`` /
``csrc/nn_upsample.cu``, the ports of
``repro/kernels/mixed_res_pool/kernel.py:avg_pool_kernel`` and
``:nn_upsample_kernel``; the ``*_plain`` functions (``ref.py``,
re-exported here) are the same ops in plain PyTorch, which the CPU path
and the tests use.  Both take float32, fp16 and bf16 grids: the pool sums
in float32 and rounds once to the input's type, the upsample copies.
The pool is bit-equal to the plain version at the serving frame (d = 2,
four terms summed in the plain version's order); where torch's
reduction sums in another order (d = 4, wide channels) its float32
result differs by rounding, so a half result may differ by one unit in
the last place.
``AvgPool`` / ``NNUpsample`` are the differentiable entries
(``kernels.dispatch`` routes through them on both devices): the kernel
on the card, the plain version on the CPU, and the reference's
closed-form adjoints (``repro/kernels/mixed_res_pool/ops.py``): a mean
pool's is a d x d repeat over d^2, a nearest-neighbour upsample's a
d x d block sum.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.build import I, P, CudaKernel, check_cuda, stream_of
from repro_torch.kernels.mixed_res_pool.ref import (  # noqa: F401
    avg_pool_plain, nn_upsample_plain)

KERNEL = CudaKernel("avg_pool", "avg_pool", [P, P, I, I, I, I, I, I, P])
UPSAMPLE = CudaKernel("nn_upsample", "nn_upsample",
                      [P, P, I, I, I, I, I, I, P])


def _check_grid(name: str, kernel: CudaKernel,
                x: torch.Tensor) -> torch.dtype:
    check_cuda(name, x)
    if x.dim() != 4:
        raise ValueError(f"{name}: (B, H, W, C), got {tuple(x.shape)}")
    return kernel.check_dtype(name, x)


def avg_pool_cuda(x: torch.Tensor, d: int) -> torch.Tensor:
    dt = _check_grid("avg_pool", KERNEL, x)
    B, H, W, C = x.shape
    if H % d or W % d:
        raise ValueError(f"avg_pool: {H}x{W} not divisible by d={d}")
    x = x.contiguous()
    out = torch.empty((B, H // d, W // d, C), dtype=x.dtype, device=x.device)
    KERNEL(x, out, B, H, W, C, d, x.device.index,
           stream_of(x), dtype=dt)
    return out


def nn_upsample_cuda(x: torch.Tensor, d: int) -> torch.Tensor:
    dt = _check_grid("nn_upsample", UPSAMPLE, x)
    if d < 1:
        raise ValueError(f"nn_upsample: d={d}")
    B, H, W, C = x.shape
    x = x.contiguous()
    out = torch.empty((B, H * d, W * d, C), dtype=x.dtype, device=x.device)
    UPSAMPLE(x, out, B, H, W, C, d, x.device.index, stream_of(x), dtype=dt)
    return out


class AvgPool(torch.autograd.Function):
    """d x d mean pool; its adjoint repeats each pooled cotangent over
    its block, divided by d^2."""

    @staticmethod
    def forward(ctx, x, d: int):
        ctx.d = d
        return avg_pool_cuda(x, d) if x.is_cuda else avg_pool_plain(x, d)

    @staticmethod
    def backward(ctx, g):
        d = ctx.d
        dx = g.repeat_interleave(d, dim=1).repeat_interleave(d, dim=2)
        return dx / (d * d), None


class NNUpsample(torch.autograd.Function):
    """d x d nearest-neighbour upsample; its adjoint sums each d x d
    block of the cotangent."""

    @staticmethod
    def forward(ctx, x, d: int):
        ctx.d = d
        return nn_upsample_cuda(x, d) if x.is_cuda else nn_upsample_plain(x, d)

    @staticmethod
    def backward(ctx, g):
        d = ctx.d
        B, H, W, C = g.shape
        return g.reshape(B, H // d, d, W // d, d, C).sum(dim=(2, 4)), None
