"""Plain PyTorch oracle of ``csrc/int8_matmul.cu``, exact: the integer
sum has no rounding, and the epilogue is the reference's three float32
operations in its order (``repro/kernels/int8_matmul/ref.py``)."""
from __future__ import annotations

import torch

# float64 holds every integer up to 2**53 exactly; |sum| <= K * 127**2
_MAX_EXACT_K = 2 ** 53 // 127 ** 2


def int8_matmul_plain(xq: torch.Tensor, wq: torch.Tensor, sx: torch.Tensor,
                      sw: torch.Tensor,
                      out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """xq: (M, K) int8; wq: (K, N) int8; sx: (M,) f32; sw: (N,) f32.

    The int8 x int8 sum runs as a float64 matmul, which is exact here
    (every partial sum is an integer below 2**53) and, unlike an int32
    matmul, runs through BLAS on the CPU and is available on the card."""
    if xq.shape[1] > _MAX_EXACT_K:
        raise ValueError(f"int8_matmul: K={xq.shape[1]} exceeds float64's "
                         f"exact range")
    acc = torch.matmul(xq.double(), wq.double()).to(torch.int32)
    out = acc.float() * sx[:, None].float() * sw[None, :].float()
    return out.to(out_dtype)
