"""Flash attention (ViTDet global blocks after the restoration point).

``flash_attention_cuda`` launches ``csrc/flash_attention.cu``, the port
of ``repro/kernels/flash_attention/kernel.py:flash_attention_kernel``;
``flash_attention_plain`` (``ref.py``, re-exported here) is the same
function in plain PyTorch: dense float32 softmax attention, taken
``Q_CHUNK`` query rows at a time so the score buffer stays bounded.

q: (B, T, H, Dh); k/v: (B, S, KV, Dh) with H = KV * G.  ``causal``: query
t sees keys s <= t.  A row that no key reaches outputs zeros.  The
kernel reads q, k and v through their batch and token strides.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.build import (F, I, L, P, CudaKernel, check_cuda,
                                       head_rows, stream_of)
from repro_torch.kernels.flash_attention.ref import (  # noqa: F401
    NEG_INF, Q_CHUNK, flash_attention_plain)

KERNEL = CudaKernel("flash_attention", "flash_attention_f32",
                    [P, P, P, P, I, I, I, I, I, I, L, L, L, L, L, L, F, I, I,
                     P])
HEAD_DIMS = (16, 32, 64, 128)


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = False,
                         scale: Optional[float] = None) -> torch.Tensor:
    B, T, H, Dh = q.shape
    S, KV = k.shape[1], k.shape[2]
    if (H % KV or k.shape != v.shape or k.shape[0] != B or k.shape[3] != Dh
            or Dh not in HEAD_DIMS):
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}; head dim "
                         f"must be one of {HEAD_DIMS}")
    q, k, v = head_rows(q), head_rows(k), head_rows(v)
    check_cuda("flash_attention", q, k, v)
    if q.dtype != torch.float32 or k.dtype != torch.float32 \
            or v.dtype != torch.float32:
        raise ValueError("flash_attention: float32 q/k/v only")
    scale = Dh ** -0.5 if scale is None else scale
    out = torch.empty((B, T, H, Dh), dtype=q.dtype, device=q.device)
    KERNEL(q, k, v, out, B, T, S,
           H, KV, Dh, q.stride(0), q.stride(1), k.stride(0), k.stride(1),
           v.stride(0), v.stride(1), float(scale), int(bool(causal)),
           q.device.index, stream_of(q))
    return out
