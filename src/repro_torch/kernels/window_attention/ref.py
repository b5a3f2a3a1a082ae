"""Plain PyTorch oracle of ``csrc/window_attention.cu``: dense float32
softmax attention inside each window, pad windows zeroed."""
from __future__ import annotations

from typing import Optional

import torch


def window_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           window: int, win_valid: Optional[torch.Tensor] = None,
                           scale: Optional[float] = None) -> torch.Tensor:
    B, T, H, Dh = q.shape
    KV = k.shape[2]
    G = H // KV
    W = T // window
    scale = Dh ** -0.5 if scale is None else scale
    qw = q.reshape(B, W, window, KV, G, Dh).float()
    kw = k.reshape(B, W, window, KV, Dh).float()
    vw = v.reshape(B, W, window, KV, Dh).float()
    s = torch.einsum("bwikgd,bwjkd->bwkgij", qw, kw) * scale
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bwkgij,bwjkd->bwikgd", p, vw).reshape(B, W, window, H, Dh)
    if win_valid is not None:
        keep = (torch.arange(W, device=q.device)[None, :]
                < win_valid.reshape(-1, 1).to(q.device))
        o = torch.where(keep[:, :, None, None, None], o,
                        torch.zeros((), dtype=o.dtype, device=o.device))
    return o.reshape(B, T, H, Dh).to(q.dtype)
