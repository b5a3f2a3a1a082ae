"""Plain PyTorch oracle of ``csrc/decode_attention.cu``: a dense masked
float32 softmax (the reference's ``ref.py``), with zeros for a row whose
``kv_len`` is 0, as the Pallas kernel gives."""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -2.0 ** 30


def decode_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           kv_len: torch.Tensor,
                           scale: Optional[float] = None) -> torch.Tensor:
    B, _, H, Dh = q.shape
    S, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = Dh ** -0.5 if scale is None else scale
    qg = q.reshape(B, KV, G, Dh).float()
    s = torch.einsum("bkgd,bskd->bkgs", qg, k.float()) * scale
    valid = (torch.arange(S, device=q.device)[None, :]
             < kv_len.to(q.device)[:, None])                         # (B,S)
    s = s.masked_fill(~valid[:, None, None, :], NEG_INF)
    p = torch.softmax(s, dim=-1) * valid.any(-1)[:, None, None, None]
    o = torch.einsum("bkgs,bskd->bkgd", p, v.float())
    return o.reshape(B, 1, H, Dh).to(q.dtype)
