"""Plain PyTorch oracle of ``csrc/flash_attention.cu``: dense float32
softmax attention, taken ``Q_CHUNK`` query rows at a time so the score
buffer stays bounded.  The CPU path and the tests use it; ``chip_smoke.py``
holds the kernel against it on the card, and against it on float64
inputs, which it computes in float64."""
from __future__ import annotations

from typing import Optional

import torch

Q_CHUNK = 1024
NEG_INF = -2.0 ** 30


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = False,
                          scale: Optional[float] = None) -> torch.Tensor:
    B, T, H, Dh = q.shape
    S, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = Dh ** -0.5 if scale is None else scale
    ct = torch.promote_types(q.dtype, torch.float32)     # float32 or 64
    kf, vf = k.to(ct), v.to(ct)
    outs = []
    for t0 in range(0, T, Q_CHUNK):
        qc = q[:, t0:t0 + Q_CHUNK]
        Tc = qc.shape[1]
        qg = qc.reshape(B, Tc, KV, G, Dh).to(ct)
        s = torch.einsum("btkgd,bskd->bkgts", qg, kf) * scale
        if causal:
            seen = (torch.arange(Tc, device=q.device)[:, None] + t0
                    >= torch.arange(S, device=q.device)[None, :])
            s = s.masked_fill(~seen, NEG_INF)
            p = torch.softmax(s, dim=-1) * seen.any(-1)[:, None]
        else:
            p = torch.softmax(s, dim=-1)
        o = torch.einsum("bkgts,bskd->btkgd", p, vf)
        outs.append(o.reshape(B, Tc, H, Dh))
    return torch.cat(outs, dim=1).to(q.dtype)
