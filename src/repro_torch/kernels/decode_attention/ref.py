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


def decode_attention_split(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, kv_len: torch.Tensor,
                           n_split: int,
                           scale: Optional[float] = None) -> torch.Tensor:
    """The CUDA kernel's path in plain PyTorch, for the tests: row b's
    kv_len[b] valid keys are cut into n_split runs of
    ceil(kv_len[b] / n_split) rounded up to a multiple of 8 (the last ones
    shorter or empty); each run keeps its partial softmax (max m, sum l,
    unnormalised output acc; m = -inf where it saw no key), and the
    partials merge run by run as the cluster's rank 0 merges them, each
    scaled to the larger max.  A row no key reaches gives zeros."""
    B, _, H, Dh = q.shape
    S, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = Dh ** -0.5 if scale is None else scale
    dev = q.device
    qg = q.reshape(B, KV, G, Dh).float() * scale
    neg = torch.tensor(float("-inf"), device=dev)
    m = torch.full((B, KV, G), float("-inf"), device=dev)
    l = torch.zeros((B, KV, G), device=dev)
    acc = torch.zeros((B, KV, G, Dh), device=dev)
    lens = kv_len.to(dev).long().clamp(0, S)
    run = ((lens + n_split - 1) // n_split + 7) // 8 * 8          # (B,)
    pos = torch.arange(S, device=dev)[None]
    for i in range(n_split):
        lo, hi = (i * run)[:, None], torch.minimum((i + 1) * run, lens)[:, None]
        valid = (pos >= lo) & (pos < hi)                              # (B,S)
        s = torch.einsum("bkgd,bskd->bkgs", qg, k.float())
        s = torch.where(valid[:, None, None], s, neg)
        mi = s.amax(-1)
        p = torch.exp(s - torch.where(mi == neg, 0.0, mi)[..., None])
        li = p.sum(-1)
        ai = torch.einsum("bkgs,bskd->bkgd", p, v.float())
        mx = torch.maximum(m, mi)
        ref = torch.where(mx == neg, 0.0, mx)
        c1 = torch.where(m == neg, 0.0, torch.exp(m - ref))
        c2 = torch.where(mi == neg, 0.0, torch.exp(mi - ref))
        l = l * c1 + li * c2
        acc = acc * c1[..., None] + ai * c2[..., None]
        m = mx
    inv = torch.where(l > 0, 1.0 / torch.where(l > 0, l, 1.0), 0.0)
    return (acc * inv[..., None]).reshape(B, 1, H, Dh).to(q.dtype)
