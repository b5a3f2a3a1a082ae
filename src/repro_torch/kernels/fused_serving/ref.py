"""Plain PyTorch oracles of ``csrc/fused_serving.cu`` (pack + positional
add, restoration gather), and the index helpers the kernels' wrappers
share with them.  Both ops are data movement plus one add, so kernel and
plain version agree bit for bit."""
from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def upsample_token_maps(window: int, downsample: int) -> np.ndarray:
    """(d^2 + 1, w^2) i32: maps[0] identity; maps[k+1][t] = the low-window
    token that nearest-neighbour upsampling replicates into token ``t``
    of full-region sub-window ``k``."""
    w, d = window, downsample
    w2, dd = w * w, d * d
    maps = np.zeros((dd + 1, w2), np.int32)
    maps[0] = np.arange(w2)
    t = np.arange(w2)
    wi, wj = t // w, t % w
    for di in range(d):
        for dj in range(d):
            maps[di * d + dj + 1] = ((di * w + wi) // d) * w \
                + (dj * w + wj) // d
    return maps


@functools.lru_cache(maxsize=8)
def _maps_on(device: torch.device, window: int,
             downsample: int) -> torch.Tensor:
    return torch.as_tensor(upsample_token_maps(window, downsample),
                           device=device)


def _per_sample(ids: torch.Tensor, B: int) -> torch.Tensor:
    """(n,) shared or (B, n) per-sample ids -> contiguous (B, n) int32."""
    ids = ids.to(torch.int32)
    if ids.dim() == 1:
        ids = ids[None].expand(B, ids.shape[0])
    return ids.contiguous()


def _counts(nw: torch.Tensor, B: int) -> torch.Tensor:
    return nw.to(torch.int32).reshape(-1).expand(B).contiguous()


def pack_pos_plain(bank: torch.Tensor, pos_bank: torch.Tensor,
                   win_src: torch.Tensor, nw: torch.Tensor) -> torch.Tensor:
    """bank: (B, nbank, w2, C); pos_bank: (nbank, w2, C); win_src:
    (nw_pad,) or (B, nw_pad); nw: scalar, (1,) or (B,).  Returns packed
    tokens (B, nw_pad * w2, C): window ``i`` is ``bank[b, win_src[b, i]]
    + pos_bank[win_src[b, i]]`` when ``i < nw[b]``, else zeros."""
    B, _, w2, C = bank.shape
    src = _per_sample(win_src, B).long()
    nwb = _counts(nw, B)
    nw_pad = src.shape[1]
    packed = bank[torch.arange(B, device=bank.device)[:, None], src]
    x = packed + pos_bank[src]
    valid = torch.arange(nw_pad, device=bank.device)[None, :] < nwb[:, None]
    out = torch.where(valid[:, :, None, None], x, torch.zeros((), dtype=x.dtype,
                                                              device=x.device))
    return out.reshape(B, nw_pad * w2, C)


def restore_gather_plain(windows: torch.Tensor, out_src: torch.Tensor,
                         out_map: torch.Tensor, window: int, downsample: int,
                         reuse_tiles: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """windows: (B, nw_pad, w2, D) packed post-block activations; out_src
    / out_map: (nout,) or (B, nout) PlanLayout inverse maps (REUSE
    sources offset by nw_pad into the tile bank); reuse_tiles: optional
    (B, nR, d^2, w2, D).  Returns the full-resolution window-blocked
    sequence (B, nout * w2, D)."""
    B, _, w2, D = windows.shape
    src_idx = _per_sample(out_src, B).long()
    map_idx = _per_sample(out_map, B).long()
    nout = src_idx.shape[1]
    if reuse_tiles is None:
        tiles = windows.new_zeros((B, nout, w2, D))
    else:
        tiles = reuse_tiles.to(windows.dtype).reshape(B, -1, w2, D)
    src = torch.cat([windows, tiles], dim=1)
    blk = src[torch.arange(B, device=src.device)[:, None], src_idx]
    sel = _maps_on(windows.device, window, downsample).long()[map_idx]
    out = torch.gather(blk, 2, sel[..., None].expand(B, nout, w2, D))
    return out.reshape(B, nout * w2, D)
