"""Fused serving prologue (pack + positional add + pad zeroing) and
epilogue (destination-major restoration gather).

``pack_pos_cuda`` / ``restore_gather_cuda`` launch ``csrc/fused_serving.cu``,
the ports of ``repro/kernels/fused_serving/kernel.py:pack_pos_kernel`` and
``:restore_gather_kernel``; the ``*_plain`` functions are the same ops in
plain PyTorch.  Both are data movement plus one add, so kernel and plain
version agree bit for bit.

Token-map convention (``upsample_token_maps``): the restoration's
nearest-neighbour upsample sends LOW-window token ``t`` of sub-window
``k = di*d + dj`` to low token ``((di*w + wi)//d)*w + (dj*w + wj)//d``
with ``t = wi*w + wj``; map 0 is the identity (FULL windows and REUSE
tiles copy through unchanged).
"""
from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from repro_torch.kernels.build import (I, L, P, CudaKernel, check_cuda,
                                       stream_of)

PACK_POS = CudaKernel("fused_serving", "pack_pos_f32",
                      [P, P, P, P, P, I, I, I, L, I, P])
RESTORE = CudaKernel("fused_serving", "restore_gather_f32",
                     [P, P, P, P, P, P, I, I, I, I, I, I, I, I, P])


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


# ---------------------------------------------------------------------------
# pack_pos


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


def pack_pos_cuda(bank: torch.Tensor, pos_bank: torch.Tensor,
                  win_src: torch.Tensor, nw: torch.Tensor) -> torch.Tensor:
    B, nbank, w2, C = bank.shape
    if pos_bank.shape != (nbank, w2, C):
        raise ValueError(f"pack_pos: pos_bank {tuple(pos_bank.shape)} does "
                         f"not match bank {tuple(bank.shape)}")
    src = _per_sample(win_src, B)
    nwb = _counts(nw, B)
    bank, pos_bank = bank.contiguous(), pos_bank.contiguous()
    check_cuda("pack_pos", bank, pos_bank, src, nwb)
    if bank.dtype != torch.float32 or pos_bank.dtype != torch.float32:
        raise ValueError("pack_pos: float32 banks only")
    nw_pad = src.shape[1]
    out = torch.empty((B, nw_pad * w2, C), dtype=bank.dtype,
                      device=bank.device)
    PACK_POS(bank, pos_bank, src,
             nwb, out, B, nbank, nw_pad, w2 * C,
             bank.device.index, stream_of(bank))
    return out


# ---------------------------------------------------------------------------
# restore_gather


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


def restore_gather_cuda(windows: torch.Tensor, out_src: torch.Tensor,
                        out_map: torch.Tensor, window: int, downsample: int,
                        reuse_tiles: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    B, nw_pad, w2, D = windows.shape
    if w2 != window * window:
        raise ValueError(f"restore_gather: {w2} tokens per window, "
                         f"window {window}")
    src_idx = _per_sample(out_src, B)
    map_idx = _per_sample(out_map, B)
    nout = src_idx.shape[1]
    maps = _maps_on(windows.device, window, downsample)
    windows = windows.contiguous()
    tensors = [windows, src_idx, map_idx, maps]
    tiles_arg, ntile = None, 0
    if reuse_tiles is not None:
        tiles = reuse_tiles.reshape(B, -1, w2, D).contiguous()
        tensors.append(tiles)
        tiles_arg, ntile = tiles, tiles.shape[1]
    check_cuda("restore_gather", *tensors)
    if windows.dtype != torch.float32 or (
            reuse_tiles is not None and reuse_tiles.dtype != torch.float32):
        raise ValueError("restore_gather: float32 windows and tiles only")
    out = torch.empty((B, nout * w2, D), dtype=windows.dtype,
                      device=windows.device)
    RESTORE(windows, tiles_arg, src_idx,
            map_idx, maps, out, B, nw_pad,
            ntile, nout, maps.shape[0], w2, D, windows.device.index,
            stream_of(windows))
    return out
