"""Fused serving prologue (pack + positional add + pad zeroing) and
epilogue (destination-major restoration gather).

``pack_pos_cuda`` / ``restore_gather_cuda`` launch ``csrc/fused_serving.cu``,
the ports of ``repro/kernels/fused_serving/kernel.py:pack_pos_kernel`` and
``:restore_gather_kernel``; the ``*_plain`` functions (``ref.py``,
re-exported here) are the same ops in plain PyTorch.  Both are data
movement plus one add, so kernel and plain version agree bit for bit,
in float32, fp16 and bf16 alike (the banks, windows and tiles of one
call share a type; the half add rounds once, as the reference's add in
the input type does).

Token-map convention (``upsample_token_maps``): the restoration's
nearest-neighbour upsample sends LOW-window token ``t`` of sub-window
``k = di*d + dj`` to low token ``((di*w + wi)//d)*w + (dj*w + wj)//d``
with ``t = wi*w + wj``; map 0 is the identity (FULL windows and REUSE
tiles copy through unchanged).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.build import (I, L, P, CudaKernel, check_cuda,
                                       stream_of)
from repro_torch.kernels.fused_serving.ref import (  # noqa: F401
    _counts, _maps_on, _per_sample, pack_pos_plain, restore_gather_plain,
    upsample_token_maps)

PACK_POS = CudaKernel("fused_serving", "pack_pos",
                      [P, P, P, P, P, I, I, I, L, I, P])
RESTORE = CudaKernel("fused_serving", "restore_gather",
                     [P, P, P, P, P, P, I, I, I, I, I, I, I, I, P])


# ---------------------------------------------------------------------------
# pack_pos


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
    dt = PACK_POS.check_dtype("pack_pos", bank, pos_bank)
    nw_pad = src.shape[1]
    out = torch.empty((B, nw_pad * w2, C), dtype=bank.dtype,
                      device=bank.device)
    PACK_POS(bank, pos_bank, src,
             nwb, out, B, nbank, nw_pad, w2 * C,
             bank.device.index, stream_of(bank), dtype=dt)
    return out


# ---------------------------------------------------------------------------
# restore_gather


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
    dt = RESTORE.check_dtype("restore_gather", windows,
                             *([tiles_arg] if tiles_arg is not None else []))
    out = torch.empty((B, nout * w2, D), dtype=windows.dtype,
                      device=windows.device)
    RESTORE(windows, tiles_arg, src_idx,
            map_idx, maps, out, B, nw_pad,
            ntile, nout, maps.shape[0], w2, D, windows.device.index,
            stream_of(windows), dtype=dt)
    return out
