"""Kernel dispatch: routes each hot-path op by the device of its input.

A CUDA tensor launches the op's hand-written kernel (``csrc/``); a CPU
tensor takes the op's plain PyTorch version; any other device raises.
There is no backend knob and no environment switch, and a kernel that
fails to build or launch raises rather than falling back.

Each kernel keeps a launch count (``launch_counts``), which grows only
where a wrapper launched its kernel, so a run can show that it went
through the kernels.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.kernels.flash_attention import ops as _flash
from repro_torch.kernels.fused_serving import ops as _fused
from repro_torch.kernels.mixed_res_pool import ops as _pool
from repro_torch.kernels.window_attention import ops as _win

KERNELS = {
    "window_attention": _win.KERNEL,
    "flash_attention": _flash.KERNEL,
    "pack_pos": _fused.PACK_POS,
    "restore_gather": _fused.RESTORE,
    "avg_pool": _pool.KERNEL,
}


def on_card(x: torch.Tensor) -> bool:
    if x.is_cuda:
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"no kernel route for device {x.device}")


def launch_counts() -> Dict[str, int]:
    return {name: k.launches for name, k in KERNELS.items()}


def reset_launch_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0


def window_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     window: int,
                     win_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q: (B, T, H, Dh); k/v: (B, T, KV, Dh); ``window`` tokens per
    window; ``win_valid`` (B,) valid-window counts (pad windows -> 0)."""
    if on_card(q):
        return _win.window_attention_cuda(q, k, v, window, win_valid)
    return _win.window_attention_plain(q, k, v, window, win_valid)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = False) -> torch.Tensor:
    """q: (B, T, H, Dh); k/v: (B, S, KV, Dh)."""
    if on_card(q):
        return _flash.flash_attention_cuda(q, k, v, causal)
    return _flash.flash_attention_plain(q, k, v, causal)


def avg_pool(x: torch.Tensor, d: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, H/d, W/d, C) mean pool."""
    if d == 1:
        return x
    if on_card(x):
        return _pool.avg_pool_cuda(x, d)
    return _pool.avg_pool_plain(x, d)


def pack_pos(bank: torch.Tensor, pos_bank: torch.Tensor,
             win_src: torch.Tensor, nw: torch.Tensor) -> torch.Tensor:
    """Fused serving prologue: window-bank gather + positional add +
    pad-window zeroing.  Returns packed tokens (B, nw_pad * w2, C)."""
    if on_card(bank):
        return _fused.pack_pos_cuda(bank, pos_bank, win_src, nw)
    return _fused.pack_pos_plain(bank, pos_bank, win_src, nw)


def restore_gather(windows: torch.Tensor, out_src: torch.Tensor,
                   out_map: torch.Tensor, window: int, downsample: int,
                   reuse_tiles: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
    """Fused serving epilogue: destination-major restoration gather
    (window un-pack + LOW upsample + REUSE splice).  ``windows``: packed
    activations (B, nw_pad, w2, D).  Returns (B, nout * w2, D)."""
    if on_card(windows):
        return _fused.restore_gather_cuda(windows, out_src, out_map, window,
                                          downsample, reuse_tiles)
    return _fused.restore_gather_plain(windows, out_src, out_map, window,
                                       downsample, reuse_tiles)
