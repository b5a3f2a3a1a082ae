"""Mixed-resolution tokenization and restoration (paper §III): the
layout ops of ``repro.core.mixed_res`` that the length-bucketed serving
path runs.

Layout (window-blocked, see core.partition): a sequence of whole
windows, each flattened row-major to ``w*w`` tokens.  The padded serving
lane packs from a window bank [every full-res window | one LOW window
per region] through ``kernels.dispatch.pack_pos`` and restores through
``kernels.dispatch.restore_gather``.  At beta == 0 (restore at input) it
packs with the plain gather :func:`pack_padded` and restores with
:func:`restore_padded`, whose LOW windows go through
``kernels.dispatch.nn_upsample``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.partition import Partition
from repro_torch.kernels import dispatch


# ---------------------------------------------------------------------------
# grid <-> window-blocked reshapes (pure layout, no compute)


def grid_to_region_windows(x: torch.Tensor, part: Partition) -> torch.Tensor:
    """(B, Hp, Wp, C) -> (B, nR, d^2, w^2, C) region-major window blocks."""
    B, Hp, Wp, C = x.shape
    w, d = part.window, part.downsample
    nRh, nRw = part.regions_h, part.regions_w
    x = x.reshape(B, nRh, d, w, nRw, d, w, C)
    x = x.permute(0, 1, 4, 2, 5, 3, 6, 7)          # B,nRh,nRw,d,d,w,w,C
    return x.reshape(B, nRh * nRw, d * d, w * w, C)


def region_windows_to_grid(x: torch.Tensor, part: Partition) -> torch.Tensor:
    """Inverse of :func:`grid_to_region_windows`."""
    B, C = x.shape[0], x.shape[-1]
    w, d = part.window, part.downsample
    nRh, nRw = part.regions_h, part.regions_w
    x = x.reshape(B, nRh, nRw, d, d, w, w, C)
    x = x.permute(0, 1, 3, 5, 2, 4, 6, 7)          # B,nRh,d,w,nRw,d,w,C
    return x.reshape(B, part.grid_h, part.grid_w, C)


def low_grid_to_windows(x_low: torch.Tensor, part: Partition) -> torch.Tensor:
    """(B, Hp/d, Wp/d, C) low-res grid -> (B, nR, w^2, C) one window/region."""
    B, C = x_low.shape[0], x_low.shape[-1]
    w = part.window
    nRh, nRw = part.regions_h, part.regions_w
    x = x_low.reshape(B, nRh, w, nRw, w, C)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, nRh * nRw, w * w, C)


def downsample_grid(x: torch.Tensor, d: int) -> torch.Tensor:
    """Average-pool a (B, Hp, Wp, C) grid by d (the avg_pool kernel)."""
    return dispatch.avg_pool(x, d)


def window_bank(x_grid: torch.Tensor, part: Partition,
                x_low_grid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, Hp, Wp, C) -> (B, nR*d^2 + nR, w^2, C) window bank: every
    full-res window of every region, then every region's LOW window."""
    regions = grid_to_region_windows(x_grid, part)        # B,nR,d^2,w^2,C
    B, nR, dd, w2, C = regions.shape
    if x_low_grid is None:
        x_low_grid = downsample_grid(x_grid, part.downsample)
    low = low_grid_to_windows(x_low_grid, part)           # B,nR,w^2,C
    return torch.cat([regions.reshape(B, nR * dd, w2, C), low], dim=1)


def pack_padded(x_grid: torch.Tensor, part: Partition, win_src: torch.Tensor,
                x_low_grid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The length-bucketed mixed sequence, unfused: window ``i`` of
    sample ``b`` is window ``win_src[b, i]`` of the bank (pad windows
    replicate window 0, as in the reference).  win_src: (nw_pad,) shared
    or (B, nw_pad).  Returns tokens (B, nw_pad * w^2, C)."""
    bank = window_bank(x_grid, part, x_low_grid)
    src = win_src.to(device=bank.device, dtype=torch.long)
    if src.dim() == 2:
        windows = bank[torch.arange(bank.shape[0],
                                    device=bank.device)[:, None], src]
    else:
        windows = bank[:, src]
    return windows.reshape(bank.shape[0], -1, bank.shape[-1])


def _per_sample(ids: torch.Tensor, B: int) -> torch.Tensor:
    ids = ids.to(torch.long)
    return ids[None].expand(B, ids.shape[0]) if ids.dim() == 1 else ids


def restore_padded(tokens: torch.Tensor, part: Partition,
                   win_dst: torch.Tensor, low_src: torch.Tensor,
                   low_ids: torch.Tensor) -> torch.Tensor:
    """Restore the full-resolution sequence from a padded mixed one.

    tokens: (B, nw_pad * w^2, D).  FULL windows scatter window-level at
    ``win_dst`` (pad and LOW windows carry the sentinel slot nR*d^2);
    LOW windows are gathered at ``low_src``, upsampled, and scattered
    region-level at ``low_ids`` (pads carry the sentinel region nR).
    Duplicate indices only ever hit a sentinel row, which is sliced off,
    so the order of the scatter's writes cannot change the result.
    Output: (B, Hp*Wp, D) window-blocked."""
    B, _, D = tokens.shape
    w, d = part.window, part.downsample
    w2 = w * w
    nR, dd = part.n_regions, part.windows_per_full_region
    windows = tokens.reshape(B, -1, w2, D)
    b = torch.arange(B, device=tokens.device)[:, None]
    dst = _per_sample(win_dst, B).to(tokens.device)
    lsrc = _per_sample(low_src, B).to(tokens.device)
    lids = _per_sample(low_ids, B).to(tokens.device)

    buf = tokens.new_zeros((B, nR * dd + 1, w2, D))
    buf[b, dst] = windows
    out = tokens.new_zeros((B, nR + 1, dd, w2, D))
    out[:, :nR] = buf[:, :nR * dd].reshape(B, nR, dd, w2, D)
    up = _upsample_low_windows(windows[b, lsrc].reshape(B, -1, w, w, D),
                               part)
    out[b, lids] = up
    return out[:, :nR].reshape(B, part.grid_h * part.grid_w, D)


def _upsample_low_windows(low_part: torch.Tensor, part: Partition
                          ) -> torch.Tensor:
    """Nearest-neighbour upsample LOW windows (B, n, w, w, D) ->
    (B, n, d^2, w^2, D) window-blocked full-region tiles (the
    ``nn_upsample`` kernel on the card)."""
    B, nL = low_part.shape[:2]
    D = low_part.shape[-1]
    w, d = part.window, part.downsample
    up = dispatch.nn_upsample(low_part.reshape(B * nL, w, w, D), d)
    up = up.reshape(B, nL, d, w, d, w, D)
    return up.permute(0, 1, 2, 4, 3, 5, 6).reshape(B, nL, d * d, w * w, D)


def full_seq_to_grid(tokens: torch.Tensor, part: Partition) -> torch.Tensor:
    """Window-blocked full sequence (B, Hp*Wp, D) -> (B, Hp, Wp, D)."""
    B, _, D = tokens.shape
    x = tokens.reshape(B, part.n_regions, part.windows_per_full_region,
                       part.window * part.window, D)
    return region_windows_to_grid(x, part)


def grid_to_full_seq(grid: torch.Tensor, part: Partition) -> torch.Tensor:
    """(B, Hp, Wp, D) -> window-blocked full sequence (B, Hp*Wp, D)."""
    x = grid_to_region_windows(grid, part)
    B, nR, dd, ww, D = x.shape
    return x.reshape(B, nR * dd * ww, D)


# ---------------------------------------------------------------------------
# device-resident feature-tile index ops (serving hot path): the
# FeatureCache keeps its restoration-point tiles on the card, so reuse
# gathers and capture refreshes never cross PCIe.


def gather_tiles(tiles: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """(n_regions, d^2, w^2, D), (n,) -> (n, d^2, w^2, D), on device."""
    return tiles.index_select(0, ids.to(device=tiles.device,
                                        dtype=torch.long))


def take_sample_tiles(wave_tiles: torch.Tensor, i: int) -> torch.Tensor:
    """(B, nR, d^2, w^2, D) wave capture -> sample ``i``'s (nR, ...) tiles
    (a view; :func:`refresh_tiles` or a clone gives it its own buffer)."""
    return wave_tiles[i]


def refresh_tiles(stale: torch.Tensor, new: torch.Tensor) -> torch.Tensor:
    """Overwrite ``stale`` in place with ``new`` (no new allocation per
    refresh); returns ``stale``."""
    return stale.copy_(new)
