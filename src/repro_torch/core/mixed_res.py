"""Mixed-resolution tokenization and restoration (paper §III): the
layout ops of ``repro.core.mixed_res`` that the length-bucketed serving
path runs.

Layout (window-blocked, see core.partition): a sequence of whole
windows, each flattened row-major to ``w*w`` tokens.  The padded serving
lane packs from a window bank [every full-res window | one LOW window
per region] through ``kernels.dispatch.pack_pos`` and restores through
``kernels.dispatch.restore_gather``.
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
