"""Mixed-resolution tokenization and restoration (paper §III): the
layout ops of ``repro.core.mixed_res``.

Layout (window-blocked, see core.partition): a sequence of whole
windows, each flattened row-major to ``w*w`` tokens.  Two lanes:

  exact    :func:`pack_mixed` packs [full-region windows | one LOW window
           per LOW region] at the plan's exact length from region ids
           (``partition.plan_to_region_ids``), (n,) shared or (B, n) per
           sample; :func:`restore_full` restores it, splicing REUSE tiles.
  padded   the length-bucketed serving lane packs from a window bank
           [every full-res window | one LOW window per region] through
           ``kernels.dispatch.pack_pos`` and restores through
           ``kernels.dispatch.restore_gather``.  At beta == 0 (restore at
           input) it packs with the plain gather :func:`pack_padded` and
           restores with :func:`restore_padded`.

Both lanes upsample LOW windows through ``kernels.dispatch.nn_upsample``
and pool through ``kernels.dispatch.avg_pool``.  Padded region ids
repeat an id; every restoration writes each destination once (a
repeated LOW or REUSE id goes to a sentinel row that is dropped), so no
result depends on the order of a scatter's writes.
"""
from __future__ import annotations

from typing import Optional, Tuple

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


def _ids(ids, device) -> torch.Tensor:
    """Region ids (numpy or tensor) as a long tensor on ``device``."""
    return torch.as_tensor(ids, device=device).to(torch.long)


def _take_regions(x: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Rows ``ids`` of axis 1 of ``x``: (n,) ids shared by the batch or
    (B, n) ids per sample."""
    if ids.dim() == 2:
        b = torch.arange(x.shape[0], device=x.device)[:, None]
        return x[b, ids]
    return x.index_select(1, ids)


def pack_mixed(x_grid: torch.Tensor, part: Partition, full_ids, low_ids,
               x_low_grid: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The exact-length mixed-resolution window sequence.

    x_grid: (B, Hp, Wp, C) full-res patch grid; x_low_grid: the
    (B, Hp/d, Wp/d, C) low-res grid, pooled from x_grid when omitted (and
    not read at all when there is no LOW region).  full_ids / low_ids:
    (n,) shared or (B, n) per sample.  Returns (tokens (B, n_tokens, C),
    windows (B, n_windows, w^2, C) view)."""
    w2 = part.window * part.window
    regions = grid_to_region_windows(x_grid, part)        # B,nR,d^2,w^2,C
    B, C = regions.shape[0], regions.shape[-1]
    full_part = _take_regions(regions, _ids(full_ids, x_grid.device))
    if low_ids.shape[-1] > 0:
        if x_low_grid is None:
            x_low_grid = downsample_grid(x_grid, part.downsample)
        low_part = _take_regions(low_grid_to_windows(x_low_grid, part),
                                 _ids(low_ids, x_grid.device))
    else:           # no LOW region: the pooled grid is never read
        low_part = regions.new_zeros((B, 0, w2, C))
    windows = torch.cat([full_part.reshape(B, -1, w2, C), low_part], dim=1)
    return windows.reshape(B, -1, C), windows


def exact_window_src(part: Partition, full_ids, low_ids,
                     device=None) -> torch.Tensor:
    """The window-bank rows (:func:`window_bank`) that :func:`pack_mixed`
    packs, in order: each FULL region's d^2 windows, then each LOW
    region's window.  (n,) ids give (n_windows,), (B, n) ids
    (B, n_windows)."""
    dd, nR = part.windows_per_full_region, part.n_regions
    full = _ids(full_ids, device)
    low = _ids(low_ids, device)
    win = full[..., :, None] * dd + torch.arange(dd, device=full.device)
    return torch.cat([win.flatten(-2), nR * dd + low], dim=-1)


def pack_positions(pos_grid: torch.Tensor, part: Partition, full_ids,
                   low_ids) -> torch.Tensor:
    """Positional embeddings of the exact mixed sequence: pos_grid
    (Hp, Wp, D) packed as :func:`pack_mixed` packs a frame, LOW tokens
    getting the mean embedding of the d x d patches they stand for.
    (n,) ids give (n_tokens, D); (B, n) ids a (B, n_tokens, D) batch."""
    if torch.as_tensor(full_ids).dim() == 2:
        grid = pos_grid[None].expand(len(full_ids), *pos_grid.shape)
        return pack_mixed(grid, part, full_ids, low_ids)[0]
    return pack_mixed(pos_grid[None], part, full_ids, low_ids)[0][0]


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


def pack_positions_padded(pos_grid: torch.Tensor, part: Partition,
                          win_src: torch.Tensor) -> torch.Tensor:
    """Positional embeddings of the padded sequence (LOW windows get the
    mean embedding of their d x d patch groups, as in
    :func:`pack_positions`); (nw_pad,) win_src gives (nw_pad * w^2, D),
    (B, nw_pad) a batch."""
    if win_src.dim() == 2:
        grid = pos_grid[None].expand(win_src.shape[0], *pos_grid.shape)
        return pack_padded(grid, part, win_src)
    return pack_padded(pos_grid[None], part, win_src)[0]


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


def _dups_to_sentinel(ids: torch.Tensor, sentinel: int) -> torch.Tensor:
    """Map every repeat of an id (an equal id at an EARLIER position) to
    ``sentinel``, so only each id's first occurrence writes."""
    n = ids.shape[-1]
    if n <= 1:
        return ids
    eq = ids[..., :, None] == ids[..., None, :]           # (..., n, n)
    earlier = torch.ones((n, n), dtype=torch.bool,
                         device=ids.device).tril(-1)
    dup = (eq & earlier).any(dim=-1)
    return torch.where(dup, torch.full_like(ids, sentinel), ids)


def restore_full(tokens: torch.Tensor, part: Partition, full_ids, low_ids,
                 reuse_ids=None,
                 reuse_tiles: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Restore the full-resolution window-blocked sequence from an exact
    mixed one (:func:`pack_mixed`).

    LOW windows are upsampled nearest-neighbour (the ``nn_upsample``
    kernel on the card); REUSE regions, absent from ``tokens``, splice
    ``reuse_tiles`` ((B, n_reuse, d^2, w^2, D)) at ``reuse_ids``.  Ids are
    (n,) shared or (B, n) per sample.  The writes keep the reference's
    order (FULL, then LOW, then REUSE; within LOW or REUSE a repeated id's
    first occurrence), resolved on small index tensors; the activations
    then move once, by one gather.  Output: (B, Hp*Wp, D)."""
    B, _, D = tokens.shape
    w, d, dd = part.window, part.downsample, part.windows_per_full_region
    nR, w2 = part.n_regions, w * w
    dev = tokens.device
    full = _ids(full_ids, dev)
    nF = full.shape[-1]
    n_full_tok = nF * part.tokens_full_region
    src = [tokens[:, :n_full_tok].reshape(B, nF, dd, w2, D)]
    low_part = tokens[:, n_full_tok:].reshape(B, -1, w, w, D)
    nL = low_part.shape[1]
    # idx[b, r]: the row of ``src`` that destination region r takes (-1:
    # unwritten, the zero row); column nR is the sentinel
    idx = torch.full((B, nR + 1), -1, dtype=torch.long, device=dev)
    b = torch.arange(B, device=dev)[:, None]
    idx[b, _per_sample(full, B)] = torch.arange(nF, device=dev)
    n_src = nF
    if nL:
        src.append(_upsample_low_windows(low_part, part))
        low = _dups_to_sentinel(_per_sample(_ids(low_ids, dev), B), nR)
        idx[b, low] = n_src + torch.arange(nL, device=dev)
        n_src += nL
    if reuse_ids is not None and reuse_ids.shape[-1]:
        reuse = _dups_to_sentinel(_per_sample(_ids(reuse_ids, dev), B), nR)
        src.append(reuse_tiles.to(tokens.dtype))
        idx[b, reuse] = n_src + torch.arange(reuse.shape[-1], device=dev)
        n_src += reuse.shape[-1]
    src.append(tokens.new_zeros((B, 1, dd, w2, D)))
    idx = torch.where(idx < 0, n_src, idx)[:, :nR]
    out = torch.cat(src, dim=1)[b, idx]
    return out.reshape(B, part.grid_h * part.grid_w, D)


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
