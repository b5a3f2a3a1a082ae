"""ViTDet-style backbone with dynamic mixed-resolution inference (paper
§III); port of ``repro.core.vit_backbone``.

``n_layers`` pre-norm ViT blocks split into N subsets of M blocks;
within a subset the first M-1 blocks use window attention and the last
global attention.  Lanes:

  full resolution   the frame's whole window-blocked sequence, with or
                    without capturing restoration-point tiles;
  exact (ids)       the reference's unpadded form of the paper's C1:
                    region ids (``full_ids`` / ``low_ids`` /
                    ``reuse_ids``, core.partition) -> ``mixed_res.
                    pack_mixed`` at the plan's exact length -> blocks
                    with no pad mask -> ``mixed_res.restore_full``
                    (LOW windows through ``nn_upsample``, REUSE tiles
                    spliced) inside subset ``beta``; at beta 0 it
                    restores at the input;
  padded (beta>=1)  the length-bucketed mixed sequence of a PlanLayout:
                    window bank -> ``pack_pos`` kernel -> blocks with
                    ``win_valid`` / ``kv_len`` -> ``restore_gather``
                    kernel (splicing REUSE tiles) inside subset ``beta``
                    -> remaining blocks -> capture;
  padded (beta=0)   restore at input (the paper's "Subset 0"): the
                    window-bank gather, then ``mixed_res.restore_padded``
                    (LOW windows through the ``nn_upsample`` kernel) and
                    the full-resolution positions, then every block at
                    full length; no REUSE tiles (they are
                    restoration-point features).

Positions come from the two layouts ``add_position_banks`` derives once
per parameter tree (:func:`packed_positions` gathers every lane's from
them), so no forward re-packs the positional grid.

Every linear weight may be a ``quant.qtensor.QuantTensor`` (the int8
lane): the GEMMs route through ``qtensor.matmul``.

``backbone_flops`` / ``backbone_flops_windows`` are the reference's
analytic cost model (plain arithmetic), behind
``offload.estimator.InferenceDelayModel.fit_from_flops``.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

from repro_torch.core import det_head as dh
from repro_torch.core import mixed_res as mr
from repro_torch.core.partition import (Partition, length_bucket as
                                        pt_length_bucket, make_partition)
from repro_torch.kernels import dispatch
from repro_torch.models import attention as attn
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig
from repro_torch.quant import qtensor as qt

# parameter-tree keys derived from pos_emb by add_position_banks
DERIVED_KEYS = ("pos_seq", "pos_bank")


def vit_partition(cfg: ModelConfig) -> Partition:
    v = cfg.vit
    d = cfg.mixed_res.downsample if cfg.mixed_res else 2
    return make_partition(v.img_size[0] // v.patch_size,
                          v.img_size[1] // v.patch_size, v.window_size, d)


def blocks_per_subset(cfg: ModelConfig) -> int:
    assert cfg.n_layers % cfg.vit.n_subsets == 0
    return cfg.n_layers // cfg.vit.n_subsets


def add_position_banks(cfg: ModelConfig, params: Dict) -> Dict:
    """Derive, once per parameter set, the two layouts of the positional
    grid the forward adds: ``pos_seq``, the full-resolution window-blocked
    sequence, and ``pos_bank``, the (nR*d^2 + nR, w^2, D) window bank that
    the fused pack gathers from (LOW windows get the mean embedding of
    their d x d patch groups).  A quantized grid is dequantized first."""
    pos = qt.asarray(params["pos_emb"])
    params["pos_seq"] = position_seq(cfg, pos)
    params["pos_bank"] = pos_window_bank(pos, vit_partition(cfg))
    return params


def pos_window_bank(pos: torch.Tensor, part: Partition) -> torch.Tensor:
    """The (nR*d^2 + nR, w^2, D) window bank of the (Hp, Wp, D)
    positional grid: every full-res window, then every region's LOW
    window (the mean embedding of its d x d patch groups)."""
    return mr.window_bank(pos[None], part)[0]


def packed_positions(params: Dict, part: Partition, full_ids=None,
                     low_ids=None) -> torch.Tensor:
    """Positional embeddings of a layout, gathered from the tree's
    derived ``pos_bank`` / ``pos_seq``: the bytes
    ``mixed_res.pack_positions`` computes from the grid.  Region ids
    give the exact lane's ((n,) ids (n_tokens, D), (B, n) ids a batch);
    no ids the full-resolution sequence."""
    if low_ids is None:
        return params["pos_seq"]
    bank = params["pos_bank"]
    src = mr.exact_window_src(part, full_ids, low_ids, bank.device)
    return bank[src].flatten(-3, -2)


def position_seq(cfg: ModelConfig, pos_emb: torch.Tensor) -> torch.Tensor:
    """The full-resolution window-blocked layout of the (Hp, Wp, D)
    positional grid, the only layout the full-resolution lane reads.  A
    training loss derives it from ``pos_emb`` inside the autograd graph
    (``train.server.loss_fn``), so the grid gets its gradient."""
    return mr.grid_to_full_seq(pos_emb[None], vit_partition(cfg))[0]


def strip_derived(params: Dict) -> Dict:
    """The parameter tree without the layouts ``add_position_banks``
    derives (a shallow copy)."""
    return {k: v for k, v in params.items() if k not in DERIVED_KEYS}


def patchify(image: torch.Tensor, patch: int) -> torch.Tensor:
    """(B, H, W, 3) -> (B, H/p, W/p, p*p*3) raw patch grid."""
    B, H, W, C = image.shape
    x = image.reshape(B, H // patch, patch, W // patch, patch, C)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, H // patch, W // patch, patch * patch * C)


def embed_patches(cfg: ModelConfig, params, image: torch.Tensor,
                  downsample: int = 1) -> torch.Tensor:
    """Patchify the (optionally pixel-downsampled) image and project to D."""
    if downsample > 1:
        image = mr.downsample_grid(image, downsample)
    p = params["patch_embed"]
    return qt.matmul(patchify(image, cfg.vit.patch_size), p["w"]) + p["b"]


def _vit_block(cfg: ModelConfig, p, x: torch.Tensor, *, window: int,
               kv_len: Optional[torch.Tensor] = None,
               win_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x: (B, T, D) window-blocked.  window=0 -> global attention."""
    h = L.apply_norm(cfg, p["ln1"], x)
    x = x + attn.attention_forward(cfg, p["attn"], h, window=window,
                                   kv_len=kv_len, win_valid=win_valid)
    h = L.apply_norm(cfg, p["ln2"], x)
    return x + L.apply_mlp(cfg, p["ffn"], h)


def forward_features(cfg: ModelConfig, params, image: torch.Tensor,
                     full_ids=None, low_ids=None, beta: int = 0,
                     reuse_ids=None,
                     reuse_tiles: Optional[torch.Tensor] = None,
                     capture_beta: int = 0,
                     layout: Optional[Dict[str, torch.Tensor]] = None):
    """Backbone forward.  Returns the (B, Hp, Wp, D) full-resolution
    feature map, or ``(feats, tiles)`` when ``capture_beta > 0``.

    full_ids / low_ids / reuse_ids: region ids of the exact lane, (n,)
    shared or (B, n) per sample (``partition.plan_to_region_ids``); None
    or empty low and reuse ids run the full-resolution lane.  REUSE
    regions are absent from the packed sequence and splice from
    ``reuse_tiles`` (B, n_reuse, d^2, w^2, D), tiles captured at the
    same restoration point, which needs ``beta >= 1``; an empty
    ``reuse_ids`` leaves the lane bit-identical to none.  With LOW
    regions at ``beta == 0`` the lane restores at the input.

    layout: the PlanLayout arrays of a length-bucketed padded sequence
    instead of ids (``win_src`` (·, nw_pad), ``nw``, ``out_src`` /
    ``out_map`` (·, nR*d^2) at beta >= 1; ``win_src``, ``win_dst``
    (·, nw_pad), ``low_src`` / ``low_ids`` (·, nR) at beta == 0; each
    shared or per-sample; core.partition).  At beta >= 1 REUSE regions
    splice from ``reuse_tiles`` (B, nR, d^2, w^2, D); at beta == 0 there
    are none.

    capture_beta: also return the per-region tiles (B, nR, d^2, w^2, D)
    of the token state entering the global block of subset
    ``capture_beta`` (>= beta for a mixed forward).
    """
    part = vit_partition(cfg)
    M = blocks_per_subset(cfg)
    N = cfg.vit.n_subsets
    w2 = part.window * part.window
    padded = layout is not None
    n_reuse = 0 if reuse_ids is None else reuse_ids.shape[-1]
    has_low = low_ids is not None and low_ids.shape[-1] > 0
    exact = not padded and (has_low or n_reuse > 0)
    mixed = (padded or exact) and beta > 0
    assert 0 <= beta <= N and 0 <= capture_beta <= N
    if padded:
        assert full_ids is None and low_ids is None and reuse_ids is None
        if beta == 0:
            assert reuse_tiles is None, \
                "REUSE tiles cannot splice at beta == 0 (restore at input)"
    elif reuse_ids is None:
        assert reuse_tiles is None, "REUSE tiles need reuse_ids or a layout"
    if n_reuse:
        assert beta >= 1, "REUSE regions need a restoration point >= 1"
        assert reuse_tiles is not None
    if capture_beta and mixed:
        assert capture_beta >= beta, \
            "cannot capture tiles before the restoration point"

    x_full = embed_patches(cfg, params, image)                # B,Hp,Wp,D
    kv_len = win_valid = x_low = None
    if padded or has_low:
        # the padded lane always packs the pooled grid (one layout shape
        # serves every plan mix); an exact reuse-only plan never reads it
        x_low = embed_patches(cfg, params, image, part.downsample)
    if padded and mixed:
        bank = mr.window_bank(x_full, part, x_low)
        tokens = dispatch.pack_pos(bank, params["pos_bank"],
                                   layout["win_src"], layout["nw"])
        win_valid = layout["nw"].to(torch.int32).reshape(-1).expand(
            tokens.shape[0]).contiguous()
        kv_len = win_valid * w2
    elif padded:                          # beta == 0: restore at input
        tokens = mr.pack_padded(x_full, part, layout["win_src"], x_low)
        tokens = mr.restore_padded(tokens, part, layout["win_dst"],
                                   layout["low_src"], layout["low_ids"])
        tokens = tokens + params["pos_seq"]
    elif mixed:                           # exact lane, beta >= 1
        tokens, _ = mr.pack_mixed(x_full, part, full_ids, low_ids, x_low)
        tokens = tokens + packed_positions(params, part, full_ids, low_ids)
    elif exact:                           # exact lane, restore at input
        tokens, _ = mr.pack_mixed(x_full, part, full_ids, low_ids, x_low)
        tokens = mr.restore_full(tokens, part, full_ids, low_ids)
        tokens = tokens + params["pos_seq"]
    else:
        tokens = mr.grid_to_full_seq(x_full, part) + params["pos_seq"]

    tiles = None
    restored = not mixed
    for s in range(N):
        for m in range(M):
            p_blk = params["blocks"][s * M + m]
            is_global = m == M - 1
            if is_global and not restored and beta == s + 1:
                B, D = tokens.shape[0], tokens.shape[-1]
                if padded:
                    tokens = dispatch.restore_gather(
                        tokens.reshape(B, -1, w2, D), layout["out_src"],
                        layout["out_map"], part.window, part.downsample,
                        reuse_tiles=reuse_tiles)
                else:
                    tokens = mr.restore_full(
                        tokens, part, full_ids, low_ids,
                        reuse_ids=reuse_ids if n_reuse else None,
                        reuse_tiles=reuse_tiles if n_reuse else None)
                restored = True
            if is_global and capture_beta == s + 1:
                tiles = tokens.reshape(tokens.shape[0], part.n_regions,
                                       part.windows_per_full_region, w2,
                                       tokens.shape[-1])
            tokens = _vit_block(cfg, p_blk, tokens,
                                window=0 if is_global else w2,
                                kv_len=None if restored else kv_len,
                                win_valid=None if restored else win_valid)

    tokens = L.apply_norm(cfg, params["final_norm"], tokens)
    feats = mr.full_seq_to_grid(tokens, part)
    if capture_beta:
        return feats, tiles
    return feats


def forward_det(cfg: ModelConfig, params, image: torch.Tensor,
                full_ids=None, low_ids=None, beta: int = 0,
                reuse_ids=None, reuse_tiles: Optional[torch.Tensor] = None,
                capture_beta: int = 0,
                layout: Optional[Dict[str, torch.Tensor]] = None):
    """Backbone + dense head (arguments as :func:`forward_features`).
    Returns the det-head outputs, or ``(outputs, tiles)`` when
    ``capture_beta > 0``."""
    dispatch.disable_tf32()
    feats = forward_features(cfg, params, image, full_ids, low_ids, beta,
                             reuse_ids=reuse_ids, reuse_tiles=reuse_tiles,
                             capture_beta=capture_beta, layout=layout)
    if capture_beta:
        feats, tiles = feats
        return dh.det_head_forward(cfg, params["head"], feats), tiles
    return dh.det_head_forward(cfg, params["head"], feats)


# ---------------------------------------------------------------------------
# FLOP accounting (used by the latency model and Fig. 5 benchmark)


def backbone_flops_windows(cfg: ModelConfig, n_windows: int,
                           beta: int) -> float:
    """Analytic attention+MLP FLOPs with the PRE-restoration sequence
    pinned to ``n_windows`` windows (``n_windows * w^2`` tokens) — the
    cost of a length-bucketed padded forward, where pad windows are
    masked but still computed.  ``beta == 0`` or a full-length
    ``n_windows`` degenerates to the plain full-resolution cost.
    """
    part = vit_partition(cfg)
    D, F = cfg.d_model, cfg.d_ff
    M = blocks_per_subset(cfg)
    N = cfg.vit.n_subsets
    w2 = part.window * part.window

    n_mixed = n_windows * w2
    n_full = part.grid_h * part.grid_w
    nw_full = part.n_regions * part.windows_per_full_region

    def block_flops(n_tok, n_win):
        proj = 4 * 2 * n_tok * D * D                     # qkvo projections
        if n_win:                                        # window attention
            att = 2 * 2 * n_win * w2 * w2 * D
        else:                                            # global attention
            att = 2 * 2 * n_tok * n_tok * D
        mlp = 2 * 2 * n_tok * D * F
        return proj + att + mlp

    total = 0.0
    restored = beta <= 0
    for s in range(N):
        for m in range(M):
            is_global = m == M - 1
            if is_global and not restored and beta == s + 1:
                restored = True
            if restored:
                total += block_flops(n_full, 0 if is_global else nw_full)
            else:
                total += block_flops(n_mixed, 0 if is_global else n_windows)
    return total


def backbone_flops(cfg: ModelConfig, n_low: int, beta: int,
                   n_reuse: int = 0,
                   length_edges: Optional[Sequence[int]] = None) -> float:
    """Analytic attention+MLP FLOPs of the backbone for a given config.

    Mirrors forward_features' block schedule; used to parameterise the
    inference-delay linear models LM^inf_beta(N_d, N_r) (paper §IV-D,
    extended with the temporal-reuse term: reused regions contribute NO
    tokens before the restoration point).

    ``length_edges``: cost the PADDED length bucket the serving hot path
    actually runs (partition.length_bucket_set) instead of the exact
    mixed length — what LM^inf must model once executables are keyed on
    length buckets rather than (n_low, n_reuse).
    """
    part = vit_partition(cfg)
    mixed = (n_low > 0 or n_reuse > 0) and beta > 0
    if not mixed:
        return backbone_flops_windows(
            cfg, part.n_regions * part.windows_per_full_region, 0)
    nw = part.n_windows(n_low, n_reuse)
    if length_edges is not None:
        # the degenerate all-reuse point (0 transmitted windows) is not
        # servable (policies keep >= 1 transmitted region) but delay-
        # model fits probe it — cost it at the smallest bucket
        nw = pt_length_bucket(max(nw, 1), length_edges)
    return backbone_flops_windows(cfg, nw, beta)
