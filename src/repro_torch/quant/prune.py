"""Attention-head pruning for the deployment config; port of
``repro.quant.prune``.

Score each (layer, head), drop the lowest-k per layer, and RE-PACK the
parameter tree: the head's q/k/v column blocks of the fused ``w_qkv``,
their biases, and its ``w_o`` input rows are sliced out and ``n_heads``
shrinks in the config, so the kernels see a genuinely narrower q_dim.

Head score = mean |head output| on calibration frames (captured by
``models.attention.head_tap``) x the Frobenius norm of the head's w_o
rows; with no calibration frames the w_o norm alone ranks heads.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import vit_backbone as vb
from repro_torch.models import attention as attn
from repro_torch.models.config import ModelConfig
from repro_torch.quant import qtensor as qt


def _np(t) -> np.ndarray:
    return qt.asarray(t).detach().float().cpu().numpy()


def w_o_head_norms(cfg: ModelConfig, params) -> np.ndarray:
    """(n_layers, n_heads) Frobenius norm of each head's w_o rows."""
    H, Dh = cfg.n_heads, cfg.head_dim
    out = []
    for blk in params["blocks"]:
        w_o = _np(blk["attn"]["w_o"])                       # (H*Dh, D)
        out.append(np.linalg.norm(
            w_o.reshape(H, Dh * w_o.shape[-1]), axis=1))
    return np.stack(out)


def score_heads(cfg: ModelConfig, params, frames: Sequence[np.ndarray]
                ) -> np.ndarray:
    """(n_layers, n_heads) head importance on calibration frames: the
    full-resolution forward with the head tap armed, times the w_o
    norms."""
    dev = params["patch_embed"]["b"].device
    store: List[np.ndarray] = []
    with attn.head_tap(store), torch.no_grad():
        for f in frames:
            img = torch.as_tensor(np.asarray(f, np.float32),
                                  device=dev)[None]
            vb.forward_features(cfg, params, img)
    acts = np.stack(store).reshape(len(frames), cfg.n_layers, cfg.n_heads)
    return acts.mean(axis=0) * w_o_head_norms(cfg, params)


def prune_heads(cfg: ModelConfig, params, k: int,
                scores: Optional[np.ndarray] = None):
    """Drop the ``k`` lowest-scoring heads per layer of a float tree;
    returns the re-packed ``(cfg, params, kept)``.  ``scores``:
    (n_layers, n_heads), default the w_o-norm proxy.  MHA only."""
    if k <= 0:
        return cfg, params, [list(range(cfg.n_heads))] * cfg.n_layers
    assert cfg.n_heads == cfg.n_kv_heads, \
        "head pruning supports MHA only (n_heads == n_kv_heads)"
    H, Dh = cfg.n_heads, cfg.head_dim
    assert 0 < k < H, f"cannot drop {k} of {H} heads"
    if scores is None:
        scores = w_o_head_norms(cfg, params)
    assert scores.shape == (cfg.n_layers, H)

    blocks = []
    kept: List[List[int]] = []
    for l, blk in enumerate(params["blocks"]):
        keep = np.sort(np.argsort(scores[l], kind="stable")[k:])
        kept.append([int(i) for i in keep])
        a = dict(blk["attn"])
        assert not isinstance(a["w_qkv"], qt.QuantTensor), \
            "prune the float tree before quantizing it"
        idx = torch.as_tensor(keep, device=a["w_qkv"].device)
        D = a["w_qkv"].shape[0]
        # the fused columns are [q | k | v], each (H, Dh) head-major
        a["w_qkv"] = a["w_qkv"].reshape(D, 3, H, Dh)[:, :, idx] \
            .reshape(D, 3 * len(keep) * Dh)
        a["b_qkv"] = a["b_qkv"].reshape(3, H, Dh)[:, idx].reshape(-1)
        w_o = a["w_o"]                                       # (H*Dh, D)
        a["w_o"] = w_o.reshape(H, Dh, w_o.shape[-1])[idx] \
            .reshape(len(keep) * Dh, w_o.shape[-1])
        blocks.append({**blk, "attn": a})
    out = dict(params)
    out["blocks"] = blocks
    return cfg.replace(n_heads=H - k, n_kv_heads=H - k), out, kept


def zero_heads(cfg: ModelConfig, params, dropped: Sequence[Sequence[int]]):
    """The dense twin of :func:`prune_heads`: zero the listed heads' w_o
    rows per layer, leaving shapes unchanged."""
    H, Dh = cfg.n_heads, cfg.head_dim
    blocks = []
    for l, blk in enumerate(params["blocks"]):
        w_o = blk["attn"]["w_o"]
        mask = torch.ones((H, 1, 1), dtype=w_o.dtype, device=w_o.device)
        mask[list(dropped[l])] = 0.0
        w3 = w_o.reshape(H, Dh, w_o.shape[-1]) * mask
        blocks.append({**blk, "attn": {**blk["attn"],
                                       "w_o": w3.reshape(w_o.shape)}})
    return {**params, "blocks": blocks}
