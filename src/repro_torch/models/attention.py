"""Attention (the ``repro.models.attention`` subset the ViT, dense-LM and
hybrid serving paths run): fused QKV projection, global, causal and window
scaled dot-product attention, and the LM's KV-cache prefill and decode.
Layouts: activations (B, T, D); q/k/v (B, T, H, Dh); caches
(B, max_len, KV, Dh).

``sdpa`` routes as the reference's kernel lane does: the plain
full-sequence case (causal or not) to the flash kernel, the one-token
``kv_len`` cache read to the decode kernel, everything else (a
multi-token ``kv_len`` mask, as in the pre-restoration global blocks of a
padded ViT sequence; a nonzero ``q_offset``; an explicit ``scale``) to
the masked dense path, as the reference leaves it to XLA.  Projections
go through ``quant.qtensor.matmul``, so their weights may be int8
``QuantTensor``s.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import dispatch
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig
from repro_torch.quant import qtensor as qt

NEG_INF = -2.0 ** 30   # large-finite: avoids NaN rows for fully-masked queries
Q_CHUNK = 1024         # query block of the chunked dense path

# Head-importance tap (quant.prune calibration): when armed, every
# attention_forward appends the per-head mean |output| (pre-w_o) to the
# store; the backbone makes n_layers attention calls per forward, in
# layer order, so the store reshapes to (frames, layers, heads).
_HEAD_TAP: Optional[List[np.ndarray]] = None


@contextlib.contextmanager
def head_tap(store: List[np.ndarray]):
    """Arm the per-head output-magnitude tap for calibration."""
    global _HEAD_TAP
    prev = _HEAD_TAP
    _HEAD_TAP = store
    try:
        yield store
    finally:
        _HEAD_TAP = prev


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
         causal: bool = False, q_offset: int = 0,
         kv_len: Optional[torch.Tensor] = None,
         scale: Optional[float] = None) -> torch.Tensor:
    """q: (B,T,H,Dh)  k/v: (B,S,KV,Dh) with H = KV * G.  Returns (B,T,H,Dh).

    ``causal``: query t (at absolute position ``q_offset + t``) sees keys
    s <= q_offset + t.  ``kv_len``: optional (B,) count of valid keys per
    sample; keys past it are masked.  ``scale`` defaults to Dh^-0.5.
    Long masked sequences (T > 2*Q_CHUNK) run Q_CHUNK query rows at a
    time.
    """
    plain = kv_len is None and q_offset == 0 and scale is None
    if plain:
        return dispatch.flash_attention(q, k, v, causal=causal)
    if (q.shape[1] == 1 and not causal and q_offset == 0
            and scale is None):
        return dispatch.decode_attention(q, k, v, kv_len)
    if q.shape[1] > 2 * Q_CHUNK:
        return torch.cat([
            _sdpa_dense(q[:, t0:t0 + Q_CHUNK], k, v, causal=causal,
                        q_offset=q_offset + t0, kv_len=kv_len, scale=scale)
            for t0 in range(0, q.shape[1], Q_CHUNK)], dim=1)
    return _sdpa_dense(q, k, v, causal=causal, q_offset=q_offset,
                       kv_len=kv_len, scale=scale)


def _sdpa_dense(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                causal: bool = False, q_offset: int = 0,
                kv_len: Optional[torch.Tensor] = None,
                scale: Optional[float] = None) -> torch.Tensor:
    B, T, H, Dh = q.shape
    S, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = Dh ** -0.5 if scale is None else scale
    qg = q.reshape(B, T, KV, G, Dh).float()
    logits = torch.einsum("btkgd,bskd->bkgts", qg, k.float()) * scale
    if causal:
        seen = (torch.arange(T, device=q.device)[:, None] + q_offset
                >= torch.arange(S, device=q.device)[None, :])         # (T,S)
        logits = logits.masked_fill(~seen, NEG_INF)
    if kv_len is not None:
        valid = (torch.arange(S, device=q.device)[None, :]
                 < kv_len.to(q.device)[:, None])                      # (B,S)
        logits = logits.masked_fill(~valid[:, None, None, None], NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgts,bskd->btkgd", probs, v.float())
    return out.reshape(B, T, H, Dh).to(q.dtype)


def window_sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                window: int, *,
                win_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Non-overlapping window attention: each run of ``window`` tokens
    attends only to itself.  ``win_valid``: optional (B,) count of valid
    windows; pad windows output zeros."""
    return dispatch.window_attention(q, k, v, window, win_valid)


def _project_qkv(cfg: ModelConfig, p: Dict[str, torch.Tensor],
                 x: torch.Tensor, rope=None) -> Tuple[torch.Tensor, ...]:
    """One fused (D, q_dim + 2*kv_dim) GEMM, at prefill and at decode
    alike; q, k and v are column views of its output (the kernels read
    them through their strides).  The reference concatenates its three
    weights on every prefill and keeps three GEMMs at decode; each output
    column depends only on its own weight column, so the results agree
    up to the GEMM's summation order.  Then ``qk_norm`` (per head) and,
    the rotation by ``rope`` (``layers.rope_table``; None for none)."""
    B, T, _ = x.shape
    qkv = qt.matmul(x, p["w_qkv"])
    if "b_qkv" in p:
        qkv = qkv + p["b_qkv"]
    q, k, v = torch.split(qkv, (cfg.q_dim, cfg.kv_dim, cfg.kv_dim), dim=-1)
    q = q.reshape(B, T, cfg.n_heads, cfg.head_dim)
    k = k.reshape(B, T, cfg.n_kv_heads, cfg.head_dim)
    v = v.reshape(B, T, cfg.n_kv_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = L.rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = L.rms_norm(k, p["k_norm"], cfg.norm_eps)
    q = L.apply_rope(q, rope)
    k = L.apply_rope(k, rope)
    return q, k, v


def attention_forward(cfg: ModelConfig, p: Dict[str, torch.Tensor],
                      x: torch.Tensor, *, window: int = 0,
                      kv_len: Optional[torch.Tensor] = None,
                      win_valid: Optional[torch.Tensor] = None,
                      rope=None, causal: bool = False) -> torch.Tensor:
    """Full-sequence attention without a cache: the ViT's layers (no
    rotation, not causal) and the hybrid LM's shared block without a
    cache (``rope``: the positions' ``layers.rope_table``, causal).
    ``window`` > 0 selects window attention over runs of ``window``
    tokens, else global attention; ``kv_len`` / ``win_valid`` carry a
    padded sequence's validity."""
    q, k, v = _project_qkv(cfg, p, x, rope)
    if window > 0:
        out = window_sdpa(q, k, v, window, win_valid=win_valid)
    else:
        out = sdpa(q, k, v, causal=causal, kv_len=kv_len)
    if _HEAD_TAP is not None:
        _HEAD_TAP.append(out.float().abs().mean(dim=(0, 1, 3)).cpu().numpy())
    return _out_proj(cfg, p, out)


# ---------------------------------------------------------------------------
# LM attention with a KV cache


def _out_proj(cfg: ModelConfig, p: Dict[str, torch.Tensor],
              out: torch.Tensor) -> torch.Tensor:
    B, T = out.shape[:2]
    out = qt.matmul(out.reshape(B, T, cfg.q_dim), p["w_o"])
    return out + p["b_o"] if "b_o" in p else out


def init_attention(cfg: ModelConfig, generator: torch.Generator,
                   device="cuda") -> Dict[str, torch.Tensor]:
    """Seeded LM attention weights: q, k and v drawn apart (the
    reference's ``init_attention``) and stored fused as ``w_qkv``; ones
    for the qk norms, zeros for the biases."""
    D = cfg.d_model
    p = {"w_qkv": torch.cat([L.dense_init(D, cfg.q_dim, generator, device),
                             L.dense_init(D, cfg.kv_dim, generator, device),
                             L.dense_init(D, cfg.kv_dim, generator, device)],
                            dim=1),
         "w_o": L.dense_init(cfg.q_dim, D, generator, device)}
    if cfg.qk_norm:
        p.update(q_norm=torch.ones(cfg.head_dim, device=device),
                 k_norm=torch.ones(cfg.head_dim, device=device))
    if cfg.attention_bias:
        p.update(b_qkv=torch.zeros(cfg.q_dim + 2 * cfg.kv_dim, device=device),
                 b_o=torch.zeros(D, device=device))
    return p


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int,
                  dtype: torch.dtype = torch.float32,
                  device="cuda") -> Dict[str, torch.Tensor]:
    shape = (batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def attention_prefill(cfg: ModelConfig, p: Dict[str, torch.Tensor],
                      x: torch.Tensor, rope, cache: Dict[str, torch.Tensor]
                      ) -> torch.Tensor:
    """Prefill: causal attention over x (B, T, D); k/v are written into
    ``cache`` IN PLACE at [0, T) (the reference returns an updated copy;
    here the caller's cache tensors are the state).  ``rope``: the
    positions' ``layers.rope_table``, or None for no rotation."""
    T = x.shape[1]
    q, k, v = _project_qkv(cfg, p, x, rope)
    cache["k"][:, :T] = k
    cache["v"][:, :T] = v
    return _out_proj(cfg, p, sdpa(q, k, v, causal=True))


def attention_decode(cfg: ModelConfig, p: Dict[str, torch.Tensor],
                     x: torch.Tensor, pos: int, rope,
                     cache: Dict[str, torch.Tensor],
                     kv_len: torch.Tensor) -> torch.Tensor:
    """One-token decode.  x: (B, 1, D); ``pos``: the absolute position
    of the token; ``rope``: its ``layers.rope_table``.  k/v are written
    into ``cache`` IN PLACE at ``pos`` (no copy of the cache per step);
    the query reads the cache through ``kv_len``, the (B,) int32 count
    pos + 1 of valid keys that a step builds once for all layers (the
    decode kernel on the card)."""
    q, k, v = _project_qkv(cfg, p, x, rope)
    cache["k"][:, pos] = k[:, 0]
    cache["v"][:, pos] = v[:, 0]
    return _out_proj(cfg, p, sdpa(q, cache["k"], cache["v"], kv_len=kv_len))
