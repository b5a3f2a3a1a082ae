"""ViT attention (the ``repro.models.attention`` subset the serving path
runs): fused QKV projection, global and window scaled dot-product
attention.  Layouts: activations (B, T, D); q/k/v (B, T, H, Dh).

Unmasked global attention goes to the flash kernel and window attention
to the window kernel (``kernels.dispatch``).  Global attention with a
per-sample ``kv_len`` (the pre-restoration global blocks of a padded
sequence) stays plain PyTorch, as the reference leaves it to XLA.  The
QKV and output projections go through ``quant.qtensor.matmul``, so their
weights may be int8 ``QuantTensor``s.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import dispatch
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
         kv_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Bidirectional global attention.  q: (B,T,H,Dh)  k/v: (B,S,KV,Dh)
    with H = KV * G.  Returns (B,T,H,Dh).

    ``kv_len``: optional (B,) count of valid keys per sample; keys past
    it are masked.  Without it the call is the flash kernel's.  Long
    masked sequences (T > 2*Q_CHUNK) run Q_CHUNK query rows at a time.
    """
    if kv_len is None:
        return dispatch.flash_attention(q, k, v)
    if q.shape[1] > 2 * Q_CHUNK:
        return torch.cat([_sdpa_dense(q[:, t0:t0 + Q_CHUNK], k, v, kv_len)
                          for t0 in range(0, q.shape[1], Q_CHUNK)], dim=1)
    return _sdpa_dense(q, k, v, kv_len)


def _sdpa_dense(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                kv_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    B, T, H, Dh = q.shape
    S, KV = k.shape[1], k.shape[2]
    G = H // KV
    qg = q.reshape(B, T, KV, G, Dh).float()
    logits = torch.einsum("btkgd,bskd->bkgts", qg, k.float()) * Dh ** -0.5
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
                 x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """One fused (D, q_dim + 2*kv_dim) GEMM; q, k and v are column views
    of its output (the kernels read them through their strides)."""
    B, T, _ = x.shape
    qkv = qt.matmul(x, p["w_qkv"]) + p["b_qkv"]
    q, k, v = torch.split(qkv, (cfg.q_dim, cfg.kv_dim, cfg.kv_dim), dim=-1)
    return (q.reshape(B, T, cfg.n_heads, cfg.head_dim),
            k.reshape(B, T, cfg.n_kv_heads, cfg.head_dim),
            v.reshape(B, T, cfg.n_kv_heads, cfg.head_dim))


def attention_forward(cfg: ModelConfig, p: Dict[str, torch.Tensor],
                      x: torch.Tensor, *, window: int = 0,
                      kv_len: Optional[torch.Tensor] = None,
                      win_valid: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """ViT attention layer (no RoPE).  ``window`` > 0 selects window
    attention over runs of ``window`` tokens, else global attention;
    ``kv_len`` / ``win_valid`` carry a padded sequence's validity."""
    q, k, v = _project_qkv(cfg, p, x)
    if window > 0:
        out = window_sdpa(q, k, v, window, win_valid=win_valid)
    else:
        out = sdpa(q, k, v, kv_len=kv_len)
    if _HEAD_TAP is not None:
        _HEAD_TAP.append(out.float().abs().mean(dim=(0, 1, 3)).cpu().numpy())
    return qt.matmul(out.reshape(x.shape[0], x.shape[1], cfg.q_dim),
                     p["w_o"]) + p["b_o"]
