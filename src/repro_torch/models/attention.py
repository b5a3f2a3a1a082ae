"""Attention (the ``repro.models.attention`` subset the ViT, LM, hybrid
and whisper serving paths run): fused QKV projection, global, causal and
window scaled dot-product attention, the LM's KV-cache prefill and
decode, whisper's cross-attention and DeepSeek-V2's MLA.
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
    """Full-sequence attention without a cache: the ViT's and whisper's
    encoder layers (no rotation, not causal) and the hybrid LM's shared
    block without a cache (``rope``: the positions' ``layers.rope_table``,
    causal).
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
                   device="cuda", dtype: Optional[torch.dtype] = None
                   ) -> Dict[str, torch.Tensor]:
    """Seeded LM attention weights: q, k and v drawn apart (the
    reference's ``init_attention``) and stored fused as ``w_qkv``; ones
    for the qk norms, zeros for the biases; cast to ``dtype``
    (``layers.as_dtype``)."""
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
    return L.as_dtype(p, dtype)


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


# ---------------------------------------------------------------------------
# cross attention (the whisper decoder)


def init_cross_attention(cfg: ModelConfig, generator: torch.Generator,
                         device="cuda", dtype: Optional[torch.dtype] = None
                         ) -> Dict[str, torch.Tensor]:
    """Seeded cross-attention weights, w_q / w_k / w_v / w_o drawn in the
    reference's order, kept apart and without biases (as the reference
    keeps them, whatever ``attention_bias`` says); cast to ``dtype``."""
    D = cfg.d_model
    return L.as_dtype({"w_q": L.dense_init(D, cfg.q_dim, generator, device),
                       "w_k": L.dense_init(D, cfg.kv_dim, generator, device),
                       "w_v": L.dense_init(D, cfg.kv_dim, generator, device),
                       "w_o": L.dense_init(cfg.q_dim, D, generator, device)},
                      dtype)


def cross_kv(cfg: ModelConfig, p: Dict[str, torch.Tensor],
             enc_out: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cross-attention keys and values (B, S, KV, Dh) of the encoder
    output enc_out (B, S, D)."""
    B, S, _ = enc_out.shape
    shape = (B, S, cfg.n_kv_heads, cfg.head_dim)
    return (L.mm(enc_out, p["w_k"]).reshape(shape),
            L.mm(enc_out, p["w_v"]).reshape(shape))


def cross_attention(cfg: ModelConfig, p: Dict[str, torch.Tensor],
                    x: torch.Tensor, enc_out: torch.Tensor) -> torch.Tensor:
    """Queries from x (B, T, D) over keys and values projected from the
    encoder output enc_out (B, S, D) on every call (:func:`cross_kv`),
    as the reference does; no rotation, no mask.  The plain ``sdpa``
    route: the flash kernel on the card, at T query rows against S keys
    (T = 1 at each decode step).  Types mix as the reference's do: a
    float32 encoder output under a half tree (float32 frames) gives
    float32 keys and values, the attention computes in float32 and
    returns the queries' type."""
    B, T, _ = x.shape
    q = L.mm(x, p["w_q"]).reshape(B, T, cfg.n_heads, cfg.head_dim)
    k, v = cross_kv(cfg, p, enc_out)
    ct = torch.promote_types(q.dtype, k.dtype)      # the casts up are exact
    out = sdpa(q.to(ct), k.to(ct), v.to(ct), causal=False).to(q.dtype)
    return L.mm(out.reshape(B, T, cfg.q_dim), p["w_o"])


# ---------------------------------------------------------------------------
# Multi-head Latent Attention (DeepSeek-V2)
#
# The cache holds only the compressed latent c_kv (rank kv_lora) and the
# decoupled RoPE key k_rope.  Scores are taken against c_kv directly:
# q_nope is mapped through W_uk into latent space (weight absorption) and
# the latent output through W_uv.  No kernel: the reference runs these
# products as einsums in float32 outside any Pallas call.  On a half tree
# the projections and the latents run in the tree's type and the latent
# cache keeps its own type; the scores and the latent output are float32,
# as in the reference.


def init_mla(cfg: ModelConfig, generator: torch.Generator,
             device="cuda", dtype: Optional[torch.dtype] = None
             ) -> Dict[str, torch.Tensor]:
    """Seeded MLA weights, the reference's shapes and scales; ones for
    the two latent norms; cast to ``dtype``."""
    m = cfg.mla
    D, H = cfg.d_model, cfg.n_heads
    qk_head = m.qk_nope_head_dim + m.qk_rope_head_dim

    def w(k, n):
        return L.dense_init(k, n, generator, device)
    return L.as_dtype({"w_dq": w(D, m.q_lora_rank),
                       "q_norm": torch.ones(m.q_lora_rank, device=device),
                       "w_uq": w(m.q_lora_rank, H * qk_head),
                       "w_dkv": w(D, m.kv_lora_rank + m.qk_rope_head_dim),
                       "kv_norm": torch.ones(m.kv_lora_rank, device=device),
                       "w_uk": w(m.kv_lora_rank, H * m.qk_nope_head_dim),
                       "w_uv": w(m.kv_lora_rank, H * m.v_head_dim),
                       "w_o": w(H * m.v_head_dim, D)}, dtype)


def init_mla_cache(cfg: ModelConfig, batch: int, max_len: int,
                   dtype: torch.dtype = torch.float32,
                   device="cuda") -> Dict[str, torch.Tensor]:
    m = cfg.mla
    return {"c_kv": torch.zeros((batch, max_len, m.kv_lora_rank),
                                dtype=dtype, device=device),
            "k_rope": torch.zeros((batch, max_len, m.qk_rope_head_dim),
                                  dtype=dtype, device=device)}


def mla_rope(cfg: ModelConfig, positions: torch.Tensor):
    """The rotation table of MLA's decoupled RoPE dims (``rope_table``
    at ``qk_rope_head_dim``, every dim rotated)."""
    return L.rope_table(positions, cfg.mla.qk_rope_head_dim, cfg.rope_theta)


def _mla_q(cfg: ModelConfig, p: Dict[str, torch.Tensor], x: torch.Tensor,
           rope) -> Tuple[torch.Tensor, torch.Tensor]:
    m = cfg.mla
    B, T, _ = x.shape
    cq = L.rms_norm(x @ p["w_dq"], p["q_norm"], cfg.norm_eps)
    q = (cq @ p["w_uq"]).reshape(B, T, cfg.n_heads, -1)
    return (q[..., :m.qk_nope_head_dim],
            L.apply_rope(q[..., m.qk_nope_head_dim:], rope))


def _mla_latents(cfg: ModelConfig, p: Dict[str, torch.Tensor],
                 x: torch.Tensor, rope) -> Tuple[torch.Tensor, torch.Tensor]:
    m = cfg.mla
    dkv = x @ p["w_dkv"]
    c_kv = L.rms_norm(dkv[..., :m.kv_lora_rank], p["kv_norm"], cfg.norm_eps)
    k_rope = L.apply_rope(dkv[..., m.kv_lora_rank:][:, :, None, :], rope)
    return c_kv, k_rope[:, :, 0, :]                # one shared rope head


def mla_attend(q_nope: torch.Tensor, q_rope: torch.Tensor,
               c_kv: torch.Tensor, k_rope: torch.Tensor, w_uk: torch.Tensor,
               w_uv: torch.Tensor, seen: torch.Tensor,
               scale: float) -> torch.Tensor:
    """MLA's attention in float32 for one block of query rows: q_nope
    (B, C, H, nope) absorbed through w_uk (rank, H, nope) into latent
    space and scored against c_kv (B, S, rank), plus q_rope (B, C, H,
    rope) against the shared k_rope (B, S, rope); keys where ``seen``
    (C or 1, S) is False masked; the latent output mapped through w_uv
    (rank, H, v).  Returns (B, C, H, v)."""
    q_lat = torch.einsum("bthd,lhd->bthl", q_nope.float(), w_uk)
    logits = (torch.einsum("bthl,bsl->bhts", q_lat, c_kv)
              + torch.einsum("bthd,bsd->bhts", q_rope.float(), k_rope)
              ) * scale
    probs = torch.softmax(logits.masked_fill(~seen, NEG_INF), dim=-1)
    o_lat = torch.einsum("bhts,bsl->bthl", probs, c_kv)
    return torch.einsum("bthl,lhd->bthd", o_lat, w_uv)


def mla_forward(cfg: ModelConfig, p: Dict[str, torch.Tensor],
                x: torch.Tensor, rope,
                cache: Optional[Dict[str, torch.Tensor]] = None,
                pos: Optional[int] = None) -> torch.Tensor:
    """MLA attention over x (B, T, D); ``rope``: :func:`mla_rope` of the
    rows' positions.  With ``cache`` and ``pos`` one decode step at
    ``pos`` (keys [0, pos] of the cache); with ``cache`` alone a causal
    prefill, the latents written at [0, T); without, a causal training
    forward.  The cache is written IN PLACE and the queries read it
    whole, masked, as the reference's do.  Query rows go ``Q_CHUNK`` at
    a time where the reference blocks them: T > 2 * Q_CHUNK and a
    multiple of it."""
    m = cfg.mla
    B, T, _ = x.shape
    H = cfg.n_heads
    scale = (m.qk_nope_head_dim + m.qk_rope_head_dim) ** -0.5
    q_nope, q_rope = _mla_q(cfg, p, x, rope)
    c_new, kr_new = _mla_latents(cfg, p, x, rope)
    decode = cache is not None and pos is not None
    if cache is not None:
        off = pos if decode else 0
        cache["c_kv"][:, off:off + T] = c_new
        cache["k_rope"][:, off:off + T] = kr_new
        c_kv, k_rope = cache["c_kv"], cache["k_rope"]
    else:
        c_kv, k_rope = c_new, kr_new
    keys = torch.arange(c_kv.shape[1], device=x.device)
    w_uk = p["w_uk"].reshape(m.kv_lora_rank, H, m.qk_nope_head_dim).float()
    w_uv = p["w_uv"].reshape(m.kv_lora_rank, H, m.v_head_dim).float()
    c_kv32, k_rope32 = c_kv.float(), k_rope.float()
    chunk = Q_CHUNK if T > 2 * Q_CHUNK and T % Q_CHUNK == 0 else T
    outs = []
    for t0 in range(0, T, chunk):
        if decode:
            seen = (keys < pos + 1)[None, :]
        else:
            seen = (torch.arange(t0, t0 + chunk, device=x.device)[:, None]
                    >= keys[None, :])
        outs.append(mla_attend(q_nope[:, t0:t0 + chunk],
                               q_rope[:, t0:t0 + chunk], c_kv32, k_rope32,
                               w_uk, w_uv, seen, scale))
    out = outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)
    return out.reshape(B, T, H * m.v_head_dim).to(x.dtype) @ p["w_o"]
