"""Zamba2-style hybrid: a Mamba-2 backbone with one SHARED attention
block applied every ``SHARED_PERIOD`` layers (the port of
``repro.models.hybrid``), plus ``_mamba_prefill``, the serving prefill
of one mamba layer that the pure SSM LM (``models.ssm_lm``) uses too.

Parameters: ``mamba_blocks`` is a list of per-layer dicts (the
reference stacks them on a leading axis for ``lax.scan``); ``shared``
holds the one attention + SwiGLU block, its q/k/v weights fused into
``w_qkv``.  Caches keep the reference's stacked layout and are written
in place: ``{"ssm": {"conv": (L, B, K-1, C), "ssm": (L, B, H, N, P)},
"kv": {"k"/"v": (n_attn, B, max_len, KV, Dh)}}``; shared call ``c``
(at layer ``6c + 5``) uses KV slot ``c % n_attn``.

On the card every mamba layer's prefill runs the ``ssd_scan`` kernel;
the shared block's prefill runs ``flash_attention`` (causal) and its
decode ``decode_attention``.  ``forward_hidden`` (training) runs the
scans through ``mamba2.ssd_chunked`` and the shared block's causal
flash through its ``autograd.Function``.  As in the reference, the
shared block consumes the hidden state directly (no concat with the
embedding, no per-call LoRA).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import dispatch
from repro_torch.models import attention as attn
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as m2
from repro_torch.models import transformer as tfm
from repro_torch.models.config import ModelConfig

SHARED_PERIOD = 6


def n_shared_calls(cfg: ModelConfig) -> int:
    return cfg.n_layers // SHARED_PERIOD


def _is_shared(idx: int) -> bool:
    return idx % SHARED_PERIOD == SHARED_PERIOD - 1


def init_mamba_blocks(cfg: ModelConfig, generator: torch.Generator,
                      device="cuda", dtype: Optional[torch.dtype] = None
                      ) -> list:
    return [{"ln": L.init_norm(cfg, device, dtype),
             "mamba": m2.init_mamba2(cfg, generator, device, dtype)}
            for _ in range(cfg.n_layers)]


def init_hybrid_params(cfg: ModelConfig, generator: torch.Generator,
                       device="cuda", dtype: Optional[torch.dtype] = None
                       ) -> Dict:
    """Seeded init with the reference's shapes and distributions, each
    piece cast to ``dtype`` as it is drawn (a mamba block's
    ``FLOAT32_LEAVES`` stay float32, as the reference's)."""
    embed = L.init_embedding(cfg, generator, device, dtype)
    blocks = init_mamba_blocks(cfg, generator, device, dtype)
    shared = {"ln1": L.init_norm(cfg, device, dtype),
              "attn": attn.init_attention(cfg, generator, device, dtype),
              "ln2": L.init_norm(cfg, device, dtype),
              "ffn": L.init_mlp(cfg, generator, device, dtype=dtype)}
    return {"embed": embed, "mamba_blocks": blocks, "shared": shared,
            "final_norm": L.init_norm(cfg, device, dtype),
            "lm_head": L.init_lm_head(cfg, generator, device, dtype)}


def init_stacked_states(cfg: ModelConfig, batch: int,
                        dtype: torch.dtype = torch.float32,
                        device="cuda") -> Dict[str, torch.Tensor]:
    """Zero conv and SSM states of every mamba layer, stacked (L, B, ...)."""
    return {k: torch.zeros((cfg.n_layers,) + tuple(v.shape), dtype=v.dtype,
                           device=device)
            for k, v in m2.init_mamba2_state(cfg, batch, dtype,
                                             device).items()}


def init_hybrid_caches(cfg: ModelConfig, batch: int, max_len: int,
                       dtype: torch.dtype = torch.float32,
                       device="cuda") -> Dict:
    """SSM/conv state per mamba layer + KV cache per shared-attn call."""
    n_attn = max(n_shared_calls(cfg), 1)
    shape = (n_attn, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {"ssm": init_stacked_states(cfg, batch, dtype, device),
            "kv": {"k": torch.zeros(shape, dtype=dtype, device=device),
                   "v": torch.zeros(shape, dtype=dtype, device=device)}}


def _shared_block(cfg: ModelConfig, p: Dict, x: torch.Tensor, rope,
                  cache: Optional[Dict[str, torch.Tensor]] = None,
                  pos: Optional[int] = None,
                  kv_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The shared pre-norm attention + SwiGLU block: without a cache a
    causal forward; with ``cache`` a prefill into it (``pos`` None) or
    one decode step at ``pos`` (the dense family's ``block_forward``)."""
    if cache is not None:
        return tfm.block_forward(cfg, p, x, rope, cache, pos, kv_len)[0]
    return tfm.train_block(cfg, p, x, rope)[0]


def _rope(cfg: ModelConfig, positions: torch.Tensor):
    return L.rope_table(positions, cfg.head_dim, cfg.rope_theta,
                        cfg.partial_rotary_factor)


def _kv_slot(caches: Dict, idx: int) -> Dict[str, torch.Tensor]:
    kv = caches["kv"]
    c = (idx // SHARED_PERIOD) % kv["k"].shape[0]
    return {"k": kv["k"][c], "v": kv["v"][c]}


def _store(states: Dict[str, torch.Tensor], idx: int,
           new: Dict[str, torch.Tensor]) -> None:
    """Write layer ``idx``'s new conv and SSM states into the stacks.  A
    stack takes the type its layers produce (the conv state the model's,
    the SSM state float32), as the reference's scan stacks them anew: a
    half cache under a float32 tree, or the reverse, gives way to it."""
    for k, v in new.items():
        if states[k].dtype != v.dtype:
            states[k] = states[k].to(v.dtype)
        states[k][idx].copy_(v)


def _layer(cfg: ModelConfig, p: Dict, shared: Optional[Dict],
           x: torch.Tensor, rope) -> torch.Tensor:
    """One mamba layer on the training route, then the shared block where
    ``shared`` is given."""
    x = x + m2.mamba2_forward(cfg, p["mamba"], L.apply_norm(cfg, p["ln"], x),
                              train=True)
    return x if shared is None else _shared_block(cfg, shared, x, rope)


def forward_hidden(cfg: ModelConfig, params: Dict, tokens: torch.Tensor, *,
                   remat: bool = False) -> Tuple[torch.Tensor, float]:
    """Final hidden states (B, T, D) and aux (0), as ``ssm_lm``'s: the
    scans on the training route; ``remat`` recomputes each layer (its
    shared block included) in the backward."""
    x = L.embed_tokens(params["embed"], tokens)
    B, T, _ = x.shape
    rope = _rope(cfg, torch.arange(T, device=x.device).expand(B, T))
    for idx, p in enumerate(params["mamba_blocks"]):
        shared = params["shared"] if _is_shared(idx) else None
        x = L.remat(_layer, remat, cfg, p, shared, x, rope)
    return L.apply_norm(cfg, params["final_norm"], x), 0.0


def prefill(cfg: ModelConfig, params: Dict, tokens: torch.Tensor,
            caches: Dict) -> Tuple[torch.Tensor, Dict, float]:
    """Prefill: every mamba layer's end-of-prompt conv and SSM states and
    every shared call's KV cache, written into ``caches`` in place.
    Returns (final hidden states (B, T, D), caches, aux)."""
    x = L.embed_tokens(params["embed"], tokens)
    B, T, _ = x.shape
    rope = _rope(cfg, torch.arange(T, device=x.device).expand(B, T))
    for idx, p in enumerate(params["mamba_blocks"]):
        dx, state = _mamba_prefill(cfg, p["mamba"],
                                   L.apply_norm(cfg, p["ln"], x))
        x = x + dx
        _store(caches["ssm"], idx, state)
        if _is_shared(idx):
            x = _shared_block(cfg, params["shared"], x, rope,
                              _kv_slot(caches, idx))
    return L.apply_norm(cfg, params["final_norm"], x), caches, 0.0


def _mamba_prefill(cfg: ModelConfig, p: Dict[str, torch.Tensor],
                   x: torch.Tensor
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Mamba forward that also returns the end-of-sequence state: the
    conv state is the last d_conv - 1 rows of the conv INPUT (left-padded
    with zeros for a shorter prompt), the SSM state the scan's final
    state (the ``ssd_scan`` kernel's on the card)."""
    K1 = cfg.ssm.d_conv - 1
    T = x.shape[1]
    z, xBC, dt_raw = m2._split_proj(cfg, x @ p["w_in"])
    xBC_conv = F.silu(m2.causal_conv1d(xBC, p["conv_w"], p["conv_b"]))
    conv_state = (xBC[:, T - K1:, :] if T >= K1
                  else F.pad(xBC, (0, 0, K1 - T, 0)))
    xs, dt, A, Bm, Cm = m2._scan_inputs(cfg, p, xBC_conv, dt_raw)
    chunk = min(cfg.ssm.chunk_size, T)
    y, final_state = dispatch.ssd_scan(xs, dt, A, Bm, Cm, chunk)
    return (m2._gated_out(cfg, p, y, xs, z, x.dtype),
            {"conv": conv_state.to(x.dtype), "ssm": final_state})


def decode_step(cfg: ModelConfig, params: Dict, token: torch.Tensor,
                pos: int, caches: Dict) -> Tuple[torch.Tensor, Dict]:
    """One decode step at absolute position ``pos``; states and KV caches
    are updated in place.  Returns (logits (B, 1, V), caches)."""
    x = L.embed_tokens(params["embed"], token)
    B = x.shape[0]
    rope = _rope(cfg, torch.full((B, 1), pos, device=x.device))
    kv_len = torch.full((B,), pos + 1, dtype=torch.int32, device=x.device)
    states = caches["ssm"]
    for idx, p in enumerate(params["mamba_blocks"]):
        dx, new = m2.mamba2_decode(
            cfg, p["mamba"], L.apply_norm(cfg, p["ln"], x),
            {k: v[idx] for k, v in states.items()})
        x = x + dx
        _store(states, idx, new)
        if _is_shared(idx):
            x = _shared_block(cfg, params["shared"], x, rope,
                              _kv_slot(caches, idx), pos, kv_len)
    x = L.apply_norm(cfg, params["final_norm"], x)
    return L.lm_logits(cfg, params["lm_head"], params["embed"], x), caches
