"""Decoder-only LM assembly, dense family (the ``repro.models.transformer``
subset the LM serving engine runs).

The reference stacks its layers along a leading axis and runs them with
``jax.lax.scan``; here parameters are a list of per-layer dicts and a
Python loop runs them.  Caches keep the reference's stacked layout,
``{"dense_blocks": {"k": (L, B, S, KV, Dh), "v": ...}}``; a layer writes
its slice of them in place.

Entry points: ``init_lm_params`` / ``embed_inputs`` / ``forward_hidden``
(training) / ``logits_from_hidden`` / ``init_caches`` / ``prefill`` /
``decode_step`` and ``run_blocks``, which runs an arbitrary [start, end)
layer slice (the mixed-granularity prefill splits the backbone at its
restoration point).
MoE, MLA and VLM configs raise: their port follows in the order
``ROADMAP.md`` gives.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.models import attention as attn
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig


def check_dense(cfg: ModelConfig) -> None:
    """Raise unless ``cfg`` is a dense decoder (the ported family)."""
    if cfg.family != "dense" or cfg.moe or cfg.mla or cfg.vlm:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} (moe={cfg.moe is not None}, "
            f"mla={cfg.mla is not None}, vlm={cfg.vlm is not None}) is not "
            f"ported to repro_torch; ROADMAP.md (Queue 1, \"the other LM "
            f"families\") lists the order in which they follow")


# ---------------------------------------------------------------------------
# parameters


def init_lm_params(cfg: ModelConfig, generator: torch.Generator,
                   device="cuda") -> Dict:
    """Seeded init with the reference's shapes and distributions:
    truncated normal in (-2, 2) std / sqrt(fan_in) for dense weights,
    normal std 0.02 for the embedding, ones for norm scales.  q, k and v
    weights are drawn apart and stored fused as ``w_qkv``.  Tensors are
    drawn on ``generator.device`` and moved to ``device``."""
    check_dense(cfg)

    def block():
        return {"ln1": L.init_norm(cfg, device),
                "ln2": L.init_norm(cfg, device),
                "attn": attn.init_attention(cfg, generator, device),
                "ffn": L.init_mlp(cfg, generator, device)}

    embed = L.init_embedding(cfg, generator, device)
    return {"embed": embed,
            "blocks": [block() for _ in range(cfg.n_layers)],
            "final_norm": L.init_norm(cfg, device),
            "lm_head": L.init_lm_head(cfg, generator, device)}


# ---------------------------------------------------------------------------
# blocks


def block_forward(cfg: ModelConfig, p: Dict, x: torch.Tensor, rope,
                  cache: Dict[str, torch.Tensor], pos: Optional[int] = None,
                  kv_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Pre-norm block.  ``pos`` None: prefill x (B, T, D) into ``cache``
    at [0, T); else decode one token at ``pos``.  ``rope``: the positions'
    ``layers.rope_table``.  The cache is written in place."""
    h = L.apply_norm(cfg, p["ln1"], x)
    if pos is None:
        a = attn.attention_prefill(cfg, p["attn"], h, rope, cache)
    else:
        a = attn.attention_decode(cfg, p["attn"], h, pos, rope, cache,
                                  kv_len=kv_len)
    x = x + a
    return x + L.apply_mlp(cfg, p["ffn"], L.apply_norm(cfg, p["ln2"], x))


def train_block(cfg: ModelConfig, p: Dict, x: torch.Tensor,
                rope) -> torch.Tensor:
    """Pre-norm block without a cache: causal attention through
    ``dispatch.flash_attention`` (the kernel's ``autograd.Function`` on
    the card), then the MLP."""
    h = L.apply_norm(cfg, p["ln1"], x)
    x = x + attn.attention_forward(cfg, p["attn"], h, rope=rope, causal=True)
    return x + L.apply_mlp(cfg, p["ffn"], L.apply_norm(cfg, p["ln2"], x))


def forward_hidden(cfg: ModelConfig, params: Dict, tokens: torch.Tensor, *,
                   remat: bool = False) -> Tuple[torch.Tensor, float]:
    """Training / eval forward: the final hidden states (B, T, D) and aux
    (0 for the dense family).  ``remat``: each block's activations are
    recomputed in the backward (``layers.remat``; the reference's
    ``jax.checkpoint`` of its scan body), so its flash forward runs
    twice a step."""
    check_dense(cfg)
    x = embed_inputs(cfg, params, tokens)
    B, T, _ = x.shape
    positions = torch.arange(T, device=x.device).expand(B, T)
    rope = L.rope_table(positions, cfg.head_dim, cfg.rope_theta,
                        cfg.partial_rotary_factor)
    for p in params["blocks"]:
        x = L.remat(train_block, remat, cfg, p, x, rope)
    return L.apply_norm(cfg, params["final_norm"], x), 0.0


def embed_inputs(cfg: ModelConfig, params: Dict,
                 tokens: torch.Tensor) -> torch.Tensor:
    return L.embed_tokens(params["embed"], tokens)


def logits_from_hidden(cfg: ModelConfig, params: Dict,
                       x: torch.Tensor) -> torch.Tensor:
    return L.lm_logits(cfg, params["lm_head"], params["embed"], x)


# ---------------------------------------------------------------------------
# serving: prefill + decode


def init_caches(cfg: ModelConfig, batch: int, max_len: int,
                dtype: torch.dtype = torch.float32,
                device="cuda") -> Dict[str, Dict[str, torch.Tensor]]:
    """Stacked (L, B, max_len, KV, Dh) k/v caches, zero-filled."""
    check_dense(cfg)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {"dense_blocks": {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device)}}


def run_blocks(cfg: ModelConfig, params: Dict, x: torch.Tensor,
               positions: torch.Tensor, start: int, end: int, caches: Dict,
               pos: Optional[int] = None) -> Tuple[torch.Tensor, Dict, float]:
    """Run backbone layers [start, end) on hidden states x, prefilling
    (``pos`` None) or decoding one token at ``pos``; ``positions`` (B, T)
    are the RoPE positions of x's rows.  Each layer writes its slice of
    ``caches`` in place.  Returns (x, caches, aux); aux is 0 for the
    dense family (the reference's MoE load-balance term)."""
    rope = L.rope_table(positions, cfg.head_dim, cfg.rope_theta,
                        cfg.partial_rotary_factor)
    kv_len = None
    if pos is not None:
        kv_len = torch.full((x.shape[0],), pos + 1, dtype=torch.int32,
                            device=x.device)
    stack = caches["dense_blocks"]
    for i in range(start, end):
        x = block_forward(cfg, params["blocks"][i], x, rope,
                          {"k": stack["k"][i], "v": stack["v"][i]}, pos,
                          kv_len)
    return x, caches, 0.0


def prefill(cfg: ModelConfig, params: Dict, tokens: torch.Tensor,
            caches: Dict) -> Tuple[torch.Tensor, Dict, float]:
    """Prefill the caches with tokens (B, T); returns (final hidden
    states (B, T, D), caches, aux)."""
    x = embed_inputs(cfg, params, tokens)
    B, T, _ = x.shape
    positions = torch.arange(T, device=x.device).expand(B, T)
    x, caches, aux = run_blocks(cfg, params, x, positions, 0, cfg.n_layers,
                                caches)
    return L.apply_norm(cfg, params["final_norm"], x), caches, aux


def decode_step(cfg: ModelConfig, params: Dict, token: torch.Tensor,
                pos: int, caches: Dict) -> Tuple[torch.Tensor, Dict]:
    """One decode step.  token: (B, 1) int64 or int32; ``pos``: the
    absolute position of the token.  Returns (logits (B, 1, V), caches)."""
    x = embed_inputs(cfg, params, token)
    B = x.shape[0]
    positions = torch.full((B, 1), pos, device=x.device)
    x, caches, _ = run_blocks(cfg, params, x, positions, 0, cfg.n_layers,
                              caches, pos=pos)
    x = L.apply_norm(cfg, params["final_norm"], x)
    return logits_from_hidden(cfg, params, x), caches
