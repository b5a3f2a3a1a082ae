"""Architecture registry: the dispatch surface over model families (the
port of ``repro.models.registry``).

  init_params(cfg, generator, device, dtype)
  forward_hidden(cfg, params, batch, remat, ctx) -> (hidden, aux) training
  lm_loss(cfg, params, batch, remat, ctx)      -> (loss, {"ce", "aux"})
  init_decode_state(cfg, batch, max_len, dtype, device)
  prefill(cfg, params, batch, state)           -> (hidden, state, aux)
  decode_step(cfg, params, token, pos, state)  -> (logits, state)
  count_params_analytic(cfg)                   analytic N (6 N D FLOPs)

Every family of the reference serves and trains: the dense, MoE and VLM
decoders (``models.transformer``, GQA or MLA attention; a VLM's prefill
and training forward take ``batch["image_embeds"]``), the pure SSM LM
(``models.ssm_lm``), the Mamba-2 + shared-attention hybrid
(``models.hybrid``), the encoder-decoder (``models.whisper``:
``batch["frames"]`` at prefill and in ``decode_train``, the serving
state ``(enc_out, caches)``) and the ViT's parameters
(``convert.init_vitdet_params``).  ``lm_loss`` scores the last T_text
positions of a VLM's image + text sequence, as the reference does.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.models import hybrid as hyb
from repro_torch.models import ssm_lm
from repro_torch.models import transformer as tfm
from repro_torch.models import whisper as whs
from repro_torch.models.config import ModelConfig
from repro_torch.models.mamba2 import ssm_dims
from repro_torch.models.transformer import LOCAL, ParallelCtx


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device="cuda", dtype: Optional[torch.dtype] = None) -> Dict:
    """Seeded parameters; ``dtype`` (None: float32) as the reference's
    ``init_params(cfg, key, dtype)``: every float leaf in it but a mamba
    block's ``A_log``, ``dt_bias`` and ``D``, which stay float32."""
    if cfg.family == "vit":
        from repro_torch import convert
        return convert.init_vitdet_params(cfg, generator, device, dtype)
    if cfg.family == "ssm":
        return ssm_lm.init_ssm_params(cfg, generator, device, dtype)
    if cfg.family == "hybrid":
        return hyb.init_hybrid_params(cfg, generator, device, dtype)
    if cfg.family == "encdec":
        return whs.init_whisper_params(cfg, generator, device, dtype)
    return tfm.init_lm_params(cfg, generator, device, dtype)  # dense/moe/vlm


# ---------------------------------------------------------------------------
# training forward and loss


def forward_hidden(cfg: ModelConfig, params: Dict, batch: Dict[str, Any],
                   remat: bool = False, ctx: ParallelCtx = LOCAL
                   ) -> Tuple[torch.Tensor, Any]:
    """batch: {"tokens": (B, T)} plus the family's extra: "frames" (B,
    T_enc, D) for the encoder-decoder (required), "image_embeds" (B, N,
    vision_hidden) for a VLM (optional: without it the text decoder).
    The SSM and hybrid families run their scans on the training route
    (``mamba2.ssd_chunked``).  ``ctx`` reaches the decoder families
    (expert parallelism, the ``sp`` carry); the other families' loops
    keep their carry whole on a mesh, a layout that changes no number."""
    if cfg.family == "encdec":
        return whs.decode_train(cfg, params, batch["tokens"],
                                batch["frames"], remat)
    if cfg.family == "ssm":
        return ssm_lm.forward_hidden(cfg, params, batch["tokens"],
                                     remat=remat)
    if cfg.family == "hybrid":
        return hyb.forward_hidden(cfg, params, batch["tokens"], remat=remat)
    return tfm.forward_hidden(cfg, params, batch["tokens"], remat=remat,
                              image_embeds=batch.get("image_embeds"),
                              ctx=ctx)


CE_CHUNK_ELEMS = 64 * 2 ** 20      # chunk the CE when T*V exceeds this


def _ce_nll_dense(logits: torch.Tensor,
                  targets: torch.Tensor) -> torch.Tensor:
    """Per-token NLL, logsumexp minus the target's logit, in float32."""
    logits32 = logits.to(torch.float32)
    picked = logits32.gather(-1, targets.long()[..., None])[..., 0]
    return torch.logsumexp(logits32, dim=-1) - picked


def _ce_nll(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Per-token NLL (B, T), taken over time chunks of a power of two
    that divides T when the logits exceed ``CE_CHUNK_ELEMS`` a row, by
    the reference's rule."""
    B, T, V = logits.shape
    chunk = max(CE_CHUNK_ELEMS // max(V, 1), 128)
    chunk = 1 << (chunk.bit_length() - 1)       # floor to a power of two
    while chunk > 128 and T % chunk:            # ...that divides T
        chunk //= 2
    if T <= chunk or T % chunk:
        return _ce_nll_dense(logits, targets)
    return torch.cat([_ce_nll_dense(logits[:, t:t + chunk],
                                    targets[:, t:t + chunk])
                      for t in range(0, T, chunk)], dim=1)


def lm_loss(cfg: ModelConfig, params: Dict, batch: Dict[str, Any],
            remat: bool = False, ctx: ParallelCtx = LOCAL
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token cross entropy + ``moe.router_aux_coef`` times the MoE
    load-balance aux (0 for the other families).  ``batch``: "tokens" (B, T), optional "labels" (B, T)
    (default: the tokens shifted left, a 0 last) and "loss_mask" (B, T),
    plus the family's extra (:func:`forward_hidden`).  Only the last T
    positions are scored: a VLM's image tokens come first.  The reference
    slices the logits; the head is row-wise, so slicing the hidden
    states before it gives the same loss without the image rows' logits.
    Returns (loss, {"ce", "aux"}).

    On a mesh (``ctx.mesh``; ``batch`` is this rank's rows) the loss is
    the reference's global masked mean: the mask's count is summed over
    the data axes, not averaged per rank.  The returned loss is then this
    rank's TERM of the global loss, (its rows' NLL sum / the global count
    + coef * aux / n_data) / ep: the terms summed over every rank give
    the reference's loss, whose aux gradient is that of the mean of the
    data shards' aux (``moe.moe_sharded``), and the collectives'
    backwards sum their gradients.  ``ce`` is then the global mean and
    ``aux`` data shard 0's (what the reference's host reads); neither
    carries a gradient."""
    hidden, aux = forward_hidden(cfg, params, batch, remat, ctx)
    tokens = batch["tokens"]
    logits = tfm.logits_from_hidden(cfg, params,
                                    hidden[:, -tokens.shape[1]:])
    targets = batch.get("labels")
    if targets is None:
        targets = torch.cat([tokens[:, 1:], torch.zeros_like(tokens[:, :1])],
                            dim=1)
    nll = _ce_nll(logits, targets)
    mask = batch.get("loss_mask")
    mask = torch.ones_like(nll) if mask is None else mask.to(nll.dtype)
    aux = torch.as_tensor(aux, dtype=torch.float32, device=nll.device)
    aux_coef = cfg.moe.router_aux_coef if cfg.moe is not None else 0.0
    if ctx.mesh is None:
        loss = torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
        return loss + aux_coef * aux, {"ce": loss, "aux": aux}
    return _mesh_loss(ctx, torch.sum(nll * mask), torch.sum(mask), aux,
                      aux_coef)


def _mesh_loss(ctx: ParallelCtx, nll_sum: torch.Tensor,
               count: torch.Tensor, aux: torch.Tensor, aux_coef: float):
    """:func:`lm_loss`'s rank term and its global metrics."""
    import torch.distributed as dist
    from repro_torch.distributed import sharding as shd
    mesh = ctx.mesh
    sizes = shd.mesh_shape(mesh)
    n_dp, ep = shd.dp_size(mesh), sizes[ctx.model_axis]
    count = shd.reduce_over(count.detach().clone(), mesh, ctx.data_axes)
    count = torch.clamp(count, min=1.0)
    term = (nll_sum / count + aux_coef * (aux / n_dp)) / ep
    with torch.no_grad():
        ce = shd.reduce_over(nll_sum.detach().clone(), mesh,
                             ctx.data_axes) / count
        aux0 = aux.detach().clone()
        if dist.get_world_size() > 1:
            dist.broadcast(aux0, src=0)
    return term, {"ce": ce, "aux": aux0}


# ---------------------------------------------------------------------------
# serving


def init_decode_state(cfg: ModelConfig, batch: int, max_len: int,
                      dtype: torch.dtype = torch.float32, device="cuda"):
    if cfg.family == "ssm":
        return hyb.init_stacked_states(cfg, batch, dtype, device)
    if cfg.family == "hybrid":
        return hyb.init_hybrid_caches(cfg, batch, max_len, dtype, device)
    if cfg.family == "encdec":      # enc_out joins the state at prefill
        return whs.init_dec_caches(cfg, batch, max_len, dtype, device)
    return tfm.init_caches(cfg, batch, max_len, dtype, device)


def prefill(cfg: ModelConfig, params: Dict, batch: Dict[str, Any], state):
    """batch: {"tokens": (B, T)} plus the family's extra: "frames" (B,
    T_enc, D) for the encoder-decoder (required), "image_embeds" (B, N,
    vision_hidden) for a VLM (optional: without it the text decoder)."""
    if cfg.family == "ssm":
        return ssm_lm.prefill(cfg, params, batch["tokens"], state)
    if cfg.family == "hybrid":
        return hyb.prefill(cfg, params, batch["tokens"], state)
    if cfg.family == "encdec":
        return whs.prefill(cfg, params, batch["tokens"], batch["frames"],
                           state)
    return tfm.prefill(cfg, params, batch["tokens"], state,
                       image_embeds=batch.get("image_embeds"))


def decode_step(cfg: ModelConfig, params: Dict, token: torch.Tensor,
                pos: int, state):
    if cfg.family == "ssm":
        return ssm_lm.decode_step(cfg, params, token, pos, state)
    if cfg.family == "hybrid":
        return hyb.decode_step(cfg, params, token, pos, state)
    if cfg.family == "encdec":
        return whs.decode_step(cfg, params, token, pos, state)
    return tfm.decode_step(cfg, params, token, pos, state)


# ---------------------------------------------------------------------------
# analytic parameter counts (for MODEL_FLOPS = 6 N D rooflines)


def _attn_params(cfg: ModelConfig) -> int:
    if cfg.mla is not None:
        m = cfg.mla
        qk_head = m.qk_nope_head_dim + m.qk_rope_head_dim
        return (cfg.d_model * m.q_lora_rank
                + m.q_lora_rank * cfg.n_heads * qk_head
                + cfg.d_model * (m.kv_lora_rank + m.qk_rope_head_dim)
                + m.kv_lora_rank * cfg.n_heads * m.qk_nope_head_dim
                + m.kv_lora_rank * cfg.n_heads * m.v_head_dim
                + cfg.n_heads * m.v_head_dim * cfg.d_model)
    return cfg.d_model * (cfg.q_dim + 2 * cfg.kv_dim) + cfg.q_dim * cfg.d_model


def _mlp_params(cfg: ModelConfig, d_ff: int) -> int:
    if cfg.activation == "silu":
        return 3 * cfg.d_model * d_ff
    return 2 * cfg.d_model * d_ff


def _mamba_params(cfg: ModelConfig) -> int:
    s = cfg.ssm
    d_inner, H, conv_ch = ssm_dims(cfg)
    proj_out = 2 * d_inner + 2 * s.n_groups * s.d_state + H
    return (cfg.d_model * proj_out + s.d_conv * conv_ch + conv_ch
            + 3 * H + d_inner + d_inner * cfg.d_model)


def count_params_analytic(cfg: ModelConfig, active_only: bool = False) -> int:
    """The reference's analytic count: embeddings (and an untied head),
    then the family's layers; MoE counts every expert, or ``top_k`` of
    them with ``active_only``."""
    D = cfg.d_model
    total = cfg.vocab_size * D
    if not cfg.tied_embeddings:
        total += D * cfg.vocab_size
    if cfg.family == "ssm":
        return total + cfg.n_layers * _mamba_params(cfg)
    if cfg.family == "hybrid":
        shared = _attn_params(cfg) + _mlp_params(cfg, cfg.d_ff)
        return total + cfg.n_layers * _mamba_params(cfg) + shared
    if cfg.family == "encdec":
        enc = cfg.encdec.n_encoder_layers * (
            _attn_params(cfg) + _mlp_params(cfg, cfg.d_ff))
        dec = cfg.n_layers * (2 * _attn_params(cfg) +
                              _mlp_params(cfg, cfg.d_ff))
        return total + enc + dec + cfg.max_seq_len * D
    attn_p = _attn_params(cfg)                  # dense / moe / vlm decoder
    if cfg.moe is None:
        return total + cfg.n_layers * (attn_p + _mlp_params(cfg, cfg.d_ff))
    m = cfg.moe
    n_dense = m.first_dense_layers
    n_moe = cfg.n_layers - n_dense
    dense_ffn = _mlp_params(cfg, m.d_ff_dense or cfg.d_ff)
    expert_ffn = _mlp_params(cfg, m.d_ff_expert)
    shared_ffn = (_mlp_params(cfg, m.d_ff_expert * m.n_shared_experts)
                  if m.n_shared_experts else 0)
    n_eff = m.top_k if active_only else m.n_experts
    total += n_dense * (attn_p + dense_ffn)
    total += n_moe * (attn_p + D * m.n_experts + n_eff * expert_ffn
                      + shared_ffn)
    return total
