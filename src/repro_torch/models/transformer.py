"""Decoder-only LM assembly, dense, MoE and VLM families (the
``repro.models.transformer`` subset the LM serving engine and trainer
run).

The reference stacks its layers along a leading axis and runs them with
``jax.lax.scan``, one stack per layer kind (``dense_blocks`` then
``moe_blocks``); here parameters are one list of per-layer dicts and a
Python loop runs them.  Caches keep the reference's stacked layout,
``{"dense_blocks": {...}, "moe_blocks": {...}}`` with leaves (L, B, S,
...): k / v (L, B, S, KV, Dh), or MLA's latent c_kv (L, B, S, rank) and
k_rope (L, B, S, rope dims); a layer writes its slice of them in place.

A MoE config's first ``moe.first_dense_layers`` layers carry a dense
FFN of width ``moe.d_ff_dense``, the rest the MoE FFN
(``models.moe.moe_local``), whose load-balance aux every forward sums.
On a mesh (``ParallelCtx``) a MoE layer runs ``moe.moe_sharded``
(expert parallel over ``model``) and, with ``sp``, the residual stream
between blocks is kept as d_model pieces over ``model``.
An MLA config's layers attend through ``attention.mla_forward``.  A VLM
config carries the reference's projector (``w1 b1 w2 b2``), which maps
stub image embeddings (B, N_img, vision_hidden) into d_model ahead of the
token embeddings (``embed_inputs``); without them it is its text decoder.

Entry points: ``init_lm_params`` / ``embed_inputs`` / ``forward_hidden``
(training) / ``logits_from_hidden`` / ``init_caches`` / ``prefill`` /
``decode_step`` and ``run_blocks``, which runs an arbitrary [start, end)
layer slice across the dense-to-MoE boundary (the mixed-granularity
prefill splits the backbone at its restoration point).  Encoder-decoder
configs raise here: ``models.whisper`` serves them.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import attention as attn
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_lib
from repro_torch.models.config import ModelConfig


@dataclass(frozen=True)
class ParallelCtx:
    """Mesh and axis names threaded through the model code (the
    reference's); no mesh runs on one device.  ``remat``: each block
    recomputed in the backward.  ``sp``: sequence parallelism, the
    residual stream between blocks stored as d_model pieces over
    ``model_axis`` (when d_model divides), so remat's saved carry is
    sharded; a block all-gathers it at entry and keeps its own piece at
    exit.  It changes no number."""
    mesh: Any = None
    data_axes: Tuple[str, ...] = ("data",)
    model_axis: str = "model"
    use_ep: bool = True
    remat: bool = False
    sp: bool = False

    def _sp_on(self, width: int) -> bool:
        if self.mesh is None or not self.sp:
            return False
        n = self.mesh.size(self.mesh.mesh_dim_names.index(self.model_axis))
        return n > 1 and width % n == 0

    def hidden(self, x: torch.Tensor) -> torch.Tensor:
        """The layout of a (B, T, D) residual-stream carry: under ``sp``
        this rank's d_model piece, else ``x``."""
        if not self._sp_on(x.shape[-1]):
            return x
        from repro_torch.distributed.sharding import Spec, shard_leaf
        return shard_leaf(self.mesh, x, Spec(None, None, self.model_axis))

    def full(self, x: torch.Tensor, width: int) -> torch.Tensor:
        """The whole carry of d_model ``width`` back from :meth:`hidden`'s
        layout (under ``sp`` an all-gather over ``model``, whose backward
        reduce-scatters)."""
        if not self._sp_on(width):
            return x
        from repro_torch.distributed.sharding import Spec, gather_leaf
        return gather_leaf(x, self.mesh, Spec(None, None, self.model_axis))


LOCAL = ParallelCtx()


def check_decoder(cfg: ModelConfig) -> None:
    """Raise unless ``cfg`` is a dense, MoE or VLM decoder (the
    encoder-decoder family runs ``models.whisper``)."""
    if cfg.family not in ("dense", "moe", "vlm"):
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not a decoder-only LM; "
            f"the encoder-decoder family runs models.whisper through "
            f"models.registry")


def n_dense_layers(cfg: ModelConfig) -> int:
    """Leading layers with a dense FFN (every layer of a dense config)."""
    if cfg.moe is None:
        return cfg.n_layers
    return min(cfg.moe.first_dense_layers, cfg.n_layers)


def layer_kind(cfg: ModelConfig, idx: int) -> str:
    return "dense" if idx < n_dense_layers(cfg) else "moe"


# ---------------------------------------------------------------------------
# parameters


def init_block(cfg: ModelConfig, generator: torch.Generator, device,
               kind: str, dtype: Optional[torch.dtype] = None) -> Dict:
    """One pre-norm block: GQA or MLA attention, then a SwiGLU FFN (at
    ``moe.d_ff_dense`` in a MoE config's dense layers) or the MoE FFN;
    cast to ``dtype``."""
    p = {"ln1": L.init_norm(cfg, device, dtype),
         "ln2": L.init_norm(cfg, device, dtype)}
    p["attn"] = (attn.init_mla(cfg, generator, device, dtype)
                 if cfg.mla is not None
                 else attn.init_attention(cfg, generator, device, dtype))
    if kind == "moe":
        p["ffn"] = moe_lib.init_moe(cfg, generator, device, dtype)
    else:
        d_ff = cfg.moe.d_ff_dense if cfg.moe is not None else None
        p["ffn"] = L.init_mlp(cfg, generator, device, d_ff=d_ff, dtype=dtype)
    return p


def init_lm_params(cfg: ModelConfig, generator: torch.Generator,
                   device="cuda", dtype: Optional[torch.dtype] = None
                   ) -> Dict:
    """Seeded init with the reference's shapes and distributions:
    truncated normal in (-2, 2) std / sqrt(fan_in) for dense weights,
    normal std 0.02 for the embedding, ones for norm scales.  q, k and v
    weights are drawn apart and stored fused as ``w_qkv``.  Tensors are
    drawn on ``generator.device`` and moved to ``device``.  ``dtype``:
    each piece (the embedding, a block, the head) is cast to it as soon
    as it is drawn, so the tree equals ``qtensor.cast_tree`` of the
    float32 tree while at most one float32 block is alive."""
    check_decoder(cfg)
    embed = L.init_embedding(cfg, generator, device, dtype)
    blocks = [init_block(cfg, generator, device, layer_kind(cfg, i), dtype)
              for i in range(cfg.n_layers)]
    params = {"embed": embed, "blocks": blocks,
              "final_norm": L.init_norm(cfg, device, dtype),
              "lm_head": L.init_lm_head(cfg, generator, device, dtype)}
    if cfg.vlm is not None:
        D = cfg.d_model
        params["projector"] = L.as_dtype({
            "w1": L.dense_init(cfg.vlm.vision_hidden, D, generator, device),
            "b1": torch.zeros(D, device=device),
            "w2": L.dense_init(D, D, generator, device),
            "b2": torch.zeros(D, device=device)}, dtype)
    return params


# ---------------------------------------------------------------------------
# blocks


def _ffn(cfg: ModelConfig, p: Dict, h: torch.Tensor,
         ctx: ParallelCtx = LOCAL):
    """The block's FFN on its normed input: (output, aux); aux is the MoE
    load-balance term, 0.0 for a dense FFN.  On a mesh with ``use_ep`` a
    MoE FFN is expert parallel (``moe.moe_sharded``)."""
    if "router" in p:
        if ctx.mesh is not None and ctx.use_ep:
            return moe_lib.moe_sharded(cfg, p, h, ctx.mesh, ctx.data_axes,
                                       ctx.model_axis)
        return moe_lib.moe_local(cfg, p, h)
    return L.apply_mlp(cfg, p, h), 0.0


def block_forward(cfg: ModelConfig, p: Dict, x: torch.Tensor, rope,
                  cache: Dict[str, torch.Tensor], pos: Optional[int] = None,
                  kv_len: Optional[torch.Tensor] = None):
    """Pre-norm block.  ``pos`` None: prefill x (B, T, D) into ``cache``
    at [0, T); else decode one token at ``pos``.  ``rope``: the positions'
    ``layers.rope_table`` (``attention.mla_rope`` for MLA).  The cache is
    written in place.  Returns (x, aux)."""
    h = L.apply_norm(cfg, p["ln1"], x)
    if cfg.mla is not None:
        a = attn.mla_forward(cfg, p["attn"], h, rope, cache, pos)
    elif pos is None:
        a = attn.attention_prefill(cfg, p["attn"], h, rope, cache)
    else:
        a = attn.attention_decode(cfg, p["attn"], h, pos, rope, cache,
                                  kv_len=kv_len)
    x = x + a
    f, aux = _ffn(cfg, p["ffn"], L.apply_norm(cfg, p["ln2"], x))
    return x + f, aux


def train_block(cfg: ModelConfig, p: Dict, x: torch.Tensor, rope,
                ctx: ParallelCtx = LOCAL):
    """Pre-norm block without a cache: causal attention (GQA through
    ``dispatch.flash_attention``, the kernel's ``autograd.Function`` on
    the card; MLA's einsums), then the FFN.  ``x`` is the carry in
    ``ctx.hidden``'s layout, and so is the result.  Returns (x, aux)."""
    x = ctx.full(x, cfg.d_model)
    h = L.apply_norm(cfg, p["ln1"], x)
    if cfg.mla is not None:
        x = x + attn.mla_forward(cfg, p["attn"], h, rope)
    else:
        x = x + attn.attention_forward(cfg, p["attn"], h, rope=rope,
                                       causal=True)
    f, aux = _ffn(cfg, p["ffn"], L.apply_norm(cfg, p["ln2"], x), ctx)
    return ctx.hidden(x + f), aux


def rope_for(cfg: ModelConfig, positions: torch.Tensor):
    """The rotation table every layer of a forward shares."""
    if cfg.mla is not None:
        return attn.mla_rope(cfg, positions)
    return L.rope_table(positions, cfg.head_dim, cfg.rope_theta,
                        cfg.partial_rotary_factor)


def forward_hidden(cfg: ModelConfig, params: Dict, tokens: torch.Tensor, *,
                   remat: bool = False,
                   image_embeds: Optional[torch.Tensor] = None,
                   ctx: ParallelCtx = LOCAL
                   ) -> Tuple[torch.Tensor, object]:
    """Training / eval forward: the final hidden states (B, T, D), or (B,
    N + T, D) after a VLM's N projected ``image_embeds`` (RoPE runs over
    all N + T positions), and the summed MoE aux (0.0 for the dense
    family).  ``remat``: each block's activations are recomputed in the
    backward (``layers.remat``; the reference's ``jax.checkpoint`` of its
    scan body), so its flash forward runs twice a step.  ``ctx``: the
    mesh, for expert parallelism and the ``sp`` carry."""
    check_decoder(cfg)
    x = embed_inputs(cfg, params, tokens, image_embeds)
    B, T, _ = x.shape
    rope = rope_for(cfg, torch.arange(T, device=x.device).expand(B, T))
    x = ctx.hidden(x)
    aux_total = 0.0
    for p in params["blocks"]:
        x, aux = L.remat(train_block, remat, cfg, p, x, rope, ctx)
        aux_total = aux_total + aux
    x = ctx.full(x, cfg.d_model)
    return L.apply_norm(cfg, params["final_norm"], x), aux_total


def embed_inputs(cfg: ModelConfig, params: Dict, tokens: torch.Tensor,
                 image_embeds: Optional[torch.Tensor] = None
                 ) -> torch.Tensor:
    """The token embeddings (B, T, D); for a VLM config given
    ``image_embeds`` (B, N, vision_hidden), the projected image tokens
    ``gelu(e @ w1 + b1) @ w2 + b2`` (tanh GELU, the reference's
    ``jax.nn.gelu`` default) ahead of them: (B, N + T, D).  The
    projector runs in the promoted type of the embeddings and its
    weights (float32 embeddings under a half tree: float32), then joins
    the token embeddings in their type, as the reference's."""
    x = L.embed_tokens(params["embed"], tokens)
    if cfg.vlm is not None and image_embeds is not None:
        pr = params["projector"]
        v = F.gelu(L.mm(image_embeds, pr["w1"]) + pr["b1"],
                   approximate="tanh")
        x = torch.cat([(L.mm(v, pr["w2"]) + pr["b2"]).to(x.dtype), x],
                      dim=1)
    return x


def logits_from_hidden(cfg: ModelConfig, params: Dict,
                       x: torch.Tensor) -> torch.Tensor:
    return L.lm_logits(cfg, params["lm_head"], params["embed"], x)


# ---------------------------------------------------------------------------
# serving: prefill + decode


def init_caches(cfg: ModelConfig, batch: int, max_len: int,
                dtype: torch.dtype = torch.float32,
                device="cuda") -> Dict[str, Dict[str, torch.Tensor]]:
    """Stacked zero-filled caches, one per layer kind present: k / v
    (L, B, max_len, KV, Dh), or MLA's c_kv / k_rope (L, B, max_len,
    ...)."""
    check_decoder(cfg)
    layer = (attn.init_mla_cache if cfg.mla is not None
             else attn.init_kv_cache)(cfg, batch, max_len, dtype, "meta")
    n_dense = n_dense_layers(cfg)
    caches = {}
    for name, n in (("dense_blocks", n_dense),
                    ("moe_blocks", cfg.n_layers - n_dense)):
        if n:
            caches[name] = {k: torch.zeros((n, *v.shape), dtype=dtype,
                                           device=device)
                            for k, v in layer.items()}
    return caches


def layer_cache(cfg: ModelConfig, caches: Dict,
                idx: int) -> Dict[str, torch.Tensor]:
    """Layer ``idx``'s slice of the stacked caches (views: writes land in
    the stack)."""
    n_dense = n_dense_layers(cfg)
    name, i = (("dense_blocks", idx) if idx < n_dense
               else ("moe_blocks", idx - n_dense))
    return {k: v[i] for k, v in caches[name].items()}


def restore_counts(cfg: ModelConfig, n_layers: int) -> Dict[str, int]:
    """How many leading layers of each cache stack lie in the first
    ``n_layers`` layers (the mixed prefill's pre-RP layers)."""
    n_dense = n_dense_layers(cfg)
    return {"dense_blocks": min(n_layers, n_dense),
            "moe_blocks": max(n_layers - n_dense, 0)}


def run_blocks(cfg: ModelConfig, params: Dict, x: torch.Tensor,
               positions: torch.Tensor, start: int, end: int, caches: Dict,
               pos: Optional[int] = None) -> Tuple[torch.Tensor, Dict, object]:
    """Run backbone layers [start, end) on hidden states x, across the
    dense-to-MoE boundary, prefilling (``pos`` None) or decoding one
    token at ``pos``; ``positions`` (B, T) are the RoPE positions of x's
    rows.  Each layer writes its slice of ``caches`` in place.  Returns
    (x, caches, aux), aux the layers' MoE load-balance terms summed (0.0
    when none is a MoE layer)."""
    rope = rope_for(cfg, positions)
    kv_len = None
    if pos is not None and cfg.mla is None:
        kv_len = torch.full((x.shape[0],), pos + 1, dtype=torch.int32,
                            device=x.device)
    aux_total = 0.0
    for i in range(start, end):
        x, aux = block_forward(cfg, params["blocks"][i], x, rope,
                               layer_cache(cfg, caches, i), pos, kv_len)
        aux_total = aux_total + aux
    return x, caches, aux_total


def prefill(cfg: ModelConfig, params: Dict, tokens: torch.Tensor,
            caches: Dict, image_embeds: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, Dict, float]:
    """Prefill the caches with tokens (B, T), after a VLM's N projected
    ``image_embeds`` when given; returns (final hidden states (B, N + T,
    D), caches, aux)."""
    x = embed_inputs(cfg, params, tokens, image_embeds)
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
