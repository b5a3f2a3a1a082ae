"""Norms, rotary and sinusoidal positions, MLPs, the token embedding and
``remat`` (the ``repro.models.layers`` subset the ViT and LM paths run).
Parameters are plain dicts of tensors; projection weights may be int8
``QuantTensor``s (``quant.qtensor.matmul``).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch.models.config import ModelConfig
from repro_torch.quant import qtensor as qt

# ---------------------------------------------------------------------------
# seeded inits (the reference's distributions; torch.Generator draws)


def dense_init(k: int, n: int, generator: torch.Generator,
               device="cuda") -> torch.Tensor:
    """A (k, n) weight: truncated normal in (-2, 2) times 1 / sqrt(k),
    drawn on ``generator.device`` and moved to ``device``."""
    return slab_init((k, n), generator, device)


def as_dtype(tree, dtype: Optional[torch.dtype]):
    """``tree`` with its float leaves cast to ``dtype``; None keeps them
    as drawn (float32).  The inits draw in float32 and cast each piece
    as soon as it is drawn, as the reference's ``.astype(dtype)`` after
    each float32 draw: at most one float32 piece is alive."""
    return tree if dtype is None else qt.cast_tree(tree, dtype)


def is_meta(device) -> bool:
    """Whether ``device`` is the meta device: an init there draws nothing
    and builds the tree's shapes only (``distributed.sharding`` reads
    them at full width without the memory)."""
    return torch.device(device).type == "meta"


def slab_init(shape: Tuple[int, ...], generator: torch.Generator,
              device="cuda", scale: Optional[float] = None) -> torch.Tensor:
    """A weight of any rank >= 2 drawn as the reference's ``dense_init``
    draws it: truncated normal in (-2, 2) times ``scale``, by default
    1 / sqrt(shape[0]) (for an (E, D, F) expert slab, the expert count).
    On the meta device nothing is drawn: the shape alone."""
    if is_meta(device):
        return torch.empty(shape, device="meta")
    t = torch.empty(shape, device=generator.device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    t = t.div_(math.sqrt(shape[0])) if scale is None else t.mul_(scale)
    return t.to(device)


def init_mlp(cfg: ModelConfig, generator: torch.Generator,
             device="cuda", d_ff: Optional[int] = None,
             dtype: Optional[torch.dtype] = None) -> Dict[str, torch.Tensor]:
    """SwiGLU (gate, up, down) or the plain GELU MLP with zero biases;
    hidden width ``d_ff`` (default ``cfg.d_ff``); cast to ``dtype``."""
    D, F_ = cfg.d_model, d_ff or cfg.d_ff
    if cfg.activation == "silu":
        return as_dtype({"w_gate": dense_init(D, F_, generator, device),
                         "w_up": dense_init(D, F_, generator, device),
                         "w_down": dense_init(F_, D, generator, device)},
                        dtype)
    return as_dtype({"w_up": dense_init(D, F_, generator, device),
                     "b_up": torch.zeros(F_, device=device),
                     "w_down": dense_init(F_, D, generator, device),
                     "b_down": torch.zeros(D, device=device)}, dtype)


def init_embedding(cfg: ModelConfig, generator: torch.Generator,
                   device="cuda", dtype: Optional[torch.dtype] = None
                   ) -> Dict[str, torch.Tensor]:
    """The token table, normal with std 0.02; cast to ``dtype``."""
    if is_meta(device):
        tok = torch.empty((cfg.vocab_size, cfg.d_model), device="meta")
    else:
        tok = torch.empty((cfg.vocab_size, cfg.d_model),
                          device=generator.device)
        torch.nn.init.normal_(tok, 0.0, 0.02, generator=generator)
    return as_dtype({"tok": tok.to(device)}, dtype)


def init_lm_head(cfg: ModelConfig, generator: torch.Generator,
                 device="cuda", dtype: Optional[torch.dtype] = None
                 ) -> Dict[str, torch.Tensor]:
    if cfg.tied_embeddings:
        return {}
    return as_dtype({"w": dense_init(cfg.d_model, cfg.vocab_size, generator,
                                     device)}, dtype)


def mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` in the two operands' promoted type, as jnp's ``@`` mixes
    them (a float32 input against half weights runs in float32; the
    casts up are exact).  ``qtensor.matmul`` is the other rule: the
    reference's projections cast the input down to a half weight's
    type."""
    ct = torch.promote_types(x.dtype, w.dtype)
    return torch.matmul(x.to(ct), w.to(ct))


# ---------------------------------------------------------------------------
# norms


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm with float32 statistics."""
    dt = x.dtype
    x = x.float()
    var = x.square().mean(-1, keepdim=True)
    return (x * torch.rsqrt(var + eps) * weight.float()).to(dt)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm with float32 statistics (population variance)."""
    dt = x.dtype
    x = x.float()
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    out = (x - mu) * torch.rsqrt(var + eps) * weight.float() + bias.float()
    return out.to(dt)


def init_norm(cfg: ModelConfig, device, dtype: Optional[torch.dtype] = None
              ) -> Dict[str, torch.Tensor]:
    p = {"w": torch.ones(cfg.d_model, device=device)}
    if cfg.norm == "layernorm":
        p["b"] = torch.zeros(cfg.d_model, device=device)
    return as_dtype(p, dtype)


def apply_norm(cfg: ModelConfig, p: Dict[str, torch.Tensor],
               x: torch.Tensor) -> torch.Tensor:
    """The block's pre-norm: LayerNorm (ViTDet) or RMSNorm (the LMs)."""
    if cfg.norm == "layernorm":
        return layer_norm(x, p["w"], p["b"], cfg.norm_eps)
    return rms_norm(x, p["w"], cfg.norm_eps)


# ---------------------------------------------------------------------------
# rotary embeddings


def rope_frequencies(head_dim: int, theta: float, partial_factor: float = 1.0,
                     device=None) -> torch.Tensor:
    """Inverse frequencies for the rotated sub-dimension, (rot_dim // 2,)."""
    rot_dim = int(head_dim * partial_factor) // 2 * 2
    exponent = (torch.arange(0, rot_dim, 2, dtype=torch.float32,
                             device=device) / max(rot_dim, 1))
    return 1.0 / (theta ** exponent)


def rope_table(positions: torch.Tensor, head_dim: int, theta: float,
               partial_factor: float = 1.0
               ) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
    """cos and sin of the rotation angles, (..., T, 1, rot_dim // 2), for
    ``positions`` (..., T); None when nothing rotates.  A forward computes
    it once and hands it to every layer's :func:`apply_rope`."""
    rot_dim = int(head_dim * partial_factor) // 2 * 2
    if rot_dim == 0:
        return None
    inv_freq = rope_frequencies(head_dim, theta, partial_factor,
                                device=positions.device)
    ang = positions.float()[..., None] * inv_freq
    return torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]


def apply_rope(x: torch.Tensor,
               table: Optional[Tuple[torch.Tensor, torch.Tensor]]
               ) -> torch.Tensor:
    """Rotate the leading rot_dim channels of the head dim by ``table``
    (:func:`rope_table` of the positions; None rotates nothing).

    x: (..., T, H, Dh).
    """
    if table is None:
        return x
    cos, sin = table
    rot_dim = 2 * cos.shape[-1]
    x_rot, x_pass = x[..., :rot_dim], x[..., rot_dim:]
    x1, x2 = x_rot.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return torch.cat([out.to(x.dtype), x_pass], dim=-1)


def sinusoidal_positions(n_pos: int, dim: int, device=None) -> torch.Tensor:
    """Whisper's sinusoidal position table (n_pos, dim) in float32: sines
    of the first dim / 2 frequencies, then their cosines."""
    half = dim // 2
    inv = torch.exp(-torch.arange(half, dtype=torch.float32, device=device)
                    * (math.log(10000.0) / (half - 1)))
    pos = (torch.arange(n_pos, dtype=torch.float32, device=device)[:, None]
           * inv[None, :])
    return torch.cat([torch.sin(pos), torch.cos(pos)], dim=-1)


# ---------------------------------------------------------------------------
# MLPs


def apply_mlp(cfg: ModelConfig, p: Dict[str, torch.Tensor],
              x: torch.Tensor) -> torch.Tensor:
    """SwiGLU (gate + up + down) when the block has ``w_gate``, else the
    plain GELU MLP.  The reference's GELU is the tanh approximation
    (``jax.nn.gelu(approximate=True)``); PyTorch's default is erf."""
    if "w_gate" in p:
        h = F.silu(qt.matmul(x, p["w_gate"])) * qt.matmul(x, p["w_up"])
        return qt.matmul(h, p["w_down"])
    h = F.gelu(qt.matmul(x, p["w_up"]) + p["b_up"], approximate="tanh")
    return qt.matmul(h, p["w_down"]) + p["b_down"]


# ---------------------------------------------------------------------------
# embedding / unembedding


def embed_tokens(p: Dict[str, torch.Tensor],
                 tokens: torch.Tensor) -> torch.Tensor:
    return p["tok"][tokens]


def lm_logits(cfg: ModelConfig, head_p: Dict[str, torch.Tensor],
              embed_p: Dict[str, torch.Tensor],
              x: torch.Tensor) -> torch.Tensor:
    """Vocabulary logits; tied embeddings read the embedding table
    transposed (a plain GEMM, left to ``torch.matmul``)."""
    if cfg.tied_embeddings:
        return x @ embed_p["tok"].T
    return x @ head_p["w"]


def remat(fn, on: bool, *args):
    """``fn(*args)``; when ``on`` (and autograd records), its activations
    are dropped after the forward and recomputed in the backward
    (``torch.utils.checkpoint``, the port of the reference's
    ``jax.checkpoint`` around a layer)."""
    if on and torch.is_grad_enabled():
        return torch.utils.checkpoint.checkpoint(fn, *args,
                                                 use_reentrant=False)
    return fn(*args)
