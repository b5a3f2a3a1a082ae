"""LayerNorm and the GELU MLP of the ViT blocks (the ``repro.models.layers``
subset the serving path runs).  Parameters are plain dicts of tensors;
MLP weights may be int8 ``QuantTensor``s (``quant.qtensor.matmul``).
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.quant import qtensor as qt


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm with float32 statistics (population variance)."""
    dt = x.dtype
    x = x.float()
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    out = (x - mu) * torch.rsqrt(var + eps) * weight.float() + bias.float()
    return out.to(dt)


def apply_norm(cfg: ModelConfig, p: Dict[str, torch.Tensor],
               x: torch.Tensor) -> torch.Tensor:
    """The ViT's pre-norm (``cfg.norm == "layernorm"``, as ViTDet has)."""
    if cfg.norm != "layernorm":
        raise NotImplementedError(f"norm {cfg.norm!r} is not ported")
    return layer_norm(x, p["w"], p["b"], cfg.norm_eps)


def apply_mlp(cfg: ModelConfig, p: Dict[str, torch.Tensor],
              x: torch.Tensor) -> torch.Tensor:
    """Plain GELU MLP.  The reference uses the tanh approximation
    (``jax.nn.gelu(approximate=True)``); PyTorch's default is erf."""
    h = F.gelu(qt.matmul(x, p["w_up"]) + p["b_up"], approximate="tanh")
    return qt.matmul(h, p["w_down"]) + p["b_down"]
