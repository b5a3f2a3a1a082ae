"""Architecture registry: the dispatch surface over model families (the
``repro.models.registry`` serving entry points).

  init_params(cfg, generator, device)
  init_decode_state(cfg, batch, max_len, dtype, device)
  prefill(cfg, params, batch, state)           -> (hidden, state, aux)
  decode_step(cfg, params, token, pos, state)  -> (logits, state)

The dense decoder family (``models.transformer``) and the ViT's
parameters (``convert.init_vitdet_params``) are ported; the other
families raise, in the order ``ROADMAP.md`` gives for their port.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.models import transformer as tfm
from repro_torch.models.config import ModelConfig


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device="cuda") -> Dict:
    if cfg.family == "vit":
        from repro_torch import convert
        return convert.init_vitdet_params(cfg, generator, device)
    return tfm.init_lm_params(cfg, generator, device)


def init_decode_state(cfg: ModelConfig, batch: int, max_len: int,
                      dtype: torch.dtype = torch.float32, device="cuda"):
    return tfm.init_caches(cfg, batch, max_len, dtype, device)


def prefill(cfg: ModelConfig, params: Dict, batch: Dict[str, Any], state):
    tfm.check_dense(cfg)
    return tfm.prefill(cfg, params, batch["tokens"], state)


def decode_step(cfg: ModelConfig, params: Dict, token: torch.Tensor,
                pos: int, state):
    tfm.check_dense(cfg)
    return tfm.decode_step(cfg, params, token, pos, state)
