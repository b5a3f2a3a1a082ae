"""Architecture registry: the dispatch surface over model families (the
``repro.models.registry`` serving entry points).

  init_params(cfg, generator, device)
  init_decode_state(cfg, batch, max_len, dtype, device)
  prefill(cfg, params, batch, state)           -> (hidden, state, aux)
  decode_step(cfg, params, token, pos, state)  -> (logits, state)

The dense decoder (``models.transformer``), the pure SSM LM
(``models.ssm_lm``), the Mamba-2 + shared-attention hybrid
(``models.hybrid``) and the ViT's parameters
(``convert.init_vitdet_params``) are ported; MoE, MLA, VLM and
encoder-decoder configs raise, in the order ``ROADMAP.md`` gives for
their port.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.models import hybrid as hyb
from repro_torch.models import ssm_lm
from repro_torch.models import transformer as tfm
from repro_torch.models.config import ModelConfig


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device="cuda") -> Dict:
    if cfg.family == "vit":
        from repro_torch import convert
        return convert.init_vitdet_params(cfg, generator, device)
    if cfg.family == "ssm":
        return ssm_lm.init_ssm_params(cfg, generator, device)
    if cfg.family == "hybrid":
        return hyb.init_hybrid_params(cfg, generator, device)
    return tfm.init_lm_params(cfg, generator, device)


def init_decode_state(cfg: ModelConfig, batch: int, max_len: int,
                      dtype: torch.dtype = torch.float32, device="cuda"):
    if cfg.family == "ssm":
        return hyb.init_stacked_states(cfg, batch, dtype, device)
    if cfg.family == "hybrid":
        return hyb.init_hybrid_caches(cfg, batch, max_len, dtype, device)
    return tfm.init_caches(cfg, batch, max_len, dtype, device)


def prefill(cfg: ModelConfig, params: Dict, batch: Dict[str, Any], state):
    if cfg.family == "ssm":
        return ssm_lm.prefill(cfg, params, batch["tokens"], state)
    if cfg.family == "hybrid":
        return hyb.prefill(cfg, params, batch["tokens"], state)
    tfm.check_dense(cfg)
    return tfm.prefill(cfg, params, batch["tokens"], state)


def decode_step(cfg: ModelConfig, params: Dict, token: torch.Tensor,
                pos: int, state):
    if cfg.family == "ssm":
        return ssm_lm.decode_step(cfg, params, token, pos, state)
    if cfg.family == "hybrid":
        return hyb.decode_step(cfg, params, token, pos, state)
    tfm.check_dense(cfg)
    return tfm.decode_step(cfg, params, token, pos, state)
