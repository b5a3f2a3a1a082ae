"""Pure Mamba-2 LM (mamba2-370m): mamba blocks, no attention (the port
of ``repro.models.ssm_lm``).

Parameters are a list of per-layer dicts under ``mamba_blocks``; states
keep the reference's stacked layout, ``{"conv": (L, B, K-1, C), "ssm":
(L, B, H, N, P)}`` (``hybrid.init_stacked_states``, which the reference
calls ``ssm_lm.init_states``), written in place by ``prefill`` and
``decode_step``.
On the card every layer's prefill runs the ``ssd_scan`` kernel;
``forward_hidden`` (training) runs ``mamba2.ssd_chunked``.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.models import layers as L
from repro_torch.models import mamba2 as m2
from repro_torch.models.config import ModelConfig
from repro_torch.models.hybrid import (_mamba_prefill, _store,
                                       init_mamba_blocks)


def init_ssm_params(cfg: ModelConfig, generator: torch.Generator,
                    device="cuda", dtype: Optional[torch.dtype] = None
                    ) -> Dict:
    """Seeded init with the reference's shapes and distributions, each
    piece cast to ``dtype`` as it is drawn (a mamba block's
    ``FLOAT32_LEAVES`` stay float32, as the reference's)."""
    embed = L.init_embedding(cfg, generator, device, dtype)
    return {"embed": embed,
            "mamba_blocks": init_mamba_blocks(cfg, generator, device, dtype),
            "final_norm": L.init_norm(cfg, device, dtype),
            "lm_head": L.init_lm_head(cfg, generator, device, dtype)}


def _block(cfg: ModelConfig, p: Dict, x: torch.Tensor) -> torch.Tensor:
    return x + m2.mamba2_forward(cfg, p["mamba"],
                                 L.apply_norm(cfg, p["ln"], x), train=True)


def forward_hidden(cfg: ModelConfig, params: Dict, tokens: torch.Tensor, *,
                   remat: bool = False) -> Tuple[torch.Tensor, float]:
    """Final hidden states (B, T, D) and aux (0), the scans on the
    training route (``mamba2.ssd_chunked``, differentiable); ``remat``:
    each layer's activations are recomputed in the backward
    (``torch.utils.checkpoint``, the reference's ``jax.checkpoint`` of
    its scan body)."""
    x = L.embed_tokens(params["embed"], tokens)
    for p in params["mamba_blocks"]:
        x = L.remat(_block, remat, cfg, p, x)
    return L.apply_norm(cfg, params["final_norm"], x), 0.0


def prefill(cfg: ModelConfig, params: Dict, tokens: torch.Tensor,
            states: Dict[str, torch.Tensor]
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], float]:
    """Run the prompt; every layer's end-of-prompt conv and SSM states are
    written into ``states`` in place.  Returns (final hidden states
    (B, T, D), states, aux)."""
    x = L.embed_tokens(params["embed"], tokens)
    for idx, p in enumerate(params["mamba_blocks"]):
        dx, state = _mamba_prefill(cfg, p["mamba"],
                                   L.apply_norm(cfg, p["ln"], x))
        x = x + dx
        _store(states, idx, state)
    return L.apply_norm(cfg, params["final_norm"], x), states, 0.0


def decode_step(cfg: ModelConfig, params: Dict, token: torch.Tensor,
                pos: int, states: Dict[str, torch.Tensor]
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One recurrent step (``pos`` is unused: the state carries the
    position).  Returns (logits (B, 1, V), states)."""
    x = L.embed_tokens(params["embed"], token)
    for idx, p in enumerate(params["mamba_blocks"]):
        dx, new = m2.mamba2_decode(cfg, p["mamba"],
                                   L.apply_norm(cfg, p["ln"], x),
                                   {k: v[idx] for k, v in states.items()})
        x = x + dx
        _store(states, idx, new)
    x = L.apply_norm(cfg, params["final_norm"], x)
    return L.lm_logits(cfg, params["lm_head"], params["embed"], x), states
