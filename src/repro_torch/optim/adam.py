"""AdamW over a dict of tensors; port of ``repro.optim.adam``.

The reference's update, kept as it is: b2 = 0.95 by default, a
global-norm gradient clip (1.0 by default) fused into the moment
updates, fp32 moments whatever the parameters' dtype, and a non-finite
gradient norm skips the step (the moments see zero gradients).  It is a
function, as the reference's is: it returns new parameters and a new
state and changes neither input.  ``torch.optim.Adam`` has other
defaults and no clip.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

Tree = Dict[str, torch.Tensor]


class AdamState(NamedTuple):
    step: int
    m: Tree                    # like params (fp32)
    v: Tree


def init_adam(params: Tree) -> AdamState:
    def zeros():
        return {k: torch.zeros(p.shape, dtype=torch.float32,
                               device=p.device) for k, p in params.items()}
    return AdamState(step=0, m=zeros(), v=zeros())


def adam_update(grads: Tree, state: AdamState, params: Tree, *,
                lr: float = 1e-4, b1: float = 0.9, b2: float = 0.95,
                eps: float = 1e-8, weight_decay: float = 0.0,
                grad_clip: Optional[float] = 1.0
                ) -> Tuple[Tree, AdamState, Dict[str, torch.Tensor]]:
    step = state.step + 1

    gnorm = global_norm(grads)
    if grad_clip is not None:
        scale = torch.clamp(grad_clip / (gnorm + 1e-12), max=1.0)
    else:
        scale = torch.ones_like(gnorm)
    # a non-finite gradient must not poison the moments: zero the
    # gradients (NaN * 0 is NaN, so scaling is not enough)
    ok = torch.isfinite(gnorm)
    scale = torch.where(ok, scale, torch.zeros_like(scale))

    bc1 = 1.0 - b1 ** step
    bc2 = 1.0 - b2 ** step
    new_m, new_v, new_p = {}, {}, {}
    for k, p in params.items():
        g = grads[k].to(torch.float32)
        g = torch.where(ok, g, torch.zeros_like(g)) * scale
        m = b1 * state.m[k] + (1 - b1) * g
        v = b2 * state.v[k] + (1 - b2) * torch.square(g)
        delta = (m / bc1) / (torch.sqrt(v / bc2) + eps)
        if weight_decay:
            delta = delta + weight_decay * p.to(torch.float32)
        new_m[k], new_v[k] = m, v
        new_p[k] = (p.to(torch.float32) - lr * delta).to(p.dtype)
    return new_p, AdamState(step, new_m, new_v), {"grad_norm": gnorm}


def global_norm(tree: Tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(t.to(torch.float32)))
                          for t in tree.values()))
