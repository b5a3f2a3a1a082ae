"""AdamW over a dict of tensors; port of ``repro.optim.adam``.

The reference's update, kept as it is: b2 = 0.95 by default, a
global-norm gradient clip (1.0 by default) fused into the moment
updates, fp32 moments, and a non-finite gradient norm skips the step
(the moments see zero gradients).  Parameters and gradients may be of
any float type, leaf by leaf (a bf16 tree whose mamba ``A_log`` /
``dt_bias`` / ``D`` are float32): the update runs in float32 and each
parameter is rounded once to its own type, the reference's
``(p.astype(f32) - lr * delta).astype(p.dtype)``, its decay term
``weight_decay * p.astype(f32)``.  ``torch.optim.Adam`` has other
defaults and no clip.

The reference's update is a function that builds new trees; here
``adam_update`` writes the live parameters and moments in place
(``torch._foreach_*_``) and returns the same dicts, since new trees
beside the old ones would hold about seven fp32 copies of the parameters
at their peak (113 GB for Qwen3-4B).  The gradients are not changed.
The leaves go in groups whose fp32 bytes stay under ``GROUP_BYTES``, so
each of the update's temporaries (the scaled gradients and their
squares, the bias-corrected moments, the decay term; at most two alive
at once, plus a float32 copy of a group's half parameters) is at most
one group; a leaf larger than the budget forms a group of its own.
Each product is rounded on its own, as in the reference's expressions,
so the result equals the functional form's.
The clip's scale and the finite check stay device tensors: the update
makes no host sync.
"""
from __future__ import annotations

from typing import Dict, Iterator, List, NamedTuple, Optional, Tuple

import torch

Tree = Dict[str, torch.Tensor]
GROUP_BYTES = 1 << 30


class AdamState(NamedTuple):
    step: int
    m: Tree                    # like params (fp32)
    v: Tree


def init_adam(params: Tree) -> AdamState:
    def zeros():
        return {k: torch.zeros(p.shape, dtype=torch.float32,
                               device=p.device) for k, p in params.items()}
    return AdamState(step=0, m=zeros(), v=zeros())


def groups(params: Tree) -> Iterator[List[str]]:
    """The keys of ``params`` in order, cut into runs whose fp32 bytes
    stay under ``GROUP_BYTES`` (a larger leaf is a run of its own)."""
    run: List[str] = []
    size = 0
    for k, p in params.items():
        n = 4 * p.numel()
        if run and size + n > GROUP_BYTES:
            yield run
            run, size = [], 0
        run.append(k)
        size += n
    if run:
        yield run


def adam_update(grads: Tree, state: AdamState, params: Tree, *,
                lr: float = 1e-4, b1: float = 0.9, b2: float = 0.95,
                eps: float = 1e-8, weight_decay: float = 0.0,
                grad_clip: Optional[float] = 1.0,
                gnorm: Optional[torch.Tensor] = None
                ) -> Tuple[Tree, AdamState, Dict[str, torch.Tensor]]:
    """One AdamW step, in place on ``params``, ``state.m`` and
    ``state.v``; returns (params, the state with its step advanced,
    {"grad_norm"}).  ``gnorm``: the gradients' global norm when they are
    local pieces of a sharded tree (``train.trainer`` sums it across the
    mesh); by default :func:`global_norm` of ``grads``."""
    step = state.step + 1
    if gnorm is None:
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
    zero = torch.zeros((), device=gnorm.device)
    for keys in groups(params):
        ps = [params[k] for k in keys]
        ms = [state.m[k] for k in keys]
        vs = [state.v[k] for k in keys]
        gs = [torch.where(ok, grads[k].to(torch.float32), zero)
              for k in keys]
        torch._foreach_mul_(gs, scale)
        sq = torch._foreach_mul(gs, gs)
        torch._foreach_mul_(sq, 1 - b2)
        torch._foreach_mul_(vs, b2)
        torch._foreach_add_(vs, sq)        # not addcmul_: it rounds once
        del sq
        torch._foreach_mul_(gs, 1 - b1)
        torch._foreach_mul_(ms, b1)
        torch._foreach_add_(ms, gs)              # m = b1 m + (1-b1) g
        del gs
        den = torch._foreach_div(vs, bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, eps)
        delta = torch._foreach_div(ms, bc1)
        torch._foreach_div_(delta, den)
        del den
        # the float32 view of the parameters: a float32 leaf itself (its
        # update stays in place), a half leaf a float32 copy
        half = [i for i, p in enumerate(ps) if p.dtype != torch.float32]
        pf = [p if p.dtype == torch.float32 else p.float() for p in ps]
        if weight_decay:
            torch._foreach_add_(delta, torch._foreach_mul(pf, weight_decay))
        torch._foreach_mul_(delta, lr)
        torch._foreach_sub_(pf, delta)
        del delta
        if half:                 # one rounding to the parameter's type
            torch._foreach_copy_([ps[i] for i in half],
                                 [pf[i] for i in half])
        del pf
    return params, AdamState(step, state.m, state.v), {"grad_norm": gnorm}


def global_norm(tree: Tree) -> torch.Tensor:
    """sqrt of the sum over the leaves, in order, of each leaf's sum of
    squares: the reference's summation order (``torch._foreach_norm``
    rounds each leaf's norm before squaring it again)."""
    return torch.sqrt(sum(torch.sum(torch.square(t.to(torch.float32)))
                          for t in tree.values()))
