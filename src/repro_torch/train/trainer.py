"""The LM training step; port of ``repro.train.trainer`` at world size 1.

``make_train_step(cfg, tc)`` returns

    train_step(params, opt_state, batch) -> (params, opt_state, metrics)

over the port's parameter tree (nested dicts and lists of tensors): the
next-token loss (``registry.lm_loss``), its gradients, the reference's
``warmup_cosine`` learning rate at the optimiser's step, and AdamW with
the global-norm clip (``optim.adam``), which writes the parameters and
moments in place.  The optimiser state runs over the flat view of the
tree (``train.checkpoint.flatten``), whose leaves are the tree's own
tensors.

Accumulation: with ``accum_steps`` A the batch's rows go in A
contiguous microbatches, each one's ``backward`` adding into the leaves'
``.grad``, which are then divided by A: the reference's float32 sum over
its microbatch scan, then the divide.  Only one gradient set is ever
alive (a second, added in, would be another 16 GB at Qwen3-4B), and the
leaves' ``.grad`` are freed after the update.

The reference's ``ParallelCtx`` reduces to the ``remat`` flag here;
``sp``, ``train_shardings`` and the cross-pod ``compress_pod_grads``
need the port's mesh code (``ROADMAP.md``, Queue 1, the mesh item), so
``make_train_step`` refuses a config that sets ``sp`` or
``compress_pod_grads``.  The leaves require grad only inside a step: the
returned parameters are plain tensors again, as the reference's arrays.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.models import registry
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adam
from repro_torch.optim.schedules import warmup_cosine
from repro_torch.train import checkpoint as ckpt


@dataclass(frozen=True)
class TrainConfig:
    accum_steps: int = 1             # microbatch gradient accumulation
    remat: bool = True
    sp: bool = False                 # sequence parallelism (a mesh; refused)
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10000
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    compress_pod_grads: bool = False  # across pods (a mesh; refused)


def make_train_step(cfg: ModelConfig,
                    tc: TrainConfig = TrainConfig()) -> Callable:
    for flag in ("sp", "compress_pod_grads"):
        if getattr(tc, flag):
            raise ValueError(f"TrainConfig.{flag} needs a device mesh, which "
                             "the port's trainer does not have (world size 1)")

    def train_step(params: Dict, opt_state: adam.AdamState,
                   batch: Dict[str, torch.Tensor]
                   ) -> Tuple[Dict, adam.AdamState, Dict[str, Any]]:
        A = tc.accum_steps
        rows = next(iter(batch.values())).shape[0]
        if rows % A:
            raise ValueError(f"batch of {rows} rows does not split into "
                             f"{A} microbatches")
        flat = ckpt.flatten(params)
        for p in flat.values():
            p.requires_grad_(True)
            p.grad = None
        loss, metrics = 0.0, {}
        for i in range(A):
            mb = {k: v[i * rows // A:(i + 1) * rows // A]
                  for k, v in batch.items()}
            mb_loss, mb_metrics = registry.lm_loss(cfg, params, mb, tc.remat)
            mb_loss.backward()
            loss = loss + mb_loss.detach()
            if A == 1:                   # the reference drops them at A > 1
                metrics = {k: v.detach() for k, v in mb_metrics.items()}
        # a leaf the loss does not reach (the hybrid's shared block at
        # fewer than six layers) gets the zero gradient jax.grad gives it
        grads = {k: p.grad if p.grad is not None else torch.zeros_like(p)
                 for k, p in flat.items()}
        if A > 1:
            torch._foreach_div_(list(grads.values()), A)
            loss = loss / A
        lr = warmup_cosine(opt_state.step, peak_lr=tc.peak_lr,
                           warmup_steps=tc.warmup_steps,
                           total_steps=tc.total_steps)
        with torch.no_grad(), torch.profiler.record_function("adamw"):
            _, opt_state, om = adam.adam_update(
                grads, opt_state, flat, lr=lr,
                weight_decay=tc.weight_decay, grad_clip=tc.grad_clip)
        del grads
        for p in flat.values():
            p.grad = None
            p.requires_grad_(False)
        return params, opt_state, {"loss": loss, "lr": lr, **om, **metrics}

    return train_step


def init_train_state(cfg: ModelConfig, generator: torch.Generator,
                     device="cuda") -> Tuple[Dict, adam.AdamState]:
    """Seeded parameters (``registry.init_params``) and a fresh AdamW
    state over their flat view."""
    params = registry.init_params(cfg, generator, device)
    return params, adam.init_adam(ckpt.flatten(params))
