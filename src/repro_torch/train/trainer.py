"""The LM training step; port of ``repro.train.trainer``.

``make_train_step(cfg, tc, mesh=None)`` returns

    train_step(params, opt_state, batch) -> (params, opt_state, metrics)

over the port's parameter tree (nested dicts and lists of tensors): the
next-token loss (``registry.lm_loss``), its gradients, the reference's
``warmup_cosine`` learning rate at the optimiser's step, and AdamW with
the global-norm clip (``optim.adam``), which writes the parameters and
moments in place.  The optimiser state runs over the flat view of the
tree (``train.checkpoint.flatten``), whose leaves are the tree's own
tensors.

Parameters may be float32, fp16 or bf16 (``init_train_state(dtype=)``),
leaf by leaf; the AdamW moments are float32 at any type.

Accumulation: with ``accum_steps`` A the batch's rows go in A
contiguous microbatches, each one's ``backward`` adding into the leaves'
``.grad``, which are then divided by A: the reference's float32 sum over
its microbatch scan, then the divide.  A half leaf's microbatch gradient
is moved into a float32 sum instead (its ``.grad`` freed), so the sum
and the divide run in float32 as the reference's; at A = 1 gradients
stay in the parameter's type, as the reference's.  Only one gradient
set is ever alive (a second, added in, would be another 16 GB at
Qwen3-4B), and the leaves' ``.grad`` are freed after the update.

On a mesh (``launch.mesh``; the reference's FSDP + expert-parallel
layout, ``train_shardings``): ``params`` and both AdamW moments are this
rank's pieces under the fixed ``param_specs``; ``batch`` is the global
batch, of which each data rank takes its rows (microbatch by
microbatch, as the reference's sharded microbatch scan splits them);
each block gathers its leaves as it runs (``sharding.Gathered``), the
MoE slabs over ``data`` only, split over ``model``
(``moe.moe_sharded``); gradients come back reduce-scattered (a half
leaf's in its type, each microbatch's before it joins the float32 sum),
and a leaf replicated over an axis sums its gradient over that axis;
the loss is the global masked mean (``registry.lm_loss``); the clip's
global norm counts each element once (a replicated leaf on the ranks at
coordinate 0 of its replicated axes only); AdamW updates the local
pieces.  Compute
gathers (tensor parallelism by gather, not Megatron's split GEMMs): the
numbers are the reference's on any mesh, as GSPMD's are.  ``sp`` keeps
the decoder's residual carry in d_model pieces over ``model``
(``transformer.ParallelCtx``); without a mesh it is refused.
``compress_pod_grads`` is refused everywhere: the reference's step never
reads it.  The leaves require grad only inside a step: the returned
parameters are plain tensors again, as the reference's arrays.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.distributed import sharding as shd
from repro_torch.models import registry
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import ParallelCtx
from repro_torch.optim import adam
from repro_torch.optim.schedules import warmup_cosine
from repro_torch.train import checkpoint as ckpt


@dataclass(frozen=True)
class TrainConfig:
    accum_steps: int = 1             # microbatch gradient accumulation
    remat: bool = True
    sp: bool = False                 # sequence-parallel carry (a mesh)
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10000
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    compress_pod_grads: bool = False  # refused: the reference never reads it


def make_ctx(cfg: ModelConfig, mesh=None, remat: bool = True,
             sp: bool = False) -> ParallelCtx:
    if mesh is None:
        return ParallelCtx(remat=remat, sp=sp)
    return ParallelCtx(mesh=mesh, data_axes=shd.dp_axes(mesh), remat=remat,
                       sp=sp)


def train_shardings(cfg: ModelConfig, mesh, params, batch=None
                    ) -> Tuple[Any, adam.AdamState, Any]:
    """(param, AdamW state, batch) spec trees for the step on ``mesh``
    (``params`` may be meta tensors: shapes are all it reads).  The
    reference's ``train_shardings`` calls ``param_specs`` without a mesh;
    storage needs every split dim divisible, so these are the fixed
    specs, as its dry-run stores them (``launch/specs.py``).  The
    moments run over the flat view of the tree, so their specs are
    flat."""
    pspecs = shd.param_specs(cfg, params, mesh)
    flat = ckpt.flatten(pspecs)
    opt = adam.AdamState(step=shd.Spec(), m=flat, v=dict(flat))
    bspecs = (None if batch is None
              else shd.batch_specs(cfg, mesh, batch))
    return pspecs, opt, bspecs


def shape_tree(cfg: ModelConfig, dtype: Optional[torch.dtype] = None
               ) -> Dict:
    """The config's parameter tree on the meta device: shapes and the
    dtypes ``registry.init_params(..., dtype)`` gives, no storage."""
    return registry.init_params(cfg, torch.Generator(), "meta", dtype)


def make_train_step(cfg: ModelConfig, tc: TrainConfig = TrainConfig(),
                    mesh=None) -> Callable:
    """The step; without ``mesh`` on one device (world size 1), with one
    sharded over it (the module docstring).  The reference's order is
    ``make_train_step(cfg, mesh, tc)``; the port keeps ``tc`` second so
    that mesh-free callers read as before."""
    if tc.compress_pod_grads:
        raise ValueError("TrainConfig.compress_pod_grads: the reference's "
                         "train step never reads it (its int8 all-reduce "
                         "is optim.grad_compression.compressed_psum)")
    if tc.sp and mesh is None:
        raise ValueError("TrainConfig.sp shards the residual carry over a "
                         "mesh's model axis: it needs a device mesh")
    if mesh is not None:
        return _mesh_step(cfg, tc, mesh)

    def train_step(params: Dict, opt_state: adam.AdamState,
                   batch: Dict[str, torch.Tensor]
                   ) -> Tuple[Dict, adam.AdamState, Dict[str, Any]]:
        A = tc.accum_steps
        rows = _rows(batch, A)
        flat = _require_grad(params)
        loss, metrics = 0.0, {}
        acc: Dict[str, torch.Tensor] = {}
        for i in range(A):
            mb = {k: v[i * rows // A:(i + 1) * rows // A]
                  for k, v in batch.items()}
            mb_loss, mb_metrics = registry.lm_loss(cfg, params, mb, tc.remat)
            mb_loss.backward()
            loss = loss + mb_loss.detach()
            if A == 1:                   # the reference drops them at A > 1
                metrics = {k: v.detach() for k, v in mb_metrics.items()}
            else:
                _accumulate_half(flat, acc)
        grads = _grads(flat, acc)
        if A > 1:
            torch._foreach_div_(list(grads.values()), A)
            loss = loss / A
        return _update(tc, params, opt_state, flat, grads, None, loss,
                       metrics)

    return train_step


def _rows(batch: Dict[str, torch.Tensor], A: int) -> int:
    rows = next(iter(batch.values())).shape[0]
    if rows % A:
        raise ValueError(f"batch of {rows} rows does not split into "
                         f"{A} microbatches")
    return rows


def _require_grad(params: Dict) -> Dict[str, torch.Tensor]:
    flat = ckpt.flatten(params)
    for p in flat.values():
        p.requires_grad_(True)
        p.grad = None
    return flat


def _accumulate_half(flat: Dict[str, torch.Tensor],
                     acc: Dict[str, torch.Tensor]) -> None:
    """Move each half leaf's microbatch gradient into its float32 sum in
    ``acc`` (the reference's ``a + b.astype(f32)`` over its microbatch
    scan); float32 leaves keep adding into their ``.grad``."""
    with torch.no_grad():
        for k, p in flat.items():
            if p.dtype == torch.float32 or p.grad is None:
                continue
            g = p.grad.float()
            p.grad = None
            if k in acc:
                acc[k].add_(g)
            else:
                acc[k] = g


def _grads(flat: Dict[str, torch.Tensor],
           acc: Optional[Dict[str, torch.Tensor]] = None
           ) -> Dict[str, torch.Tensor]:
    # a leaf the loss does not reach (the hybrid's shared block at fewer
    # than six layers) gets the zero gradient jax.grad gives it
    acc = acc or {}
    return {k: acc[k] if k in acc else p.grad if p.grad is not None
            else torch.zeros_like(p) for k, p in flat.items()}


def _update(tc: TrainConfig, params, opt_state, flat, grads, gnorm, loss,
            metrics):
    lr = warmup_cosine(opt_state.step, peak_lr=tc.peak_lr,
                       warmup_steps=tc.warmup_steps,
                       total_steps=tc.total_steps)
    with torch.no_grad(), torch.profiler.record_function("adamw"):
        _, opt_state, om = adam.adam_update(
            grads, opt_state, flat, lr=lr, weight_decay=tc.weight_decay,
            grad_clip=tc.grad_clip, gnorm=gnorm)
    del grads
    for p in flat.values():
        p.grad = None
        p.requires_grad_(False)
    return params, opt_state, {"loss": loss, "lr": lr, **om, **metrics}


def _mesh_step(cfg: ModelConfig, tc: TrainConfig, mesh) -> Callable:
    import torch.distributed as dist
    ctx = make_ctx(cfg, mesh, tc.remat, tc.sp)
    pspecs, _, _ = train_shardings(cfg, mesh, shape_tree(cfg))
    flat_specs = ckpt.flatten(pspecs)
    names = list(shd.mesh_shape(mesh))
    # per leaf: the axes it is replicated over (its gradient sums there)
    # and whether this rank's piece counts in the global norm
    replicated = {k: tuple(a for a in names if a not in shd.spec_axes(s))
                  for k, s in flat_specs.items()}
    counts = {k: all(mesh.get_local_rank(a) == 0 for a in axes)
              for k, axes in replicated.items()}
    aux_coef = cfg.moe.router_aux_coef if cfg.moe is not None else 0.0

    def train_step(params: Dict, opt_state: adam.AdamState,
                   batch: Dict[str, torch.Tensor]
                   ) -> Tuple[Dict, adam.AdamState, Dict[str, Any]]:
        A = tc.accum_steps
        rows = _rows(batch, A)
        flat = _require_grad(params)
        view = shd.Gathered(params, pspecs, mesh)
        loss, metrics = 0.0, {}
        acc: Dict[str, torch.Tensor] = {}
        for i in range(A):
            mb = {k: v[i * rows // A:(i + 1) * rows // A]
                  for k, v in batch.items()}
            mb = {k: shd.shard_leaf(mesh, v, s) for (k, v), s in zip(
                mb.items(), shd.batch_specs(cfg, mesh, mb).values())}
            term, mb_metrics = registry.lm_loss(cfg, view, mb, tc.remat, ctx)
            term.backward()
            loss = loss + (mb_metrics["ce"] + aux_coef * mb_metrics["aux"])
            if A == 1:
                metrics = dict(mb_metrics)
            else:
                _accumulate_half(flat, acc)
        grads = _grads(flat, acc)
        with torch.no_grad():
            for k, g in grads.items():
                shd.reduce_over(g, mesh, replicated[k])
            if A > 1:
                torch._foreach_div_(list(grads.values()), A)
                loss = loss / A
            sq = sum(torch.sum(torch.square(g.to(torch.float32)))
                     for k, g in grads.items() if counts[k])
            sq = torch.as_tensor(sq, dtype=torch.float32,
                                 device=next(iter(grads.values())).device)
            if dist.get_world_size() > 1:
                dist.all_reduce(sq, op=dist.ReduceOp.SUM)
            gnorm = torch.sqrt(sq)
        return _update(tc, params, opt_state, flat, grads, gnorm, loss,
                       metrics)

    return train_step


def shard_train_state(cfg: ModelConfig, mesh, params: Dict
                      ) -> Tuple[Dict, adam.AdamState]:
    """This rank's pieces of a full parameter tree under
    ``train_shardings`` and a fresh AdamW state over them."""
    pspecs, _, _ = train_shardings(cfg, mesh, params)
    local = shd.shard_tree(mesh, params, pspecs)
    return local, adam.init_adam(ckpt.flatten(local))


def init_train_state(cfg: ModelConfig, generator: torch.Generator,
                     device="cuda", dtype: Optional[torch.dtype] = None
                     ) -> Tuple[Dict, adam.AdamState]:
    """Seeded parameters at ``dtype`` (``registry.init_params``; None is
    float32) and a fresh AdamW state over their flat view, its moments
    float32 at any parameter type, as the reference's."""
    params = registry.init_params(cfg, generator, device, dtype)
    return params, adam.init_adam(ckpt.flatten(params))
