"""GPipe-style pipeline parallelism over a ``stage`` process group; port
of ``repro.distributed.pipeline``.

Layers are partitioned into S contiguous stages; microbatches flow
through them with activations handed from stage s to s + 1 by
point-to-point sends (``dist.batch_isend_irecv`` on a ring).

Schedule (GPipe, fill-drain, the reference's): M + S - 1 ticks for M
microbatches on S stages.  At tick t, stage s computes microbatch t - s
when it is in range; activations move s -> s + 1 between ticks.  Every
stage computes at every tick: one idle in the fill / drain phase
computes on what it holds (zeros at first) and masks the result, so
every rank runs the same sequence of sends and receives.  The last stage
writes each finished microbatch; a final all-reduce over the stages
(the others hold zeros) hands the outputs to every stage.

Bubble fraction = (S - 1) / (M + S - 1), the classic GPipe overhead.
A forward pass only, as in the reference (its own test and benchmark).
"""
from __future__ import annotations

from typing import Any, Callable, Tuple

import torch
import torch.distributed as dist


def stage_layers(n_layers: int, n_stages: int, stage: int) -> Tuple[int, int]:
    """[lo, hi) layer range of ``stage`` under near-even partitioning."""
    base = n_layers // n_stages
    extra = n_layers % n_stages
    lo = stage * base + min(stage, extra)
    hi = lo + base + (1 if stage < extra else 0)
    return lo, hi


def bubble_fraction(n_micro: int, n_stages: int) -> float:
    return (n_stages - 1) / (n_micro + n_stages - 1)


def _take(tree: Any, i) -> Any:
    if isinstance(tree, dict):
        return {k: _take(v, i) for k, v in tree.items()}
    return tree[i]


def _n_layers(tree: Any) -> int:
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree.shape[0]


def make_pipeline_fn(layer_fn: Callable, n_layers: int, n_stages: int,
                     n_micro: int, group=None) -> Callable:
    """The per-stage body of a GPipe forward.

    ``layer_fn(params_for_layer, x) -> x`` applies ONE layer.  Returns
    ``body(stage_params, x_micro) -> y_micro``: ``stage_params`` this
    stage's layers stacked on a leading axis, ``x_micro`` (M, mb, ...)
    the microbatched input (every stage holds it; stage 0 consumes it),
    ``y_micro`` the finished microbatches on every stage."""
    S, M = n_stages, n_micro

    def body(stage_params: Any, x_micro: torch.Tensor) -> torch.Tensor:
        sid = dist.get_rank(group)
        nxt = dist.get_global_rank(group, (sid + 1) % S)
        prv = dist.get_global_rank(group, (sid - 1) % S)

        def apply_stage(x):
            for i in range(_n_layers(stage_params)):
                x = layer_fn(_take(stage_params, i), x)
            return x

        inflight = torch.zeros_like(x_micro[0])
        outputs = torch.zeros_like(x_micro)
        for t in range(M + S - 1):
            m = t - sid
            active = 0 <= m < M
            x_in = x_micro[min(max(m, 0), M - 1)] if sid == 0 else inflight
            y = apply_stage(x_in)
            if not active:
                y = torch.zeros_like(y)
            elif sid == S - 1:
                outputs[m] = y
            if S > 1:
                # ring hand-off s -> s + 1 (the wrap S-1 -> 0 carries
                # what stage 0 ignores)
                recv = torch.empty_like(y)
                reqs = dist.batch_isend_irecv([
                    dist.P2POp(dist.isend, y.contiguous(), nxt, group),
                    dist.P2POp(dist.irecv, recv, prv, group)])
                for r in reqs:
                    r.wait()
                inflight = recv
        if S > 1:
            dist.all_reduce(outputs, op=dist.ReduceOp.SUM, group=group)
        return outputs

    return body


def pipeline_forward(mesh, layer_fn: Callable, stacked_params: Any,
                     x: torch.Tensor, n_micro: int,
                     axis: str = "stage") -> torch.Tensor:
    """A GPipe forward of ``n_layers`` stacked layers over ``mesh``'s
    ``axis``.  stacked_params: a dict tree with leading layer axis L (the
    whole stack on every rank; each stage takes its L / S layers);
    x: (B, ...) with B % n_micro == 0, the same on every rank.  Returns
    y (B, ...) on every rank."""
    S = mesh.size(list(mesh.mesh_dim_names).index(axis))
    group = mesh.get_group(axis)
    L = _n_layers(stacked_params)
    if L % S:
        raise ValueError(f"{L} layers do not split over {S} stages")
    B = x.shape[0]
    if B % n_micro:
        raise ValueError(f"batch {B} does not split into {n_micro} "
                         "microbatches")
    lo, hi = stage_layers(L, S, mesh.get_local_rank(axis))
    local = _take(stacked_params, slice(lo, hi))
    body = make_pipeline_fn(layer_fn, L, S, n_micro, group)
    y = body(local, x.reshape((n_micro, B // n_micro) + tuple(x.shape[1:])))
    return y.reshape(x.shape)
