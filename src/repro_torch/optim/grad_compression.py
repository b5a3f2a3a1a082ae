"""int8 gradient compression with error feedback; port of
``repro.optim.grad_compression``.

The reference quantizes gradients to int8 with a shared scale for the
all-reduce across pods and keeps each shard's quantization error to add
in at the next step, so the noise telescopes instead of accumulating:

  1. scale = max(|g|) / 127
  2. q = round(g / scale) in int8; e = g - q * scale is kept
  3. the int32 sum of q over the pods, dequantized, over the pod count.

``quantize_roundtrip`` is steps 1-2 and the dequantize on one rank
(what the reference's unit and property tests run);
``compressed_psum`` / ``compressed_psum_tree`` are the all-reduce over
a process group (a mesh axis's, ``mesh.get_group("pod")``), in the
reference's exact sequence.  The reference's train step never calls
them (``TrainConfig.compress_pod_grads`` is unused there), so the
port's ``make_train_step`` refuses that flag.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import torch
import torch.distributed as dist


def quantize(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Round half to even, as ``jnp.round``; clipped to [-127, 127]."""
    return torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def quantize_roundtrip(x: torch.Tensor, err: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Local quantize / dequantize with error feedback (no collective).
    Returns (the dequantized values, the new error)."""
    x = x.to(torch.float32)
    if err is not None:
        x = x + err
    scale = torch.clamp(torch.max(torch.abs(x)), min=1e-12) / 127.0
    deq = dequantize(quantize(x, scale), scale)
    return deq, x - deq


def int8_psum(x: torch.Tensor, group=None
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Steps 1-3 over ``group``: the shared scale (an all-reduce MAX of
    max|x|, over 127, at least 1e-12), this rank's int8 codes and their
    int32 SUM.  Returns (codes, scale, total)."""
    amax = torch.max(torch.abs(x)).reshape(())
    dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
    scale = torch.clamp(amax / 127.0, min=1e-12)
    q = quantize(x, scale)
    total = q.to(torch.int32)
    dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
    return q, scale, total


def compressed_psum(x: torch.Tensor, group=None,
                    err: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """All-reduce-mean ``x`` over ``group`` in int8, the reference's
    sequence: ``err`` (the previous step's error) added, the codes and
    their int32 sum (:func:`int8_psum`), dequantized and divided by the
    group's size, and the local error x - dequantize(codes).  Returns
    (mean, err)."""
    x = x.to(torch.float32)
    if err is not None:
        x = x + err
    q, scale, total = int8_psum(x, group)
    mean = dequantize(total, scale) / dist.get_world_size(group)
    return mean, x - dequantize(q, scale)


def compressed_psum_tree(tree: Any, group=None,
                         err_tree: Optional[Any] = None
                         ) -> Tuple[Any, Any]:
    """:func:`compressed_psum` on every leaf of a dict / list tree (one
    scale per leaf); returns (means, errors) in the tree's structure."""
    from repro_torch.train.checkpoint import flatten, unflatten
    flat = flatten(tree)
    errs = flatten(err_tree) if err_tree is not None else {}
    outs, new_errs = {}, {}
    for k, leaf in flat.items():
        outs[k], new_errs[k] = compressed_psum(leaf, group, errs.get(k))
    return unflatten(outs, tree), unflatten(new_errs, tree)
