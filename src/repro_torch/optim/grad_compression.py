"""int8 gradient compression with error feedback; port of the local half
of ``repro.optim.grad_compression``.

The reference quantizes gradients to int8 with a shared scale for the
all-reduce across pods and keeps each shard's quantization error to add
in at the next step, so the noise telescopes instead of accumulating:

  1. scale = max(|g|) / 127
  2. q = round(g / scale) in int8; e = g - q * scale is kept
  3. the int32 sum of q over the pods, dequantized, over the pod count.

Here are steps 1-2 and the dequantize (``quantize_roundtrip``, what the
reference's unit and property tests run).  ``compressed_psum`` and
``compressed_psum_tree`` reduce over a named mesh axis; they wait for the
port's mesh code (``ROADMAP.md``, Queue 1, the mesh item).  The
reference's train step never calls them (``TrainConfig.compress_pod_grads``
is unused there too).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


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
