"""Mamba-2 SSD chunked scan (every mamba layer's prefill, once per layer).

``ssd_scan_cuda`` launches ``csrc/ssd_scan.cu``, the port of
``repro/kernels/ssd_scan/kernel.py:ssd_scan_kernel``; ``ssd_scan_plain``
(``ref.py``, re-exported here) is the same function in plain PyTorch,
the port of ``repro.models.mamba2.ssd_chunked`` (the function the
reference's serving prefill computes).  Both take the ``ssd_ops.ssd``
arguments and return ``(y, final_state)``:

  x:  (b, T, H, P)  inputs (the dt scaling ``xbar = x * dt`` is inside)
  dt: (b, T, H)     post-softplus step sizes
  A:  (H,)          negative decay rates (``dA = dt * A`` is inside)
  Bm/Cm: (b, T, G, N), head h reads group h // (H / G)
  chunk: chunk length Q (taken as min(chunk, T))
  init_state: (b, H, N, P) or None (zeros)
  -> y (b, T, H, P) float32, final_state (b, H, N, P) float32

A ragged T is zero-padded to a chunk multiple in the plain version; the
padded rows have dt = 0, so they leave the state unchanged (the kernel
bounds its last chunk instead, which gives the same result).  The kernel
reads x, B and C through their batch and token strides, so column views
of the conv output need no copy.  One call runs four kernels on the
caller's stream (one counted launch); the wrapper allocates their
scratch, the C.B scores, chunk states and prefix sums
(:func:`scratch_floats`).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.build import (I, L, P, CudaKernel, check_cuda,
                                       head_rows, stream_of)
from repro_torch.kernels.ssd_scan.ref import ssd_scan_plain  # noqa: F401

KERNEL = CudaKernel("ssd_scan", "ssd_scan",
                    [P, P, P, P, P, P, P, P, P, L, I, I, I, I, I, I, I, L, L,
                     L, L, L, L, L, L, I, P], dtypes=(torch.float32,))
STATE_DIMS = (16, 32, 64, 128)       # N the kernel is built for
P_SLICE = 64                         # head-dim columns one block owns
TILE = 64                            # the kernels' row tile


def scratch_floats(b: int, T: int, H: int, G: int, N: int, P: int,
                   chunk: int) -> int:
    """Floats of scratch one call needs (``csrc/ssd_scan.cu``
    ``scratch_floats``): the C.B scores (b, nc, G, Qp, Qp), the chunk
    states (b, nc, H, N, P) and the prefix sums (b, H, nc, Qp), with nc
    chunks and Qp the chunk length rounded up to a multiple of TILE."""
    nc = -(-T // chunk)
    Qp = -(-chunk // TILE) * TILE
    return b * nc * (G * Qp * Qp + H * N * P + H * Qp)


def ssd_scan_cuda(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                  Bm: torch.Tensor, Cm: torch.Tensor, chunk: int,
                  init_state: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    b, T, H, Pd = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    ps = min(Pd, P_SLICE)
    if (G < 1 or H % G or tuple(dt.shape) != (b, T, H)
            or tuple(A.shape) != (H,) or tuple(Cm.shape) != tuple(Bm.shape)
            or Bm.shape[:2] != (b, T) or N not in STATE_DIMS
            or ps not in (16, 32, 64) or Pd % ps or T < 1 or chunk < 1
            or (init_state is not None
                and tuple(init_state.shape) != (b, H, N, Pd))):
        raise ValueError(
            f"ssd_scan: x {tuple(x.shape)}, dt {tuple(dt.shape)}, A "
            f"{tuple(A.shape)}, B {tuple(Bm.shape)}, C {tuple(Cm.shape)}; "
            f"N one of {STATE_DIMS}, P 16, 32 or a multiple of 64, G "
            f"dividing H")
    tensors = [x, dt, A, Bm, Cm] + ([init_state] if init_state is not None
                                    else [])
    check_cuda("ssd_scan", *tensors)
    if any(t.dtype != torch.float32 for t in tensors):
        raise ValueError("ssd_scan: float32 inputs only")
    chunk = min(chunk, T)
    x, Bm, Cm = head_rows(x), head_rows(Bm), head_rows(Cm)
    dt = dt if dt.stride(2) == 1 else dt.contiguous()
    A = A.contiguous()
    s0 = init_state.contiguous() if init_state is not None else 0
    dev = x.device
    y = torch.empty((b, T, H, Pd), dtype=torch.float32, device=dev)
    s_fin = torch.empty((b, H, N, Pd), dtype=torch.float32, device=dev)
    n_scratch = scratch_floats(b, T, H, G, N, Pd, chunk)
    scratch = torch.empty(n_scratch, dtype=torch.float32, device=dev)
    KERNEL(x, dt, A, Bm, Cm, s0, y, s_fin, scratch, n_scratch, b, T, H, G,
           N, Pd, chunk,
           x.stride(0), x.stride(1), dt.stride(0), dt.stride(1),
           Bm.stride(0), Bm.stride(1), Cm.stride(0), Cm.stride(1),
           dev.index, stream_of(x))
    return y, s_fin
