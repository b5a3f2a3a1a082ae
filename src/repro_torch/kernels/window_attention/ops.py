"""Non-overlapping window attention (ViTDet window blocks).

``window_attention_cuda`` launches ``csrc/window_attention.cu``, the port
of ``repro/kernels/window_attention/kernel.py:window_attention_kernel``;
``window_attention_plain`` (``ref.py``, re-exported here) is the same
function in plain PyTorch.

q: (B, T, H, Dh); k/v: (B, T, KV, Dh) with H = KV * G; ``window`` is the
number of TOKENS per window (w^2) and divides T.  ``win_valid``: optional
(B,) count of valid windows per sample; later (pad) windows output
zeros.  The kernel reads q, k and v through their batch and token
strides, so the three column slices of the fused QKV product go in
without a copy.  At float32 it computes both products on the TF32 tensor
cores in the 3xTF32 scheme (each operand split into two TF32 parts,
three products kept), which stays within ~1e-5 of float32 here.  q, k
and v share one type, float32, fp16 or bf16, and the result has it, as
the reference's.  At fp16 / bf16 the kernel keeps half rows and runs
the half tensor cores: Q K^T exact, the softmax in float32, P V as two
half products of P split into P_hi and P_lo, one rounding on store
(within one ULP of the plain version, >= 99% bit-equal).  Its 16-byte
loads need 16-byte-aligned bases and strides: the wrapper copies a view
that misses them and counts the copy (``KERNEL.copies``).  The plain
version computes in float32 and casts back.

``WindowAttention`` is the differentiable entry (``kernels.dispatch``
routes through it on both devices): its forward is the kernel on the
card and the plain version on the CPU, its backward the reference's
analytic per-window gradient (``window_attention_bwd``), plain PyTorch
as the reference's is plain jnp outside its Pallas call
(``repro/kernels/window_attention/ops.py:_vjp_bwd``).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import autotune
from repro_torch.kernels.build import (HALF_TYPES, F, I, L, P, CudaKernel,
                                       aligned_rows, check_cuda, head_rows,
                                       stream_of)
from repro_torch.kernels.window_attention.ref import (  # noqa: F401
    window_attention_plain)

KERNEL = CudaKernel("window_attention", "window_attention",
                    [P, P, P, P, P, I, I, I, I, I, I, L, L, L, L, L, L, F,
                     I, I, P])
MAX_WINDOW = MAX_HEAD_DIM = 128   # the kernel's register tiles
MULTI_MAX = 64                    # wb > 1: windows and heads of at most 64
DEFAULT_TILE = {"wb": 1}          # one (window, head) a block


def tile_grid(B: int, T: int, H: int, Dh: int, window: int) -> tuple:
    """The tiles the kernel takes for this shape, the default first:
    ``wb`` windows of one head a block, 1, 2 or 4; above 1 only where
    window and head width are at most ``MULTI_MAX`` and the call has at
    least ``wb`` windows (the reference's rule)."""
    grid = [DEFAULT_TILE]
    if window <= MULTI_MAX and Dh <= MULTI_MAX:
        grid += [{"wb": wb} for wb in (2, 4) if wb <= B * (T // window)]
    return tuple(grid)


def _default(B, T, H, Dh, window, dtype) -> dict:
    return DEFAULT_TILE


def _valid(tile, B, T, H, Dh, window, dtype) -> bool:
    return tile in tile_grid(B, T, H, Dh, window)


def tile_for(B: int, T: int, H: int, Dh: int, window: int,
             dtype: torch.dtype) -> dict:
    """The resolved tile of a call: the tuned winner of its bucket where
    one is cached and valid here, else one window a block."""
    return autotune.resolve(
        ("window_attention", B, T, H, Dh, window, dtype),
        autotune.window_bucket, _default, _valid)


def window_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          window: int, win_valid: Optional[torch.Tensor] = None,
                          scale: Optional[float] = None, *,
                          wb: Optional[int] = None) -> torch.Tensor:
    """``wb``: windows of one head a block; None resolves it
    (:func:`tile_for`)."""
    B, T, H, Dh = q.shape
    KV = k.shape[2]
    if T % window or H % KV or k.shape != v.shape or k.shape[:2] != (B, T):
        raise ValueError(f"window_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}, window "
                         f"{window}")
    if window > MAX_WINDOW or Dh % 8 or Dh > MAX_HEAD_DIM:
        raise ValueError(f"window_attention: the kernel takes windows of at "
                         f"most {MAX_WINDOW} tokens and head widths that are "
                         f"multiples of 8 up to {MAX_HEAD_DIM}, got window "
                         f"{window}, head {Dh}")
    q, k, v = head_rows(q), head_rows(k), head_rows(v)
    tensors = [q, k, v]
    valid_arg = None
    if win_valid is not None:
        wv = win_valid.to(torch.int32).reshape(-1).expand(B).contiguous()
        tensors.append(wv)
        valid_arg = wv
    check_cuda("window_attention", *tensors)
    dt = KERNEL.check_dtype("window_attention", q, k, v)
    if wb is None:
        wb = tile_for(B, T, H, Dh, window, dt)["wb"]
    elif {"wb": wb} not in tile_grid(B, T, H, Dh, window):
        raise ValueError(f"window_attention: wb {wb} at window {window}, "
                         f"head {Dh}, {B * (T // window)} windows; the kernel "
                         f"takes {tile_grid(B, T, H, Dh, window)}")
    if dt in HALF_TYPES:
        q, k, v = (aligned_rows(KERNEL, t) for t in (q, k, v))
    scale = Dh ** -0.5 if scale is None else scale
    out = torch.empty((B, T, H, Dh), dtype=q.dtype, device=q.device)
    KERNEL(q, k, v, valid_arg, out,
           B, T // window, window, H, KV, Dh, q.stride(0), q.stride(1),
           k.stride(0), k.stride(1), v.stride(0), v.stride(1), float(scale),
           wb, q.device.index, stream_of(q), dtype=dt)
    return out


def window_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         g: torch.Tensor, window: int,
                         win_valid: Optional[torch.Tensor] = None):
    """Analytic per-window softmax-attention backward: recomputes the
    scores of each window in float32 and returns (dq, dk, dv).

    dv = p^T g;  dp = g v^T;  ds = p * (dp - sum_s(dp * p));
    dq = ds k * scale;  dk = ds^T q * scale.  Pad windows (beyond
    ``win_valid``) output constant zeros, so their cotangent is masked
    off first; query head h reads kv head h // G, so dk and dv sum over
    the G heads of a group."""
    B, T, H, Dh = q.shape
    KV = k.shape[2]
    G = H // KV
    W = T // window
    scale = Dh ** -0.5
    qw = q.reshape(B, W, window, KV, G, Dh).float()
    kw = k.reshape(B, W, window, KV, Dh).float()
    vw = v.reshape(B, W, window, KV, Dh).float()
    gw = g.reshape(B, W, window, KV, G, Dh).float()
    if win_valid is not None:
        keep = (torch.arange(W, device=q.device)[None, :]
                < win_valid.reshape(-1, 1).to(q.device))
        gw = gw * keep[:, :, None, None, None, None].float()
    p = torch.softmax(torch.einsum("bwtkgd,bwskd->bwkgts", qw, kw) * scale,
                      dim=-1)
    dv = torch.einsum("bwkgts,bwtkgd->bwskd", p, gw)
    ds = torch.einsum("bwtkgd,bwskd->bwkgts", gw, vw)
    ds = p * (ds - torch.sum(ds * p, dim=-1, keepdim=True))
    dq = torch.einsum("bwkgts,bwskd->bwtkgd", ds, kw) * scale
    dk = torch.einsum("bwkgts,bwtkgd->bwskd", ds, qw) * scale
    return (dq.reshape(B, T, H, Dh).to(q.dtype),
            dk.reshape(B, T, KV, Dh).to(k.dtype),
            dv.reshape(B, T, KV, Dh).to(v.dtype))


class WindowAttention(torch.autograd.Function):
    """Window attention with the reference's analytic backward.  A CUDA
    input launches the kernel, a CPU input takes the plain version;
    ``win_valid`` gets no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, window: int, win_valid=None):
        fwd = window_attention_cuda if q.is_cuda else window_attention_plain
        ctx.window = window
        ctx.save_for_backward(q, k, v, win_valid)
        return fwd(q, k, v, window, win_valid)

    @staticmethod
    def backward(ctx, g):
        q, k, v, win_valid = ctx.saved_tensors
        with torch.profiler.record_function("window_attention_bwd"):
            dq, dk, dv = window_attention_bwd(q, k, v, g, ctx.window,
                                              win_valid)
        return dq, dk, dv, None, None
