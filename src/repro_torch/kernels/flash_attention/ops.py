"""Flash attention (ViTDet global blocks after the restoration point).

``flash_attention_cuda`` launches ``csrc/flash_attention.cu``, the port
of ``repro/kernels/flash_attention/kernel.py:flash_attention_kernel``;
``flash_attention_plain`` (``ref.py``, re-exported here) is the same
function in plain PyTorch: dense float32 softmax attention, taken
``Q_CHUNK`` query rows at a time so the score buffer stays bounded.

q: (B, T, H, Dh); k/v: (B, S, KV, Dh) with H = KV * G.  ``causal``: query
t sees keys s <= t.  A row that no key reaches outputs zeros.  The
kernel reads q, k and v through their batch and token strides.  q, k
and v share one type, float32, fp16 or bf16, and the result has it, as
the reference's.  At float32 the kernel runs 3xTF32 products; at fp16 /
bf16 it runs TMA loads and ``wgmma`` on the half tensor cores (Q K^T
exact, the online softmax in float32, P V as two half products of P
split into P_hi and P_lo, one rounding on store), whose maps need
16-byte-aligned bases and strides: the wrapper copies a view that misses
them and counts the copy (``KERNEL.copies``).  The plain version
computes in float32 and casts back.

``FlashAttention`` is the differentiable entry (``kernels.dispatch``
routes through it on both devices): its forward is the kernel on the
card and the plain version on the CPU, its backward the reference's
dense analytic gradient (``flash_attention_bwd``), plain PyTorch as the
reference's is plain jnp outside its Pallas call
(``repro/kernels/flash_attention/ops.py:_vjp_bwd``).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.build import (HALF_TYPES, F, I, L, P, CudaKernel,
                                       aligned_rows, check_cuda, head_rows,
                                       stream_of)
from repro_torch.kernels.flash_attention.ref import (  # noqa: F401
    NEG_INF, Q_CHUNK, flash_attention_plain)

KERNEL = CudaKernel("flash_attention", "flash_attention",
                    [P, P, P, P, I, I, I, I, I, I, L, L, L, L, L, L, F, I, I,
                     P])
HEAD_DIMS = (16, 32, 64, 128)


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = False,
                         scale: Optional[float] = None) -> torch.Tensor:
    B, T, H, Dh = q.shape
    S, KV = k.shape[1], k.shape[2]
    if (H % KV or k.shape != v.shape or k.shape[0] != B or k.shape[3] != Dh
            or Dh not in HEAD_DIMS):
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}; head dim "
                         f"must be one of {HEAD_DIMS}")
    q, k, v = head_rows(q), head_rows(k), head_rows(v)
    check_cuda("flash_attention", q, k, v)
    dt = KERNEL.check_dtype("flash_attention", q, k, v)
    if dt in HALF_TYPES:
        q, k, v = (aligned_rows(KERNEL, t) for t in (q, k, v))
    scale = Dh ** -0.5 if scale is None else scale
    out = torch.empty((B, T, H, Dh), dtype=q.dtype, device=q.device)
    KERNEL(q, k, v, out, B, T, S,
           H, KV, Dh, q.stride(0), q.stride(1), k.stride(0), k.stride(1),
           v.stride(0), v.stride(1), float(scale), int(bool(causal)),
           q.device.index, stream_of(q), dtype=dt)
    return out


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        g: torch.Tensor, causal: bool = False):
    """Dense analytic softmax-attention backward in float32: recomputes
    p (causal keys masked at the reference's finite ``NEG_INF``) and
    returns (dq, dk, dv); kv head h // G serves query head h.  Softmax
    is per query row, so the rows go ``Q_CHUNK`` at a time and dk / dv
    sum over the chunks: each chunk's s, p, dp and ds are (B, KV, G,
    Q_CHUNK, S) and are freed as soon as they are used."""
    B, T, H, Dh = q.shape
    S, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = Dh ** -0.5
    kf, vf = k.float(), v.float()
    dk = torch.zeros((B, S, KV, Dh), dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    dqs = []
    for t0 in range(0, T, Q_CHUNK):
        qc = q[:, t0:t0 + Q_CHUNK]
        Tc = qc.shape[1]
        qg = qc.reshape(B, Tc, KV, G, Dh).float()
        gg = g[:, t0:t0 + Q_CHUNK].reshape(B, Tc, KV, G, Dh).float()
        p = torch.einsum("btkgd,bskd->bkgts", qg, kf) * scale
        if causal:
            seen = (torch.arange(Tc, device=q.device)[:, None] + t0
                    >= torch.arange(S, device=q.device)[None, :])
            p = p.masked_fill_(~seen, NEG_INF)
        p = torch.softmax(p, dim=-1)
        dv += torch.einsum("bkgts,btkgd->bskd", p, gg)
        ds = torch.einsum("btkgd,bskd->bkgts", gg, vf)
        ds = ds.sub_(torch.sum(ds * p, dim=-1, keepdim=True)).mul_(p)
        del p
        dqs.append(torch.einsum("bkgts,bskd->btkgd", ds, kf)
                   .reshape(B, Tc, H, Dh) * scale)
        dk += torch.einsum("bkgts,btkgd->bskd", ds, qg)
        del ds
    dq = torch.cat(dqs, dim=1)
    return dq.to(q.dtype), (dk * scale).to(k.dtype), dv.to(v.dtype)


class FlashAttention(torch.autograd.Function):
    """Flash attention with the reference's dense analytic backward.  A
    CUDA input launches the kernel, a CPU input takes the plain
    version."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool = False):
        fwd = flash_attention_cuda if q.is_cuda else flash_attention_plain
        ctx.causal = causal
        ctx.save_for_backward(q, k, v)
        return fwd(q, k, v, causal)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        with torch.profiler.record_function("flash_attention_bwd"):
            dq, dk, dv = flash_attention_bwd(q, k, v, g, ctx.causal)
        return dq, dk, dv, None
