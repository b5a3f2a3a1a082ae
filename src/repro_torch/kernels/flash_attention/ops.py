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

from repro_torch.kernels import autotune
from repro_torch.kernels.build import (HALF_TYPES, F, I, L, P, CudaKernel,
                                       aligned_rows, check_cuda, head_rows,
                                       stream_of)
from repro_torch.kernels.flash_attention.ref import (  # noqa: F401
    NEG_INF, Q_CHUNK, flash_attention_plain)

KERNEL = CudaKernel("flash_attention", "flash_attention",
                    [P, P, P, P, I, I, I, I, I, I, L, L, L, L, L, L, F, I, I,
                     I, I, I, P])
HEAD_DIMS = (16, 32, 64, 128)

# The tiles csrc/flash_attention.cu is built for, by precision and head
# width, the default first.  Float32: 16-row m-tiles a warp (64 mt query
# rows a block); Dh 16 / 32 keep their one tile, and Dh = 128's mt = 2
# spilled (ptxas) and is left out.  Half: keys a tile and stages of the
# TMA ring; at Dh = 128 a 128-key tile's scores and O do not fit the
# registers, so 64 only.  The autotuner sweeps these grids.
F32_TILES = {16: ({"mt": 2},), 32: ({"mt": 2},),
             64: ({"mt": 2}, {"mt": 1}), 128: ({"mt": 1},)}
_HALF_64 = ({"bn": 128, "stages": 3}, {"bn": 128, "stages": 2},
            {"bn": 64, "stages": 3}, {"bn": 64, "stages": 2})
HALF_TILES = {16: _HALF_64, 32: _HALF_64, 64: _HALF_64,
              128: ({"bn": 64, "stages": 3}, {"bn": 64, "stages": 2})}


def m_tiles(Dh: int) -> int:
    """The float32 kernel's default m-tiles a warp (``m_tiles`` in the
    source): two where the registers allow, one at Dh = 128."""
    return 2 if Dh <= 64 else 1


def precision(dtype: torch.dtype) -> str:
    """The autotuner's grid of a type: ``half`` or ``float32``."""
    return "half" if dtype in HALF_TYPES else "float32"


def tile_grid(Dh: int, dtype: torch.dtype) -> tuple:
    """The tiles the kernel takes at head width ``Dh`` and type ``dtype``,
    the default first."""
    return (HALF_TILES if dtype in HALF_TYPES else F32_TILES).get(Dh, ())


def default_tile(Dh: int, dtype: torch.dtype) -> dict:
    """The tile the kernel launches with no tuned winner: ``m_tiles(Dh)``
    at float32; 128 keys (64 at Dh = 128) and three stages at half."""
    if dtype in HALF_TYPES:
        return {"bn": 128 if Dh <= 64 else 64, "stages": 3}
    return {"mt": m_tiles(Dh)}


def _default(B, T, S, H, KV, Dh, causal, dtype) -> dict:
    return default_tile(Dh, dtype)


def _valid(tile, B, T, S, H, KV, Dh, causal, dtype) -> bool:
    return tile in tile_grid(Dh, dtype)


def tile_for(B: int, T: int, S: int, H: int, KV: int, Dh: int, causal: bool,
             dtype: torch.dtype) -> dict:
    """The resolved tile of a call: the tuned winner of its bucket where
    one is cached, else the default (``autotune.resolve``, memoised)."""
    return autotune.resolve(
        ("flash_attention", B, T, S, H, KV, Dh, causal, dtype),
        autotune.flash_bucket, _default, _valid)


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = False,
                         scale: Optional[float] = None, *,
                         mt: Optional[int] = None, bn: Optional[int] = None,
                         stages: Optional[int] = None) -> torch.Tensor:
    """``mt`` (float32) or ``bn`` / ``stages`` (fp16 / bf16) pick the
    tile; None resolves it (:func:`tile_for`)."""
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
    given = {n: x for n, x in (("mt", mt), ("bn", bn), ("stages", stages))
             if x is not None}
    if given:
        tile = {**default_tile(Dh, dt), **given}
        if tile not in tile_grid(Dh, dt):
            raise ValueError(f"flash_attention: tile {given} at Dh {Dh}, "
                             f"{dt}; the kernel takes {tile_grid(Dh, dt)}")
    else:
        tile = tile_for(B, T, S, H, KV, Dh, bool(causal), dt)
    if dt in HALF_TYPES:
        q, k, v = (aligned_rows(KERNEL, t) for t in (q, k, v))
    scale = Dh ** -0.5 if scale is None else scale
    out = torch.empty((B, T, H, Dh), dtype=q.dtype, device=q.device)
    KERNEL(q, k, v, out, B, T, S,
           H, KV, Dh, q.stride(0), q.stride(1), k.stride(0), k.stride(1),
           v.stride(0), v.stride(1), float(scale), int(bool(causal)),
           tile.get("mt", 0), tile.get("bn", 0), tile.get("stages", 0),
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
