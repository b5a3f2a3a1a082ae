"""QuantTensor: the per-output-channel int8 weight container, and the
quant-aware matmul every linear use-site routes through; port of
``repro.quant.qtensor``.

Quantization is symmetric per OUTPUT channel: ``w ~= q * scale`` with
``scale = max|w| / 127`` over every other axis.  The output channel is
the last axis of a ``(K, N)`` weight, as in the reference; the port's
convolution weights are OIHW, so theirs is axis 0 (``axis=0``).
Activations are quantized dynamically per row at matmul time
(``sx = max|x| / 127``), so the lane needs no activation calibration.
Codes and scales are byte-equal to the reference's for the same float
weight: both compute ``round(w / scale)`` with round-half-to-even in
IEEE float32.

A 2-D QuantTensor keeps its codes K-contiguous: ``q`` is the (K, N)
transpose of a row-major (N, K) matrix, the layout the int8 GEMM
kernel's B operand reads.  ``q`` keeps the reference's (K, N) meaning,
so ``dequant()`` and the tests compare like with like.

Execution mode (``kernels.dispatch.resolve_quant``):

  "native"   int8 x int8 -> int32 GEMM + dequant epilogue
             (``dispatch.int8_matmul``: the CUDA kernel on the card, its
             plain version on the CPU).
  "dequant"  dequantize the weight and run the float GEMM, the oracle
             lane a caller asks for explicitly.

The row quantization (amax, divide, round, clamp, cast) stays plain
PyTorch, as the reference computes it in jnp outside its kernel.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Union

import torch

from repro_torch.kernels import dispatch


def _k_major(q: torch.Tensor) -> torch.Tensor:
    """A (K, N) tensor as the transpose of a row-major (N, K) one."""
    return q if q.t().is_contiguous() else q.t().contiguous().t()


def _bcast(scale: torch.Tensor, ndim: int, axis: int) -> torch.Tensor:
    """Per-channel scales shaped to broadcast along ``axis`` of an
    ``ndim``-D weight (stacked scales are broadcast-shaped already)."""
    ax = axis % ndim
    if scale.dim() > 1 or ax == ndim - 1:
        return scale
    shape = [1] * ndim
    shape[ax] = -1
    return scale.reshape(shape)


@dataclass
class QuantTensor:
    """int8 codes + per-output-channel float32 scales for one weight.

    ``q``: int8, the output channel at ``axis``; ``scale``: float32,
    (q.shape[axis],) (or broadcast-shaped for a stacked weight);
    ``out_dtype``: name of the dtype the dequantized weight and matmul
    outputs are produced in."""
    q: torch.Tensor
    scale: torch.Tensor
    out_dtype: str = "float32"
    axis: int = -1

    def __post_init__(self):
        if self.q.dim() == 2 and self.axis in (-1, 1):
            self.q = _k_major(self.q)

    @property
    def shape(self):
        return self.q.shape

    @property
    def nbytes(self) -> int:
        return (self.q.numel() * self.q.element_size()
                + self.scale.numel() * self.scale.element_size())

    def dequant(self, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """The float weight ``q * scale`` in ``dtype`` (default
        ``out_dtype``)."""
        w = self.q.float() * _bcast(self.scale, self.q.dim(),
                                    self.axis).float()
        return w.to(dtype if dtype is not None
                    else getattr(torch, self.out_dtype))

    def to(self, device) -> "QuantTensor":
        return QuantTensor(self.q.to(device), self.scale.to(device),
                           self.out_dtype, self.axis)


WeightLike = Union[torch.Tensor, QuantTensor]


def quantize_weight(w: torch.Tensor, out_dtype=torch.float32,
                    stacked: bool = False, axis: int = -1) -> QuantTensor:
    """Symmetric per-output-channel int8 quantization of a float weight
    (output channel = ``axis``, the last by default).  ``stacked``: the
    leading axis is a stacked layer axis, and the scales are per (layer,
    output channel), kept broadcast-shaped (L, 1, ..., N)."""
    w32 = w.float()
    ax = axis % w32.dim()
    red = tuple(i for i in range(1 if stacked else 0, w32.dim()) if i != ax)
    amax = w32.abs().amax(dim=red, keepdim=stacked) if red else w32.abs()
    scale = amax.clamp_min(1e-12) / 127.0
    q = torch.round(w32 / _bcast(scale, w32.dim(), ax)).clamp(-127, 127)
    return QuantTensor(q.to(torch.int8), scale, _dtype_name(out_dtype),
                       -1 if ax == w32.dim() - 1 else ax)


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def asarray(w: WeightLike, dtype: Optional[torch.dtype] = None
            ) -> torch.Tensor:
    """Dequantize a QuantTensor; pass plain tensors through."""
    if isinstance(w, QuantTensor):
        return w.dequant(dtype)
    return w if dtype is None else w.to(dtype)


def concat_out(ws: Sequence[WeightLike]) -> WeightLike:
    """Concatenate (K, N) weights along the OUTPUT axis (the fused-QKV
    helper).  Per-output-channel scales concatenate losslessly, so the
    fused quantized GEMM is column-for-column identical to separate
    ones."""
    if any(isinstance(w, QuantTensor) for w in ws):
        assert all(isinstance(w, QuantTensor) for w in ws), \
            "cannot fuse quantized and unquantized weights"
        return QuantTensor(torch.cat([w.q for w in ws], dim=1),
                           torch.cat([w.scale.reshape(-1) for w in ws]),
                           ws[0].out_dtype)
    return torch.cat(list(ws), dim=1)


def _quantize_rows(x2: torch.Tensor):
    """Dynamic symmetric per-row int8 activation quantization:
    (M, K) float32 -> (M, K) int8 codes and (M,) float32 scales."""
    sx = x2.abs().amax(dim=1).clamp_min(1e-12) / 127.0
    xq = torch.round(x2 / sx[:, None]).clamp(-127, 127).to(torch.int8)
    return xq, sx


def matmul(x: torch.Tensor, w: WeightLike, *,
           mode: Optional[str] = None) -> torch.Tensor:
    """``x @ w`` with quant-aware routing.

    Float weights take the plain ``x @ w``; the half-precision lane casts
    the activations to an fp16 / bf16 weight's type first, so a half tree
    carries half activations through the whole backbone.  QuantTensor
    weights run the int8 lane (mode "native") or the dequantized float
    GEMM (mode "dequant"), see ``kernels.dispatch.resolve_quant``."""
    if not isinstance(w, QuantTensor):
        if w.dtype != x.dtype and w.dtype in (torch.float16, torch.bfloat16):
            x = x.to(w.dtype)
        return torch.matmul(x, w)
    if dispatch.resolve_quant(mode) == "dequant":
        wd = w.dequant()
        return torch.matmul(x.to(wd.dtype), wd)
    lead = x.shape[:-1]
    xq, sx = _quantize_rows(x.reshape(-1, x.shape[-1]).float())
    y = dispatch.int8_matmul(xq, w.q, sx, w.scale.reshape(-1),
                             out_dtype=getattr(torch, w.out_dtype))
    return y.reshape(*lead, w.q.shape[-1])


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def tree_bytes(tree) -> int:
    """Total parameter bytes of a tree of dicts and lists (QuantTensor
    leaves count their int8 codes + scales)."""
    total = 0
    for leaf in _leaves(tree):
        if isinstance(leaf, QuantTensor):
            total += leaf.nbytes
        elif isinstance(leaf, torch.Tensor):
            total += leaf.numel() * leaf.element_size()
    return total


def map_tree(fn, tree):
    """``fn`` applied to every leaf (QuantTensors are leaves) of a tree of
    dicts and lists."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tree(fn, v) for v in tree)
    return fn(tree)


def to_device(tree, device):
    """A tree of dicts and lists of tensors and QuantTensors on
    ``device`` (leaves already there are kept, not copied)."""
    return map_tree(lambda x: x.to(device)
                    if isinstance(x, (torch.Tensor, QuantTensor)) else x,
                    tree)


def cast_tree(tree, dtype: torch.dtype):
    """Cast every float leaf to ``dtype``.  QuantTensor leaves keep their
    int8 codes and float32 scales but retarget their output dtype."""
    name = _dtype_name(dtype)

    def cast(x):
        if isinstance(x, QuantTensor):
            return QuantTensor(x.q, x.scale, name, x.axis)
        if isinstance(x, torch.Tensor) and x.is_floating_point():
            return x.to(dtype)
        return x

    return map_tree(cast, tree)
