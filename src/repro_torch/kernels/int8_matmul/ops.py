"""int8 x int8 -> int32 GEMM with a per-row x per-column dequant
epilogue, the quantized lane's matmul:

    out[m, n] = float(sum_k xq[m, k] * wq[k, n]) * sx[m] * sw[n]

``int8_matmul_cuda`` launches ``csrc/int8_matmul.cu``, the port of
``repro/kernels/int8_matmul/kernel.py:int8_matmul_kernel``;
``int8_matmul_plain`` (``ref.py``, re-exported here) is the same function
in plain PyTorch.  Both are exact: the integer sum has no rounding, and
the epilogue is the same three float32 operations in the same order as
the reference (``repro/kernels/int8_matmul/ref.py``), so kernel, plain
version and reference agree bit for bit.  ``out_dtype`` float32, fp16
or bf16 rounds that float32 value once (the ``int8+fp16`` lane).

The kernel reads the weight codes K-contiguous, as the (N, K) matrix
whose transpose is ``wq``; ``quant.qtensor.QuantTensor`` keeps its 2-D
codes in that layout (``wq.stride() == (1, K)``).  Its TMA loads need a
K that is a multiple of 16: the wrapper zero-pads a K that is not
(``pad_k``, exact for integer sums), which no model shape needs.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import autotune
from repro_torch.kernels.build import I, P, CudaKernel, check_cuda, stream_of
from repro_torch.kernels.int8_matmul.ref import int8_matmul_plain  # noqa: F401

KERNEL = CudaKernel("int8_matmul", "int8_matmul",
                    [P, P, P, P, P, I, I, I, I, I, P])
K_ALIGN = 16                 # TMA: 16-byte row pitch
BALANCE = 590                # H100 int8 ops per byte: 1,979 TOPS / 3.35 TB/s


def tile_n(N: int, K: int) -> int:
    """The kernel's output tile width for an (M, K) x (K, N) product at
    M >> N, K.  256 where the tensor cores bound it (more int8 operations
    per byte of operands and float32 output than the card's balance): a
    128 x 256 tile halves the shared-memory reads per operation.  Else
    128, where the output's bytes bound it: two 128 x 128 blocks share an
    SM, and one's epilogue overlaps the other's main loop."""
    return 256 if 2 * N * K >= BALANCE * (4 * N + K) else 128


# the tile widths csrc/int8_matmul.cu is built for (Tile<BN>); tile_n()
# picks the default, and the autotuner may find the other faster at a
# shape bucket
TILE_GRID = ({"bn": 128}, {"bn": 256})


def _bucket(M, N, K) -> str:
    return autotune.matmul_bucket(M, N, K, torch.int8, torch.int8)


def _default(M, N, K) -> dict:
    return {"bn": tile_n(N, K)}


def _valid(tile, M, N, K) -> bool:
    return tile in TILE_GRID


def tile_for(M: int, N: int, K: int) -> dict:
    """The resolved tile width of an (M, K) x (K, N) product: the tuned
    winner of its bucket where one is cached, else :func:`tile_n`'s.  The
    bucket is the reference's (int8, int8) key, whatever the output type:
    the int8+fp16 and int8+fp32 lanes share winners."""
    return autotune.resolve(("int8_matmul", M, N, K), _bucket, _default,
                            _valid)


def pad_k(xq: torch.Tensor, wq: torch.Tensor
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Zero-pad the shared K of xq (M, K) and wq (K, N) up to a positive
    multiple of ``K_ALIGN``; returns them unchanged where it is one.  The
    padded wq is again the transpose of a row-major (N, K') matrix.  The
    added products are 0 * 0, so the GEMM's result does not change."""
    K = xq.shape[1]
    Kp = max(K_ALIGN, -(-K // K_ALIGN) * K_ALIGN)
    if Kp == K:
        return xq, wq
    xp = xq.new_zeros((xq.shape[0], Kp))
    xp[:, :K] = xq
    wp = wq.new_zeros((wq.shape[1], Kp))
    wp[:, :K] = wq.t()
    return xp, wp.t()


def int8_matmul_cuda(xq: torch.Tensor, wq: torch.Tensor, sx: torch.Tensor,
                     sw: torch.Tensor,
                     out_dtype: torch.dtype = torch.float32, *,
                     bn: Optional[int] = None) -> torch.Tensor:
    """``bn``: the output tile's width, 128 or 256; None resolves it
    (:func:`tile_for`)."""
    check_cuda("int8_matmul", xq, wq, sx, sw)
    if xq.dtype != torch.int8 or wq.dtype != torch.int8:
        raise ValueError(f"int8_matmul: int8 operands, got {xq.dtype} and "
                         f"{wq.dtype}")
    if sx.dtype != torch.float32 or sw.dtype != torch.float32:
        raise ValueError("int8_matmul: float32 scales only")
    if out_dtype not in KERNEL.dtypes:
        raise ValueError(f"int8_matmul: out_dtype {out_dtype}, not one of "
                         f"{KERNEL.dtypes}")
    if xq.dim() != 2 or wq.dim() != 2 or xq.shape[1] != wq.shape[0]:
        raise ValueError(f"int8_matmul: xq {tuple(xq.shape)} and wq "
                         f"{tuple(wq.shape)} do not multiply")
    M, K = xq.shape
    N = wq.shape[1]
    if sx.shape != (M,) or sw.shape != (N,):
        raise ValueError(f"int8_matmul: scales {tuple(sx.shape)} / "
                         f"{tuple(sw.shape)} for a ({M}, {N}) output")
    if not xq.is_contiguous() or not wq.t().is_contiguous():
        raise ValueError("int8_matmul: xq must be row-major and wq the "
                         "transpose of a row-major (N, K) matrix")
    if bn is None:
        bn = tile_for(M, N, K)["bn"]
    elif {"bn": bn} not in TILE_GRID:
        raise ValueError(f"int8_matmul: tile width {bn}, not one of "
                         f"{TILE_GRID}")
    xq, wq = pad_k(xq, wq)
    if xq.data_ptr() % 16 or wq.data_ptr() % 16:
        raise ValueError("int8_matmul: xq and wq must start 16-byte aligned "
                         "(TMA)")
    sx, sw = sx.contiguous(), sw.contiguous()
    out = torch.empty((M, N), dtype=out_dtype, device=xq.device)
    if M and N:
        K = xq.shape[1]
        KERNEL(xq, wq, sx, sw, out, M, N, K, bn, xq.device.index,
               stream_of(xq), dtype=out_dtype)
    return out
