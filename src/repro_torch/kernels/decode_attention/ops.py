"""One-token GQA decode attention against a KV cache (the LM serving
engine's decode step, once per layer).

``decode_attention_cuda`` launches ``csrc/decode_attention.cu``, the
port of ``repro/kernels/decode_attention/kernel.py:decode_attention_kernel``;
``decode_attention_plain`` (``ref.py``, re-exported here) is the same
function in plain PyTorch: a dense masked float32 softmax (the
reference's ``ref.py``), with zeros for a row whose ``kv_len`` is 0, as
the Pallas kernel gives.

q: (B, 1, H, Dh); k/v: (B, S, KV, Dh) with H = KV * G; kv_len: (B,)
int32 valid cache lengths.  Returns (B, 1, H, Dh).  The kernel reads the
cache through its batch and token strides, in place.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.kernels.build import (F, I, L, P, CudaKernel, check_cuda,
                                       head_rows, stream_of)
from repro_torch.kernels.decode_attention.ref import (  # noqa: F401
    NEG_INF, decode_attention_plain)

KERNEL = CudaKernel("decode_attention", "decode_attention_f32",
                    [P, P, P, P, P, P, P, P, I, I, I, I, I, I, L, L, L, L, L,
                     F, I, P])
HEAD_DIMS = (16, 32, 64, 128)
# split the keys of a (batch row, kv head) over several blocks only when
# each split keeps at least this many keys; aim at this many blocks per SM
MIN_KEYS_PER_SPLIT = 256
BLOCKS_PER_SM = 4
MAX_GROUP = 8               # query heads one block serves (kMaxG)

_SMS: Dict[int, int] = {}


def n_splits(B: int, KV: int, G: int, S: int, sms: int) -> int:
    """How many blocks share the keys of one (batch row, kv head, group
    of up to MAX_GROUP query heads): enough to put BLOCKS_PER_SM blocks on
    every SM, but no split shorter than MIN_KEYS_PER_SPLIT keys."""
    pairs = B * KV * -(-G // MAX_GROUP)
    want = -(-BLOCKS_PER_SM * sms // max(pairs, 1))
    return max(1, min(want, -(-S // MIN_KEYS_PER_SPLIT)))


def _aligned(t: torch.Tensor, *strides: int) -> bool:
    return t.data_ptr() % 16 == 0 and all(s % 4 == 0 for s in strides)


def decode_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          kv_len: torch.Tensor,
                          scale: Optional[float] = None) -> torch.Tensor:
    B, T, H, Dh = q.shape
    S, KV = k.shape[1], k.shape[2]
    if (T != 1 or KV < 1 or H % KV or k.shape != v.shape or k.shape[0] != B
            or k.shape[3] != Dh or Dh not in HEAD_DIMS
            or tuple(kv_len.shape) != (B,)):
        raise ValueError(f"decode_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}, kv_len "
                         f"{tuple(kv_len.shape)}; one query token, head dim "
                         f"one of {HEAD_DIMS}")
    check_cuda("decode_attention", q, k, v, kv_len)
    if q.dtype != torch.float32 or k.dtype != torch.float32 \
            or v.dtype != torch.float32 or kv_len.dtype != torch.int32:
        raise ValueError("decode_attention: float32 q/k/v and int32 kv_len "
                         "only")
    q, kv_len = head_rows(q), kv_len.contiguous()
    if not _aligned(q, q.stride(0)):
        q = q.contiguous()
    if (k.stride(3) != 1 or k.stride(2) != Dh or v.stride(3) != 1
            or v.stride(2) != Dh or not _aligned(k, k.stride(0), k.stride(1))
            or not _aligned(v, v.stride(0), v.stride(1))):
        raise ValueError("decode_attention: the cache must have dense heads "
                         "and 16-byte aligned rows (it is read in place)")
    dev = q.device
    sms = _SMS.get(dev.index)
    if sms is None:
        sms = _SMS[dev.index] = torch.cuda.get_device_properties(
            dev).multi_processor_count
    n = n_splits(B, KV, H // KV, S, sms)
    out = torch.empty((B, 1, H, Dh), dtype=q.dtype, device=dev)
    if n > 1:
        rows = B * H * n          # partial (max, sum, output) per split
        part = torch.empty(rows * (Dh + 2), dtype=torch.float32, device=dev)
        parts = (part[rows * Dh:rows * (Dh + 1)], part[rows * (Dh + 1):],
                 part[:rows * Dh])
    else:
        parts = (0, 0, 0)
    scale = Dh ** -0.5 if scale is None else scale
    KERNEL(q, k, v, kv_len, out, *parts, B, S, H, KV, Dh, n, q.stride(0),
           k.stride(0), k.stride(1), v.stride(0), v.stride(1), float(scale),
           dev.index, stream_of(q))
    return out
