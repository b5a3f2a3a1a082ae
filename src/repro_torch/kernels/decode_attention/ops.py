"""One-token GQA decode attention against a KV cache (the LM serving
engine's decode step, once per layer).

``decode_attention_cuda`` launches ``csrc/decode_attention.cu``, the
port of ``repro/kernels/decode_attention/kernel.py:decode_attention_kernel``;
``decode_attention_plain`` (``ref.py``, re-exported here) is the same
function in plain PyTorch: a dense masked float32 softmax (the
reference's ``ref.py``), with zeros for a row whose ``kv_len`` is 0, as
the Pallas kernel gives.

q: (B, 1, H, Dh); k/v: (B, S, KV, Dh) with H = KV * G; kv_len: (B,)
int32 valid cache lengths.  Returns (B, 1, H, Dh) in q's type.  The
kernel reads the cache through its batch and token strides, in place.
q and the cache may each be float32, fp16 or bf16, and their types may
differ (an fp16 model over a float32 cache, a float32 model over a bf16
cache): the kernel has one entry point per cache type, takes q's type
as an argument and computes in float32, as the reference casts q, k and
v on load.  A launch counts under the cache's type where that is half,
else under q's.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import autotune
from repro_torch.kernels.build import (FLOAT_TYPES, F, I, L, P, CudaKernel,
                                       check_cuda, head_rows, stream_of)
from repro_torch.kernels.decode_attention.ref import (  # noqa: F401
    NEG_INF, decode_attention_plain)

# one entry point per cache type; q's type is an argument (Q_TYPE)
KERNEL = CudaKernel("decode_attention", "decode_attention",
                    [P, P, P, P, P, I, I, I, I, I, I, I, I, L, L, L, L, L, F,
                     I, P])
Q_TYPE = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
HEAD_DIMS = (16, 32, 64, 128)
MAX_GROUP = 8               # query heads of one kv head a block serves
KV_PER_BLOCK = 4            # kv heads a block serves where G = 1
MAX_CLUSTER = 8             # splits of one group: a portable cluster
BLOCKS_PER_SM = 2           # a short cache: at least this many blocks an SM
MIN_KEYS_PER_SPLIT = 32     # no split shorter (rounding aside)
MAX_KEYS_PER_SPLIT = 1024   # a long cache: no split longer, within 8
KEY_ALIGN = 8               # splits hold a multiple of this many keys
SHORT_SPLIT = 64            # a split of at most this many keys: one copy

_SMS: Dict[int, int] = {}


def plan(B: int, KV: int, G: int, S: int, sms: int) -> Tuple[int, int]:
    """(n_split, keys_per_split): the size of the thread-block cluster
    that shares the keys of one (batch row, kv head, group of up to
    MAX_GROUP query heads) -- or of KV_PER_BLOCK adjacent kv heads where
    each has one query head -- and the most keys one of its blocks takes.
    This is the default; the autotuner may find another cluster size
    faster at a shape bucket (:func:`tile_grid`, :func:`split_for`), and
    the wrapper then launches that one.

    A short cache, whose splits then hold at most SHORT_SPLIT keys, is cut
    until every SM has BLOCKS_PER_SM blocks: the step is one wave of
    blocks that each copy their keys at once.  A long cache streams
    through each block's ring of copies,
    and there one block an SM keeps the memory busiest: as many splits as
    fill the SMs once, or as keep every split within MAX_KEYS_PER_SPLIT
    (rows of different kv_len balance better in short splits), whichever
    is more.  Always at most MAX_CLUSTER splits, none under
    MIN_KEYS_PER_SPLIT slots.  The runs [i * keys_per_split, (i + 1) *
    keys_per_split) clipped to S cover the cache; on the device the kernel
    cuts each row's kv_len valid keys into n_split even runs (multiples of
    8, none longer than keys_per_split, so the ring sized by it holds
    them).  The plan depends on the shapes alone and never reads kv_len:
    a CUDA graph can replay the launch."""
    if G == 1 and KV % KV_PER_BLOCK == 0:   # csrc: launch_g's HB = 4
        pairs = B * KV // KV_PER_BLOCK
    else:
        pairs = B * KV * -(-G // MAX_GROUP)
    pairs = max(pairs, 1)
    n = -(-BLOCKS_PER_SM * sms // pairs)
    if -(-S // n) > SHORT_SPLIT:
        n = max(sms // pairs, -(-S // MAX_KEYS_PER_SPLIT))
    n = max(1, min(MAX_CLUSTER, n, -(-S // MIN_KEYS_PER_SPLIT)))
    keys = max(1, -(-S // n))
    keys = -(-keys // KEY_ALIGN) * KEY_ALIGN
    return max(1, -(-S // keys)), keys


def sm_count(device) -> int:
    """The card's SMs, read once a device."""
    dev = torch.device(device)
    idx = torch.cuda.current_device() if dev.index is None else dev.index
    sms = _SMS.get(idx)
    if sms is None:
        sms = _SMS[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    return sms


def split_keys(n: int, S: int) -> int:
    """The keys a split of ``n`` takes over a cache of S slots, as
    :func:`plan` derives them: S / n rounded up to ``KEY_ALIGN``."""
    keys = max(1, -(-S // n))
    return -(-keys // KEY_ALIGN) * KEY_ALIGN


def default_tile(B: int, KV: int, G: int, S: int, sms: int) -> dict:
    """The cluster size :func:`plan` picks."""
    return {"n_split": plan(B, KV, G, S, sms)[0]}


def tile_grid(B: int, KV: int, G: int, S: int, sms: int) -> tuple:
    """The cluster sizes the kernel takes at this shape, the default
    first: :func:`plan`'s and each of 1, 2, 4, 8 whose even split
    (``split_keys``) leaves no block of the cluster without a key slot
    and, split at all, holds at least ``MIN_KEYS_PER_SPLIT`` slots.  The
    kernel's ring streams a split of any length in tiles, so no split
    overflows it.  Like the plan, the grid never reads kv_len."""
    grid = [default_tile(B, KV, G, S, sms)]
    for n in (1, 2, 4, 8):
        keys = split_keys(n, S)
        if ({"n_split": n} not in grid and n <= MAX_CLUSTER
                and max(1, -(-S // keys)) == n
                and (n == 1 or keys >= MIN_KEYS_PER_SPLIT)):
            grid.append({"n_split": n})
    return tuple(grid)


def split_for(n: int, B: int, KV: int, G: int, S: int,
              sms: int) -> Tuple[int, int]:
    """(n_split, keys_per_split) of cluster size ``n``: :func:`plan`'s own
    where it is plan's size, else the even split."""
    n0, keys0 = plan(B, KV, G, S, sms)
    return (n0, keys0) if n == n0 else (n, split_keys(n, S))


def _bucket(B, S, H, KV, Dh, dtype, sms) -> str:
    return autotune.decode_bucket(B, S, H, KV, Dh, dtype)


def _default(B, S, H, KV, Dh, dtype, sms) -> dict:
    return default_tile(B, KV, H // KV, S, sms)


def _valid(tile, B, S, H, KV, Dh, dtype, sms) -> bool:
    return tile in tile_grid(B, KV, H // KV, S, sms)


def tile_for(B: int, S: int, H: int, KV: int, Dh: int,
             dtype: torch.dtype, sms: int) -> dict:
    """The resolved cluster size of a call (the cache's type ``dtype``):
    the tuned winner of its bucket where one is cached and valid here,
    else :func:`plan`'s."""
    return autotune.resolve(
        ("decode_attention", B, S, H, KV, Dh, dtype, sms),
        _bucket, _default, _valid)


def _aligned(t: torch.Tensor, *strides: int) -> bool:
    """16-byte aligned start and strides (in elements of ``t``)."""
    return t.data_ptr() % 16 == 0 and all(
        s * t.element_size() % 16 == 0 for s in strides)


def decode_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          kv_len: torch.Tensor,
                          scale: Optional[float] = None, *,
                          n_split: Optional[int] = None) -> torch.Tensor:
    """``n_split``: the cluster size; None resolves it
    (:func:`tile_for`)."""
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
    cache_dt = KERNEL.check_dtype("decode_attention cache", k, v)
    if q.dtype not in FLOAT_TYPES or kv_len.dtype != torch.int32:
        raise ValueError(f"decode_attention: q of {FLOAT_TYPES} and int32 "
                         f"kv_len, got {q.dtype} and {kv_len.dtype}")
    q, kv_len = head_rows(q), kv_len.contiguous()
    if not _aligned(q, q.stride(0)):
        q = q.contiguous()
    if (k.stride(3) != 1 or k.stride(2) != Dh or v.stride(3) != 1
            or v.stride(2) != Dh or not _aligned(k, k.stride(0), k.stride(1))
            or not _aligned(v, v.stride(0), v.stride(1))):
        raise ValueError("decode_attention: the cache must have dense heads "
                         "and 16-byte aligned rows (it is read in place)")
    dev = q.device
    sms = sm_count(dev)
    G = H // KV
    if n_split is None:
        n_split = tile_for(B, S, H, KV, Dh, cache_dt, sms)["n_split"]
    elif {"n_split": n_split} not in tile_grid(B, KV, G, S, sms):
        raise ValueError(f"decode_attention: n_split {n_split} at S {S}; the "
                         f"kernel takes {tile_grid(B, KV, G, S, sms)}")
    n, keys = split_for(n_split, B, KV, G, S, sms)
    out = torch.empty((B, 1, H, Dh), dtype=q.dtype, device=dev)
    scale = Dh ** -0.5 if scale is None else scale
    KERNEL(q, k, v, kv_len, out, Q_TYPE[q.dtype], B, S, H, KV, Dh, n, keys,
           q.stride(0), k.stride(0), k.stride(1), v.stride(0), v.stride(1),
           float(scale), dev.index, stream_of(q), dtype=cache_dt)
    return out
