"""Operation and byte counts the per-layer metrics divide by: a frozen
copy of the arithmetic of ``core/vit_backbone.backbone_flops_windows``
(plus the patch embedding and the head), and the attention problems a
wave hands the flash and window kernels.  Sizes are a configuration
file's ``sizes``.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

ELEMENT_BYTES = {"fp32": 4, "fp16": 2, "bf16": 2}
HEAD_STRIDES = (8, 16, 32)


def _geometry(sz: Dict) -> Tuple[int, int, int, int, int]:
    """(tokens at full resolution, windows at full resolution, w^2,
    blocks a subset, subsets)."""
    grid = sz["img_size"] // sz["patch_size"]
    w2 = sz["window_size"] ** 2
    n_full = grid * grid
    return (n_full, n_full // w2, w2, sz["n_layers"] // sz["n_subsets"],
            sz["n_subsets"])


def backbone_flops_windows(sz: Dict, n_windows: int, beta: int) -> float:
    """Attention and MLP FLOPs of the blocks with the sequence before
    the restoration point at ``n_windows`` windows; ``beta`` 0, or a
    full ``n_windows``, is the full-resolution cost."""
    D, F = sz["d_model"], sz["d_ff"]
    n_full, nw_full, w2, M, N = _geometry(sz)
    n_mixed = n_windows * w2

    def block(n_tok, n_win):
        proj = 4 * 2 * n_tok * D * D
        att = (2 * 2 * n_win * w2 * w2 * D if n_win
               else 2 * 2 * n_tok * n_tok * D)
        return proj + att + 2 * 2 * n_tok * D * F

    total, restored = 0.0, beta <= 0
    for s in range(N):
        for m in range(M):
            is_global = m == M - 1
            if is_global and not restored and beta == s + 1:
                restored = True
            if restored:
                total += block(n_full, 0 if is_global else nw_full)
            else:
                total += block(n_mixed, 0 if is_global else n_windows)
    return total


def embed_flops(sz: Dict, n_full_regions: int, n_low_regions: int) -> float:
    """The patch projection of the tokens a plan transmits."""
    D, p = sz["d_model"], sz["patch_size"]
    r = sz["window_size"] * sz["downsample"]
    tokens = n_full_regions * r * r + n_low_regions * sz["window_size"] ** 2
    return 2.0 * tokens * p * p * 3 * D


def head_flops(sz: Dict) -> float:
    """The pyramid's convolutions and the shared head at three levels."""
    D, C, nc = sz["d_model"], sz["out_channels"], sz["n_classes"]
    grid = sz["img_size"] // sz["patch_size"]
    total = 0.0
    for s in HEAD_STRIDES:
        px = (grid * 16 // s) ** 2
        total += 2.0 * px * (D * C + 9 * C * C + 9 * C * C
                             + 9 * C * (nc + 4 + 1))
    return total


def frame_flops(sz: Dict, n_full_regions: int, n_low_regions: int,
                n_windows: int, beta: int) -> float:
    """Useful FLOPs of one frame at its exact window count."""
    return (backbone_flops_windows(sz, n_windows, beta)
            + embed_flops(sz, n_full_regions, n_low_regions)
            + head_flops(sz))


def attention_cost(rows_windows: Sequence[int], w2_q: int, w2_k: int,
                   sz: Dict, dtype: str) -> Tuple[float, float]:
    """(FLOPs, bytes) of attention over groups: ``rows_windows`` groups
    of ``w2_q`` queries against ``w2_k`` keys; 4 Tq Tk Dh FLOPs a head
    (QK^T and PV), and q, k, v, o each read or written once."""
    H, Dh = sz["n_heads"], sz["head_dim"]
    es = ELEMENT_BYTES[dtype]
    groups = sum(rows_windows)
    flops = 4.0 * groups * w2_q * w2_k * Dh * H
    nbytes = groups * (2 * w2_q + 2 * w2_k) * H * Dh * es
    return flops, nbytes


def wave_attention(sz: Dict, Bp: int, beta: int, full_res: bool,
                   rows_valid: Sequence[int], dtype: str
                   ) -> Dict[str, List[Tuple[float, float]]]:
    """The (FLOPs, bytes) of each flash and window call one wave makes.

    A full-resolution wave runs every global block on the flash kernel
    and every window block on the window kernel at full length.  A
    mixed wave (length-bucketed, restoring at ``beta``) runs the window
    blocks before the restoration point over each row's valid windows
    (``rows_valid``, pad rows included: the kernel computes them), its
    masked global blocks before the restoration point on no kernel of
    these two, and everything after at full length; pad windows write
    zeros and are not counted."""
    n_full, nw_full, w2, M, N = _geometry(sz)
    flash = attention_cost([Bp], n_full, n_full, sz, dtype)
    window_full = attention_cost([Bp * nw_full], w2, w2, sz, dtype)
    calls = {"flash": [], "window": []}
    pre = 0 if full_res else beta
    for s in range(N):
        for m in range(M):
            is_global = m == M - 1
            before = s < pre and not (is_global and s == pre - 1)
            if is_global:
                if not before:
                    calls["flash"].append(flash)
            elif before:
                calls["window"].append(
                    attention_cost(rows_valid, w2, w2, sz, dtype))
            else:
                calls["window"].append(window_full)
    return calls


def attention_roofline(traced_waves, sz: Dict, dtype: str, beta: int,
                       peaks: Dict, kernel: str, calls: str):
    """The least time the card could take for the ``calls`` ("flash" or
    "window") problems of ``traced_waves`` ((wave, device ops) pairs),
    the larger of FLOPs over the peak at ``dtype`` and bytes over the
    card's bandwidth, over the device time of the ops whose name holds
    ``kernel``, in percent; None where no such op ran."""
    peak, bw = peaks["flops"][dtype], peaks["bytes_per_s"]
    bound = spent = 0.0
    for w, ops in traced_waves:
        for f, b in wave_attention(sz, w.Bp, beta, w.full_res,
                                   w.rows_valid, dtype)[calls]:
            bound += max(f / peak, b / bw)
        spent += sum(o.end - o.start for o in ops if kernel in o.name)
    return 100.0 * bound / spent if spent > 0 else None
