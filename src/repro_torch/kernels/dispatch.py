"""Kernel dispatch: routes each hot-path op by the device of its input.

A CUDA tensor launches the op's hand-written kernel (``csrc/``); a CPU
tensor takes the op's plain PyTorch version; any other device raises.
There is no backend knob, and a kernel that fails to build or launch
raises rather than falling back.  Window and flash attention and the two
pools go through their ``torch.autograd.Function``s on both devices, so
serving and training share one route and the CPU runs the same analytic
backward as the card, at any of the three types: the forward is the
half kernel on the card at fp16 / bf16, and the backward the
reference's VJP (flash and window in float32, cast to each operand's
type; the pools in the cotangent's type).

The quant plane (``resolve_quant``) chooses how a ``QuantTensor`` weight
multiplies (``quant.qtensor.matmul``): ``"native"`` runs the int8 GEMM
route below, ``"dequant"`` the float GEMM on the dequantized weight, the
reference's explicit oracle lane that a caller asks for.  Precedence, as
in the reference: the ``REPRO_QUANT`` environment variable (read once at
import, :func:`refresh_from_env`) > a per-call ``mode`` >
:func:`set_quant_mode` > ``"native"``.

Each kernel keeps a launch count (``launch_counts``), which grows only
where a wrapper launched its kernel, so a run can show that it went
through the kernels; ``launch_counts("f16")`` / ``("bf16")`` count the
launches of its half entry point alone, and ``copy_counts`` the operands
a half attention wrapper copied because its kernel's loads refuse the
view.  While :func:`tag_plain_routes` is open, a route that takes its
plain version names its kernel on the caller's stack for the call, so a
counting mode can keep apart the work a kernel does on the card
(``launch.costing``'s ``kernel:<name>`` regions).

Every route takes float32, fp16 and bf16 tensors, as the reference's
kernels do (they compute in float32 and return the input's type): on
the card each launches its kernel's entry point for that type, on the
CPU the plain version casts to float32, computes and casts back.
``ssd_scan`` is the exception the reference makes too: it casts its
inputs to float32 before the (float32) kernel and returns y in float32
and the final state in the incoming state's type.
"""
from __future__ import annotations

import contextlib
import os
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.kernels.decode_attention import ops as _decode
from repro_torch.kernels.flash_attention import ops as _flash
from repro_torch.kernels.fused_serving import ops as _fused
from repro_torch.kernels.int8_matmul import ops as _int8
from repro_torch.kernels.mixed_res_pool import ops as _pool
from repro_torch.kernels.ssd_scan import ops as _ssd
from repro_torch.kernels.window_attention import ops as _win

KERNELS = {
    "window_attention": _win.KERNEL,
    "flash_attention": _flash.KERNEL,
    "pack_pos": _fused.PACK_POS,
    "restore_gather": _fused.RESTORE,
    "avg_pool": _pool.KERNEL,
    "nn_upsample": _pool.UPSAMPLE,
    "int8_matmul": _int8.KERNEL,
    "decode_attention": _decode.KERNEL,
    "ssd_scan": _ssd.KERNEL,
}

QUANT_MODES = ("native", "dequant")
QUANT_ENV_VAR = "REPRO_QUANT"

_ENV_QUANT: Optional[str] = None        # cached REPRO_QUANT override
_PROCESS_QUANT: Optional[str] = None    # set_quant_mode() default
_PLAIN_TAGS: Optional[List[str]] = None  # tag_plain_routes() stack


def disable_tf32() -> None:
    """Keep float32 GEMMs and cuDNN convolutions in full float32, as the
    reference computes them (PyTorch runs cuDNN convolutions in TF32 by
    default)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def on_card(x: torch.Tensor) -> bool:
    if x.is_cuda:
        return True
    if x.device.type in ("cpu", "meta"):   # meta: the plain ops' shapes
        return False
    raise ValueError(f"no kernel route for device {x.device}")


@contextlib.contextmanager
def tag_plain_routes(stack: List[str]):
    """While open, each route that takes its plain version pushes its
    kernel's name on ``stack`` for the call's duration."""
    global _PLAIN_TAGS
    prev, _PLAIN_TAGS = _PLAIN_TAGS, stack
    try:
        yield
    finally:
        _PLAIN_TAGS = prev


@contextlib.contextmanager
def _route(name: str, x: torch.Tensor):
    """Yields whether ``x`` is on the card (any other device than the
    card, the CPU or meta raises); on the plain route, the kernel's name
    is on the :func:`tag_plain_routes` stack meanwhile."""
    card, stack = on_card(x), _PLAIN_TAGS
    if card or stack is None:
        yield card
        return
    stack.append(name)
    try:
        yield card
    finally:
        stack.pop()


def _no_vjp(name: str, *xs: Optional[torch.Tensor]) -> None:
    """Raise where autograd would differentiate through a kernel that
    has no backward (the reference gives it no VJP either): on the card
    its output would carry no gradient, silently."""
    if torch.is_grad_enabled() and any(
            x is not None and x.requires_grad for x in xs):
        raise RuntimeError(f"{name} has no backward: call it on tensors "
                           f"that do not require grad, or under "
                           f"torch.no_grad()")


def launch_counts(dtype: Optional[str] = None) -> Dict[str, int]:
    """Launches per kernel since the last reset; with ``dtype`` ("f32",
    "f16", "bf16"), those of that type's entry point alone (0 for a
    kernel built for float32 only)."""
    if dtype is None:
        return {name: k.launches for name, k in KERNELS.items()}
    return {name: k.by_dtype.get(dtype, 0) for name, k in KERNELS.items()}


def copy_counts() -> Dict[str, int]:
    """Operands copied since the last reset because a kernel's 16-byte
    loads refuse their view (``build.aligned_rows``), per kernel."""
    return {name: k.copies for name, k in KERNELS.items()}


def reset_launch_counts() -> None:
    for k in KERNELS.values():
        k.reset()


# ---------------------------------------------------------------------------
# quant plane


def _check_quant(mode: str) -> str:
    if mode not in QUANT_MODES:
        raise ValueError(f"quant mode must be one of {QUANT_MODES}, got "
                         f"{mode!r}")
    return mode


def refresh_from_env() -> Optional[str]:
    """Re-read the cached ``REPRO_QUANT`` override (it is resolved on
    every quantized matmul, so it is not read per call)."""
    global _ENV_QUANT
    qenv = os.environ.get(QUANT_ENV_VAR)
    _ENV_QUANT = _check_quant(qenv) if qenv else None
    return _ENV_QUANT


def set_quant_mode(mode: Optional[str]) -> None:
    """Process-wide default for ``mode=None`` call sites; ``None``
    restores the built-in ``"native"``."""
    global _PROCESS_QUANT
    _PROCESS_QUANT = _check_quant(mode) if mode is not None else None


@contextlib.contextmanager
def quant_scope(mode: Optional[str]):
    """Temporarily set the process quant mode; a ``None`` scope is a
    no-op."""
    if mode is None:
        yield
        return
    prev = _PROCESS_QUANT
    set_quant_mode(mode)
    try:
        yield
    finally:
        set_quant_mode(prev)


def resolve_quant(mode: Optional[str] = None) -> str:
    """Resolve a quant-mode request to ``"native"`` or ``"dequant"``."""
    if _ENV_QUANT is not None:
        return _ENV_QUANT
    if mode is None:
        return _PROCESS_QUANT if _PROCESS_QUANT is not None else "native"
    return _check_quant(mode)


refresh_from_env()


# ---------------------------------------------------------------------------
# kernel routes


def window_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     window: int,
                     win_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q: (B, T, H, Dh); k/v: (B, T, KV, Dh); ``window`` tokens per
    window; ``win_valid`` (B,) valid-window counts (pad windows -> 0)."""
    with _route("window_attention", q):
        return _win.WindowAttention.apply(q, k, v, window, win_valid)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = False) -> torch.Tensor:
    """q: (B, T, H, Dh); k/v: (B, S, KV, Dh)."""
    with _route("flash_attention", q):
        return _flash.FlashAttention.apply(q, k, v, causal)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     kv_len: torch.Tensor) -> torch.Tensor:
    """One-token decode: q (B, 1, H, Dh) against a (B, S, KV, Dh) cache
    with (B,) int32 valid lengths ``kv_len``."""
    _no_vjp("decode_attention", q, k, v)
    with _route("decode_attention", q) as card:
        if card:
            return _decode.decode_attention_cuda(q, k, v, kv_len)
        return _decode.decode_attention_plain(q, k, v, kv_len)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor, chunk: int,
             init_state: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mamba-2 SSD chunked scan: x (b, T, H, P), dt (b, T, H), A (H,),
    B/C (b, T, G, N), chunk length ``chunk``, optional initial state
    (b, H, N, P).  Returns (y (b, T, H, P), final state (b, H, N, P))."""
    _no_vjp("ssd_scan", x, dt, A, Bm, Cm, init_state)
    # the scan runs in float32 whatever its inputs' type, as the
    # reference's ssd_scan/ops.py casts them before its kernel; y stays
    # float32 and the final state takes the incoming state's type
    f32 = torch.float32
    x, dt, A, Bm, Cm = (t.to(f32) for t in (x, dt, A, Bm, Cm))
    s0 = init_state.to(f32) if init_state is not None else None
    with _route("ssd_scan", x) as card:
        if card:
            y, s_fin = _ssd.ssd_scan_cuda(x, dt, A, Bm, Cm, chunk, s0)
        else:
            y, s_fin = _ssd.ssd_scan_plain(x, dt, A, Bm, Cm, chunk, s0)
    if init_state is not None:
        s_fin = s_fin.to(init_state.dtype)
    return y, s_fin


def avg_pool(x: torch.Tensor, d: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, H/d, W/d, C) mean pool."""
    if d == 1:
        return x
    with _route("avg_pool", x):
        return _pool.AvgPool.apply(x, d)


def nn_upsample(x: torch.Tensor, d: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, H*d, W*d, C) nearest-neighbour upsample."""
    if d == 1:
        return x
    with _route("nn_upsample", x):
        return _pool.NNUpsample.apply(x, d)


def int8_matmul(xq: torch.Tensor, wq: torch.Tensor, sx: torch.Tensor,
                sw: torch.Tensor, *,
                out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Quantized GEMM: xq (M, K) int8 row-quantized activations, wq
    (K, N) int8 per-output-channel codes (K-contiguous, as
    ``QuantTensor`` keeps them), sx (M,) / sw (N,) float32 scales."""
    _no_vjp("int8_matmul", sx, sw)
    with _route("int8_matmul", xq) as card:
        if card:
            return _int8.int8_matmul_cuda(xq, wq, sx, sw, out_dtype)
        return _int8.int8_matmul_plain(xq, wq, sx, sw, out_dtype)


def pack_pos(bank: torch.Tensor, pos_bank: torch.Tensor,
             win_src: torch.Tensor, nw: torch.Tensor) -> torch.Tensor:
    """Fused serving prologue: window-bank gather + positional add +
    pad-window zeroing.  Returns packed tokens (B, nw_pad * w2, C)."""
    _no_vjp("pack_pos", bank, pos_bank)
    with _route("pack_pos", bank) as card:
        if card:
            return _fused.pack_pos_cuda(bank, pos_bank, win_src, nw)
        return _fused.pack_pos_plain(bank, pos_bank, win_src, nw)


def restore_gather(windows: torch.Tensor, out_src: torch.Tensor,
                   out_map: torch.Tensor, window: int, downsample: int,
                   reuse_tiles: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
    """Fused serving epilogue: destination-major restoration gather
    (window un-pack + LOW upsample + REUSE splice).  ``windows``: packed
    activations (B, nw_pad, w2, D).  Returns (B, nout * w2, D)."""
    _no_vjp("restore_gather", windows, reuse_tiles)
    with _route("restore_gather", windows) as card:
        if card:
            return _fused.restore_gather_cuda(windows, out_src, out_map,
                                              window, downsample, reuse_tiles)
        return _fused.restore_gather_plain(windows, out_src, out_map,
                                           window, downsample, reuse_tiles)
