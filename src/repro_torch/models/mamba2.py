"""Mamba-2 block (state-space duality / SSD, arXiv:2405.21060): the port
of ``repro.models.mamba2``.

The full-sequence block has two routes.  Serving runs the chunked SSD
scan through ``kernels.dispatch.ssd_scan`` (the CUDA kernel on the card,
its plain version on the CPU), which has no backward.  Training
(``mamba2_forward(..., train=True)``) runs :func:`ssd_chunked` in plain
PyTorch on either device, differentiable by autograd: the reference
trains through its jnp ``ssd_chunked`` too (its ``use_kernel=False``
default), outside any Pallas call.  Decode is the O(1) recurrent state
update, in plain PyTorch as in the reference.  All SSD math in float32.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import dispatch
from repro_torch.kernels.ssd_scan.ref import ssd_chunked
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig


# the leaves the reference draws in float32 and keeps there at any
# parameter type (``init_mamba2``)
FLOAT32_LEAVES = ("A_log", "dt_bias", "D")


def ssm_dims(cfg: ModelConfig) -> Tuple[int, int, int]:
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    n_heads = d_inner // s.head_dim
    conv_ch = d_inner + 2 * s.n_groups * s.d_state
    return d_inner, n_heads, conv_ch


def init_mamba2(cfg: ModelConfig, generator: torch.Generator,
                device="cuda", dtype: Optional[torch.dtype] = None
                ) -> Dict[str, torch.Tensor]:
    """Seeded init with the reference's shapes and distributions:
    truncated normal in (-2, 2) std / sqrt(fan_in) for ``w_in`` and
    ``w_out``, N(0, 1) * 0.1 for the depthwise conv, ``A_log = log(1..H)``,
    ``dt_bias`` the inverse softplus of a log-uniform dt in [dt_min,
    dt_max], ones for ``D`` and ``norm_w``.  Tensors are drawn on
    ``generator.device`` and moved to ``device``; every leaf but
    ``FLOAT32_LEAVES`` is cast to ``dtype``, as the reference's."""
    s = cfg.ssm
    d_inner, H, conv_ch = ssm_dims(cfg)
    gdev = "meta" if L.is_meta(device) else generator.device
    proj_out = 2 * d_inner + 2 * s.n_groups * s.d_state + H
    w_in = L.dense_init(cfg.d_model, proj_out, generator, device)
    gen = None if L.is_meta(device) else generator
    conv_w = torch.randn((s.d_conv, conv_ch), generator=gen,
                         device=gdev) * 0.1
    u = torch.rand((H,), generator=gen, device=gdev)
    dt = torch.exp(u * (math.log(s.dt_max) - math.log(s.dt_min))
                   + math.log(s.dt_min))
    dt_bias = dt + torch.log(-torch.expm1(-dt))          # inverse softplus
    p = {
        "w_in": w_in,
        "conv_w": conv_w.to(device),
        "conv_b": torch.zeros(conv_ch, device=device),
        "A_log": torch.log(torch.arange(1, H + 1, dtype=torch.float32,
                                        device=device)),
        "dt_bias": dt_bias.to(device),
        "D": torch.ones(H, device=device),
        "norm_w": torch.ones(d_inner, device=device),
        "w_out": L.dense_init(d_inner, cfg.d_model, generator, device),
    }
    return {k: v if k in FLOAT32_LEAVES else L.as_dtype(v, dtype)
            for k, v in p.items()}


# ---------------------------------------------------------------------------
# causal depthwise conv1d


def causal_conv1d(x: torch.Tensor, w: torch.Tensor,
                  b: torch.Tensor) -> torch.Tensor:
    """x: (B, T, C); w: (K, C) depthwise; left-padded causal:
    out[t] = sum_k w[k] * x[t - (K-1) + k] + b, summed in the reference's
    order."""
    K, T = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, K - 1, 0))
    out = torch.zeros_like(x)
    for k in range(K):
        out = out + xp[:, k:k + T, :] * w[k][None, None, :]
    return out + b[None, None, :]


def conv1d_step(x_t: torch.Tensor, conv_state: torch.Tensor,
                w: torch.Tensor, b: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-step conv: x_t (B, C); conv_state (B, K-1, C) of past inputs.
    Returns (out (B, C), the new state (B, K-1, C)).  Mixed types
    promote, as the reference's jnp ops do (a float32 state under a half
    model runs the step in float32)."""
    window = torch.cat([conv_state, x_t[:, None, :]], dim=1)     # (B,K,C)
    ct = torch.promote_types(window.dtype, w.dtype)
    out = torch.einsum("bkc,kc->bc", window.to(ct), w.to(ct)) + b[None, :]
    return out, window[:, 1:, :]


def ssd_decode_step(x_t: torch.Tensor, dt_t: torch.Tensor, A: torch.Tensor,
                    B_t: torch.Tensor, C_t: torch.Tensor,
                    state: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-token SSD: x_t (b, H, P), dt_t (b, H), B_t/C_t (b, G, N),
    state (b, H, N, P) -> (y_t (b, H, P), new_state)."""
    H, G = x_t.shape[1], B_t.shape[1]
    hpg = H // G
    f32 = torch.float32
    Bh = B_t.to(f32).repeat_interleave(hpg, 1)                    # (b,H,N)
    Ch = C_t.to(f32).repeat_interleave(hpg, 1)
    dA = torch.exp(dt_t.to(f32) * A[None, :])                     # (b,H)
    xbar = x_t.to(f32) * dt_t[..., None].to(f32)
    new_state = state * dA[:, :, None, None] + \
        torch.einsum("bhd,bhp->bhdp", Bh, xbar)
    y = torch.einsum("bhd,bhdp->bhp", Ch, new_state)
    return y, new_state


# ---------------------------------------------------------------------------
# full block


def _split_proj(cfg: ModelConfig, z_all: torch.Tensor):
    """The in-projection's output -> (z, xBC, dt_raw) column views."""
    s = cfg.ssm
    d_inner, H, _ = ssm_dims(cfg)
    gN = s.n_groups * s.d_state
    return torch.split(z_all, (d_inner, d_inner + 2 * gN, H), dim=-1)


def _scan_inputs(cfg: ModelConfig, p: Dict[str, torch.Tensor],
                 xBC: torch.Tensor, dt_raw: torch.Tensor):
    """The conv output ``xBC`` (B, T, conv_ch) and ``dt_raw`` -> the scan's
    (xs, dt, A, Bm, Cm); xs, Bm and Cm are column views of ``xBC``."""
    s = cfg.ssm
    d_inner, H, _ = ssm_dims(cfg)
    gN = s.n_groups * s.d_state
    B_, T = xBC.shape[:2]
    xs, Bm, Cm = torch.split(xBC, (d_inner, gN, gN), dim=-1)
    xs = xs.reshape(B_, T, H, s.head_dim)
    Bm = Bm.reshape(B_, T, s.n_groups, s.d_state)
    Cm = Cm.reshape(B_, T, s.n_groups, s.d_state)
    dt = F.softplus(dt_raw.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    return xs, dt, A, Bm, Cm


def _gated_out(cfg: ModelConfig, p: Dict[str, torch.Tensor], y, xs, z,
               x_dtype) -> torch.Tensor:
    """y + D * x skip, gated RMSNorm by silu(z), out-projection."""
    d_inner = ssm_dims(cfg)[0]
    y = y + xs.float() * p["D"][None, None, :, None]
    y = y.reshape(*y.shape[:2], d_inner).to(x_dtype)
    y = L.rms_norm(y * F.silu(z), p["norm_w"], cfg.norm_eps)
    return y @ p["w_out"]


def mamba2_forward(cfg: ModelConfig, p: Dict[str, torch.Tensor],
                   x: torch.Tensor, *, train: bool = False) -> torch.Tensor:
    """Full-sequence Mamba-2 block.  x: (B, T, D) -> (B, T, D).
    ``train``: the scan is :func:`ssd_chunked` (autograd), else the
    ``ssd_scan`` route (no backward)."""
    z, xBC, dt_raw = _split_proj(cfg, x @ p["w_in"])
    xBC = F.silu(causal_conv1d(xBC, p["conv_w"], p["conv_b"]))
    xs, dt, A, Bm, Cm = _scan_inputs(cfg, p, xBC, dt_raw)
    chunk = min(cfg.ssm.chunk_size, x.shape[1])
    if train:
        y = ssd_chunked(xs, dt, A, Bm, Cm, chunk)
    else:
        y, _ = dispatch.ssd_scan(xs, dt, A, Bm, Cm, chunk)
    return _gated_out(cfg, p, y, xs, z, x.dtype)


def init_mamba2_state(cfg: ModelConfig, batch: int,
                      dtype: torch.dtype = torch.float32,
                      device="cuda") -> Dict[str, torch.Tensor]:
    s = cfg.ssm
    d_inner, H, conv_ch = ssm_dims(cfg)
    return {
        "conv": torch.zeros((batch, s.d_conv - 1, conv_ch), dtype=dtype,
                            device=device),
        "ssm": torch.zeros((batch, H, s.d_state, s.head_dim),
                           dtype=torch.float32, device=device),
    }


def mamba2_decode(cfg: ModelConfig, p: Dict[str, torch.Tensor],
                  x_t: torch.Tensor, state: Dict[str, torch.Tensor]
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token recurrent step.  x_t: (B, 1, D); ``state``: this layer's
    {"conv": (B, K-1, C), "ssm": (B, H, N, P)}.  Returns (out (B, 1, D),
    the new state) — new tensors; the caller decides where they live."""
    z, xBC, dt_raw = _split_proj(cfg, x_t[:, 0, :] @ p["w_in"])
    xBC, conv_state = conv1d_step(xBC, state["conv"], p["conv_w"],
                                  p["conv_b"])
    xs, dt, A, Bm, Cm = _scan_inputs(cfg, p, F.silu(xBC)[:, None],
                                     dt_raw[:, None])
    y, ssm_state = ssd_decode_step(xs[:, 0], dt[:, 0], A, Bm[:, 0],
                                   Cm[:, 0], state["ssm"])
    out = _gated_out(cfg, p, y[:, None], xs, z[:, None], x_t.dtype)
    return out, {"conv": conv_state, "ssm": ssm_state}
