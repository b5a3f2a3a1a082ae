"""1-D sequence adaptation of the paper's mixed-resolution technique: the
**mixed-granularity prefill** for decoder LMs (the
``repro.core.seq_mixed_res`` subset the LM serving engine runs).

Transposition of §III to sequences:
  decision region  -> span of r = w*d consecutive tokens
  low-res region   -> the span's d-token groups mean-pooled (r -> w tokens)
  restoration (RP) -> broadcast pooled hidden states back to all covered
                      positions between backbone subsets; KV-cache entries
                      of pre-RP layers are restored the same way, so decode
                      continues with a full-resolution cache.

WHICH spans are pooled is data carried by three gather-index arrays built
on the host by :func:`build_seq_pack` (numpy, byte-equal to the
reference's).  The mixed sequence keeps temporal order, so index
causality inside the standard causal attention is position causality.
A VLM's projected image tokens join the text in one sequence ahead of
it, pooled by the same spans; whisper pools its encoder frames
(:func:`encode_mixed`), non-causal 1-D regions, and leaves its decoder
untouched.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.models import layers as L
from repro_torch.models import mamba2 as m2
from repro_torch.models import transformer as tfm
from repro_torch.models import whisper as whs
from repro_torch.models.config import ModelConfig


@dataclass(frozen=True)
class SeqPartition:
    seq_len: int
    window: int            # w: tokens per pooled span after pooling
    downsample: int        # d: pooling factor

    @property
    def span(self) -> int:                    # r = w * d tokens per span
        return self.window * self.downsample

    @property
    def n_spans(self) -> int:
        return self.seq_len // self.span

    def validate(self):
        if self.seq_len % self.span:
            raise ValueError(f"seq_len {self.seq_len} % span {self.span}")

    def n_tokens(self, n_low: int) -> int:
        return self.seq_len - n_low * (self.span - self.window)


def seq_partition(cfg: ModelConfig, seq_len: int) -> SeqPartition:
    m = cfg.mixed_res
    p = SeqPartition(seq_len, m.window, m.downsample)
    p.validate()
    return p


def layers_before_rp(cfg: ModelConfig, beta: int, n_layers: int) -> int:
    """Number of leading backbone layers run at mixed granularity."""
    n_sub = cfg.mixed_res.n_subsets
    assert 0 <= beta <= n_sub
    return (beta * n_layers) // n_sub


# ---------------------------------------------------------------------------
# host-side pack-plan construction


def build_seq_pack(span_mask: np.ndarray, n_low: int, part: SeqPartition
                   ) -> Dict[str, np.ndarray]:
    """Build gather plans for a given span downsampling mask.

    span_mask: (n_spans,) binary, 1 = pool this span.  ``n_low`` is the
    bucket; extra selections are dropped (first n_low kept), missing ones
    are filled from the EARLIEST unselected spans (old context is the
    least fresh).

    Returns int32 arrays:
      mix_idx     (T_mix,) index into concat([tokens (T), pooled (T/d)])
      pos_mix     (T_mix,) RoPE position of each mixed slot
      restore_idx (T,)     mixed slot covering each full position
      low_spans   (n_low,) the spans actually pooled
    """
    part.validate()
    mask = np.asarray(span_mask).reshape(-1).astype(bool).copy()
    assert mask.shape[0] == part.n_spans
    sel = np.nonzero(mask)[0]
    if len(sel) > n_low:
        mask[sel[n_low:]] = False
    elif len(sel) < n_low:
        unsel = np.nonzero(~mask)[0]
        mask[unsel[:n_low - len(sel)]] = True
    low_spans = np.nonzero(mask)[0].astype(np.int32)

    r, w, d = part.span, part.window, part.downsample
    T = part.seq_len
    mix_idx, pos_mix, restore_idx = [], [], np.zeros((T,), np.int32)
    for s in range(part.n_spans):
        t0 = s * r
        if mask[s]:
            g0 = t0 // d
            for g in range(w):
                slot = len(mix_idx)
                mix_idx.append(T + g0 + g)               # pooled source
                pos_mix.append(t0 + g * d + (d - 1) // 2)
                restore_idx[t0 + g * d: t0 + (g + 1) * d] = slot
        else:
            for t in range(t0, t0 + r):
                slot = len(mix_idx)
                mix_idx.append(t)
                pos_mix.append(t)
                restore_idx[t] = slot
    assert len(mix_idx) == part.n_tokens(n_low)
    return {
        "mix_idx": np.asarray(mix_idx, np.int32),
        "pos_mix": np.asarray(pos_mix, np.int32),
        "restore_idx": restore_idx,
        "low_spans": low_spans,
    }


# ---------------------------------------------------------------------------
# packing / restoration primitives (pack arrays as int64 device tensors)


def pool_groups(x: torch.Tensor, d: int) -> torch.Tensor:
    """Mean-pool groups of d along time: (B, T, D) -> (B, T/d, D)."""
    B, T, D = x.shape
    return x.reshape(B, T // d, d, D).float().mean(dim=2).to(x.dtype)


def pack_sequence(x: torch.Tensor, mix_idx: torch.Tensor,
                  d: int) -> torch.Tensor:
    """(B, T, D) -> (B, T_mix, D) mixed-granularity sequence."""
    z = torch.cat([x, pool_groups(x, d)], dim=1)
    return z.index_select(1, mix_idx)


def restore_sequence(x_mix: torch.Tensor,
                     restore_idx: torch.Tensor) -> torch.Tensor:
    """Broadcast-restore: (B, T_mix, D) -> (B, T, D)."""
    return x_mix.index_select(1, restore_idx)


def restore_kv_caches(caches: Dict, restore_idx: torch.Tensor,
                      n_restore_layers: Dict[str, int]) -> Dict:
    """Restore the time axis of the pre-RP layers' cache entries, in place.

    caches: {"<kind>_blocks": {leaf: (L, B, S, ...)}} (GQA k / v, MLA
    c_kv / k_rope; time on axis 2), whose leading
    ``n_restore_layers[name]`` layers hold mixed-granularity entries at
    [0, T_mix); afterwards [0, T) holds the restored full-resolution
    entries.  The gather is taken first, then written over the slice (it
    reads slots the write overwrites)."""
    T = restore_idx.shape[0]
    for name, tree in caches.items():
        k = n_restore_layers.get(name, 0)
        if k <= 0:
            continue
        for leaf in tree.values():
            head = leaf[:k]
            head[:, :, :T] = head.index_select(2, restore_idx)
    return caches


# ---------------------------------------------------------------------------
# mixed-granularity forward and prefill of the decoder families (dense,
# MoE and VLM, GQA or MLA; the SSM and hybrid families have none in the
# reference either: its run_blocks knows no mamba layer)


def mixed_forward_hidden(cfg: ModelConfig, params: Dict,
                         tokens: torch.Tensor, pack: Dict[str, torch.Tensor],
                         beta: int,
                         image_embeds: Optional[torch.Tensor] = None):
    """Training / eval forward with mixed-granularity lower layers:
    layers [0, Lb) attend causally over the pooled sequence, a broadcast
    restore, then the rest at full resolution (beta 0 is the plain
    forward).  A MoE layer's capacity follows the pooled token count.
    A VLM's ``image_embeds`` go ahead of the tokens (``pack`` then spans
    both).  Returns (hidden (B, T, D), aux)."""
    x = tfm.embed_inputs(cfg, params, tokens, image_embeds)
    B, T, _ = x.shape
    Lb = layers_before_rp(cfg, beta, cfg.n_layers)
    aux = 0.0

    def run(x, positions, layers):
        nonlocal aux
        rope = tfm.rope_for(cfg, positions)
        for p in layers:
            x, a = tfm.train_block(cfg, p, x, rope)
            aux = aux + a
        return x

    if Lb > 0:
        xm = pack_sequence(x, pack["mix_idx"], cfg.mixed_res.downsample)
        xm = run(xm, pack["pos_mix"][None].expand(B, xm.shape[1]),
                 params["blocks"][:Lb])
        x = restore_sequence(xm, pack["restore_idx"])
    x = run(x, torch.arange(T, device=x.device).expand(B, T),
            params["blocks"][Lb:])
    return L.apply_norm(cfg, params["final_norm"], x), aux


def mixed_prefill(cfg: ModelConfig, params: Dict, tokens: torch.Tensor,
                  pack: Dict[str, torch.Tensor], beta: int, caches: Dict,
                  image_embeds: Optional[torch.Tensor] = None):
    """Serving prefill with mixed-granularity lower layers.

    Pre-RP layers attend over the pooled sequence and write pooled cache
    entries (k / v, or MLA's latents); those are then broadcast-restored
    in every stack they fall in, so the returned caches are
    FULL-resolution for every layer — decode proceeds exactly as after a
    plain prefill.  ``pack``: the :func:`build_seq_pack` arrays as
    integer tensors on the tokens' device, over the whole sequence: a
    VLM's projected ``image_embeds`` and then the tokens.  Returns
    (hidden, caches, aux).
    """
    x = tfm.embed_inputs(cfg, params, tokens, image_embeds)
    B, T, _ = x.shape
    Lb = layers_before_rp(cfg, beta, cfg.n_layers)
    d = cfg.mixed_res.downsample
    aux = 0.0
    if Lb > 0:
        xm = pack_sequence(x, pack["mix_idx"], d)
        pos = pack["pos_mix"][None].expand(B, xm.shape[1])
        xm, caches, a1 = tfm.run_blocks(cfg, params, xm, pos, 0, Lb, caches)
        aux += a1
        x = restore_sequence(xm, pack["restore_idx"])
        caches = restore_kv_caches(caches, pack["restore_idx"],
                                   tfm.restore_counts(cfg, Lb))
    positions = torch.arange(T, device=x.device).expand(B, T)
    x, caches, a2 = tfm.run_blocks(cfg, params, x, positions, Lb,
                                   cfg.n_layers, caches)
    x = L.apply_norm(cfg, params["final_norm"], x)
    return x, caches, aux + a2


# ---------------------------------------------------------------------------
# SSM family: the paper's 1-D technique on the Mamba-2 backbone (pooling
# gives linear savings only on a linear-time backbone)


def mixed_forward_ssm(cfg: ModelConfig, params: Dict, tokens: torch.Tensor,
                      pack: Dict[str, torch.Tensor], beta: int):
    """Forward with mixed-granularity lower layers on the pure SSM LM:
    layers [0, Lb) run on the pooled sequence, then a broadcast restore,
    then the rest at full resolution.  Every layer's scan goes through
    ``dispatch.ssd_scan``.  Returns (hidden (B, T, D), aux)."""
    x = L.embed_tokens(params["embed"], tokens)
    Lb = layers_before_rp(cfg, beta, cfg.n_layers)
    blocks = params["mamba_blocks"]

    def run(x, layers):
        for p in layers:
            x = x + m2.mamba2_forward(cfg, p["mamba"],
                                      L.apply_norm(cfg, p["ln"], x))
        return x

    if Lb > 0:
        xm = pack_sequence(x, pack["mix_idx"], cfg.mixed_res.downsample)
        x = restore_sequence(run(xm, blocks[:Lb]), pack["restore_idx"])
    x = run(x, blocks[Lb:])
    return L.apply_norm(cfg, params["final_norm"], x), 0.0


# ---------------------------------------------------------------------------
# whisper: encoder frame pooling (non-causal 1-D regions); the decoder is
# untouched


def encode_mixed(cfg: ModelConfig, params: Dict, frames: torch.Tensor,
                 pack: Dict[str, torch.Tensor], beta: int) -> torch.Tensor:
    """Whisper's encoder with mixed-granularity lower layers: the frames
    plus their sinusoidal positions pooled by ``pack``, encoder layers
    [0, Lb) over the pooled sequence (the flash kernel, not causal, on
    the card), a broadcast restore, then the rest at full resolution.
    Returns the encoder output (B, T_enc, D)."""
    Lb = layers_before_rp(cfg, beta, cfg.encdec.n_encoder_layers)
    x = whs.frames_with_positions(frames)
    blocks = params["enc_blocks"]
    if Lb > 0:
        xm = pack_sequence(x, pack["mix_idx"], cfg.mixed_res.downsample)
        for p in blocks[:Lb]:
            xm = whs.enc_block(cfg, p, xm)
        x = restore_sequence(xm, pack["restore_idx"])
    for p in blocks[Lb:]:
        x = whs.enc_block(cfg, p, x)
    return L.apply_norm(cfg, params["enc_norm"], x)


# ---------------------------------------------------------------------------
# analytic FLOPs of the mixed prefill (latency model input, paper §IV-D)


def prefill_flops(cfg: ModelConfig, seq_len: int, n_low: int,
                  beta: int) -> float:
    """Attention+MLP FLOPs for a mixed-granularity prefill (per batch el)."""
    part = seq_partition(cfg, seq_len)
    Lb = layers_before_rp(cfg, beta, cfg.n_layers)
    Tm = part.n_tokens(n_low)
    D, F = cfg.d_model, cfg.d_ff

    def layer_flops(T):
        proj = 2 * T * D * (cfg.q_dim + 2 * cfg.kv_dim) + \
            2 * T * cfg.q_dim * D
        att = 2 * 2 * T * T * cfg.q_dim / 2          # causal: half the pairs
        if cfg.moe is not None:
            f_eff = cfg.moe.top_k * cfg.moe.d_ff_expert + \
                cfg.moe.n_shared_experts * cfg.moe.d_ff_expert
            mlp = 3 * 2 * T * D * f_eff
        else:
            mlp = 3 * 2 * T * D * F
        return proj + att + mlp

    return Lb * layer_flops(Tm) + (cfg.n_layers - Lb) * layer_flops(seq_len)
