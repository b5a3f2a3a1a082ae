"""Whisper-medium style encoder-decoder (the port of
``repro.models.whisper``: its serving entry points and the
teacher-forced training forward).

The conv / mel frontend is a stub, as in the reference: ``frames`` are
precomputed frame embeddings (B, T_enc, d_model).  Sinusoidal positions
are added to the encoder frames, whose layers attend without a mask or a
rotation; the decoder adds learned positions (``dec_pos``) and runs
causal self-attention with a KV cache, then cross-attention over the
encoder output, LayerNorm and the tanh-GELU MLP.  Cross-attention K and
V are projected from the encoder output in every call, prefill and each
decode step alike, as the reference does.

Parameters are per-layer lists (``enc_blocks``, ``dec_blocks``); the
decoder caches keep the reference's stacked layout, k / v (L, B, S, KV,
Dh), a layer writing its slice in place.  The serving state is
``(enc_out, caches)``.  On the card the encoder's and the
cross-attention's attention run the flash kernel (at T_q = 1 against the
encoder frames at each decode step), the decoder's prefill the flash
kernel causal and each decode step the decode kernel.  The
teacher-forced training forward (``decode_train``) runs the encoder, then
every decoder layer without a cache (causal self-attention through the
flash kernel's ``autograd.Function`` on the card, then cross-attention
over the encoder output).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.models import attention as attn
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig


def init_whisper_params(cfg: ModelConfig, generator: torch.Generator,
                        device="cuda", dtype: Optional[torch.dtype] = None
                        ) -> Dict:
    """Seeded init with the reference's shapes and distributions (dense
    weights truncated normal / sqrt(fan_in), the token table and
    ``dec_pos`` (max_seq_len, D) normal with std 0.02, ones and zeros for
    the LayerNorms, zero biases); self-attention q / k / v fused as
    ``w_qkv`` with ``b_qkv``, cross-attention weights apart; each piece
    cast to ``dtype`` as it is drawn."""
    def enc_layer():
        return {"ln1": L.init_norm(cfg, device, dtype),
                "attn": attn.init_attention(cfg, generator, device, dtype),
                "ln2": L.init_norm(cfg, device, dtype),
                "ffn": L.init_mlp(cfg, generator, device, dtype=dtype)}

    def dec_layer():
        return {"ln1": L.init_norm(cfg, device, dtype),
                "self_attn": attn.init_attention(cfg, generator, device,
                                                 dtype),
                "ln_x": L.init_norm(cfg, device, dtype),
                "cross_attn": attn.init_cross_attention(cfg, generator,
                                                        device, dtype),
                "ln2": L.init_norm(cfg, device, dtype),
                "ffn": L.init_mlp(cfg, generator, device, dtype=dtype)}

    enc = [enc_layer() for _ in range(cfg.encdec.n_encoder_layers)]
    embed = L.init_embedding(cfg, generator, device, dtype)
    dec_pos = torch.empty((cfg.max_seq_len, cfg.d_model),
                          device="meta" if L.is_meta(device)
                          else generator.device)
    if not L.is_meta(device):
        torch.nn.init.normal_(dec_pos, 0.0, 0.02, generator=generator)
    return {"enc_blocks": enc, "enc_norm": L.init_norm(cfg, device, dtype),
            "embed": embed, "dec_pos": L.as_dtype(dec_pos.to(device), dtype),
            "dec_blocks": [dec_layer() for _ in range(cfg.n_layers)],
            "final_norm": L.init_norm(cfg, device, dtype),
            "lm_head": L.init_lm_head(cfg, generator, device, dtype)}


def enc_block(cfg: ModelConfig, p: Dict, x: torch.Tensor) -> torch.Tensor:
    """One pre-norm encoder layer: unmasked, unrotated self-attention,
    then the MLP."""
    x = x + attn.attention_forward(cfg, p["attn"],
                                   L.apply_norm(cfg, p["ln1"], x))
    return x + L.apply_mlp(cfg, p["ffn"], L.apply_norm(cfg, p["ln2"], x))


def frames_with_positions(frames: torch.Tensor) -> torch.Tensor:
    """The encoder's input: frames (B, T, D) plus the sinusoidal table."""
    _, T, D = frames.shape
    pos = L.sinusoidal_positions(T, D, frames.device).to(frames.dtype)
    return frames + pos[None]


def encode(cfg: ModelConfig, params: Dict, frames: torch.Tensor,
           remat: bool = False) -> torch.Tensor:
    """frames (B, T_enc, D) stub embeddings -> the encoder output.
    ``remat``: each layer's activations are recomputed in the backward
    (``layers.remat``), as the reference's ``encode`` checkpoints its
    scan body under ``ctx.remat``."""
    x = frames_with_positions(frames)
    for p in params["enc_blocks"]:
        x = L.remat(enc_block, remat, cfg, p, x)
    return L.apply_norm(cfg, params["enc_norm"], x)


def _dec_block(cfg: ModelConfig, p: Dict, x: torch.Tensor,
               enc_out: torch.Tensor,
               cache: Optional[Dict[str, torch.Tensor]] = None,
               pos: Optional[int] = None,
               kv_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One decoder layer: causal self-attention, without a cache
    (training) or writing ``cache`` in place (a prefill at [0, T) when
    ``pos`` is None, else one token at ``pos``), cross-attention over
    ``enc_out``, the MLP."""
    h = L.apply_norm(cfg, p["ln1"], x)
    if cache is None:
        x = x + attn.attention_forward(cfg, p["self_attn"], h, causal=True)
    elif pos is None:
        x = x + attn.attention_prefill(cfg, p["self_attn"], h, None, cache)
    else:
        x = x + attn.attention_decode(cfg, p["self_attn"], h, pos, None,
                                      cache, kv_len)
    x = x + attn.cross_attention(cfg, p["cross_attn"],
                                 L.apply_norm(cfg, p["ln_x"], x), enc_out)
    return x + L.apply_mlp(cfg, p["ffn"], L.apply_norm(cfg, p["ln2"], x))


def decode_train(cfg: ModelConfig, params: Dict, tokens: torch.Tensor,
                 frames: torch.Tensor, remat: bool = False
                 ) -> Tuple[torch.Tensor, float]:
    """The teacher-forced training forward: encode ``frames`` (B, T_enc,
    D), then run the decoder over the tokens (B, T) embedded plus
    ``dec_pos[:T]``.  Returns (final hidden states (B, T, D), aux 0.0).
    ``remat`` recomputes each encoder and each decoder layer in the
    backward: the reference checkpoints the scan bodies of both
    ``encode`` and ``decode_train`` under ``ctx.remat``, so on the card
    every flash call of the forward (the encoder's, the decoder's causal
    self-attention and its cross-attention) runs twice a step."""
    enc_out = encode(cfg, params, frames, remat)
    T = tokens.shape[1]
    x = L.embed_tokens(params["embed"], tokens) + params["dec_pos"][None, :T]
    for p in params["dec_blocks"]:
        x = L.remat(_dec_block, remat, cfg, p, x, enc_out)
    return L.apply_norm(cfg, params["final_norm"], x), 0.0


def init_dec_caches(cfg: ModelConfig, batch: int, max_len: int,
                    dtype: torch.dtype = torch.float32,
                    device="cuda") -> Dict[str, torch.Tensor]:
    """Zero-filled stacked self-attention caches, k / v (L, B, max_len,
    KV, Dh)."""
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _layer_cache(caches: Dict[str, torch.Tensor],
                 i: int) -> Dict[str, torch.Tensor]:
    return {k: v[i] for k, v in caches.items()}


def prefill(cfg: ModelConfig, params: Dict, tokens: torch.Tensor,
            frames: torch.Tensor, caches: Dict[str, torch.Tensor]
            ) -> Tuple[torch.Tensor, Tuple, float]:
    """Encode ``frames``, then prefill the decoder's self-attention
    caches with ``tokens`` (B, T).  Returns (final hidden states (B, T,
    D), (enc_out, caches), aux 0.0)."""
    enc_out = encode(cfg, params, frames)
    T = tokens.shape[1]
    x = L.embed_tokens(params["embed"], tokens) + params["dec_pos"][None, :T]
    for i, p in enumerate(params["dec_blocks"]):
        x = _dec_block(cfg, p, x, enc_out, _layer_cache(caches, i))
    return L.apply_norm(cfg, params["final_norm"], x), (enc_out, caches), 0.0


def decode_step(cfg: ModelConfig, params: Dict, token: torch.Tensor,
                pos: int, state: Tuple) -> Tuple[torch.Tensor, Tuple]:
    """One decoder token (B, 1) at ``pos``; ``state`` = (enc_out,
    caches).  Returns (logits (B, 1, V), state)."""
    enc_out, caches = state
    x = L.embed_tokens(params["embed"], token) + params["dec_pos"][pos]
    kv_len = torch.full((x.shape[0],), pos + 1, dtype=torch.int32,
                        device=x.device)
    for i, p in enumerate(params["dec_blocks"]):
        x = _dec_block(cfg, p, x, enc_out, _layer_cache(caches, i), pos,
                       kv_len)
    x = L.apply_norm(cfg, params["final_norm"], x)
    return L.lm_logits(cfg, params["lm_head"], params["embed"], x), state
