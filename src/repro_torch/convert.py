"""Parameters for the port: conversion of ViTDet, dense-, MoE- and VLM-LM,
SSM-LM, hybrid and whisper trees from the reference (the LMs'
scan-stacked layers become per-layer lists) and of the offload
estimator's MLP, and a seeded
PyTorch init of ViTDet with the reference's shapes and distributions
(the LMs' are in ``models``).

Port layout (plain dicts of tensors):

  patch_embed {w (p*p*3, D), b (D,)}     pos_emb (Hp, Wp, D)
  blocks[i]   {ln1, ln2 {w, b}, ffn {w_up, b_up, w_down, b_down},
               attn {w_qkv (D, 3D), b_qkv (3D,), w_o (D, D), b_o (D,)}}
  final_norm  {w, b}
  head        {lateral[3], smooth[3], tower, cls, box, ctr: {w OIHW, b}}
  pos_seq, pos_bank   derived position layouts (vit_backbone)

The reference keeps q, k and v weights apart and concatenates them on
every call; here they are concatenated once.  Its conv weights are HWIO;
``F.conv2d`` takes OIHW.

An int8 LM tree (``repro.quant.ptq.quantize_lm_params``: stacked
QuantTensors with per-(layer, column) scales) converts into per-layer
QuantTensors.  A compressed reference ViTDet tree
(``repro.quant.ptq.compress``) converts too:
its QuantTensor leaves are read by duck typing (``.q``, ``.scale``,
``.out_dtype``) into the port's ``quant.qtensor.QuantTensor``; q/k/v
fuse with ``concat_out`` semantics, conv codes turn HWIO -> OIHW with
their scales kept per output channel, and the position grid stays
quantized.
"""
from __future__ import annotations

import math
from types import SimpleNamespace
from typing import Dict, List, Mapping, Optional

import numpy as np
import torch

from repro_torch.core import vit_backbone as vb
from repro_torch.models.config import ModelConfig
from repro_torch.quant import qtensor as qt


def _is_quant(x) -> bool:
    return all(hasattr(x, a) for a in ("q", "scale", "out_dtype"))


# float leaves that keep their type; any other float leaf becomes float32
_HALF = {"float16": torch.float16, "bfloat16": torch.bfloat16}


def _t(x, device):
    """A float leaf -> a float32 tensor, or an fp16 / bf16 one where the
    leaf is half (bf16 arrives as ``ml_dtypes.bfloat16``, which torch
    cannot read: it goes through float32, exactly both ways); a
    QuantTensor leaf -> the port's QuantTensor (codes and scales byte for
    byte, its output type kept)."""
    if _is_quant(x):
        return qt.QuantTensor(
            torch.tensor(np.asarray(x.q, dtype=np.int8), device=device),
            torch.tensor(np.asarray(x.scale, dtype=np.float32).reshape(-1),
                         device=device), str(x.out_dtype))
    a = np.asarray(x)
    t = torch.tensor(a.astype(np.float32), device=device)
    return t.to(_HALF[a.dtype.name]) if a.dtype.name in _HALF else t


def _conv(p: Mapping, device) -> Dict:
    w = p["w"]
    if _is_quant(w):            # HWIO codes -> OIHW, scales per O
        q = np.ascontiguousarray(np.asarray(w.q, np.int8).transpose(3, 2, 0, 1))
        wt = qt.QuantTensor(
            torch.tensor(q, device=device),
            torch.tensor(np.asarray(w.scale, np.float32).reshape(-1),
                         device=device), str(w.out_dtype), axis=0)
    else:
        wt = _t(np.ascontiguousarray(np.asarray(w).transpose(3, 2, 0, 1)),
                device)
    return {"w": wt, "b": _t(p["b"], device)}


def _attn(p: Mapping, device) -> Dict:
    def cat(names, axis):
        return _t(np.concatenate([np.asarray(p[n]) for n in names], axis),
                  device)
    ws = [_t(p[n], device) for n in ("w_q", "w_k", "w_v")]
    return {"w_qkv": qt.concat_out(ws),
            "b_qkv": cat(("b_q", "b_k", "b_v"), 0),
            "w_o": _t(p["w_o"], device), "b_o": _t(p["b_o"], device)}


def params_from_jax(tree: Mapping, cfg: ModelConfig,
                    device: str = "cuda") -> Dict:
    """The reference's ``init_vitdet_params`` tree, float or compressed
    (numpy or array leaves, read through ``np.asarray``; QuantTensor
    leaves by duck typing) -> the port's parameters."""
    def norm(p):
        return {k: _t(v, device) for k, v in p.items()}

    head = tree["head"]
    params = {
        "patch_embed": {k: _t(v, device)
                        for k, v in tree["patch_embed"].items()},
        "pos_emb": _t(tree["pos_emb"], device),
        "blocks": [{"ln1": norm(b["ln1"]), "ln2": norm(b["ln2"]),
                    "attn": _attn(b["attn"], device),
                    "ffn": {k: _t(v, device) for k, v in b["ffn"].items()}}
                   for b in tree["blocks"]],
        "final_norm": norm(tree["final_norm"]),
        "head": {"lateral": [_conv(p, device) for p in head["lateral"]],
                 "smooth": [_conv(p, device) for p in head["smooth"]],
                 **{k: _conv(head[k], device)
                    for k in ("tower", "cls", "box", "ctr")}},
    }
    return vb.add_position_banks(cfg, params)


def init_vitdet_params(cfg: ModelConfig, generator: torch.Generator,
                       device: str = "cuda",
                       dtype: Optional[torch.dtype] = None) -> Dict:
    """Seeded init with the reference's shapes and distributions:
    truncated normal in (-2, 2) std / sqrt(fan_in) for dense and conv
    weights, normal std 0.02 for the position grid, zeros for biases
    (class bias -4, the focal prior), ones for norm scales.  Tensors are
    drawn on ``generator.device`` in float32 and each is moved to
    ``device`` and cast to ``dtype`` (None: float32) as it is drawn, as
    the reference's; the position layouts are derived from the cast
    grid."""
    meta = torch.device(device).type == "meta"     # shapes only
    gdev = "meta" if meta else generator.device
    v = cfg.vit
    D, F_, C = cfg.d_model, cfg.d_ff, v.out_channels
    part = vb.vit_partition(cfg)
    dt = dtype or torch.float32

    def trunc(shape, fan_in):
        t = torch.empty(shape, device=gdev)
        if not meta:
            torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0,
                                        generator=generator)
        return (t / math.sqrt(fan_in)).to(device, dt)

    def zeros(n, fill=0.0):
        return torch.full((n,), fill, device=device, dtype=dt)

    def dense(k, n):
        return trunc((k, n), k)

    def conv(k, cin, cout, bias=0.0):
        w = trunc((k, k, cin, cout), k * k * cin)       # HWIO, as drawn
        return {"w": w.permute(3, 2, 0, 1).contiguous(),
                "b": zeros(cout, bias)}

    def norm():
        return {"w": torch.ones(D, device=device, dtype=dt), "b": zeros(D)}

    def block():
        wq, wk, wv = dense(D, cfg.q_dim), dense(D, cfg.kv_dim), \
            dense(D, cfg.kv_dim)
        return {"ln1": norm(), "ln2": norm(),
                "attn": {"w_qkv": torch.cat([wq, wk, wv], dim=1),
                         "b_qkv": zeros(cfg.q_dim + 2 * cfg.kv_dim),
                         "w_o": dense(cfg.q_dim, D), "b_o": zeros(D)},
                "ffn": {"w_up": dense(D, F_), "b_up": zeros(F_),
                        "w_down": dense(F_, D), "b_down": zeros(D)}}

    patch_dim = v.patch_size * v.patch_size * 3
    pos = torch.empty((part.grid_h, part.grid_w, D), device=gdev)
    if not meta:
        torch.nn.init.normal_(pos, 0.0, 0.02, generator=generator)
    params = {
        "patch_embed": {"w": dense(patch_dim, D), "b": zeros(D)},
        "pos_emb": pos.to(device, dt),
        "blocks": [block() for _ in range(cfg.n_layers)],
        "final_norm": norm(),
        "head": {"lateral": [], "smooth": []},
    }
    for _ in range(3):
        params["head"]["lateral"].append(conv(1, D, C))
        params["head"]["smooth"].append(conv(3, C, C))
    params["head"].update(tower=conv(3, C, C),
                          cls=conv(3, C, v.n_classes, bias=-4.0),
                          box=conv(3, C, 4), ctr=conv(3, C, 1))
    return vb.add_position_banks(cfg, params)


def _layer(stack: Mapping, i: int) -> Dict:
    """Layer ``i`` of a scan-stacked subtree (leading (L, ...) axis); a
    stacked QuantTensor gives layer i's codes and (1, N) scales."""
    def take(v):
        if isinstance(v, Mapping):
            return _layer(v, i)
        if _is_quant(v):
            return SimpleNamespace(q=np.asarray(v.q)[i],
                                   scale=np.asarray(v.scale)[i],
                                   out_dtype=v.out_dtype)
        return np.asarray(v)[i]
    return {k: take(v) for k, v in stack.items()}


def _tensors(tree: Mapping, device) -> Dict:
    return {k: (_tensors(v, device) if isinstance(v, Mapping)
                else _t(v, device)) for k, v in tree.items()}


def _fused_attn(a: Mapping, device) -> Dict:
    """Reference LM attention weights -> the port's, ``w_q | w_k | w_v``
    (and their biases) fused into ``w_qkv`` (``b_qkv``); int8 weights
    (``quantize_lm_params``) fuse as ``qtensor.concat_out`` fuses them."""
    qkv = ("w_q", "w_k", "w_v")
    if _is_quant(a["w_q"]):         # codes and scales concatenate as is
        w_qkv = qt.concat_out([_t(a[n], device) for n in qkv])
    else:
        w_qkv = _t(np.concatenate([a[n] for n in qkv], axis=1), device)
    attn = {"w_qkv": w_qkv, "w_o": _t(a["w_o"], device)}
    for k in ("q_norm", "k_norm", "b_o"):
        if k in a:
            attn[k] = _t(a[k], device)
    if "b_q" in a:
        attn["b_qkv"] = _t(np.concatenate([a["b_q"], a["b_k"], a["b_v"]]),
                           device)
    return attn


def _head(tree: Mapping, device) -> Dict:
    return {"embed": _tensors(tree["embed"], device),
            "final_norm": _tensors(tree["final_norm"], device),
            "lm_head": _tensors(tree.get("lm_head", {}), device)}


def lm_params_from_jax(tree: Mapping, cfg: ModelConfig,
                       device: str = "cuda") -> Dict:
    """The reference's dense, MoE or VLM ``init_lm_params`` tree
    (scan-stacked ``dense_blocks`` then ``moe_blocks``, each with a
    leading (L, ...) axis; numpy or array leaves) -> the port's per-layer
    parameters: GQA ``w_q | w_k | w_v`` (and their biases) fused once into
    ``w_qkv`` (``b_qkv``), MLA's leaves as they are, a MoE layer's (L, E,
    D, F) expert slabs as its (E, D, F) slice, a VLM's ``projector`` as
    it is."""
    from repro_torch.models import transformer as tfm
    tfm.check_decoder(cfg)
    n_dense = tfm.n_dense_layers(cfg)
    blocks = []
    for i in range(cfg.n_layers):
        b = (_layer(tree["dense_blocks"], i) if i < n_dense
             else _layer(tree["moe_blocks"], i - n_dense))
        attn = (_tensors(b["attn"], device) if cfg.mla is not None
                else _fused_attn(b["attn"], device))
        blocks.append({"ln1": _tensors(b["ln1"], device),
                       "ln2": _tensors(b["ln2"], device),
                       "attn": attn,
                       "ffn": _tensors(b["ffn"], device)})
    out = dict(_head(tree, device), blocks=blocks)
    if "projector" in tree:
        out["projector"] = _tensors(tree["projector"], device)
    return out


def whisper_params_from_jax(tree: Mapping, cfg: ModelConfig,
                            device: str = "cuda") -> Dict:
    """The reference's ``init_whisper_params`` tree -> the port's
    (``models.whisper``): the scan-stacked encoder and decoder layers as
    per-layer lists, each self-attention's q / k / v weights and biases
    fused into ``w_qkv`` / ``b_qkv``, the cross-attention's weights as
    they are; ``dec_pos``, the norms and the (tied) token table."""
    def enc(i):
        b = _layer(tree["enc_blocks"], i)
        return {"ln1": _tensors(b["ln1"], device),
                "attn": _fused_attn(b["attn"], device),
                "ln2": _tensors(b["ln2"], device),
                "ffn": _tensors(b["ffn"], device)}

    def dec(i):
        b = _layer(tree["dec_blocks"], i)
        return {"ln1": _tensors(b["ln1"], device),
                "self_attn": _fused_attn(b["self_attn"], device),
                "ln_x": _tensors(b["ln_x"], device),
                "cross_attn": _tensors(b["cross_attn"], device),
                "ln2": _tensors(b["ln2"], device),
                "ffn": _tensors(b["ffn"], device)}

    return dict(_head(tree, device),
                enc_blocks=[enc(i) for i in
                            range(cfg.encdec.n_encoder_layers)],
                enc_norm=_tensors(tree["enc_norm"], device),
                dec_pos=_t(tree["dec_pos"], device),
                dec_blocks=[dec(i) for i in range(cfg.n_layers)])


def ssm_params_from_jax(tree: Mapping, cfg: ModelConfig,
                        device: str = "cuda") -> Dict:
    """The reference's ``init_ssm_params`` tree (``mamba_blocks`` stacked
    on a leading (L, ...) axis) -> the port's per-layer ``mamba_blocks``
    list."""
    return dict(_head(tree, device), mamba_blocks=[
        _tensors(_layer(tree["mamba_blocks"], i), device)
        for i in range(cfg.n_layers)])


def hybrid_params_from_jax(tree: Mapping, cfg: ModelConfig,
                           device: str = "cuda") -> Dict:
    """The reference's ``init_hybrid_params`` tree -> the port's: the
    mamba blocks as :func:`ssm_params_from_jax` converts them, plus the
    ``shared`` block with its q/k/v weights fused into ``w_qkv``."""
    sh = tree["shared"]
    shared = {"ln1": _tensors(sh["ln1"], device),
              "attn": _fused_attn(sh["attn"], device),
              "ln2": _tensors(sh["ln2"], device),
              "ffn": _tensors(sh["ffn"], device)}
    return dict(ssm_params_from_jax(tree, cfg, device), shared=shared)


def mlp_params_from_jax(params, device: str = "cuda") -> List[Dict]:
    """The reference ``MLPEstimator.params`` (a list of {w (in, out),
    b (out,)}) -> the same layers as tensors, for
    ``offload.estimator.MLPEstimator.load_params``."""
    return [{k: _t(p[k], device) for k in ("w", "b")} for p in params]
