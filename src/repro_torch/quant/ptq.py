"""Post-training compression of the ViTDet parameter tree; port of
``repro.quant.ptq``.

``QuantSpec`` names one point in the (weight dtype, activation dtype,
pruned heads) space; :func:`compress` applies it (head pruning first,
on the float weights, then quantization) and returns the re-packed
``(cfg, params, report)``.  The result is a drop-in parameter tree:
every linear use-site routes through ``quant.qtensor.matmul``, so
``ServerModel(cfg, params, quant=spec)`` is the whole deployment story.

"int8" makes per-output-channel symmetric QuantTensors of every linear
weight (fused QKV, w_o, MLP, patch embed, the position grid and the
detection-head convs); biases and norm affines stay float.  A half
``act_dtype`` ("fp16" / "bf16") casts every float leaf to it, and the
QuantTensors' outputs too (the ``int8+fp16`` lane); "fp16" / "bf16"
weights cast the whole tree, as in the reference.  The half trees run
through the kernels' half entry points (``kernels.dispatch``).
:func:`quantize_lm_params` is the LM serving lane's counterpart: the
attention and MLP projections of every block (a MoE layer's experts and
router stay float, as in the reference).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import vit_backbone as vb
from repro_torch.models.config import ModelConfig
from repro_torch.quant import prune
from repro_torch.quant import qtensor as qt

DTYPES = {"fp32": torch.float32, "fp16": torch.float16,
          "bf16": torch.bfloat16}


@dataclass(frozen=True)
class QuantSpec:
    """One deployment compression point."""
    weight_dtype: str = "int8"        # fp32 | fp16 | bf16 | int8
    act_dtype: str = "fp32"           # fp32 | fp16 | bf16
    prune_heads: int = 0              # heads dropped per layer

    def __post_init__(self):
        assert self.weight_dtype in ("fp32", "fp16", "bf16", "int8"), \
            self.weight_dtype
        assert self.act_dtype in DTYPES, self.act_dtype

    @property
    def act_torch(self) -> torch.dtype:
        return DTYPES[self.act_dtype]

    @property
    def name(self) -> str:
        n = self.weight_dtype
        if self.act_dtype != "fp32":
            n += f"+{self.act_dtype}"
        if self.prune_heads:
            n += f"-p{self.prune_heads}"
        return n


# the candidate ladder of the reference's calibration gate, most
# compressed first
DEFAULT_CANDIDATES: Tuple[QuantSpec, ...] = (
    QuantSpec("int8", "fp16", 1),
    QuantSpec("int8", "fp16", 0),
    QuantSpec("int8", "fp32", 0),
    QuantSpec("fp16", "fp16", 0),
)


def quantize_vitdet_params(params, out_dtype=torch.float32):
    """Per-output-channel int8 QuantTensors for every linear weight of a
    (derived-key-free) ViTDet tree; biases and norm affines pass
    through.  Conv weights are OIHW, quantized per output channel O."""
    def qz(w, axis=-1):
        return qt.quantize_weight(w, out_dtype=out_dtype, axis=axis)

    def conv(c):
        return {**c, "w": qz(c["w"], axis=0)}

    blocks = []
    for blk in params["blocks"]:
        a = dict(blk["attn"])
        for key in ("w_qkv", "w_o"):
            a[key] = qz(a[key])
        f = dict(blk["ffn"])
        for key in ("w_up", "w_down", "w_gate"):
            if key in f:
                f[key] = qz(f[key])
        blocks.append({**blk, "attn": a, "ffn": f})
    head = dict(params["head"])
    head["lateral"] = [conv(c) for c in head["lateral"]]
    head["smooth"] = [conv(c) for c in head["smooth"]]
    for key in ("tower", "cls", "box", "ctr"):
        head[key] = conv(head[key])
    return {
        **params,
        "patch_embed": {**params["patch_embed"],
                        "w": qz(params["patch_embed"]["w"])},
        "pos_emb": qz(params["pos_emb"]),
        "blocks": blocks,
        "head": head,
    }


# the projection weights of a port LM block (q/k/v fused into w_qkv)
LM_TARGETS = frozenset({"w_qkv", "w_o", "w_up", "w_down", "w_gate"})


INT8_MLA_REFUSAL = (
    "the reference's int8 LM lane cannot serve MLA attention or shared "
    "experts: it quantizes MLA's w_o and the shared experts' weights, then "
    "multiplies them with a plain @ (repro/models/attention.py:457, "
    "repro/models/moe.py:117-119) and raises TypeError at the first "
    "forward")


def check_lm_int8(cfg: ModelConfig) -> None:
    """Raise before any weight is drawn when ``cfg``'s int8 lane is one
    the reference cannot serve (:func:`quantize_lm_params`)."""
    if cfg.mla is not None or (cfg.moe is not None
                               and cfg.moe.n_shared_experts):
        raise NotImplementedError(f"{cfg.name}: {INT8_MLA_REFUSAL}")


def quantize_lm_params(params, out_dtype: torch.dtype = torch.float32):
    """The LM serving lane's tree walk: per-output-channel int8
    QuantTensors (outputs in ``out_dtype``, float32 by default, as the
    reference's) for the attention and MLP projections
    of every block (``LM_TARGETS``), which route through
    ``qtensor.matmul``; embeddings, norms, the LM head and the mamba
    layers' ``w_in`` / ``w_out`` (plain GEMMs in the reference too) pass
    through.  Per-column scales make the fused ``w_qkv``'s codes and
    scales those of ``w_q``, ``w_k`` and ``w_v`` quantized apart, and a
    layer's those of the reference's scan-stacked weight at that layer
    (its per-(layer, column) scales).

    A MoE layer's FFN (the dict that holds a ``router``) stays float: the
    reference quantizes only rank-2 and rank-3 leaves, and its expert
    stacks are 4-D (L, E, D, F).  The port selects by position, since its
    per-layer (E, D, F) slabs are 3-D and a rank test would take them.
    A tree with MLA attention or shared experts (deepseek-v2) raises: the
    reference's walk turns MLA's ``w_o`` and the shared experts into
    QuantTensors that its forward multiplies with a plain ``@``
    (``repro/models/attention.py:457``, ``repro/models/moe.py:117-119``),
    so its lane raises ``TypeError`` at the first forward."""
    for b in params.get("blocks", ()):
        if "w_dkv" in b.get("attn", {}) or "shared" in b.get("ffn", {}):
            raise NotImplementedError(
                f"quantize_lm_params: {INT8_MLA_REFUSAL}")

    def walk(node):
        if isinstance(node, dict):
            if "router" in node:          # a MoE FFN: router and slabs float
                return node
            return {k: (qt.quantize_weight(v, out_dtype=out_dtype)
                        if k in LM_TARGETS else walk(v))
                    for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        return node

    return walk(params)


def compress(cfg: ModelConfig, params, spec: QuantSpec,
             calib_frames: Optional[Sequence[np.ndarray]] = None,
             head_scores: Optional[np.ndarray] = None):
    """Apply ``spec`` to a float ViTDet tree.

    Returns ``(cfg, params, report)``: cfg shrinks ``n_heads`` when
    pruning, params carries QuantTensors (and its position layouts
    re-derived from the quantized grid), and the report records bytes
    before and after (the derived position layouts not counted, as the
    reference's tree has none), the ratio, and each layer's kept and
    dropped heads.  The position layouts are derived after the cast, from
    the half or dequantized grid (``vb.add_position_banks``: dequantize
    to the activation type, pool in float32, cast back, as the
    reference's forward does)."""
    params = vb.strip_derived(params)
    bytes0 = qt.tree_bytes(params)
    report: Dict = {"spec": spec.name, "weight_dtype": spec.weight_dtype,
                    "act_dtype": spec.act_dtype,
                    "prune_heads": spec.prune_heads, "bytes_fp32": bytes0}
    if spec.prune_heads:
        scores = head_scores
        if scores is None:
            scores = (prune.score_heads(cfg, vb.add_position_banks(
                cfg, dict(params)), calib_frames)
                if calib_frames is not None and len(calib_frames)
                else prune.w_o_head_norms(cfg, params))
        H = cfg.n_heads
        cfg, params, kept = prune.prune_heads(cfg, params,
                                              spec.prune_heads, scores)
        report["kept_heads"] = kept
        report["dropped_heads"] = [
            sorted(set(range(H)) - set(ks)) for ks in kept]
    adt = spec.act_torch
    if spec.weight_dtype == "int8":
        params = quantize_vitdet_params(params, out_dtype=adt)
        if adt != torch.float32:
            params = qt.cast_tree(params, adt)
    elif spec.weight_dtype in ("fp16", "bf16"):
        params = qt.cast_tree(params, DTYPES[spec.weight_dtype])
    elif adt != torch.float32:
        params = qt.cast_tree(params, adt)
    report["bytes"] = qt.tree_bytes(params)
    report["ratio"] = bytes0 / max(report["bytes"], 1)
    return cfg, vb.add_position_banks(cfg, params), report
