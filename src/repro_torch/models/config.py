"""Unified model configuration (copy of ``repro.models.config``).

One frozen dataclass covers every architecture family of the JAX
package, with its analytic parameter counts.  Kept field for field so a
config built here describes the same model as its JAX twin.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 8
    top_k: int = 2
    n_shared_experts: int = 0          # deepseek-v2 style always-on experts
    d_ff_expert: int = 0               # per-expert hidden size
    first_dense_layers: int = 0        # leading layers that use a dense FFN
    d_ff_dense: int = 0                # hidden size of those dense FFNs
    capacity_factor: float = 1.25      # dispatch capacity (static shapes)
    router_aux_coef: float = 0.01      # load-balance aux loss weight


@dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V2 Multi-head Latent Attention."""
    kv_lora_rank: int = 512
    q_lora_rank: int = 1536
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class SSMConfig:
    """Mamba-2 SSD block."""
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64                 # P: SSD head dim
    n_groups: int = 1                  # B/C groups
    chunk_size: int = 256              # SSD chunk length
    dt_min: float = 0.001
    dt_max: float = 0.1


@dataclass(frozen=True)
class EncDecConfig:
    n_encoder_layers: int = 24
    encoder_seq_len: int = 1500        # whisper: 30 s -> 1500 frames
    frontend: str = "stub"             # modality frontend is a stub per spec


@dataclass(frozen=True)
class VLMConfig:
    n_image_tokens: int = 2880         # anyres: base 576 + 4 tiles * 576
    vision_hidden: int = 1024          # stubbed frontend embedding width
    frontend: str = "stub"


@dataclass(frozen=True)
class MixedResConfig:
    """Paper C1 knobs (2-D ViT native and 1-D sequence adaptation)."""
    enabled: bool = True
    window: int = 8                    # w: window size (patches or tokens)
    downsample: int = 2                # d: per-region downsample factor
    n_subsets: int = 4                 # N: backbone subsets (RP candidates)


@dataclass(frozen=True)
class ViTConfig:
    """ViTDet-style dense-prediction backbone (the paper's own arch)."""
    img_size: Tuple[int, int] = (1024, 1024)
    patch_size: int = 16
    window_size: int = 8
    n_subsets: int = 4                 # N subsets; RP after last window block
    out_channels: int = 256            # det-head pyramid width
    n_classes: int = 80


@dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "dense"   # dense | moe | ssm | hybrid | encdec | vlm | vit
    n_layers: int = 2
    d_model: int = 128
    n_heads: int = 4
    n_kv_heads: int = 4
    head_dim: int = 32
    d_ff: int = 256
    vocab_size: int = 1024

    # attention / embedding knobs
    qk_norm: bool = False
    rope_theta: float = 10000.0
    partial_rotary_factor: float = 1.0
    tied_embeddings: bool = False
    norm: str = "rmsnorm"              # rmsnorm | layernorm
    activation: str = "silu"           # silu (SwiGLU) | gelu (plain MLP)
    norm_eps: float = 1e-5
    max_seq_len: int = 131072
    attention_bias: bool = False

    # hybrid layout: e.g. zamba2 — 'm' = mamba block, 'A' = shared attn block
    layer_pattern: Optional[Tuple[str, ...]] = None

    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    encdec: Optional[EncDecConfig] = None
    vlm: Optional[VLMConfig] = None
    vit: Optional[ViTConfig] = None
    mixed_res: Optional[MixedResConfig] = None

    # long_500k policy: quadratic-attention archs cannot run 512k decode
    subquadratic: bool = False

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    def param_count(self) -> int:
        """Analytic parameter count (total, incl. all experts)."""
        from repro_torch.models.registry import count_params_analytic
        return count_params_analytic(self)

    def active_param_count(self) -> int:
        from repro_torch.models.registry import count_params_analytic
        return count_params_analytic(self, active_only=True)


def reduced(cfg: ModelConfig, **extra) -> ModelConfig:
    """A tiny same-family config for CPU smoke tests."""
    kw = dict(
        n_layers=min(cfg.n_layers, 2),
        d_model=64,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 4) if cfg.n_kv_heads < cfg.n_heads else 4,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        max_seq_len=512,
    )
    if cfg.moe is not None:
        kw["moe"] = dataclasses.replace(
            cfg.moe, n_experts=4, top_k=2, d_ff_expert=64, d_ff_dense=128,
            first_dense_layers=min(cfg.moe.first_dense_layers, 1))
    if cfg.mla is not None:
        kw["mla"] = MLAConfig(kv_lora_rank=32, q_lora_rank=48,
                              qk_nope_head_dim=16, qk_rope_head_dim=8,
                              v_head_dim=16)
    if cfg.ssm is not None:
        kw["ssm"] = dataclasses.replace(cfg.ssm, d_state=16, head_dim=16,
                                        chunk_size=32)
    if cfg.encdec is not None:
        kw["encdec"] = dataclasses.replace(cfg.encdec, n_encoder_layers=2,
                                           encoder_seq_len=64)
    if cfg.vlm is not None:
        kw["vlm"] = dataclasses.replace(cfg.vlm, n_image_tokens=16,
                                        vision_hidden=32)
    if cfg.vit is not None:
        kw["vit"] = dataclasses.replace(cfg.vit, img_size=(128, 128),
                                        window_size=2, n_subsets=2,
                                        out_channels=32, n_classes=8)
        kw["d_model"] = 64
        kw["n_layers"] = 4                 # 2 subsets of 2 blocks
        if cfg.mixed_res is not None:
            kw["mixed_res"] = dataclasses.replace(cfg.mixed_res, window=2,
                                                  n_subsets=2)
    if cfg.layer_pattern is not None:
        kw["layer_pattern"] = cfg.layer_pattern[:4]
        kw["n_layers"] = len(kw["layer_pattern"])
    kw.update(extra)
    return cfg.replace(**kw)
