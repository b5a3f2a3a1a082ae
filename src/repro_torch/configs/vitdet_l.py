"""vitdet-l [vit] — the paper's own model (Li et al., ECCV 2022); copy of
``repro.configs.vitdet_l``.

ViT-L backbone: 24 blocks, d_model=1024, 16 heads, d_ff=4096, patch 16.
N=4 subsets of M=6 blocks; the last block of each subset uses global
attention, the rest window attention (window 8).

1024x1024 input -> 64x64 patch grid; window 8 and downsample 2 give
decision regions of r = w*d = 16x16 patches, i.e. a 4x4 decision grid.
"""
from repro_torch.models.config import (MixedResConfig, ModelConfig,
                                       ViTConfig, reduced)

CONFIG = ModelConfig(
    name="vitdet-l",
    family="vit",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=1,                 # unused for the vision task
    norm="layernorm",
    activation="gelu",
    attention_bias=True,
    max_seq_len=4096,             # 64x64 patch tokens
    vit=ViTConfig(img_size=(1024, 1024), patch_size=16, window_size=8,
                  n_subsets=4, out_channels=256, n_classes=80),
    mixed_res=MixedResConfig(enabled=True, window=8, downsample=2,
                             n_subsets=4),
)

REDUCED = reduced(CONFIG)

# System-simulation variant: same 4x4 decision-region grid as the full
# model (256px / 16 = 16x16 patches, window 2, d 2 -> region r=4 patches).
SIM = CONFIG.replace(
    n_layers=8,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    head_dim=16,
    d_ff=128,
    vit=CONFIG.vit.__class__(img_size=(256, 256), patch_size=16,
                             window_size=2, n_subsets=4, out_channels=32,
                             n_classes=8),
    mixed_res=CONFIG.mixed_res.__class__(enabled=True, window=2,
                                         downsample=2, n_subsets=4),
)
