"""qwen3-4b [dense] — qk_norm + GQA (hf:Qwen/Qwen3-8B family); copy of
``repro.configs.qwen3_4b``.

36L d_model=2560 32H (GQA kv=8) d_ff=9728 vocab=151936, head_dim=128.
"""
from repro_torch.models.config import MixedResConfig, ModelConfig, reduced

CONFIG = ModelConfig(
    name="qwen3-4b",
    family="dense",
    n_layers=36,
    d_model=2560,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=9728,
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1000000.0,
    tied_embeddings=True,
    max_seq_len=131072,
    mixed_res=MixedResConfig(enabled=True, window=8, downsample=2,
                             n_subsets=4),
)

REDUCED = reduced(CONFIG)
