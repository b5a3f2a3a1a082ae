"""phi4-mini-3.8b [dense] — RoPE SwiGLU GQA (arXiv:2412.08905).

32L d_model=3072 24H (GQA kv=8) d_ff=8192 vocab=200064, head_dim=128,
partial rotary factor 0.75 (phi family trait).

Copy of ``repro.configs.phi4_mini_3p8b``.
"""
from repro_torch.models.config import MixedResConfig, ModelConfig, reduced

CONFIG = ModelConfig(
    name="phi4-mini-3.8b",
    family="dense",
    n_layers=32,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=200064,
    partial_rotary_factor=0.75,
    tied_embeddings=True,
    max_seq_len=131072,
    mixed_res=MixedResConfig(enabled=True, window=8, downsample=2,
                             n_subsets=4),
)

REDUCED = reduced(CONFIG)
