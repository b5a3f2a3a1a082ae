"""whisper-medium [audio] — enc-dec, conv frontend stubbed (arXiv:2212.04356).

24L decoder (+24L encoder) d_model=1024 16H d_ff=4096 vocab=51865.
Encoder consumes 1500 precomputed frame embeddings (30 s of audio after
the conv frontend, which is a stub here).  LayerNorm+GELU.

Copy of ``repro.configs.whisper_medium``.
"""
from repro_torch.models.config import (EncDecConfig, MixedResConfig, ModelConfig,
                                       reduced)

CONFIG = ModelConfig(
    name="whisper-medium",
    family="encdec",
    n_layers=24,                  # decoder layers
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=51865,
    norm="layernorm",
    activation="gelu",
    attention_bias=True,
    tied_embeddings=True,
    max_seq_len=32768,            # decode_32k cell; real model uses 448
    encdec=EncDecConfig(n_encoder_layers=24, encoder_seq_len=1500),
    mixed_res=MixedResConfig(enabled=True, window=10, downsample=2,
                             n_subsets=4),   # encoder frame pooling
)

REDUCED = reduced(CONFIG)
