"""mamba2-370m [ssm] — SSD (state-space duality), arXiv:2405.21060; copy
of ``repro.configs.mamba2_370m``.

48L d_model=1024, attention-free, vocab=50280, ssm_state=128.
Official family hyperparameters: expand=2 (d_inner=2048), headdim=64
(=> 32 SSD heads), 1 B/C group, conv kernel 4.
"""
from repro_torch.models.config import (MixedResConfig, ModelConfig,
                                       SSMConfig, reduced)

CONFIG = ModelConfig(
    name="mamba2-370m",
    family="ssm",
    n_layers=48,
    d_model=1024,
    n_heads=32,              # SSD heads (d_inner / head_dim)
    n_kv_heads=32,
    head_dim=64,
    d_ff=0,                  # attention-free: no transformer MLP
    vocab_size=50280,
    tied_embeddings=True,
    max_seq_len=1048576,
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64,
                  n_groups=1, chunk_size=256),
    mixed_res=MixedResConfig(enabled=True, window=8, downsample=2,
                             n_subsets=4),
    subquadratic=True,
)

REDUCED = reduced(CONFIG)
