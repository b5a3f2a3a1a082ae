"""zamba2-1.2b [hybrid] — Mamba2 backbone + shared attention blocks
(arXiv:2411.15242); copy of ``repro.configs.zamba2_1p2b``.

38L d_model=2048 32H (kv=32) d_ff=8192 vocab=32000, ssm_state=64.
The shared transformer block (one set of attention + MLP weights reused
periodically) is applied every ``models.hybrid.SHARED_PERIOD`` mamba
layers.
"""
from repro_torch.models.config import (MixedResConfig, ModelConfig,
                                       SSMConfig, reduced)

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=32000,
    tied_embeddings=True,
    max_seq_len=1048576,
    ssm=SSMConfig(d_state=64, d_conv=4, expand=2, head_dim=64,
                  n_groups=1, chunk_size=256),
    mixed_res=MixedResConfig(enabled=True, window=8, downsample=2,
                             n_subsets=4),
    subquadratic=True,   # SSM decode state is O(1); shared-attn KV is sparse
)

REDUCED = reduced(CONFIG)
