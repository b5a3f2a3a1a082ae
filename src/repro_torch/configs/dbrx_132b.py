"""dbrx-132b [moe] — 16 experts top-4, fine-grained
(hf:databricks/dbrx-base); copy of ``repro.configs.dbrx_132b``.

40L d_model=6144 48H (GQA kv=8) d_ff=10752 vocab=100352.
"""
from repro_torch.models.config import (MixedResConfig, MoEConfig,
                                       ModelConfig, reduced)

CONFIG = ModelConfig(
    name="dbrx-132b",
    family="moe",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=10752,
    vocab_size=100352,
    rope_theta=500000.0,
    max_seq_len=32768,
    moe=MoEConfig(n_experts=16, top_k=4, d_ff_expert=10752,
                  capacity_factor=1.25),
    mixed_res=MixedResConfig(enabled=True, window=8, downsample=2,
                             n_subsets=4),
)

REDUCED = reduced(CONFIG)
