"""deepseek-v2-236b [moe] — MLA kv_lora=512, 2 shared + 160 routed top-6
(arXiv:2405.04434); copy of ``repro.configs.deepseek_v2_236b``.

60L d_model=5120 128H (kv=128 via MLA) d_ff(expert)=1536 vocab=102400.
First layer uses a dense FFN (d_ff=12288) per the release.
"""
from repro_torch.models.config import (MLAConfig, MixedResConfig, MoEConfig,
                                       ModelConfig, reduced)

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    family="moe",
    n_layers=60,
    d_model=5120,
    n_heads=128,
    n_kv_heads=128,
    head_dim=128,
    d_ff=12288,
    vocab_size=102400,
    rope_theta=10000.0,
    max_seq_len=131072,
    moe=MoEConfig(n_experts=160, top_k=6, n_shared_experts=2,
                  d_ff_expert=1536, first_dense_layers=1, d_ff_dense=12288,
                  capacity_factor=1.25),
    mla=MLAConfig(kv_lora_rank=512, q_lora_rank=1536, qk_nope_head_dim=128,
                  qk_rope_head_dim=64, v_head_dim=128),
    mixed_res=MixedResConfig(enabled=True, window=8, downsample=2,
                             n_subsets=4),
)

REDUCED = reduced(CONFIG)
