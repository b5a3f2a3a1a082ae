"""deepseek-7b [dense] — llama-arch MHA (arXiv:2401.02954).

30L d_model=4096 32H (kv=32: full MHA) d_ff=11008 vocab=102400.

Copy of ``repro.configs.deepseek_7b``.
"""
from repro_torch.models.config import MixedResConfig, ModelConfig, reduced

CONFIG = ModelConfig(
    name="deepseek-7b",
    family="dense",
    n_layers=30,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    head_dim=128,
    d_ff=11008,
    vocab_size=102400,
    max_seq_len=131072,
    mixed_res=MixedResConfig(enabled=True, window=8, downsample=2,
                             n_subsets=4),
)

REDUCED = reduced(CONFIG)
