"""mistral-nemo-12b [dense] — 128k ctx (hf:mistralai/Mistral-Nemo-Base-2407).

40L d_model=5120 32H (GQA kv=8) d_ff=14336 vocab=131072, head_dim=128.

Copy of ``repro.configs.mistral_nemo_12b``.
"""
from repro_torch.models.config import MixedResConfig, ModelConfig, reduced

CONFIG = ModelConfig(
    name="mistral-nemo-12b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=131072,
    rope_theta=1000000.0,
    max_seq_len=131072,
    mixed_res=MixedResConfig(enabled=True, window=8, downsample=2,
                             n_subsets=4),
)

REDUCED = reduced(CONFIG)
