"""llava-next-mistral-7b [vlm] — anyres tiling
(hf:llava-hf/llava-v1.6-mistral-7b-hf).

Mistral-7B backbone: 32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000.
The vision frontend is a STUB: ``input_specs`` provides
precomputed patch embeddings (anyres: base 576 + 4 tiles x 576 = 2880
tokens at CLIP-L hidden 1024) which the projector maps into d_model.

This is the arch where the paper's technique is NATIVE: the anyres tiles
form the 2-D decision regions for mixed-resolution tokenization.

Copy of ``repro.configs.llava_next_mistral_7b``.
"""
from repro_torch.models.config import (MixedResConfig, ModelConfig,
                                       VLMConfig, reduced)

CONFIG = ModelConfig(
    name="llava-next-mistral-7b",
    family="vlm",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=32000,
    rope_theta=1000000.0,
    max_seq_len=131072,
    vlm=VLMConfig(n_image_tokens=2880, vision_hidden=1024),
    mixed_res=MixedResConfig(enabled=True, window=8, downsample=2,
                             n_subsets=4),
)

REDUCED = reduced(CONFIG)
