"""Architecture configs, one module per arch of ``repro.configs`` (the
ten LM archs and the paper's ViTDet-L), each a copy of the reference's.

``get_config(name)`` returns the full published config and
``get_reduced(name)`` the CPU smoke-test variant, as in
``repro.configs``; an unknown name raises ``KeyError``.
"""
from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig, reduced

ARCH_MODULES = {
    "mamba2-370m": "repro_torch.configs.mamba2_370m",
    "qwen3-4b": "repro_torch.configs.qwen3_4b",
    "mistral-nemo-12b": "repro_torch.configs.mistral_nemo_12b",
    "phi4-mini-3.8b": "repro_torch.configs.phi4_mini_3p8b",
    "deepseek-7b": "repro_torch.configs.deepseek_7b",
    "llava-next-mistral-7b": "repro_torch.configs.llava_next_mistral_7b",
    "dbrx-132b": "repro_torch.configs.dbrx_132b",
    "deepseek-v2-236b": "repro_torch.configs.deepseek_v2_236b",
    "zamba2-1.2b": "repro_torch.configs.zamba2_1p2b",
    "whisper-medium": "repro_torch.configs.whisper_medium",
    "vitdet-l": "repro_torch.configs.vitdet_l",
}


def _module(name: str):
    if name not in ARCH_MODULES:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCH_MODULES)}")
    return importlib.import_module(ARCH_MODULES[name])


def get_config(name: str) -> ModelConfig:
    return _module(name).CONFIG


def get_reduced(name: str) -> ModelConfig:
    mod = _module(name)
    if hasattr(mod, "REDUCED"):
        return mod.REDUCED
    return reduced(mod.CONFIG)
