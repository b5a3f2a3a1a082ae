"""Architecture configs of the archs the port serves.

``get_config(name)`` returns the full published config and
``get_reduced(name)`` the CPU smoke-test variant, as in
``repro.configs``.  Archs the port does not serve yet raise; their order
of porting is in ``ROADMAP.md`` (Queue 1, "the other LM families").
"""
from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig, reduced

ARCH_MODULES = {
    "dbrx-132b": "repro_torch.configs.dbrx_132b",
    "deepseek-v2-236b": "repro_torch.configs.deepseek_v2_236b",
    "mamba2-370m": "repro_torch.configs.mamba2_370m",
    "qwen3-4b": "repro_torch.configs.qwen3_4b",
    "vitdet-l": "repro_torch.configs.vitdet_l",
    "zamba2-1.2b": "repro_torch.configs.zamba2_1p2b",
}


def _module(name: str):
    if name not in ARCH_MODULES:
        raise KeyError(f"arch {name!r} is not ported to repro_torch (have "
                       f"{sorted(ARCH_MODULES)}); ROADMAP.md lists the "
                       f"order in which the others follow")
    return importlib.import_module(ARCH_MODULES[name])


def get_config(name: str) -> ModelConfig:
    return _module(name).CONFIG


def get_reduced(name: str) -> ModelConfig:
    mod = _module(name)
    if hasattr(mod, "REDUCED"):
        return mod.REDUCED
    return reduced(mod.CONFIG)
