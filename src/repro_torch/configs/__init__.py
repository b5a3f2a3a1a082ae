"""Architecture configs, one module per arch of ``repro.configs`` (the
ten LM archs and the paper's ViTDet-L), each a copy of the reference's.

``get_config(name)`` returns the full published config and
``get_reduced(name)`` the CPU smoke-test variant, as in
``repro.configs``; an unknown name raises ``KeyError``.  ``SHAPES`` are
the reference's assigned input shapes and ``cells()`` its 40 (arch x
shape) cells, long_500k only for sub-quadratic archs
(``shape_runnable``).
"""
from __future__ import annotations

import importlib
from dataclasses import dataclass
from typing import Dict, List, Tuple

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

ASSIGNED = [a for a in ARCH_MODULES if a != "vitdet-l"]


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


# ---------------------------------------------------------------------------
# assigned input shapes


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str            # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def shape_runnable(cfg: ModelConfig, shape: str) -> Tuple[bool, str]:
    """(runnable, reason).  long_500k needs sub-quadratic decode."""
    if shape == "long_500k" and not cfg.subquadratic:
        return False, ("pure full-attention arch: 512k-context decode is "
                       "quadratic-KV-bound; skipped per assignment")
    return True, ""


def cells() -> List[Tuple[str, str]]:
    """All 40 assigned (arch, shape) cells (including recorded skips)."""
    return [(a, s) for a in ASSIGNED for s in SHAPES]
