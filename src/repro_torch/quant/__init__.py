"""Post-training quantization, head pruning and the calibration gate.

  qtensor    QuantTensor, the quant-aware matmul, tree utilities
  ptq        QuantSpec + compress(): the (weight dtype, act dtype,
             pruned heads) point applied to a ViTDet tree, and
             quantize_lm_params for the LM serving lane
  prune      head scoring (calibration-frame tap) + re-packing
  calibrate  the accuracy gate: the rendering-F1 delta bound on the
             calibration scenarios decides which point ships

``qtensor`` loads with the package (the models import it); ``ptq``,
``prune`` and ``calibrate`` import the backbone and the server, so their
names load on first use.
"""
import importlib

from repro_torch.quant.qtensor import (QuantTensor, asarray,  # noqa: F401
                                       cast_tree, concat_out, matmul,
                                       quantize_weight, tree_bytes)

_PTQ = ("DEFAULT_CANDIDATES", "DTYPES", "QuantSpec", "compress",
        "quantize_lm_params", "quantize_vitdet_params")

__all__ = [
    "QuantTensor", "QuantSpec", "DEFAULT_CANDIDATES", "DTYPES",
    "quantize_weight", "matmul", "asarray", "concat_out", "cast_tree",
    "tree_bytes", "compress", "quantize_vitdet_params",
    "quantize_lm_params", "prune", "calibrate",
]


def __getattr__(name):
    if name in _PTQ:
        return getattr(importlib.import_module("repro_torch.quant.ptq"), name)
    if name in ("ptq", "prune", "calibrate"):
        return importlib.import_module(f"repro_torch.quant.{name}")
    raise AttributeError(name)
