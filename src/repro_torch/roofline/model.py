"""Roofline terms for the NVIDIA H100 SXM5 80GB HBM3 at 700 W; port of
``repro.roofline.model``.

  compute term    = FLOPs / (chips x the peak at the compute type:
                    989 TFLOP/s dense bf16 / fp16 on the tensor cores,
                    67 TFLOP/s float32 without TF32)
  memory term     = bytes / (chips x 3.35 TB/s HBM3)
  collective term = inter-node bytes / 50 GB/s (one NDR 400 Gb/s
                    InfiniBand port a GPU)
                  + intra-node bytes / 450 GB/s (NVLink, one direction)

The constants are the card's datasheet figures, not measurements.  The
reference has one link rate (a TPU's ICI link); on a host of
``GPUS_PER_NODE`` cards a collective whose group lies inside one node
moves at NVLink's rate and any other at InfiniBand's, so
``roofline_terms`` takes the intra-node share of the collective bytes as
one more keyword; at 0 (and bf16) its formula is the reference's with
``IB_BW`` in place of ``ICI_BW``.  The dry-run's counts are per device (rank 0's), so
the per-chip division is already done; the totals scale them back up.
The port runs float32 GEMMs in full float32 (PyTorch's default for
matmuls, which ``kernels.dispatch.disable_tf32`` keeps), on the CUDA
cores and not the tensor cores: ``roofline_terms`` prices FLOPs at the
peak of its ``compute_dtype``, a float32 step at ``PEAK_FLOPS_FP32``
and a bf16 one (every dry-run cell, train cells included, as the
reference's) at ``PEAK_FLOPS``.
MODEL_FLOPS = 6*N*D (dense) or 6*N_active*D (MoE) measures how much of
the counted compute is useful.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs import ShapeSpec
from repro_torch.models.config import ModelConfig

PEAK_FLOPS = 989e12          # dense bf16 / fp16 per GPU (tensor cores)
PEAK_FLOPS_FP32 = 67e12      # float32 per GPU, TF32 off (CUDA cores)
PEAK_FLOPS_BY_DTYPE = {torch.bfloat16: PEAK_FLOPS,
                       torch.float16: PEAK_FLOPS,
                       torch.float32: PEAK_FLOPS_FP32}
HBM_BW = 3.35e12             # bytes/s per GPU
HBM_BYTES = 80e9             # device memory per GPU
NVLINK_BW = 450e9            # bytes/s per GPU, one direction
IB_BW = 50e9                 # bytes/s per GPU: one NDR 400 Gb/s port
GPUS_PER_NODE = 8


def peak_flops(dtype: torch.dtype) -> float:
    """The card's peak FLOP/s for GEMMs in ``dtype``."""
    if dtype not in PEAK_FLOPS_BY_DTYPE:
        raise ValueError(f"no peak for {dtype}; have "
                         f"{list(PEAK_FLOPS_BY_DTYPE)}")
    return PEAK_FLOPS_BY_DTYPE[dtype]


def roofline_terms(*, flops_per_device: float, bytes_per_device: float,
                   collective_bytes_per_device: float, n_chips: int,
                   intra_node_bytes_per_device: float = 0.0,
                   compute_dtype: torch.dtype = torch.bfloat16) -> Dict:
    t_compute = flops_per_device / peak_flops(compute_dtype)
    t_memory = bytes_per_device / HBM_BW
    inter = collective_bytes_per_device - intra_node_bytes_per_device
    t_collective = inter / IB_BW + intra_node_bytes_per_device / NVLINK_BW
    terms = {"t_compute": t_compute, "t_memory": t_memory,
             "t_collective": t_collective}
    bound = max(terms, key=terms.get).replace("t_", "")
    t_crit = max(t_compute, t_memory, t_collective)
    return {
        **terms,
        "bound": bound,
        "t_critical": t_crit,
        "compute_fraction": t_compute / t_crit if t_crit else 0.0,
        "total_flops": flops_per_device * n_chips,
        "total_bytes": bytes_per_device * n_chips,
        "total_collective_bytes": collective_bytes_per_device * n_chips,
    }


def model_flops(cfg: ModelConfig, shape: ShapeSpec) -> float:
    """6*N*D useful-FLOPs estimate for the cell's workload."""
    n = cfg.active_param_count() if cfg.moe is not None else \
        cfg.param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    return 2.0 * n * shape.global_batch      # decode: one token per seq
