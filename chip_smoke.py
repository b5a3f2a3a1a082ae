#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Run from the root of a checkout, on a machine with an NVIDIA H100, the
CUDA toolkit and PyTorch built for CUDA:

    python3 chip_smoke.py

Phases; any failure exits non-zero and prints no result:

  1. print the card's name and power limit; build the nine CUDA kernels
     (eight libraries) from ``src/repro_torch/csrc`` (one nvcc per source,
     all at once);
  2. hold each kernel against its plain PyTorch version on the card, at
     the full-width ViTDet-L shapes the serving path gives it, and time
     the kernel alone, the plain version and, where one PyTorch call
     computes the same function, that call.  ``window_attention`` is
     checked to 1e-4 at the padded shape with ``win_valid``, the int8
     lane's 15-head call through views of a 2880-wide fused QKV, and
     the full-resolution shape (its kernels-line row).  ``int8_matmul``
     is checked bit-equal at the five GEMM shapes of the quantized model
     (M = 8192), each at both output tile widths (the other one timed
     for the record), and at two ragged ones (K = 100, which the wrapper
     zero-pads to 112, and the pruned 960 x 2880 at M = 1000); its
     numbers in the kernels line are sums over the five (the bound is
     the sum of each shape's bound, "by" the kind that bounds most of
     it).  Both print their achieved rates and share of their bound.
     The per-row activation quantization in front of each GEMM is
     timed on its own.  ``decode_attention`` is checked to 1e-5 at its
     kv_len edges (``DECODE_EDGES``), then at the Qwen3-4B serving shape
     (its kernels-line row), zamba2-1.2b's shared attention (G = 1, Dh =
     64) and a ragged 8192-key cache, each also timed cold: its launches
     rotate over enough caches to leave the 50 MB L2 (``cold_us``), as
     the 36 layers of a decode step do.  ``avg_pool`` is checked at its
     4-byte, chunked and wide paths (``POOL_CASES``) and must match the
     plain version exactly at the serving frame, also timed cold over
     four frames.  Every row's ``ms`` is host-clocked back-to-back
     relaunches (CUDA events), which the host's launch rate can bound for
     a short kernel; ``device_us`` is the kernel's own device time per
     launch from a ``torch.profiler`` trace of twenty relaunches (summed
     over the shapes for ``int8_matmul``, over the four kernels of a call
     for ``ssd_scan``).  ``flash_attention`` is checked to 1e-4, causal and
     not, at a causal-GQA T = 1000 and at every head width it builds (16,
     32, 64, 128; T and S off its 64-row tiles, S < T, GQA groups 1 and
     4), then at the ViT shape (its kernels-line row) and the LM prefill's
     causal GQA shapes (T = 128 and the mixed prefill's T = 96).  The
     three float32 tensor-core kernels (window, flash, ``ssd_scan``) are
     bounded by their bytes or by three TF32 products per product at the
     TF32 peak (3xTF32), whichever is larger;
  3. serve full-width ViTDet-L (24 blocks, D=1024, 1024x1024 frames,
     weights drawn from a seed) through ``ServerModel.infer_wave``: warm
     up, then a full-resolution wave that captures restoration-point
     tiles and a mixed FULL/LOW/REUSE wave at beta 2 that splices them.
     Detections must be finite, every kernel of the path must have
     launched during the two waves, and no grid key may first run after
     warmup.  One more wave of each kind is traced with
     ``torch.profiler``: device time by kernel family (GEMM, attention
     kernels, convolutions, ...) and the device's busy share of the
     wave; the full tables go to ``chiprun_out/profile_*.txt``.  Then a
     mixed wave at beta 0 (restore at input), which must launch
     ``nn_upsample`` and is traced the same way;
  4. one mixed wave of an 8-block full-width model on the card and,
     through the plain versions, on the CPU, at beta 2 and at beta 0:
     features (and captured tiles) agree to 1e-3 relative;
  5. the quantized ViTDet-L (int8 weights, one head of 16 pruned per
     block by the w_o-norm proxy): ``ServerModel(quant=QuantSpec("int8",
     "fp32", 1))`` serves a full-resolution and a mixed beta-2 wave as
     in phase 3; ``int8_matmul`` must launch and no key may first run
     after warmup; one traced wave splits device time into int8 GEMM,
     row quantization, attention, convolutions and elementwise;
  6. an 8-block full-width quantized wave, card vs CPU: features and
     tiles agree to 5% of their largest magnitude (a one-ulp difference
     upstream can flip an int8 code at a rounding tie; see
     ``tests/test_torch_quant.py``);
  7. serve full-width Qwen3-4B (36 layers, D=2560, GQA 32/8, weights
     from a seed) through ``repro_torch.serve.engine.ServeEngine``: warm
     up, then a plain wave and a mixed beta-2 wave (4 of 8 spans pooled)
     of 8 requests x 128 prompt tokens x 16 new tokens.  Every request
     must get 16 tokens, each wave must launch ``flash_attention`` 36
     times (one prefill) and ``decode_attention`` 36 times per decode
     step, and no key may first run after warmup.  Wall time (median of
     three), prefill and decode-step times, and one traced wave of each
     kind: device time by kernel family and the device's busy share
     inside the prefill and inside the decode steps;
  8. a 4-layer full-width Qwen3 on the card and, through the plain
     versions, on the CPU: prefill logits and 8 teacher-forced decode
     steps, plain and mixed at beta 2, agree to 1e-3 relative;
  9. ``ssd_scan`` against its plain version on the card, y and the final
     state within 1e-4 of their largest magnitudes: the mamba2-370m
     serving shape (x (8, 1024, 32, 64), B/C (8, 1024, 1, 128), chunk
     256; timed, its kernels-line row), the zamba2-1.2b shape (H = 64,
     N = 64), one 128-row chunk, a ragged T = 1000, two B/C groups,
     every (N, P slice) instance the library builds (N 16-128, P 16-128,
     G = 2, ragged T = 200 in chunks of 64) and the four shapes of the
     reference's ``test_ssd_scan``, and a state handoff through
     ``init_state``; the two serving shapes are timed, and traced for the
     device time of each of the scan's four kernels;
 10. serve full-width mamba2-370m (48 layers, D=1024, weights from a
     seed) through ``ServeEngine``: warm up, then plain waves of 8
     requests x 1024 prompt tokens x 16 new tokens.  Every request must
     get 16 tokens, a wave must launch ``ssd_scan`` 48 times (one
     prefill), and no key may first run after warmup.  Wall time
     (median of three), prefill and decode-step times, one traced wave;
     then ``mixed_forward_ssm`` at beta 2 with half the spans pooled
     (layers 0-23 at T_mix = 768; 48 ``ssd_scan`` launches) beside the
     plain ``forward_hidden``, both timed;
 11. the same for full-width zamba2-1.2b (38 mamba layers, D=2048, one
     shared attention + SwiGLU block applied 6 times): 38 ``ssd_scan``
     and 6 ``flash_attention`` launches a prefill, 6 ``decode_attention``
     launches a decode step;
 12. a 4-layer full-width mamba2 and a 6-layer full-width zamba2 (layer
     5 runs the shared block) on the card and, through the plain
     versions, on the CPU, at B = 2 and T = 512 (two chunks): prefill
     logits and 8 teacher-forced decode steps, and the mamba2's
     ``mixed_forward_ssm`` at beta 2, agree to 1e-3 relative;
 13. the single-client offloading system (paper §VI) on a full-width
     ViTDet-L server as ``launch/offload.py`` makes it (weights from
     seed 0, top-k 32, score threshold 0, B = 1, warmed over the plan
     space the policies can reach): anchor the inference-delay model to
     the card's median full-resolution ``infer``, profile ``walkS`` (8
     frames, the first 2 warm the motion model, x the 21 sample
     configs), fit the size and
     accuracy ``MLPEstimator``s on the card, then run ``Simulation`` for
     TrackB2B, ViTMAlis and ViTMAlis+Reuse on ``cycleS`` and
     ViTMAlis+Reuse on ``parkS`` (30 frames each, the 4G trace).  Per
     run: offloads, the server's wall time per offload, the modelled
     Eq. (2) terms, F1, payload size, REUSE offloads, client host ms per
     frame and launches per kernel.  No key may first run after warmup,
     every kernel of the offloads' plans must launch, ``parkS`` must
     reuse at least once, and TrackB2B on ``cycleS`` and ViTMAlis+Reuse
     on ``parkS`` (whose decisions follow the detections, with LOW and
     REUSE offloads at B = 1) through an 8-block full-width model on the
     card and on the CPU must make the same decisions with the same
     payloads and delay terms, detections equal as sets to 1e-3.
     Phase 2 also holds pack_pos, restore_gather and avg_pool exactly
     against their plain versions at this phase's B = 1 layouts.

Each serving path resets the launch counts just before it and reads them
just after.  The line before the last is a JSON object with every
kernel's numbers: its ``launches`` is the sum over the serving paths
that ran it, and ``launches_by_path`` gives each path's count (the
ViTDet-L waves of phase 3, its beta-0 wave, the int8 waves of phase 5,
the two Qwen3-4B waves of phase 7, one wave of each SSM model, the
``mixed_forward_ssm`` forward, and each simulation of phase 13).  The
last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import bisect
import json
import os
import statistics
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "chiprun_out"
SEED = 0
BETA = 2
B = 2                       # wave size of the serving phases (B bucket 2)
PEAK_BYTES = 3.35e12        # H100 SXM HBM3, bytes/s (NVIDIA data sheet)
PEAK_FP32 = 67e12           # H100 SXM float32 FMA outside tensor cores
PEAK_INT8 = 1979e12         # H100 SXM dense int8 tensor-core ops/s
PEAK_TF32 = 495e12          # H100 SXM dense TF32 tensor-core flops/s
TF32_PRODUCTS = 3           # 3xTF32: float32 accuracy from three products
# flash_attention's extra checks (B, T, S, H, KV, Dh): every head width the
# kernel builds, T and S off its 64-row tiles, S < T, GQA groups 1 and 4
FLASH_CASES = ((2, 130, 77, 4, 4, 16), (2, 200, 300, 8, 2, 32),
               (1, 333, 200, 16, 4, 64), (2, 200, 130, 8, 2, 128))
ATTN_TOL = 1e-4             # float32 attention, kernel vs plain, absolute
DECODE_TOL = 1e-5           # float32 decode attention, another sum order
LM_RTOL = 1e-3              # 4-layer Qwen3 logits, card vs CPU, relative
LM_B, LM_T, LM_NEW = 8, 128, 16      # the LM serving waves
LM_MAX_LEN = 152
LM_LONG_LENS = (8192, 6000, 4097, 2048, 513, 64, 1, 8192)
SSD_TOL = 1e-4              # SSD scan, kernel vs plain, of the largest value
SSM_B, SSM_T, SSM_NEW = 8, 1024, 16   # the SSM serving waves
SSD_NS = (16, 32, 64, 128)  # the state sizes ssd_scan.cu is built for
# the four kernels one ssd_scan call runs, in order
SSD_STAGES = ("ssd_scores_kernel", "ssd_states_kernel", "ssd_pass_kernel",
              "ssd_outputs_kernel")
SSD_REF_SHAPES = ((2, 128, 8, 1, 32, 16, 32), (1, 200, 16, 2, 64, 32, 64),
                  (2, 64, 4, 4, 16, 64, 32), (1, 96, 8, 1, 128, 64, 96))
POOL_TOL = 1e-6             # mean of four floats, absolute
# avg_pool's other paths (shape, d, base offset in floats): W * C = 30 and
# Wo * C = 9 (4-byte copies), a base 4 bytes off 16, a row of three
# chunks, 1024 channels (80 KB of shared memory), d = 4 at the frame
POOL_CASES = (((2, 10, 10, 3), 2, 0), ((2, 16, 12, 3), 4, 0),
              ((2, 64, 64, 3), 2, 1), ((1, 4, 4096, 3), 2, 0),
              ((1, 16, 16, 1024), 2, 0), ((2, 1024, 1024, 3), 4, 0))
# decode_attention's phase-2 shapes (B, S, H, KV, Dh) and kv_len: the
# Qwen3-4B serving step (its kernels-line row), zamba2-1.2b's shared
# attention (G = 1) a few steps into a wave, and a ragged long cache
DECODE_SHAPES = {
    "serving": ((LM_B, LM_MAX_LEN, 32, 8, 128), (LM_T + 1,) * LM_B),
    "zamba2": ((SSM_B, SSM_T + SSM_NEW, 32, 32, 64), (SSM_T + 8,) * SSM_B),
    "ragged": ((LM_B, LM_LONG_LENS[0], 32, 8, 128), LM_LONG_LENS)}
# decode_attention's kv_len edges (B, S, H, KV, Dh), kv_len: no key, one
# key, a split boundary, kv_len = S, runs wholly past kv_len, G = 1 over
# four kv heads a block and over one (KV = 6), G = 4 / 8 / 16
DECODE_EDGES = (((2, 256, 8, 2, 64), (0, 1)), ((2, 256, 8, 2, 64), (64, 256)),
                ((3, 300, 8, 8, 32), (5, 150, 299)),
                ((2, 200, 8, 1, 16), (33, 200)),
                ((2, 300, 16, 1, 32), (0, 300)),
                ((3, 777, 8, 4, 16), (1, 511, 777)),
                ((2, 200, 6, 6, 64), (77, 200)))
E2E_RTOL = 1e-3             # 8-block forward, card vs CPU, relative
OFFLOAD_FRAMES = 30         # frames of each phase-13 simulation
# phase 13's simulations: (policy, video), each against the 4G trace
OFFLOAD_RUNS = (("TrackB2B", "cycleS"), ("ViTMAlis", "cycleS"),
                ("ViTMAlis+Reuse", "cycleS"), ("ViTMAlis+Reuse", "parkS"))
# phase 13's card-vs-CPU simulations, (policy, video), and their frames
# (TrackB2B: two offloads in 24)
CROSS_RUNS = (("TrackB2B", "cycleS"), ("ViTMAlis+Reuse", "parkS"))
SIM_CROSS_FRAMES = 24
DET_RTOL = 1e-3             # its detections, card vs CPU, relative
QUANT_E2E_RTOL = 0.05       # 8-block quantized forward, card vs CPU
QUANT_SPEC = ("int8", "fp32", 1)
# the GEMMs of the quantized full-width model, (K, N): patch embed,
# fused QKV, w_o, MLP up, MLP down (15 heads of 64 after pruning)
GEMM_SHAPES = ((768, 1024), (1024, 2880), (960, 1024), (1024, 4096),
               (4096, 1024))
GEMM_M = 8192               # tokens of a full-resolution wave of two
# the kernels of the float32 full-res + mixed beta-2 serving path
FP32_PATH = ("window_attention", "flash_attention", "pack_pos",
             "restore_gather", "avg_pool")
# the kernels of a beta-0 (restore at input) wave
BETA0_PATH = ("window_attention", "flash_attention", "avg_pool",
              "nn_upsample")

# kernel name -> (source in the repo, the TPU kernel it replaces)
KERNEL_SOURCES = {
    "window_attention": ("src/repro_torch/csrc/window_attention.cu",
                         "src/repro/kernels/window_attention/kernel.py:82"),
    "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention/kernel.py:94"),
    "pack_pos": ("src/repro_torch/csrc/fused_serving.cu",
                 "src/repro/kernels/fused_serving/kernel.py:48"),
    "restore_gather": ("src/repro_torch/csrc/fused_serving.cu",
                       "src/repro/kernels/fused_serving/kernel.py:83"),
    "avg_pool": ("src/repro_torch/csrc/avg_pool.cu",
                 "src/repro/kernels/mixed_res_pool/kernel.py:46"),
    "nn_upsample": ("src/repro_torch/csrc/nn_upsample.cu",
                    "src/repro/kernels/mixed_res_pool/kernel.py:63"),
    "int8_matmul": ("src/repro_torch/csrc/int8_matmul.cu",
                    "src/repro/kernels/int8_matmul/kernel.py:52"),
    "decode_attention": ("src/repro_torch/csrc/decode_attention.cu",
                         "src/repro/kernels/decode_attention/kernel.py:81"),
    "ssd_scan": ("src/repro_torch/csrc/ssd_scan.cu",
                 "src/repro/kernels/ssd_scan/kernel.py:104"),
}
# kernel name -> the fragment of its CUDA kernels' names in a trace (the
# four kernels of one ssd_scan call share theirs)
DEVICE_NAMES = {
    "window_attention": "window_attention_kernel",
    "flash_attention": "flash_attention_kernel",
    "pack_pos": "pack_pos_kernel", "restore_gather": "restore_gather_kernel",
    "avg_pool": "avg_pool_kernel", "nn_upsample": "nn_upsample_kernel",
    "int8_matmul": "int8_matmul_kernel",
    "decode_attention": "decode_attention_kernel", "ssd_scan": "ssd_"}


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def say(*a) -> None:
    print(*a, flush=True)


def main() -> int:
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script; run "
              "it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke runs only on the GPU",
              file=sys.stderr)
        return 2
    try:
        result = run(torch)
    except Exception:                        # every phase failure
        traceback.print_exc()
        return 1
    say(json.dumps({"kernels": result}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


# ---------------------------------------------------------------------------


def run(torch):
    import torch.nn.functional as F

    from repro_torch.configs.vitdet_l import CONFIG
    from repro_torch.core import partition as pt
    from repro_torch.core import vit_backbone as vb
    from repro_torch.kernels import build, dispatch
    from repro_torch.kernels.flash_attention import ops as flash
    from repro_torch.kernels.fused_serving import ops as fused
    from repro_torch.kernels.int8_matmul import ops as i8
    from repro_torch.kernels.mixed_res_pool import ops as pool
    from repro_torch.kernels.window_attention import ops as win
    from repro_torch.quant import qtensor as qt

    # phase 1 -------------------------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    say(smi.stdout.strip())
    say(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    dispatch.disable_tf32()
    t0 = time.perf_counter()
    logs = build.build()
    say(f"build: {len(logs)} libraries in {time.perf_counter() - t0:.1f} s")
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke_build.log").write_text(
        "\n".join(f"== {k}\n{v}" for k, v in logs.items()))
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                say(f"  ptxas {name}: {line.strip()}")

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    cfg = CONFIG
    part = vb.vit_partition(cfg)
    nR, dd = part.n_regions, part.windows_per_full_region
    w2, D, H, Dh = part.window ** 2, cfg.d_model, cfg.n_heads, cfg.head_dim
    T = part.grid_h * part.grid_w
    plans = mixed_plans(pt, nR)
    lb = max(pt.length_bucket(pt.plan_n_windows(p, part),
                              pt.length_bucket_set(part)) for p in plans)
    arrays, _ = pt.stack_plan_layouts(
        [pt.plan_layout(p.states, lb, part) for p in plans])
    lay = {k: torch.as_tensor(v, device=dev) for k, v in arrays.items()}

    # phase 2 -------------------------------------------------------------
    say(f"phase 2: kernels vs plain versions at full width (B={B}, "
        f"T={T}, D={D}, H={H}x{Dh}, w2={w2}, length bucket {lb})")
    rows = {}

    def measure(name, kernel, plain_fn, lib_fn, nbytes, nops, peak):
        """Kernel alone (its latest launch relaunched), plain version and
        library call in ms, the bound in ms with what sets it, and the
        kernel's device microseconds per launch from a trace."""
        k_ms = timed(torch, lambda: kernel.relaunch(1))
        p_ms = timed(torch, plain_fn)
        l_ms = timed(torch, lib_fn) if lib_fn is not None else None
        d_us = device_us(torch, lambda: kernel.relaunch(1),
                         DEVICE_NAMES[name])
        return (k_ms, p_ms, l_ms) + bound(nbytes, nops, peak) + (d_us,)

    def record(name, err, kernel, plain_fn, lib_fn, nbytes, nops,
               peak=PEAK_FP32, **extra):
        put(name, err, *measure(name, kernel, plain_fn, lib_fn, nbytes,
                                nops, peak), **extra)

    def put(name, err, k_ms, p_ms, l_ms, bound_ms, bound_by, d_us, **extra):
        """One kernels-line row: ``ms`` is host-clocked back-to-back
        relaunches (CUDA events), ``device_us`` the kernel's own device
        time per launch (trace); ``extra`` adds keys such as ``cold_us``."""
        rows[name] = {"max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
                      "bound_ms": bound_ms, "bound_by": bound_by,
                      "library_ms": l_ms, "device_us": d_us, **extra}
        say(f"  {name}: max_abs_err={err:.3g} kernel_ms={k_ms:.4f} "
            f"device_us={d_us:.2f} plain_ms={p_ms:.4f} library_ms="
            f"{'null' if l_ms is None else f'{l_ms:.4f}'} "
            f"bound_ms={bound_ms:.4f} ({bound_by})"
            + "".join(f" {k}={v}" for k, v in extra.items()))

    def max_err(a, b):
        return float((a - b).abs().max())

    def rate(name, ms, nbytes):
        """Print a byte-bound kernel's achieved rate and share of its
        bound."""
        say(f"  {name}: {ms:.4f} ms, {nbytes / ms / 1e6:.1f} GB/s, "
            f"{nbytes / PEAK_BYTES * 1e3 / ms:.3f} of its byte bound")

    # avg_pool: its other paths first (4-byte copies where W * C, Wo * C
    # or the base is not 16-byte aligned, rows cut into chunks, wide
    # channels), then the raw frame, pooled before the low-resolution
    # embedding, which must match the plain version exactly
    for shape, d, off in POOL_CASES:
        flat = torch.rand(int(np.prod(shape)) + off, generator=gen,
                          device=dev)
        xs = flat[off:].view(shape)
        err = max_err(pool.avg_pool_cuda(xs, d), pool.avg_pool_plain(xs, d))
        check(err <= POOL_TOL, f"avg_pool {shape} d={d} offset {off}: max "
              f"error {err} > {POOL_TOL}")
    say(f"  avg_pool paths {POOL_CASES}: within {POOL_TOL}")
    frames = [torch.rand((B, *cfg.vit.img_size, 3), generator=gen,
                         device=dev) for _ in range(4)]
    x = frames[0]
    got, want = pool.avg_pool_cuda(x, 2), pool.avg_pool_plain(x, 2)
    err = max_err(got, want)
    check(torch.equal(got, want), f"avg_pool: serving frame differs from "
          f"plain by {err}")
    xc = x.permute(0, 3, 1, 2)
    cold = cold_us(torch, [lambda f=f: pool.avg_pool_cuda(f, 2)
                           for f in frames], DEVICE_NAMES["avg_pool"])
    pool.avg_pool_cuda(x, 2)                  # the row's relaunch is x's
    record("avg_pool", err, pool.KERNEL, lambda: pool.avg_pool_plain(x, 2),
           lambda: F.avg_pool2d(xc, 2),
           4 * (x.numel() + got.numel()), x.numel() + got.numel(),
           cold_us=cold)
    x1 = x[:1]                          # phase 13's single-client frame
    check(torch.equal(pool.avg_pool_cuda(x1, 2), pool.avg_pool_plain(x1, 2)),
          "avg_pool: B=1 serving frame differs from plain")
    del frames, x1

    # pack_pos: window bank + positional bank -> packed sequence
    nbank = nR * dd + nR
    bank = torch.randn((B, nbank, w2, D), generator=gen, device=dev)
    pos_bank = torch.randn((nbank, w2, D), generator=gen, device=dev)
    args = (bank, pos_bank, lay["win_src"], lay["nw"])
    got, want = fused.pack_pos_cuda(*args), fused.pack_pos_plain(*args)
    err = max_err(got, want)
    check(torch.equal(got, want), f"pack_pos: kernel differs from plain "
          f"by up to {err}")
    win_src, nw = arrays["win_src"], arrays["nw"]
    used = [set(win_src[b, :nw[b]].tolist()) for b in range(B)]
    win_bytes = 4 * w2 * D
    nbytes = (win_bytes * (sum(map(len, used)) + len(set().union(*used)))
              + 4 * got.numel() + 4 * (win_src.size + nw.size))
    record("pack_pos", err, fused.PACK_POS,
           lambda: fused.pack_pos_plain(*args), None, nbytes,
           int(nw.sum()) * w2 * D)

    # restore_gather: packed windows + REUSE tiles -> full-res sequence
    windows = torch.randn((B, lb, w2, D), generator=gen, device=dev)
    tiles = torch.randn((B, nR, dd, w2, D), generator=gen, device=dev)
    args = (windows, lay["out_src"], lay["out_map"], part.window,
            part.downsample, tiles)
    got, want = (fused.restore_gather_cuda(*args),
                 fused.restore_gather_plain(*args))
    err = max_err(got, want)
    check(torch.equal(got, want), f"restore_gather: kernel differs from "
          f"plain by up to {err}")
    out_src = arrays["out_src"]
    n_src = sum(len(set(out_src[b].tolist())) for b in range(B))
    nbytes = (win_bytes * n_src + 4 * got.numel()
              + 4 * (out_src.size * 2 + (dd + 1) * w2))
    record("restore_gather", err, fused.RESTORE,
           lambda: fused.restore_gather_plain(*args), None, nbytes, 0)

    # phase 13's single-client layouts (B = 1, twelve LOW regions, with
    # and without REUSE tiles spliced in), exact as above
    edges = pt.length_bucket_set(part)
    for one in single_plans(pt, nR):
        lb1 = pt.length_bucket(pt.plan_n_windows(one, part), edges)
        a1, _ = pt.stack_plan_layouts([pt.plan_layout(one.states, lb1,
                                                      part)])
        l1 = {k: torch.as_tensor(v, device=dev) for k, v in a1.items()}
        p_args = (bank[:1], pos_bank, l1["win_src"], l1["nw"])
        r_args = (torch.randn((1, lb1, w2, D), generator=gen, device=dev),
                  l1["out_src"], l1["out_map"], part.window,
                  part.downsample, tiles[:1] if one.n_reuse else None)
        check(torch.equal(fused.pack_pos_cuda(*p_args),
                          fused.pack_pos_plain(*p_args))
              and torch.equal(fused.restore_gather_cuda(*r_args),
                              fused.restore_gather_plain(*r_args)),
              f"pack_pos / restore_gather at B=1, plan {one.states} "
              f"(length bucket {lb1}): kernel differs from plain")
    say(f"  pack_pos, restore_gather, avg_pool at B=1 (phase 13's "
        f"layouts, {len(single_plans(pt, nR))} plans): equal to plain")

    # window attention: column views of a fused QKV product, as the
    # blocks hand them over; the padded shape with win_valid first
    def qkv_views(tokens):
        qkv = torch.randn((B, tokens, 3 * D), generator=gen, device=dev)
        return [t.reshape(B, tokens, H, Dh) for t in qkv.split(D, dim=-1)]

    qp, kp, vp = qkv_views(lb * w2)
    wv = lay["nw"]
    err_p = max_err(win.window_attention_cuda(qp, kp, vp, w2, wv),
                    win.window_attention_plain(qp, kp, vp, w2, wv))
    # the int8 lane's call: 15 heads, views of a 2880-wide fused QKV
    qkv = torch.randn((B, T, 3 * (H - 1) * Dh), generator=gen, device=dev)
    q15, k15, v15 = (t.reshape(B, T, H - 1, Dh)
                     for t in qkv.split((H - 1) * Dh, dim=-1))
    err_15 = max_err(win.window_attention_cuda(q15, k15, v15, w2),
                     win.window_attention_plain(q15, k15, v15, w2))
    ms_15 = timed(torch, lambda: win.KERNEL.relaunch(1))
    rate("window_attention H=15", ms_15, 16 * B * T * (H - 1) * Dh)
    del qkv, q15, k15, v15
    q, k, v = qkv_views(T)
    got = win.window_attention_cuda(q, k, v, w2)
    err = max(err_p, err_15,
              max_err(got, win.window_attention_plain(q, k, v, w2)))
    say(f"  window_attention errors: padded {err_p:.3g}, H=15 {err_15:.3g}, "
        f"full-res {err:.3g} (limit {ATTN_TOL})")
    check(err <= ATTN_TOL, f"window_attention: max error {err}")
    qw, kw, vw = (t.reshape(B, T // w2, w2, H, Dh).permute(0, 1, 3, 2, 4)
                  .reshape(-1, H, w2, Dh).contiguous() for t in (q, k, v))
    record("window_attention", err, win.KERNEL,
           lambda: win.window_attention_plain(q, k, v, w2),
           lambda: F.scaled_dot_product_attention(qw, kw, vw),
           4 * 4 * B * T * H * Dh,
           TF32_PRODUCTS * 4 * B * (T // w2) * H * w2 * w2 * Dh, PEAK_TF32)
    rate("window_attention", rows["window_attention"]["ms"],
         4 * 4 * B * T * H * Dh)

    # flash attention: the unmasked global blocks after restoration; a
    # causal GQA call and the extra cases first, each causal and not (the
    # kernel keeps both options)
    errs = {}
    for (fb, ft, fs, fh, fkv, fd) in ((1, 1000, 1000, H, 4, Dh),) \
            + FLASH_CASES:
        qs = torch.randn((fb, ft, fh, fd), generator=gen, device=dev)
        ks, vs = (torch.randn((fb, fs, fkv, fd), generator=gen, device=dev)
                  for _ in range(2))
        for causal in (True, False):
            errs[(fb, ft, fs, fh, fkv, fd, causal)] = max_err(
                flash.flash_attention_cuda(qs, ks, vs, causal=causal),
                flash.flash_attention_plain(qs, ks, vs, causal=causal))
    say(f"  flash_attention max errors by (B, T, S, H, KV, Dh, causal): "
        f"{ {k: float(f'{e:.3g}') for k, e in errs.items()} } (limit "
        f"{ATTN_TOL})")
    got = flash.flash_attention_cuda(q, k, v)
    err = max(max(errs.values()),
              max_err(got, flash.flash_attention_plain(q, k, v)))
    check(err <= ATTN_TOL, f"flash_attention: max error {err}")
    qf, kf, vf = (t.permute(0, 2, 1, 3).contiguous() for t in (q, k, v))
    record("flash_attention", err, flash.KERNEL,
           lambda: flash.flash_attention_plain(q, k, v),
           lambda: F.scaled_dot_product_attention(qf, kf, vf),
           4 * 4 * B * T * H * Dh, TF32_PRODUCTS * 4 * B * H * T * T * Dh,
           PEAK_TF32)
    del bank, pos_bank, windows, tiles, q, k, v, qw, kw, vw, qf, kf, vf
    torch.cuda.empty_cache()
    lm_kernels = lm_kernel_checks(torch, F, flash, dev, gen, put)

    # nn_upsample: the LOW windows of a beta-0 wave, (B * nR, w, w, D)
    x = torch.randn((B * nR, part.window, part.window, D), generator=gen,
                    device=dev)
    got, want = pool.nn_upsample_cuda(x, 2), pool.nn_upsample_plain(x, 2)
    check(torch.equal(got, want), "nn_upsample: kernel differs from plain")
    xc = x.permute(0, 3, 1, 2)
    record("nn_upsample", 0.0, pool.UPSAMPLE,
           lambda: pool.nn_upsample_plain(x, 2),
           lambda: F.interpolate(xc, scale_factor=2, mode="nearest"),
           4 * (x.numel() + got.numel()), 0)

    # int8_matmul: the quantized model's GEMMs, bit-equal; then a ragged
    # shape that masks M, N and K
    gemm = gemm_checks(torch, i8, qt, dev, gen, cfg.n_layers)
    by = {b: sum(r["bound_ms"] for r in gemm if r["bound_by"] == b)
          for b in ("bytes", "operations")}
    put("int8_matmul", 0.0, *(sum(r[k] for r in gemm)
                              for k in ("ms", "plain_ms", "library_ms",
                                        "bound_ms")),
        max(by, key=by.get), sum(r["device_us"] for r in gemm))
    del x, got, want
    torch.cuda.empty_cache()

    # each serving path's launch counts, reset just before it and read
    # just after: kernel -> {path: launches}
    by_path = {name: {} for name in KERNEL_SOURCES}

    def count(path, launches):
        for name, n in launches.items():
            if n:
                by_path[name][path] = n

    # phase 3 -------------------------------------------------------------
    launches, b0_launches, lat = serve(torch, cfg, dev, gen, plans, pt)
    count("vitdet-l", launches)
    count("vitdet-l beta 0", b0_launches)

    # phase 4 -------------------------------------------------------------
    cross_check(torch, cfg.replace(n_layers=8), dev, plans, pt, vb)

    # phase 5 -------------------------------------------------------------
    qlaunches, qlat = serve_quant(torch, cfg, dev, gen, plans, pt, qt)
    count("vitdet-l int8", qlaunches)
    lat["quant"] = qlat

    # phase 6 -------------------------------------------------------------
    quant_cross_check(torch, cfg.replace(n_layers=8), dev, plans, pt, vb)

    # phase 7 -------------------------------------------------------------
    from repro_torch.configs.qwen3_4b import CONFIG as QWEN
    lm_launches, lat["lm"] = serve_lm(torch, QWEN, dev)
    count("qwen3-4b", lm_launches)
    lat["lm"]["kernels"] = lm_kernels

    # phase 8 -------------------------------------------------------------
    lat["lm"]["card_vs_cpu"] = lm_cross_check(torch, QWEN.replace(n_layers=4),
                                              dev)

    # phase 9 -------------------------------------------------------------
    from repro_torch.configs.mamba2_370m import CONFIG as MAMBA
    from repro_torch.configs.zamba2_1p2b import CONFIG as ZAMBA
    lat["ssm"] = {"kernels": ssd_kernel_checks(torch, dev, gen, put)}

    # phases 10 and 11 ------------------------------------------------------
    for phase, c in ((10, MAMBA), (11, ZAMBA)):
        ln, lat["ssm"][c.name] = serve_ssm(torch, c, dev, phase)
        count(c.name, ln)
    count("mamba2-370m mixed_forward_ssm", {"ssd_scan": lat["ssm"][
        MAMBA.name]["mixed_forward_ssm"]["ssd_scan_launches"]})

    # phase 12 ------------------------------------------------------------
    lat["ssm"]["card_vs_cpu"] = {
        c.name: lm_cross_check(torch, c, dev, phase=12, T=2 * 256)
        for c in (MAMBA.replace(n_layers=4), ZAMBA.replace(n_layers=6))}

    # phase 13 ------------------------------------------------------------
    lat["offload"] = serve_offload(torch, cfg, dev, count)

    out = []
    for name in KERNEL_SOURCES:
        src, replaces = KERNEL_SOURCES[name]
        r = rows[name]
        check(by_path[name], f"{name} launched on no serving path")
        out.append({"name": name, "route": "cuda", "source": src,
                    "replaces": replaces,
                    "launches": sum(by_path[name].values()),
                    "launches_by_path": by_path[name],
                    "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                    "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                    "bound_by": r["bound_by"],
                    "library_ms": r["library_ms"],
                    "device_us": r["device_us"],
                    **({"cold_us": r["cold_us"]} if "cold_us" in r else {})})
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(
        {"card": smi.stdout.strip(), "kernels": out, "waves": lat,
         "int8_gemm_shapes": gemm}, indent=1))
    return out


def gemm_checks(torch, i8, qt, dev, gen, n_layers):
    """int8_matmul kernel vs plain version, bit-equal, at the quantized
    model's GEMM shapes (timed: kernel, plain, ``torch._int_mm`` as the
    library yardstick, the fp32 ``torch.matmul`` of the same shape for
    context, and the row quantization of the GEMM's input) and at a
    ragged shape (checked only).  Returns the timed rows."""
    out = []
    for (M, K, N) in [(GEMM_M, K, N) for K, N in GEMM_SHAPES] + \
            [(1000, 100, 130), (1000, 960, 2880)]:
        xq = torch.randint(-127, 128, (M, K), generator=gen, device=dev,
                           dtype=torch.int32).to(torch.int8)
        wq = torch.randint(-127, 128, (N, K), generator=gen, device=dev,
                           dtype=torch.int32).to(torch.int8).t()
        sx = torch.rand(M, generator=gen, device=dev) * 0.02 + 1e-3
        sw = torch.rand(N, generator=gen, device=dev) * 0.02 + 1e-3
        got = i8.int8_matmul_cuda(xq, wq, sx, sw)
        want = i8.int8_matmul_plain(xq, wq, sx, sw)
        check(torch.equal(got, want), f"int8_matmul {M}x{K}x{N}: kernel "
              f"differs from plain by up to "
              f"{float((got - want).abs().max())}")
        if M != GEMM_M:
            say(f"  int8_matmul {M}x{K}x{N} (ragged): bit-equal")
            continue
        k_ms = timed(torch, lambda: i8.KERNEL.relaunch(1))
        d_us = device_us(torch, lambda: i8.KERNEL.relaunch(1),
                         DEVICE_NAMES["int8_matmul"])
        # the other output tile width, checked and timed for the record
        tile = i8.tile_n(N, K)
        chosen = i8.tile_n
        i8.tile_n = lambda n, k: 384 - tile
        try:
            other = i8.int8_matmul_cuda(xq, wq, sx, sw)
            check(torch.equal(other, want), f"int8_matmul {M}x{K}x{N}: the "
                  f"{384 - tile}-wide tile differs from plain")
            o_ms = timed(torch, lambda: i8.KERNEL.relaunch(1))
        finally:
            i8.tile_n = chosen
        p_ms = timed(torch, lambda: i8.int8_matmul_plain(xq, wq, sx, sw))
        l_ms = timed(torch, lambda: torch._int_mm(xq, wq))
        xf = torch.randn((M, K), generator=gen, device=dev)
        wf = torch.randn((K, N), generator=gen, device=dev)
        f_ms = timed(torch, lambda: torch.matmul(xf, wf))
        r_ms = timed(torch, lambda: qt._quantize_rows(xf))
        nbytes = M * K + K * N + 4 * (M + N) + 4 * M * N
        b_ms, b_by = bound(nbytes, 2 * M * N * K, PEAK_INT8)
        row = {"M": M, "K": K, "N": N, "ms": k_ms, "device_us": d_us,
               "plain_ms": p_ms,
               "library_ms": l_ms, "fp32_matmul_ms": f_ms,
               "row_quant_ms": r_ms, "bound_ms": b_ms, "bound_by": b_by,
               "tile_n": tile, f"ms_tile_{tile}": k_ms,
               f"ms_tile_{384 - tile}": o_ms}
        out.append(row)
        say(f"  int8_matmul {M}x{K}x{N}: bit-equal kernel_ms={k_ms:.4f} "
            f"(128x{tile} tiles; 128x{384 - tile}: {o_ms:.4f}) "
            f"plain_ms={p_ms:.4f} int_mm_ms={l_ms:.4f} "
            f"fp32_matmul_ms={f_ms:.4f} row_quant_ms={r_ms:.4f} "
            f"bound_ms={b_ms:.4f} ({b_by})")
        say(f"    {2 * M * N * K / k_ms / 1e9:.1f} TOPS, "
            f"{nbytes / k_ms / 1e6:.1f} GB/s, {b_ms / k_ms:.3f} of its bound")
        del xq, wq, xf, wf, got, want, other
    by_k = {r["K"]: r["row_quant_ms"] for r in out}
    block = sum(by_k[K] for K, _ in GEMM_SHAPES[1:])
    say(f"  row quantization per full-res wave ({n_layers} blocks x "
        f"{block:.4f} ms + patch embed {by_k[768]:.4f} ms): "
        f"{n_layers * block + by_k[768]:.4f} ms")
    return out


def bound(nbytes, nops, peak):
    """The least time of a function (ms): its bytes over the memory rate
    or its operations over ``peak``, whichever is larger, and which."""
    t_b, t_o = nbytes / PEAK_BYTES * 1e3, nops / peak * 1e3
    return max(t_b, t_o), "bytes" if t_b >= t_o else "operations"


def mixed_plans(pt, nR):
    """Two clients' FULL/LOW/REUSE plans (40 and 24 transmitted windows
    at ViTDet-L's 16 regions: length buckets 48 and 24)."""
    a = np.zeros(nR, np.int8)
    a[[1, 6, 9, 14]] = pt.LOW
    a[[2, 7, 12]] = pt.REUSE
    b = np.full(nR, pt.LOW, np.int8)
    b[[0, 5, 10, 15]] = pt.REUSE
    b[[3, 4, 11, 13]] = pt.FULL
    return [pt.RegionPlan(a), pt.RegionPlan(b)]


def single_plans(pt, nR):
    """One client's plans as the offloading policies send them at
    ViTDet-L's 16 regions: twelve LOW regions beside four FULL, two FULL
    and two REUSE, and four REUSE."""
    out = []
    for reuse in ((), (0, 5), (0, 5, 10, 15)):
        states = np.full(nR, pt.LOW, np.int8)
        states[[0, 5, 10, 15]] = pt.FULL
        states[list(reuse)] = pt.REUSE
        out.append(pt.RegionPlan(states))
    return out


def timed(torch, fn, target_ms: float = 100.0) -> float:
    """Mean milliseconds of ``fn()`` over back-to-back calls, by CUDA
    events around the whole run (warmed up first)."""
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    fn()
    t1.record()
    t1.synchronize()
    n = int(min(200, max(3, target_ms / max(t0.elapsed_time(t1), 1e-3))))
    t0.record()
    for _ in range(n):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / n


def serve(torch, cfg, dev, gen, plans, pt):
    from repro_torch import convert
    from repro_torch.kernels import dispatch
    from repro_torch.offload.simulator import ServerModel
    from repro_torch.serve.request import FeatureCache

    say(f"phase 3: ServerModel, {cfg.name} {cfg.n_layers} blocks D="
        f"{cfg.d_model}, {cfg.vit.img_size[0]}x{cfg.vit.img_size[1]} frames")
    t0 = time.perf_counter()
    params = convert.init_vitdet_params(cfg, gen, device=dev)
    srv = ServerModel(cfg, params, b_buckets=(1, 2), device=dev)
    b0_plans = beta0_plans(pt, srv.part.n_regions)
    space = srv.default_plan_space([BETA], reuse_edges=(0, 4),
                                   captures=(BETA,))
    space += [(int(p.n_low), 0, 0, 0) for p in b0_plans]   # beta-0 keys
    n_keys = srv.warmup(space, (1, 2))
    say(f"  warmup of {n_keys} grid keys {srv.stats.warmup_wall_s:.2f} s; "
        f"init + warmup {time.perf_counter() - t0:.2f} s; length buckets "
        f"{srv.length_edges}")
    nR = srv.part.n_regions
    full = [pt.RegionPlan(np.zeros(nR, np.int8)) for _ in range(B)]
    caches = [FeatureCache(nR) for _ in range(B)]
    frames = [torch.rand((B, *cfg.vit.img_size, 3), generator=gen,
                         device=dev) for _ in range(2)]

    def wave(i, wplans, **kw):
        t = time.perf_counter()
        pend = srv.infer_wave(frames[i], wplans, BETA, caches=caches,
                              frame_ids=[i] * B, defer=True, **kw)
        check(bool(torch.isfinite(pend.boxes).all()
                   and torch.isfinite(pend.scores).all()),
              f"wave {i}: non-finite detections")
        dets = pend.wait()
        return time.perf_counter() - t, dets

    dispatch.reset_launch_counts()          # the main path starts here
    t_full, d_full = wave(0, full, capture_beta=BETA)
    t_mixed, d_mixed = wave(1, plans)
    launches = dispatch.launch_counts()     # ... and ends here
    say(f"  launches {json.dumps(launches)}")
    check(all(launches[k] > 0 for k in FP32_PATH),
          f"a kernel of the serving path never launched: {launches}")
    check(srv.stats.steady_compiles == 0,
          f"steady-state first uses: {srv.stats.steady_compile_keys}")
    for c, p in zip(caches, plans):
        check(c.tiles is not None and bool(torch.isfinite(c.tiles).all()),
              "cached tiles missing or non-finite")
        check(bool((c.age[p.states == pt.REUSE] == 1).all()),
              "REUSE regions did not age")
    check(len(d_full) == B and len(d_mixed) == B, "wrong detection count")
    reps_full = [wave(0, full, capture_beta=BETA)[0] for _ in range(3)]
    reps_mixed = [wave(1, plans)[0] for _ in range(3)]
    lat = {"full_res_first_s": t_full, "mixed_first_s": t_mixed,
           "full_res_median_s": statistics.median(reps_full),
           "mixed_median_s": statistics.median(reps_mixed), "B": B,
           "beta": BETA}
    say(f"  waves (B={B}, host clock incl. decode): full-res first "
        f"{t_full:.4f} s median {lat['full_res_median_s']:.4f} s; mixed "
        f"beta {BETA} first {t_mixed:.4f} s median "
        f"{lat['mixed_median_s']:.4f} s")
    check(srv.stats.steady_compiles == 0, "steady-state first uses")
    lat["profile"] = {
        "full_res": profile_wave(torch, "full_res",
                                 lambda: wave(0, full, capture_beta=BETA),
                                 lat["full_res_median_s"]),
        "mixed": profile_wave(torch, "mixed", lambda: wave(1, plans),
                              lat["mixed_median_s"])}

    # the beta-0 path: restore at input, no REUSE, no capture
    def wave0():
        t = time.perf_counter()
        pend = srv.infer_wave(frames[1], b0_plans, 0, defer=True)
        check(bool(torch.isfinite(pend.scores).all()),
              "beta-0 wave: non-finite detections")
        check(len(pend.wait()) == B, "beta-0 wave: wrong detection count")
        return time.perf_counter() - t

    dispatch.reset_launch_counts()          # the beta-0 path starts here
    t0w = wave0()
    b0_launches = dispatch.launch_counts()  # ... and ends here
    say(f"  beta-0 launches {json.dumps(b0_launches)}")
    check(all(b0_launches[k] > 0 for k in BETA0_PATH),
          f"a kernel of the beta-0 path never launched: {b0_launches}")
    check(srv.stats.steady_compiles == 0, "beta-0: steady-state first use")
    lat["beta0_first_s"] = t0w
    lat["beta0_median_s"] = statistics.median(wave0() for _ in range(3))
    say(f"  beta-0 wave (B={B}): first {t0w:.4f} s median "
        f"{lat['beta0_median_s']:.4f} s")
    lat["profile"]["beta0"] = profile_wave(torch, "beta0", wave0,
                                           lat["beta0_median_s"])
    del srv, params
    torch.cuda.empty_cache()
    return launches, b0_launches, lat


def beta0_plans(pt, nR):
    """Two clients' FULL/LOW plans for a restore-at-input wave (no REUSE
    at beta 0): 4 and 8 LOW regions."""
    a = np.zeros(nR, np.int8)
    a[[1, 6, 9, 14]] = pt.LOW
    b = np.zeros(nR, np.int8)
    b[[0, 2, 5, 7, 8, 10, 13, 15]] = pt.LOW
    return [pt.RegionPlan(a), pt.RegionPlan(b)]


def serve_quant(torch, cfg, dev, gen, plans, pt, qt):
    from repro_torch import convert
    from repro_torch.kernels import dispatch
    from repro_torch.offload.simulator import ServerModel
    from repro_torch.quant.ptq import QuantSpec
    from repro_torch.serve.request import FeatureCache

    say(f"phase 5: quantized ServerModel {QUANT_SPEC}, {cfg.name} "
        f"{cfg.n_layers} blocks D={cfg.d_model}")
    t0 = time.perf_counter()
    params = convert.init_vitdet_params(cfg, gen, device=dev)
    srv = ServerModel(cfg, params, b_buckets=(1, 2), device=dev,
                      quant=QuantSpec(*QUANT_SPEC))
    del params
    torch.cuda.synchronize()
    rep = srv.quant_report
    say(f"  compressed in {time.perf_counter() - t0:.2f} s: "
        f"{rep['bytes_fp32']} -> {rep['bytes']} bytes, ratio "
        f"{rep['ratio']:.4f}, heads {cfg.n_heads} -> {srv.cfg.n_heads}")
    check(srv.cfg.n_heads == cfg.n_heads - QUANT_SPEC[2], "heads not pruned")
    space = srv.default_plan_space([BETA], reuse_edges=(0, 4),
                                   captures=(BETA,))
    n_keys = srv.warmup(space, (1, 2))
    say(f"  warmup of {n_keys} grid keys {srv.stats.warmup_wall_s:.2f} s")
    nR = srv.part.n_regions
    full = [pt.RegionPlan(np.zeros(nR, np.int8)) for _ in range(B)]
    caches = [FeatureCache(nR) for _ in range(B)]
    frames = [torch.rand((B, *cfg.vit.img_size, 3), generator=gen,
                         device=dev) for _ in range(2)]

    def wave(i, wplans, **kw):
        t = time.perf_counter()
        pend = srv.infer_wave(frames[i], wplans, BETA, caches=caches,
                              frame_ids=[i] * B, defer=True, **kw)
        check(bool(torch.isfinite(pend.boxes).all()
                   and torch.isfinite(pend.scores).all()),
              f"quantized wave {i}: non-finite detections")
        dets = pend.wait()
        check(len(dets) == B, "quantized wave: wrong detection count")
        return time.perf_counter() - t

    dispatch.reset_launch_counts()          # the quantized path starts
    t_full = wave(0, full, capture_beta=BETA)
    t_mixed = wave(1, plans)
    launches = dispatch.launch_counts()     # ... and ends here
    say(f"  launches {json.dumps(launches)}")
    check(launches["int8_matmul"] > 0, "the int8 GEMM never launched")
    check(all(launches[k] > 0 for k in FP32_PATH),
          f"a kernel of the quantized path never launched: {launches}")
    check(srv.stats.steady_compiles == 0,
          f"steady-state first uses: {srv.stats.steady_compile_keys}")
    for c in caches:
        check(c.tiles is not None and bool(torch.isfinite(c.tiles).all()),
              "quantized: cached tiles missing or non-finite")
    lat = {"full_res_first_s": t_full, "mixed_first_s": t_mixed,
           "full_res_median_s": statistics.median(
               wave(0, full, capture_beta=BETA) for _ in range(3)),
           "mixed_median_s": statistics.median(
               wave(1, plans) for _ in range(3)),
           "ratio": rep["ratio"], "bytes": rep["bytes"],
           "bytes_fp32": rep["bytes_fp32"], "heads": srv.cfg.n_heads}
    say(f"  quantized waves (B={B}): full-res first {t_full:.4f} s median "
        f"{lat['full_res_median_s']:.4f} s; mixed beta {BETA} first "
        f"{t_mixed:.4f} s median {lat['mixed_median_s']:.4f} s; "
        f"steady_compiles {srv.stats.steady_compiles}")
    check(srv.stats.steady_compiles == 0, "steady-state first uses")

    # trace one wave with the row quantization marked as its own family
    rows_fn = qt._quantize_rows

    def marked(x2):
        with torch.profiler.record_function("row_quant"):
            return rows_fn(x2)

    qt._quantize_rows = marked
    try:
        lat["profile"] = {
            "full_res": profile_wave(
                torch, "quant_full_res",
                lambda: wave(0, full, capture_beta=BETA),
                lat["full_res_median_s"], marks=("row_quant",)),
            "mixed": profile_wave(torch, "quant_mixed",
                                  lambda: wave(1, plans),
                                  lat["mixed_median_s"],
                                  marks=("row_quant",))}
    finally:
        qt._quantize_rows = rows_fn
    del srv
    torch.cuda.empty_cache()
    return launches, lat


# kernel-name fragments -> family, first match wins.  cuDNN's
# convolutions run as implicit GEMMs, FFTs and complex GEMMs, so their
# fragments come before the plain "gemm" of the cuBLAS/CUTLASS matmuls.
FAMILIES = (("window_attention", "window_attention"),
            ("flash_attention", "flash_attention"),
            ("decode_attention_kernel", "decode_attention"),
            ("ssd_scores_kernel", "ssd_scan"),
            ("ssd_states_kernel", "ssd_scan"),
            ("ssd_pass_kernel", "ssd_scan"),
            ("ssd_outputs_kernel", "ssd_scan"),
            ("pack_pos", "fused_serving"), ("restore_gather", "fused_serving"),
            ("avg_pool_kernel", "avg_pool"),
            ("nn_upsample_kernel", "nn_upsample"),
            ("int8_matmul_kernel", "int8_gemm"),
            ("fprop", "conv"), ("fft", "conv"), ("cf32", "conv"),
            ("region_transform", "conv"), ("cudnn", "conv"),
            ("gemm", "gemm"), ("gemv", "gemm"), ("splitK", "gemm"),
            ("softmax", "softmax"), ("reduce_kernel", "reduce"),
            ("elementwise", "elementwise"),
            ("Memcpy", "memcpy"), ("Memset", "memset"))


def profile_wave(torch, name, run_wave, wall_s, marks=()):
    """Trace one wave; device time by kernel family, and the share of the
    untraced wave's wall time (``wall_s``) the device was busy.  A kernel
    that runs inside a ``record_function`` range named in ``marks`` counts
    in a family of that name instead of its own, so the families still
    partition the device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run_wave()
    (OUT_DIR / f"profile_{name}.txt").write_text(prof.key_averages().table(
        sort_by="self_device_time_total", row_limit=60))
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    # the device-side spans of the marked ranges (one stream: a kernel
    # launched inside a range runs inside its span)
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in dev if e.name in marks)
    starts = [s for s, _, _ in spans]
    fam: dict = {}
    for e in dev:
        if e.name in marks or getattr(e, "is_user_annotation", False):
            continue
        ms = e.time_range.elapsed_us() / 1e3
        if ms <= 0:
            continue
        i = bisect.bisect_right(starts, e.time_range.start) - 1
        if i >= 0 and e.time_range.end <= spans[i][1]:
            key = spans[i][2]
        else:
            key = next((f for frag, f in FAMILIES if frag in e.name), "other")
        fam[key] = fam.get(key, 0.0) + ms
    busy = sum(fam.values())
    check(busy > 0, f"profile {name}: no device time traced")
    check(not marks or spans, f"profile {name}: no device span of {marks}")
    out = {"device_ms": busy, "busy_share": busy / (wall_s * 1e3),
           "families_ms": dict(sorted(fam.items(), key=lambda kv: -kv[1]))}
    say(f"  profile {name}: device {busy:.2f} ms of {wall_s * 1e3:.2f} ms "
        f"wall (busy {out['busy_share']:.3f}); " + ", ".join(
            f"{k} {v:.2f}" for k, v in out["families_ms"].items()))
    return out


def cross_check(torch, cfg, dev, plans, pt, vb):
    """One mixed wave of an 8-block full-width model on the card and on
    the CPU (plain versions), at beta 2 and at beta 0: features (and the
    beta-2 tiles) to E2E_RTOL."""
    from repro_torch import convert
    say(f"phase 4: {cfg.n_layers}-block full-width wave, card vs CPU")
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    p_gpu = convert.init_vitdet_params(cfg, gen, device=dev)
    compare_on_cpu(torch, cfg, dev, gen, p_gpu, plans, pt, vb, E2E_RTOL)
    compare_on_cpu(torch, cfg, dev, gen, p_gpu,
                   beta0_plans(pt, vb.vit_partition(cfg).n_regions), pt,
                   vb, E2E_RTOL, beta=0)


def quant_cross_check(torch, cfg, dev, plans, pt, vb):
    """One mixed beta-2 wave of an 8-block full-width quantized model on
    the card and on the CPU (plain versions): features and tiles to
    QUANT_E2E_RTOL, the measured error printed beside the limit."""
    from repro_torch import convert
    from repro_torch.quant.ptq import QuantSpec, compress
    say(f"phase 6: {cfg.n_layers}-block full-width quantized wave "
        f"{QUANT_SPEC}, card vs CPU")
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    p_gpu = convert.init_vitdet_params(cfg, gen, device=dev)
    qcfg, p_gpu, _ = compress(cfg, p_gpu, QuantSpec(*QUANT_SPEC))
    compare_on_cpu(torch, qcfg, dev, gen, p_gpu, plans, pt, vb,
                   QUANT_E2E_RTOL)


def compare_on_cpu(torch, cfg, dev, gen, p_gpu, plans, pt, vb, rtol,
                   beta=BETA):
    """Sample 0's plan of ``plans`` through forward_features on the card
    and on the CPU; every output within ``rtol`` of its largest value."""
    from repro_torch.offload.simulator import to_device
    torch.set_num_threads(os.cpu_count() or 1)
    part = vb.vit_partition(cfg)
    img = torch.rand((1, *cfg.vit.img_size, 3), generator=gen, device=dev)
    tiles = torch.randn((1, part.n_regions, part.windows_per_full_region,
                         part.tokens_low_region, cfg.d_model), generator=gen,
                        device=dev)
    lb = max(pt.length_bucket_set(part))
    lay = pt.plan_layout(plans[0].states, lb, part)
    layout = {k: torch.as_tensor(getattr(lay, k)[None], device=dev)
              for k in ("win_src", "win_dst", "low_src", "low_ids",
                        "out_src", "out_map")}
    layout["nw"] = torch.tensor([lay.nw], dtype=torch.int32, device=dev)

    def run_on(device, params):
        out = vb.forward_features(
            cfg, params, img.to(device), beta=beta,
            layout={k: v.to(device) for k, v in layout.items()},
            reuse_tiles=tiles.to(device) if beta else None,
            capture_beta=beta)
        return out if beta else (out,)

    got = run_on(dev, p_gpu)
    t0 = time.perf_counter()
    p_cpu = to_device(p_gpu, torch.device("cpu"))
    want = run_on("cpu", p_cpu)
    for what, g, c in zip(("features", "tiles"), got, want):
        g = g.cpu()
        check(bool(torch.isfinite(g).all()), f"{what}: non-finite on card")
        rel = float((g - c).abs().max() / c.abs().max())
        say(f"  beta {beta} {what} {tuple(g.shape)}: max relative error "
            f"{rel:.3g} (limit {rtol})")
        check(rel <= rtol, f"{what}: card vs CPU {rel} > {rtol}")
    say(f"  CPU forward {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# the single-client offloading system (Simulation on the ViTDet-L server)


def serve_offload(torch, cfg, dev, count):
    """Phase 13: a full-width server of the launcher's make, profile, fit
    the estimators and run the four simulations; then the card-vs-CPU
    simulation checks."""
    from repro_torch.data.network_traces import make_trace
    from repro_torch.kernels import dispatch
    from repro_torch.launch import offload as lo
    from repro_torch.offload.simulator import SIZE_SCALE

    t_phase = time.perf_counter()
    say(f"phase 13: offloading Simulation on {cfg.name} {cfg.n_layers} "
        f"blocks D={cfg.d_model}, {cfg.vit.img_size[0]}px frames")
    t0 = time.perf_counter()
    srv = lo.make_server(cfg, dev)
    part, patch = srv.part, cfg.vit.patch_size
    say(f"  init + warmup of the policies' {srv.stats.compiles} grid keys "
        f"(B=1, top-k 32, score threshold 0) {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    clips = {v: lo.video_with_gt(srv, v, OFFLOAD_FRAMES)
             for v in sorted({v for _, v in OFFLOAD_RUNS})}
    t_gt = time.perf_counter() - t0
    anchor = lo.median_infer_s(srv, clips["cycleS"][0][0])
    inf_delay = lo.delay_model(cfg, anchor)
    say(f"  clips + ground truth {t_gt:.1f} s; full-res B=1 infer median "
        f"{anchor * 1e3:.2f} ms (the delay model's anchor)")
    t0 = time.perf_counter()
    data = lo.build_profile_dataset(srv, part, patch)
    t_prof = time.perf_counter() - t0
    t0 = time.perf_counter()
    size_e, acc_e, metrics = lo.fit_estimators(data, dev)
    t_fit = time.perf_counter() - t0
    check(size_e.device.type == "cuda", "estimators not on the card")
    say(f"  profile: {len(data['X'])} samples in {t_prof:.1f} s; MLP fit "
        f"on the card {t_fit:.1f} s; held-out R2 size "
        f"{metrics['size']['R2']:.4f} acc {metrics['acc']['R2']:.4f}")
    trace = make_trace("4g", 0, duration_s=OFFLOAD_FRAMES // lo.FPS + 60)
    out = {"anchor_ms": anchor * 1e3,
           "profile_samples": len(data["X"]), "profile_s": t_prof,
           "fit_s": t_fit, "estimator_metrics": metrics, "runs": {}}
    for policy, video in OFFLOAD_RUNS:
        frames, gt = clips[video]
        pol = lo.make_policy(policy, size_e, acc_e, part, inf_delay)
        t0 = time.perf_counter()
        dispatch.reset_launch_counts()      # this simulation starts here
        sim, res = lo.run_policy(srv, frames, gt, trace, pol, part, patch,
                                 inf_delay, video)
        launches = dispatch.launch_counts()  # ... and ends here
        wall = time.perf_counter() - t0
        name = f"offload {policy} {video}"
        count(name, launches)
        jobs = sim.jobs
        check(len(jobs) > 0, f"{name}: no offload")
        check_offload_kernels(name, jobs, launches)
        sw = np.array([j["server_wall"] for j in jobs]) * 1e3
        s = res.summary()
        n = len(frames)
        rec = {
            "offloads": len(jobs), "wall_s": wall,
            "server_ms_median": float(np.median(sw)),
            "server_ms_p95": float(np.percentile(sw, 95)),
            # the server calls' share of the run's wall: at most the
            # card's busy share (the calls hold host decode too)
            "server_share": float(sw.sum()) / 1e3 / wall,
            "e2e_ms_median": s["median_e2e_latency"] * 1e3,
            "net_ms_median": s["median_net_delay"] * 1e3,
            "inf_ms_median": s["median_inf_delay"] * 1e3,
            "rendering_f1_median": s["median_rendering_f1"],
            "rendering_f1_mean": s["mean_rendering_f1"],
            "inference_f1_mean": s["mean_inference_f1"],
            "payload_kb_median": float(np.median(res.sizes)) / 1e3,
            "reuse_offloads": sum(1 for j in jobs if j["n_r"] > 0),
            "betas": sorted({j["beta"] for j in jobs}),
            "host_ms_per_frame": {
                k: sum(res.overhead.get(f"{k}_wall", [])) / n * 1e3
                for k in ("motion", "codec", "tracker")},
            "launches": {k: v for k, v in launches.items() if v}}
        out["runs"][name] = rec
        say(f"  {policy} on {video}: {rec['offloads']} offloads (betas "
            f"{rec['betas']}, {rec['reuse_offloads']} with REUSE), server "
            f"{rec['server_ms_median']:.2f} ms median / "
            f"{rec['server_ms_p95']:.2f} p95 a offload, "
            f"{rec['server_share']:.3f} of the run's wall; modelled e2e "
            f"{rec['e2e_ms_median']:.1f} net {rec['net_ms_median']:.1f} "
            f"inf {rec['inf_ms_median']:.1f} ms (medians); rendering F1 "
            f"{rec['rendering_f1_median']:.3f} median "
            f"{rec['rendering_f1_mean']:.3f} mean, inference F1 "
            f"{rec['inference_f1_mean']:.3f}; payload "
            f"{rec['payload_kb_median']:.1f} kB median (x{SIZE_SCALE:.2f} "
            "of the codec's bytes); host ms/frame " + ", ".join(
                f"{k} {v:.2f}" for k, v in rec["host_ms_per_frame"].items())
            + f"; {wall:.1f} s")
        say(f"    launches {json.dumps(rec['launches'])}")
        if not any(j["beta"] == 0 and j["n_d"] for j in jobs):
            say("    nn_upsample: not reached (no LOW region at beta 0)")
    check(srv.stats.steady_compiles == 0,
          f"steady-state first uses: {srv.stats.steady_compile_keys}")
    park = out["runs"]["offload ViTMAlis+Reuse parkS"]
    check(park["reuse_offloads"] > 0, "REUSE never fired on parkS")
    steady = srv.stats.steady_compiles
    del srv
    torch.cuda.empty_cache()
    out["card_vs_cpu"] = offload_cross_check(
        torch, cfg.replace(n_layers=8), dev, clips, inf_delay, size_e, acc_e)
    out["phase_s"] = time.perf_counter() - t_phase
    say(f"  phase 13: {out['phase_s']:.1f} s; steady first uses {steady}")
    return out


def check_offload_kernels(name, jobs, launches):
    """Every kernel the offloads' plans run launched in the run: the
    attention kernels always, the packed lane's three at beta >= 1 with
    LOW or REUSE regions, the restore-at-input pair at beta 0 with LOW
    regions."""
    mixed = [j for j in jobs if j["n_d"] or j["n_r"]]
    want = {"window_attention", "flash_attention"}
    if any(j["beta"] >= 1 for j in mixed):
        want |= set(FP32_PATH)
    if any(j["beta"] == 0 for j in mixed):
        want |= set(BETA0_PATH)
    check(all(launches[k] > 0 for k in want),
          f"{name}: a kernel of its offloads never launched: {launches}")


def offload_cross_check(torch, cfg, dev, clips, inf_delay, size_e, acc_e):
    """Each of CROSS_RUNS through an 8-block full-width server on the card
    and on the CPU (plain versions), on the same parameters, frames,
    ground truth (the card's), trace and estimators: the same offloads,
    decisions (mask, beta, plan states, capture point), payloads and
    Eq. (2) terms; detections equal as sets to DET_RTOL.  ViTMAlis+Reuse
    on parkS decides from the detections (the tracker's rho) and sends
    LOW and REUSE offloads at B=1, so the kernels of the simulations'
    mixed offloads are held against their plain versions here."""
    from repro_torch import convert
    from repro_torch.data.network_traces import make_trace
    from repro_torch.kernels import dispatch
    from repro_torch.launch import offload as lo
    from repro_torch.offload.simulator import ServerModel, to_device

    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    params = convert.init_vitdet_params(cfg, gen, device=dev)
    kw = dict(top_k=32, score_thresh=0.0, b_buckets=(1,))
    gpu = ServerModel(cfg, params, device=dev, **kw)
    cpu = ServerModel(cfg, to_device(params, torch.device("cpu")),
                      device="cpu", **kw)
    part, patch = gpu.part, cfg.vit.patch_size
    trace = make_trace("4g", 0, duration_s=60)
    out = {}
    for policy, video in CROSS_RUNS:
        frames = clips[video][0][:SIM_CROSS_FRAMES]
        say(f"  card vs CPU: {policy} on {video}, {cfg.n_layers}-block "
            f"full-width model, {len(frames)} frames")
        gt = [gpu.infer(f) for f in frames]
        t0 = time.perf_counter()
        dispatch.reset_launch_counts()
        sg = lo.run_policy(gpu, frames, gt, trace, lo.make_policy(
            policy, size_e, acc_e, part, inf_delay), part, patch,
            inf_delay, video)[0]
        launches = dispatch.launch_counts()
        sc = lo.run_policy(cpu, frames, gt, trace, lo.make_policy(
            policy, size_e, acc_e, part, inf_delay), part, patch,
            inf_delay, video)[0]
        t_run = time.perf_counter() - t0
        jg, jc = sg.jobs, sc.jobs
        check(len(jg) == len(jc) > 0, f"offloads {len(jg)} vs {len(jc)}")
        check_offload_kernels(f"card vs CPU {policy}", jg, launches)
        worst = 0.0
        for a, b in zip(jg, jc):
            for k in ("frame", "n_d", "beta", "n_r", "capture_beta", "size",
                      "t_enc", "t_up", "t_dec", "t_inf", "rtt", "e2e",
                      "parts"):
                check(a[k] == b[k], f"{policy} offload at frame "
                      f"{a['frame']}: {k} {a[k]} vs {b[k]}")
            check(np.array_equal(a["mask"], b["mask"])
                  and np.array_equal(a["plan"].states, b["plan"].states),
                  f"{policy} offload at frame {a['frame']}: plans differ")
            worst = max(worst, match_dets(a["dets"], b["dets"]))
        n_reuse = sum(1 for j in jg if j["n_r"] > 0)
        if "Reuse" in policy:
            check(n_reuse > 0, f"card vs CPU {policy}: REUSE never fired")
        shown = [(j["frame"], j["n_d"], j["n_r"], j["beta"]) for j in jg]
        say(f"    {len(jg)} offloads (frame, n_low, n_reuse, beta) {shown}: "
            f"decisions, payloads and delay terms equal; detections within "
            f"{worst:.3g} relative (limit {DET_RTOL}); card launches "
            f"{json.dumps({k: v for k, v in launches.items() if v})}; both "
            f"runs {t_run:.1f} s")
        out[f"{policy} {video}"] = {
            "offloads": len(jg), "reuse_offloads": n_reuse,
            "det_rel_err": worst, "s": t_run}
    del gpu, cpu, params
    torch.cuda.empty_cache()
    return out


def match_dets(got, want) -> float:
    """Greedy set match of two top-k detection lists: box coordinates
    within DET_RTOL of max(|coordinate|, 1 px), scores within DET_RTOL
    relative.  Unmatched detections must lie at the top-k cut (a near-tie
    there may swap).  Returns the largest matched difference."""
    check(len(got) == len(want), f"{len(got)} vs {len(want)} detections")
    left, worst, extra = list(want), 0.0, []
    for g in got:
        hit = None
        for w in left:
            a = np.array([*g["box"], g["score"]])
            b = np.array([*w["box"], w["score"]])
            scale = np.maximum(np.abs(b), [1.0] * 4 + [1e-12])
            err = float((np.abs(a - b) / scale).max())
            if w["cls"] == g["cls"] and err <= DET_RTOL:
                hit = (w, err)
                break
        if hit is None:
            extra.append(g)
        else:
            left.remove(hit[0])
            worst = max(worst, hit[1])
    cut = min(d["score"] for d in want)
    for d in extra + left:
        check(abs(d["score"] - cut) <= DET_RTOL * cut,
              f"unmatched detection {d} away from the top-k cut {cut}")
    return worst


# ---------------------------------------------------------------------------
# the LM serving lane (Qwen3-4B through ServeEngine)


def lm_kernel_checks(torch, F, flash, dev, gen, put):
    """Phase 2 for the LM lane: ``decode_attention`` against its plain
    version at the serving shape (its kernels-line row, through ``put``)
    and at a ragged long cache; ``flash_attention`` at the LM prefill's
    causal GQA shapes.  Returns the extra rows."""
    from repro_torch.kernels.decode_attention import ops as dec
    from repro_torch.configs.qwen3_4b import CONFIG as QWEN
    H, KV, Dh = QWEN.n_heads, QWEN.n_kv_heads, QWEN.head_dim
    extra = {}

    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def decode_case(name):
        """One of DECODE_SHAPES: checked, timed warm (relaunches: host
        clock and device time) and cold (rotating over caches that leave
        the L2), beside the plain version and SDPA."""
        (b, S, h, kv, dh), lens = DECODE_SHAPES[name]
        sets = cold_sets(2 * 4 * b * S * kv * dh)
        q = torch.randn((b, 1, h, dh), generator=gen, device=dev)
        kl = torch.tensor(lens, dtype=torch.int32, device=dev)
        caches = [[torch.randn((b, S, kv, dh), generator=gen, device=dev)
                   for _ in range(2)] for _ in range(sets)]
        cold = cold_us(torch, [
            lambda k=k, v=v: dec.decode_attention_cuda(q, k, v, kl)
            for k, v in caches], DEVICE_NAMES["decode_attention"])
        k, v = caches[0]
        del caches
        got = dec.decode_attention_cuda(q, k, v, kl)
        err = float((got - dec.decode_attention_plain(q, k, v, kl))
                    .abs().max())
        check(err <= DECODE_TOL, f"decode_attention {name}: max error {err} "
              f"> {DECODE_TOL}")
        k_ms = timed(torch, lambda: dec.KERNEL.relaunch(1))
        d_us = device_us(torch, lambda: dec.KERNEL.relaunch(1),
                         DEVICE_NAMES["decode_attention"])
        p_ms = timed(torch, lambda: dec.decode_attention_plain(q, k, v, kl))
        qt_, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        mask = (torch.arange(S, device=dev)[None] < kl[:, None])[:, None,
                                                                  None]
        l_ms = timed(torch, lambda: F.scaled_dot_product_attention(
            qt_, kt, vt, attn_mask=mask, enable_gqa=True))
        keys = sum(min(x, S) for x in lens)       # the rows this run reads
        nbytes = 4 * (keys * kv * dh * 2 + 2 * q.numel() + b)
        b_ms, b_by = bound(nbytes, 4 * keys * h * dh, PEAK_FP32)
        n, kps = dec.plan(b, kv, h // kv, S, sms)
        row = {"shape": [b, S, h, kv, dh], "kv_len": list(lens),
               "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
               "library_ms": l_ms, "bound_ms": b_ms, "bound_by": b_by,
               "device_us": d_us, "cold_us": cold, "cold_sets": sets,
               "splits": n, "keys_per_split": kps}
        say(f"  decode_attention {name}: {row}")
        return row

    # the kv_len edges: no key, one key, a split boundary, kv_len = S,
    # splits wholly past kv_len, G = 1 / 8 / 16, every head width
    errs = {}
    for (b, S, h, kv, dh), lens in DECODE_EDGES:
        q = torch.randn((b, 1, h, dh), generator=gen, device=dev)
        k, v = (torch.randn((b, S, kv, dh), generator=gen, device=dev)
                for _ in range(2))
        kl = torch.tensor(lens, dtype=torch.int32, device=dev)
        errs[(b, S, h, kv, dh, *lens)] = err = float(
            (dec.decode_attention_cuda(q, k, v, kl)
             - dec.decode_attention_plain(q, k, v, kl)).abs().max())
        check(err <= DECODE_TOL, f"decode_attention {(b, S, h, kv, dh)} "
              f"kv_len {lens}: max error {err} > {DECODE_TOL}")
    say(f"  decode_attention kv_len edges, max errors: "
        f"{ {k: float(f'{e:.3g}') for k, e in errs.items()} } (limit "
        f"{DECODE_TOL})")
    for name in ("ragged", "zamba2"):
        extra[f"decode_attention_{name}"] = decode_case(name)
    r = decode_case("serving")
    put("decode_attention", *(r[key] for key in (
        "max_abs_err", "ms", "plain_ms", "library_ms", "bound_ms",
        "bound_by", "device_us")), cold_us=r["cold_us"],
        splits=r["splits"], keys_per_split=r["keys_per_split"])

    for T in (LM_T, LM_T - 32):       # plain prefill; mixed at 4 of 8 pooled
        q = torch.randn((LM_B, T, H, Dh), generator=gen, device=dev)
        k = torch.randn((LM_B, T, KV, Dh), generator=gen, device=dev)
        v = torch.randn((LM_B, T, KV, Dh), generator=gen, device=dev)
        got = flash.flash_attention_cuda(q, k, v, causal=True)
        err = float((got - flash.flash_attention_plain(q, k, v, causal=True))
                    .abs().max())
        check(err <= ATTN_TOL, f"flash_attention causal GQA T={T}: max "
              f"error {err}")
        k_ms = timed(torch, lambda: flash.KERNEL.relaunch(1))
        d_us = device_us(torch, lambda: flash.KERNEL.relaunch(1),
                         DEVICE_NAMES["flash_attention"])
        p_ms = timed(torch, lambda: flash.flash_attention_plain(
            q, k, v, causal=True))
        qt_, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        l_ms = timed(torch, lambda: F.scaled_dot_product_attention(
            qt_, kt, vt, is_causal=True, enable_gqa=True))
        pairs = T * (T + 1) // 2                  # causal (query, key) pairs
        b_ms, b_by = bound(4 * (2 * q.numel() + 2 * k.numel()),
                           TF32_PRODUCTS * 4 * LM_B * H * pairs * Dh,
                           PEAK_TF32)
        row = {"shape": [LM_B, T, H, KV, Dh], "max_abs_err": err,
               "ms": k_ms, "plain_ms": p_ms, "library_ms": l_ms,
               "bound_ms": b_ms, "bound_by": b_by, "device_us": d_us}
        extra[f"flash_attention_causal_T{T}"] = row
        say(f"  flash_attention causal GQA {row}")
    return extra


def _marked(torch, fn, name):
    """``fn`` run inside a ``record_function`` range named ``name``."""
    def run(*a, **kw):
        with torch.profiler.record_function(name):
            return fn(*a, **kw)
    return run


def mark_engine(torch, eng):
    """Run every prefill and decode key of ``eng`` inside ``lm_prefill``
    / ``lm_decode`` ranges, which ``profile_lm`` reads."""
    for fns, name in ((eng._prefill_fns, "lm_prefill"),
                      (eng._decode_fns, "lm_decode")):
        for key in list(fns):
            fns[key] = _marked(torch, fns[key], name)


def serve_lm(torch, cfg, dev):
    from repro_torch.kernels import dispatch
    from repro_torch.models import registry
    from repro_torch.serve.engine import ServeConfig, ServeEngine
    from repro_torch.serve.request import Request

    say(f"phase 7: ServeEngine, {cfg.name} {cfg.n_layers} layers D="
        f"{cfg.d_model} GQA {cfg.n_heads}/{cfg.n_kv_heads} Dh="
        f"{cfg.head_dim}, waves of {LM_B} x {LM_T} + {LM_NEW} tokens")
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = registry.init_params(cfg, gen, device=dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_tensors(params))
    say(f"  init {n_params} parameters ({4 * n_params} bytes) in "
        f"{time.perf_counter() - t0:.2f} s")
    eng = ServeEngine(cfg, params, ServeConfig(
        max_batch=LM_B, max_len=LM_MAX_LEN, buckets=(LM_T,),
        device=str(dev)))
    n_spans = LM_T // (cfg.mixed_res.window * cfg.mixed_res.downsample)
    mask = np.zeros(n_spans, np.int32)
    mask[:n_spans // 2] = 1
    n_keys = eng.warmup(plan_space=[(n_spans // 2, 0, BETA)])
    say(f"  warmup of {n_keys} keys {eng.stats.warmup_wall_s:.2f} s")
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab_size, LM_T).astype(np.int32)
               for _ in range(LM_B)]
    steps = LM_NEW - 1                      # the first token is prefill's
    out = {"B": LM_B, "T": LM_T, "new": LM_NEW, "beta": BETA,
           "n_params": n_params, "warmup_keys": n_keys,
           "warmup_s": eng.stats.warmup_wall_s}
    launches_total = dict.fromkeys(dispatch.KERNELS, 0)

    def wave(mixed):
        for rid, p in enumerate(prompts):
            eng.submit(Request(rid=rid, prompt=p, max_new_tokens=LM_NEW,
                               low_span_mask=mask if mixed else None,
                               beta=BETA if mixed else 0))
        t = time.perf_counter()
        resp = eng.run()
        wall = time.perf_counter() - t
        check(len(resp) == LM_B and all(r.n_tokens == LM_NEW for r in resp),
              f"LM wave: {[r.n_tokens for r in resp]} tokens, want "
              f"{LM_NEW} each")
        check(all(0 <= x < cfg.vocab_size for r in resp for x in r.tokens),
              "LM wave: token out of the vocabulary")
        return wall, [r.tokens for r in resp]

    for kind, mixed in (("plain", False), ("mixed", True)):
        dispatch.reset_launch_counts()      # the LM path starts here
        first, tokens = wave(mixed)
        launches = dispatch.launch_counts()  # ... and ends here
        say(f"  {kind} wave launches {json.dumps(launches)}")
        check(launches["flash_attention"] == cfg.n_layers,
              f"{kind}: flash launched {launches['flash_attention']} times, "
              f"want {cfg.n_layers} (one prefill)")
        check(launches["decode_attention"] == cfg.n_layers * steps,
              f"{kind}: decode launched {launches['decode_attention']} "
              f"times, want {cfg.n_layers} x {steps}")
        for name, n in launches.items():
            launches_total[name] += n
        walls = [wave(mixed)[0] for _ in range(3)]
        rec = {"first_s": first, "median_s": statistics.median(walls),
               "launches": launches, "tokens_0": tokens[0]}
        rec["tokens_per_s"] = LM_B * LM_NEW / rec["median_s"]
        rec.update(lm_phase_times(torch, eng, cfg, prompts, mask, mixed))
        out[kind] = rec
        say(f"  {kind} wave: first {first:.4f} s, median {rec['median_s']:.4f}"
            f" s, {rec['tokens_per_s']:.1f} tok/s; prefill "
            f"{rec['prefill_ms']:.3f} ms, decode {rec['decode_step_ms']:.3f} "
            f"ms/step")
    check(eng.stats.steady_compiles == 0,
          f"LM steady-state first uses: {eng.stats.steady_compile_keys}")
    out["steady_compiles"] = eng.stats.steady_compiles

    # trace one wave of each kind, prefill and decode steps marked
    mark_engine(torch, eng)
    for kind, mixed in (("plain", False), ("mixed", True)):
        out[kind]["profile"] = profile_lm(
            torch, f"lm_{kind}", lambda: wave(mixed), out[kind]["median_s"])
    check(eng.stats.steady_compiles == 0, "LM: steady-state first uses")
    del eng, params
    torch.cuda.empty_cache()
    return launches_total, out


def tree_tensors(tree):
    """The tensors of a parameter tree of dicts and lists."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from tree_tensors(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from tree_tensors(v)
    else:
        yield tree


def lm_phase_times(torch, eng, cfg, prompts, mask, mixed, new=LM_NEW):
    """Host clock, synchronised, around the engine's own prefill of the
    wave's key and around its ``new - 1`` decode steps, each read back to
    the host as the engine reads it (median of three)."""
    T, B = len(prompts[0]), len(prompts)
    toks = torch.as_tensor(np.stack(prompts).astype(np.int64),
                           device=eng.device)
    n_pool = int(mask.sum()) if mixed else 0
    beta = BETA if mixed else 0
    fn = eng._get_prefill(T, n_pool, beta, B)
    pack = eng._pack_for(T, n_pool, 0, mask) if mixed else None
    pre, dec = [], []
    with torch.no_grad():
        for _ in range(3):
            state = eng._state(B)
            torch.cuda.synchronize()
            t = time.perf_counter()
            logits, state = (fn(toks, state, pack) if mixed
                             else fn(toks, state))
            torch.cuda.synchronize()
            pre.append(time.perf_counter() - t)
            tok = logits[:, -1].argmax(-1, keepdim=True)
            decode = eng._get_decode(B)
            t = time.perf_counter()
            for step in range(1, new):
                logits, state = decode(tok, T + step - 1, state)
                tok = logits[:, -1].argmax(-1, keepdim=True)
                tok.cpu()
            torch.cuda.synchronize()
            dec.append((time.perf_counter() - t) / (new - 1))
    return {"prefill_ms": statistics.median(pre) * 1e3,
            "decode_step_ms": statistics.median(dec) * 1e3}


def profile_lm(torch, name, run_wave, wall_s, steps=LM_NEW - 1):
    """Trace one LM wave: device time by kernel family, and the device's
    busy share inside the prefill (from its first kernel to its last) and
    across the decode steps (from the first step's first kernel to the
    last step's last), where host launch overhead shows as idle gaps."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run_wave()
    (OUT_DIR / f"profile_{name}.txt").write_text(prof.key_averages().table(
        sort_by="self_device_time_total", row_limit=60))
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    spans = {m: sorted((e.time_range.start, e.time_range.end) for e in dev
                       if e.name == m) for m in ("lm_prefill", "lm_decode")}
    check(len(spans["lm_prefill"]) == 1
          and len(spans["lm_decode"]) == steps,
          f"profile {name}: {len(spans['lm_prefill'])} prefill and "
          f"{len(spans['lm_decode'])} decode spans")
    kernels = sorted((e.time_range.start, e.time_range.end, e.name)
                     for e in dev if e.name not in spans
                     and not getattr(e, "is_user_annotation", False)
                     and e.time_range.elapsed_us() > 0)
    fam: dict = {}
    for s, e, n in kernels:
        key = next((f for frag, f in FAMILIES if frag in n), "other")
        fam[key] = fam.get(key, 0.0) + (e - s) / 1e3
    busy = sum(fam.values())
    check(busy > 0, f"profile {name}: no device time traced")

    def share(lo, hi):
        """Kernel time inside [lo, hi) over its length (one stream)."""
        t = sum(max(0, min(e, hi) - max(s, lo)) for s, e, _ in kernels)
        return t / max(hi - lo, 1), (hi - lo) / 1e3

    p_lo, p_hi = spans["lm_prefill"][0]
    d_lo, d_hi = spans["lm_decode"][0][0], spans["lm_decode"][-1][1]
    p_share, p_ms = share(p_lo, p_hi)
    d_share, d_ms = share(d_lo, d_hi)
    per_step = sum(d_lo <= s < d_hi for s, _, _ in kernels) / steps
    out = {"device_ms": busy, "busy_share": busy / (wall_s * 1e3),
           "prefill_window_ms": p_ms, "prefill_busy_share": p_share,
           "decode_window_ms": d_ms, "decode_busy_share": d_share,
           "kernels_per_decode_step": per_step,
           "families_ms": dict(sorted(fam.items(), key=lambda kv: -kv[1]))}
    say(f"  profile {name}: device {busy:.2f} ms of {wall_s * 1e3:.2f} ms "
        f"wall (busy {out['busy_share']:.3f}); prefill window {p_ms:.2f} ms "
        f"busy {p_share:.3f}; decode window {d_ms:.2f} ms busy "
        f"{d_share:.3f}, {per_step:.0f} kernels a step; " + ", ".join(
            f"{k} {v:.2f}" for k, v in out["families_ms"].items()))
    return out


def lm_cross_check(torch, cfg, dev, phase=8, T=LM_T):
    """A few layers of a full-width LM on the card and, through the plain
    versions, on the CPU: prefill logits and 8 teacher-forced decode
    steps, each to LM_RTOL of its largest magnitude.  A dense model runs
    plain and mixed at beta 2; an SSM model also compares the hidden
    states of ``mixed_forward_ssm`` at beta 2 (half the spans pooled)."""
    from repro_torch.core import seq_mixed_res as smr
    from repro_torch.models import registry
    from repro_torch.models import transformer as tfm
    from repro_torch.offload.simulator import to_device
    say(f"phase {phase}: {cfg.n_layers}-layer full-width {cfg.name}, card "
        f"vs CPU")
    torch.set_num_threads(os.cpu_count() or 1)
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    p_gpu = registry.init_params(cfg, gen, device=dev)
    p_cpu = to_device(p_gpu, torch.device("cpu"))
    B, n_dec = 2, 8
    rng = np.random.default_rng(SEED + 3)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, T + n_dec)))
    part = smr.seq_partition(cfg, T)
    mask = np.zeros(part.n_spans, np.int32)
    mask[:part.n_spans // 2] = 1
    pack = smr.build_seq_pack(mask, int(mask.sum()), part)
    worst = {}

    def run(device, params, mixed):
        state = registry.init_decode_state(cfg, B, T + n_dec, device=device)
        with torch.no_grad():
            x = toks[:, :T].to(device)
            if mixed:
                pk = {k: torch.as_tensor(v.astype(np.int64), device=device)
                      for k, v in pack.items()}
                h, state, _ = smr.mixed_prefill(cfg, params, x, pk, BETA,
                                                state)
            else:
                h, state, _ = registry.prefill(cfg, params, {"tokens": x},
                                               state)
            out = [tfm.logits_from_hidden(cfg, params, h[:, -1:])]
            for i in range(n_dec):
                lg, state = registry.decode_step(
                    cfg, params, toks[:, T + i:T + i + 1].to(device), T + i,
                    state)
                out.append(lg)
        return [o.float().cpu() for o in out]

    kinds = ((("plain", False), ("mixed", True)) if cfg.family == "dense"
             else (("plain", False),))
    for kind, mixed in kinds:
        t0 = time.perf_counter()
        got = run(dev, p_gpu, mixed)
        want = run("cpu", p_cpu, mixed)
        rel = [float((g - c).abs().max() / c.abs().max())
               for g, c in zip(got, want)]
        check(all(np.isfinite(rel)), f"{kind}: non-finite logits")
        worst[kind] = {"prefill": rel[0], "decode_max": max(rel[1:])}
        say(f"  {kind}: prefill logits max relative error {rel[0]:.3g}, "
            f"{n_dec} decode steps max {max(rel[1:]):.3g} (limit {LM_RTOL}); "
            f"{time.perf_counter() - t0:.1f} s")
        check(max(rel) <= LM_RTOL, f"{kind}: card vs CPU {max(rel)} > "
              f"{LM_RTOL}")
    if cfg.family == "ssm":
        pk = {k: torch.as_tensor(v.astype(np.int64)) for k, v in pack.items()}
        with torch.no_grad():
            got, want = (smr.mixed_forward_ssm(
                cfg, params, toks[:, :T].to(device),
                {k: v.to(device) for k, v in pk.items()}, BETA)[0].cpu()
                for device, params in ((dev, p_gpu), ("cpu", p_cpu)))
        rel = float((got - want).abs().max() / want.abs().max())
        check(np.isfinite(rel) and rel <= LM_RTOL,
              f"mixed_forward_ssm: card vs CPU {rel} > {LM_RTOL}")
        worst["mixed_forward_ssm"] = rel
        say(f"  mixed_forward_ssm beta {BETA}: hidden max relative error "
            f"{rel:.3g} (limit {LM_RTOL})")
    del p_gpu, p_cpu
    torch.cuda.empty_cache()
    return worst


# ---------------------------------------------------------------------------
# the Mamba-2 serving lane (mamba2-370m and zamba2-1.2b through ServeEngine)


def serve_ssm(torch, cfg, dev, phase):
    """Phases 10 and 11: serve a full-width SSM or hybrid LM (weights from
    a seed) through ``ServeEngine``: warm up, then plain waves of SSM_B
    requests x SSM_T prompt tokens x SSM_NEW new tokens.  Every request
    must get SSM_NEW tokens; a wave launches ``ssd_scan`` once per mamba
    layer (one prefill) and, for the hybrid, ``flash_attention`` once per
    shared call and ``decode_attention`` once per shared call and decode
    step; no key may first run after warmup.  Wall time (median of
    three), prefill and decode-step times, one traced wave.  For the SSM
    LM also one ``mixed_forward_ssm`` at beta 2 with half the spans
    pooled beside the plain ``forward_hidden``, both timed."""
    from repro_torch.core import seq_mixed_res as smr
    from repro_torch.kernels import dispatch
    from repro_torch.models import hybrid as hyb
    from repro_torch.models import registry, ssm_lm
    from repro_torch.serve.engine import ServeConfig, ServeEngine
    from repro_torch.serve.request import Request

    calls = hyb.n_shared_calls(cfg) if cfg.family == "hybrid" else 0
    steps = SSM_NEW - 1
    say(f"phase {phase}: ServeEngine, {cfg.name} ({cfg.family}) "
        f"{cfg.n_layers} mamba layers D={cfg.d_model} N={cfg.ssm.d_state}"
        f"{f', {calls} shared attention calls' if calls else ''}, waves of "
        f"{SSM_B} x {SSM_T} + {SSM_NEW} tokens")
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = registry.init_params(cfg, gen, device=dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_tensors(params))
    say(f"  init {n_params} parameters ({4 * n_params} bytes) in "
        f"{time.perf_counter() - t0:.2f} s")
    eng = ServeEngine(cfg, params, ServeConfig(
        max_batch=SSM_B, max_len=SSM_T + SSM_NEW, buckets=(SSM_T,),
        device=str(dev)))
    n_keys = eng.warmup()
    say(f"  warmup of {n_keys} keys {eng.stats.warmup_wall_s:.2f} s")
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab_size, SSM_T).astype(np.int32)
               for _ in range(SSM_B)]
    want = {"ssd_scan": cfg.n_layers, "flash_attention": calls,
            "decode_attention": calls * steps}

    def wave():
        for rid, p in enumerate(prompts):
            eng.submit(Request(rid=rid, prompt=p, max_new_tokens=SSM_NEW))
        t = time.perf_counter()
        resp = eng.run()
        wall = time.perf_counter() - t
        check(len(resp) == SSM_B and all(r.n_tokens == SSM_NEW
                                         for r in resp),
              f"{cfg.name} wave: {[r.n_tokens for r in resp]} tokens, want "
              f"{SSM_NEW} each")
        check(all(0 <= x < cfg.vocab_size for r in resp for x in r.tokens),
              f"{cfg.name} wave: token out of the vocabulary")
        return wall, [r.tokens for r in resp]

    dispatch.reset_launch_counts()          # the SSM path starts here
    first, tokens = wave()
    launches = dispatch.launch_counts()     # ... and ends here
    say(f"  launches {json.dumps(launches)}")
    for name, n in want.items():
        check(launches[name] == n, f"{cfg.name}: {name} launched "
              f"{launches[name]} times, want {n}")
    walls = [wave()[0] for _ in range(3)]
    out = {"B": SSM_B, "T": SSM_T, "new": SSM_NEW, "n_params": n_params,
           "warmup_keys": n_keys, "warmup_s": eng.stats.warmup_wall_s,
           "first_s": first, "median_s": statistics.median(walls),
           "launches": launches, "tokens_0": tokens[0]}
    out["tokens_per_s"] = SSM_B * SSM_NEW / out["median_s"]
    out.update(lm_phase_times(torch, eng, cfg, prompts, None, False,
                              new=SSM_NEW))
    say(f"  wave: first {first:.4f} s, median {out['median_s']:.4f} s, "
        f"{out['tokens_per_s']:.1f} tok/s; prefill {out['prefill_ms']:.3f} "
        f"ms, decode {out['decode_step_ms']:.3f} ms/step")
    check(eng.stats.steady_compiles == 0,
          f"{cfg.name} steady-state first uses: "
          f"{eng.stats.steady_compile_keys}")
    out["steady_compiles"] = eng.stats.steady_compiles
    mark_engine(torch, eng)
    out["profile"] = profile_lm(torch, cfg.name, wave, out["median_s"],
                                steps=steps)
    check(eng.stats.steady_compiles == 0, f"{cfg.name}: steady first uses")

    if cfg.family == "ssm":
        part = smr.seq_partition(cfg, SSM_T)
        mask = np.zeros(part.n_spans, np.int32)
        mask[::2] = 1
        n_low = int(mask.sum())
        pack = {k: torch.as_tensor(v.astype(np.int64), device=dev)
                for k, v in smr.build_seq_pack(mask, n_low, part).items()}
        toks = torch.as_tensor(np.stack(prompts).astype(np.int64),
                               device=dev)

        def fwd(mixed):
            with torch.no_grad():
                if mixed:
                    return smr.mixed_forward_ssm(cfg, params, toks, pack,
                                                 BETA)[0]
                return ssm_lm.forward_hidden(cfg, params, toks)[0]

        dispatch.reset_launch_counts()      # the mixed forward starts here
        h = fwd(True)
        n_scan = dispatch.launch_counts()["ssd_scan"]   # ... and ends here
        check(n_scan == cfg.n_layers, f"mixed_forward_ssm launched ssd_scan "
              f"{n_scan} times, want {cfg.n_layers}")
        check(tuple(h.shape) == (SSM_B, SSM_T, cfg.d_model)
              and bool(torch.isfinite(h).all()),
              "mixed_forward_ssm: wrong shape or non-finite")

        def ms(mixed):
            ts = []
            for _ in range(3):
                torch.cuda.synchronize()
                t = time.perf_counter()
                fwd(mixed)
                torch.cuda.synchronize()
                ts.append(time.perf_counter() - t)
            return statistics.median(ts) * 1e3

        out["mixed_forward_ssm"] = {
            "beta": BETA, "n_low": n_low, "T_mix": part.n_tokens(n_low),
            "layers_pooled": smr.layers_before_rp(cfg, BETA, cfg.n_layers),
            "ssd_scan_launches": n_scan, "plain_ms": ms(False),
            "mixed_ms": ms(True)}
        say(f"  mixed_forward_ssm: {out['mixed_forward_ssm']}")
    del eng, params
    torch.cuda.empty_cache()
    return launches, out


def ssd_inputs(torch, cfg, dev, gen, b, T, groups=None):
    """Scan inputs shaped as a mamba layer hands them over: x, B and C are
    column views of one silu'd (b, T, conv_ch) conv output; dt is
    softplus(N(0, 1) + dt_bias) with the init's dt_bias (a log-uniform dt
    in [dt_min, dt_max]); A = -(1..H)."""
    import torch.nn.functional as F
    from repro_torch.models import mamba2 as m2
    s = cfg.ssm
    G = groups or s.n_groups
    d_inner, H, _ = m2.ssm_dims(cfg)
    N, P = s.d_state, s.head_dim
    xbc = F.silu(torch.randn((b, T, d_inner + 2 * G * N), generator=gen,
                             device=dev))
    xs, Bm, Cm = xbc.split((d_inner, G * N, G * N), dim=-1)
    u = torch.rand((H,), generator=gen, device=dev)
    dt0 = torch.exp(u * (np.log(s.dt_max) - np.log(s.dt_min))
                    + np.log(s.dt_min))
    bias = dt0 + torch.log(-torch.expm1(-dt0))
    dt = F.softplus(torch.randn((b, T, H), generator=gen, device=dev) + bias)
    A = -torch.arange(1, H + 1, dtype=torch.float32, device=dev)
    return (xs.reshape(b, T, H, P), dt, A, Bm.reshape(b, T, G, N),
            Cm.reshape(b, T, G, N))


def ssd_cost(b, T, H, G, N, P, chunk, init_state=False):
    """Bytes (each input read once, each output written once) and the
    float32 operations the chunked form needs, for this call's chunks (the
    last one may be short): the C_i.B_j scores over the lower triangle
    once per B/C group (they do not depend on the head); per head the
    masked-decay product with xbar, the state update and, where the state
    coming in is not zero (every chunk but the first without
    ``init_state``), the C_i.S term."""
    chunk = min(chunk, T)
    nbytes = 4 * (2 * b * T * H * P + b * T * H + H + 2 * b * T * G * N
                  + b * H * N * P)
    ops = 0
    for t0 in range(0, T, chunk):
        q = min(chunk, T - t0)
        carried = 2 * q * N * P if (t0 or init_state) else 0
        ops += b * G * N * q * (q + 1) \
            + b * H * (P * q * (q + 1) + 2 * q * N * P + carried)
    return nbytes, ops


TRACE_TRIES = 3   # traces kernel_breakdown takes before a kernel is untraced


def kernel_breakdown(torch, fn, names, n=20):
    """Device microseconds per call of ``fn`` spent in each kernel whose
    name holds one of ``names`` (a trace of ``n`` calls).  CUPTI now and
    then returns a trace that lacks the device activity of a kernel that
    did run (the launches are counted and checked elsewhere), so a trace
    in which a kernel reads 0 is taken again, up to TRACE_TRIES traces;
    the check fails only if no trace sees every kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(1, TRACE_TRIES + 1):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        us = dict.fromkeys(names, 0.0)
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                key = next((k for k in names if k in e.name), None)
                if key:
                    us[key] += e.time_range.elapsed_us() / n
        if all(us.values()):
            return us
        say(f"  kernel_breakdown: trace {attempt} of {TRACE_TRIES} lacks "
            f"device time in {us}")
    check(False, f"kernel_breakdown: untraced kernels in {us} after "
          f"{TRACE_TRIES} traces")


def device_us(torch, fn, frag, n=20):
    """Device microseconds per call of ``fn`` in the kernels whose names
    hold ``frag`` (a trace of ``n`` calls): the kernel's own time, without
    the host's launch rate that back-to-back CUDA-event timing can read."""
    return kernel_breakdown(torch, fn, (frag,), n)[frag]


def cold_us(torch, fns, frag, rounds=3):
    """Device microseconds per call in the kernels named by ``frag`` when
    the calls rotate over ``fns``, each on inputs of its own, so that the
    inputs of one call have left the 50 MB L2 before it runs again (as
    the caches of 36 layers do in one decode step)."""
    return kernel_breakdown(torch, lambda: [f() for f in fns], (frag,),
                            rounds)[frag] / len(fns)


def cold_sets(pair_bytes):
    """How many distinct input sets ``cold_us`` rotates over: 36 (a
    Qwen3-4B decode step's layers) while they fit in 1 GB, and never
    fewer than two."""
    return max(2, min(36, 10 ** 9 // pair_bytes))


def ssd_kernel_checks(torch, dev, gen, put):
    """Phase 9: ``ssd_scan`` against its plain version on the card, y and
    the final state each within SSD_TOL of the plain version's largest
    magnitude: the mamba2-370m serving shape (its kernels-line row, timed
    through ``put``), the zamba2-1.2b shape, one 128-row chunk, a ragged
    T, two B/C groups, every (N, P slice) instance the library builds and
    the reference's test shapes at small sizes, and a state handoff (two
    halves chained through ``init_state`` against the whole).  Returns the
    other cases' rows."""
    from repro_torch.configs.mamba2_370m import CONFIG as MAMBA
    from repro_torch.configs.zamba2_1p2b import CONFIG as ZAMBA
    import torch.nn.functional as F
    from repro_torch.kernels.ssd_scan import ops as ssd
    say("phase 9: ssd_scan vs its plain version on the card")
    extra = {}

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max())

    def case(name, cfg, b, T, groups=None, timed_case=False):
        args = ssd_inputs(torch, cfg, dev, gen, b, T, groups)
        chunk = cfg.ssm.chunk_size
        y, s = ssd.ssd_scan_cuda(*args, chunk)
        yp, sp = ssd.ssd_scan_plain(*args, chunk)
        errs = (rel(y, yp), rel(s, sp))
        check(all(np.isfinite(errs)) and max(errs) <= SSD_TOL,
              f"ssd_scan {name}: relative error y {errs[0]}, state "
              f"{errs[1]} (limit {SSD_TOL})")
        x, dt, A, Bm, Cm = args
        shape = (b, T, x.shape[2], Bm.shape[2], Bm.shape[3], x.shape[3],
                 chunk)
        row = {"shape_b_T_H_G_N_P_chunk": shape, "rel_err_y": errs[0],
               "rel_err_state": errs[1],
               "max_abs_err": float(max((y - yp).abs().max(),
                                        (s - sp).abs().max()))}
        if timed_case:
            row["ms"] = timed(torch, lambda: ssd.KERNEL.relaunch(1))
            row["plain_ms"] = timed(torch,
                                    lambda: ssd.ssd_scan_plain(*args, chunk))
            nbytes, nops = ssd_cost(*shape)
            row["bound_ms"], row["bound_by"] = bound(
                nbytes, TF32_PRODUCTS * nops, PEAK_TF32)
            row["kernels_us"] = kernel_breakdown(
                torch, lambda: ssd.KERNEL.relaunch(1), SSD_STAGES)
            say(f"  ssd_scan {name} device us per call by kernel: "
                f"{row['kernels_us']}")
        say(f"  ssd_scan {name} {shape}: relative error y {errs[0]:.3g}, "
            f"state {errs[1]:.3g} (limit {SSD_TOL})")
        extra[name] = row
        return row

    row = case("mamba2_serving", MAMBA, SSM_B, SSM_T, timed_case=True)
    put("ssd_scan", row["max_abs_err"], row["ms"], row["plain_ms"], None,
        row["bound_ms"], row["bound_by"], sum(row["kernels_us"].values()))
    z = case("zamba2_serving", ZAMBA, SSM_B, SSM_T, timed_case=True)
    say(f"  ssd_scan zamba2 shape: kernel_ms={z['ms']:.4f} plain_ms="
        f"{z['plain_ms']:.4f} bound_ms={z['bound_ms']:.4f} "
        f"({z['bound_by']})")
    case("one_chunk_T128", MAMBA, SSM_B, 128)
    case("ragged_T1000", MAMBA, 2, 1000)
    case("groups_2", MAMBA, 2, 512, groups=2)

    # every (N, P slice) instance the library builds, and the reference's
    # own test shapes (tests/test_kernels.py, test_ssd_scan)
    grid = [(2, 200, 8, 2, n, p, 64) for n in SSD_NS for p in (16, 32, 64)]
    grid += [(2, 200, 4, 1, 64, 128, 64)] + list(SSD_REF_SHAPES)
    extra["small_shapes"] = {}
    for shape in grid:
        b, T, H, G, N, P, chunk = shape
        x = torch.randn((b, T, H, P), generator=gen, device=dev)
        dt = F.softplus(torch.randn((b, T, H), generator=gen, device=dev))
        A = -torch.exp(torch.randn((H,), generator=gen, device=dev) * 0.5)
        Bm, Cm = (torch.randn((b, T, G, N), generator=gen, device=dev) * 0.3
                  for _ in range(2))
        y, s = ssd.ssd_scan_cuda(x, dt, A, Bm, Cm, chunk)
        yp, sp = ssd.ssd_scan_plain(x, dt, A, Bm, Cm, chunk)
        errs = (rel(y, yp), rel(s, sp))
        check(all(np.isfinite(errs)) and max(errs) <= SSD_TOL,
              f"ssd_scan {shape}: relative error y {errs[0]}, state "
              f"{errs[1]} (limit {SSD_TOL})")
        extra["small_shapes"][str(shape)] = errs
    worst = max(max(e) for e in extra["small_shapes"].values())
    say(f"  ssd_scan at {len(grid)} small shapes (b, T, H, G, N, P, chunk),"
        f" every built instance: worst relative error {worst:.3g} (limit "
        f"{SSD_TOL})")

    # state handoff: the halves chained through init_state == the whole
    x, dt, A, Bm, Cm = ssd_inputs(torch, MAMBA, dev, gen, 2, 1024)
    y, s = ssd.ssd_scan_cuda(x, dt, A, Bm, Cm, 256)
    h = 512 + 100                             # a cut inside a chunk
    y1, s1 = ssd.ssd_scan_cuda(x[:, :h], dt[:, :h], A, Bm[:, :h],
                               Cm[:, :h], 256)
    y2, s2 = ssd.ssd_scan_cuda(x[:, h:], dt[:, h:], A, Bm[:, h:],
                               Cm[:, h:], 256, init_state=s1)
    yp, sp = ssd.ssd_scan_plain(x[:, h:], dt[:, h:], A, Bm[:, h:],
                                Cm[:, h:], 256, init_state=s1)
    errs = (rel(torch.cat([y1, y2], 1), y), rel(s2, s), rel(y2, yp),
            rel(s2, sp))
    check(max(errs) <= SSD_TOL, f"ssd_scan handoff: relative errors {errs}")
    extra["handoff"] = dict(zip(("y_vs_whole", "state_vs_whole",
                                 "y_vs_plain", "state_vs_plain"), errs))
    say(f"  ssd_scan handoff at row {h}: {extra['handoff']}")
    return extra


if __name__ == "__main__":
    sys.exit(main())
