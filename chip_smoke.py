#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Run from the root of a checkout, on a machine with an NVIDIA H100, the
CUDA toolkit and PyTorch built for CUDA:

    python3 chip_smoke.py

Phases; any failure exits non-zero and prints no result:

  1. print the card's name and power limit; build the seven CUDA kernels
     (six libraries) from ``src/repro_torch/csrc`` (one nvcc per source,
     all at once);
  2. hold each kernel against its plain PyTorch version on the card, at
     the full-width ViTDet-L shapes the serving path gives it, and time
     the kernel alone, the plain version and, where one PyTorch call
     computes the same function, that call.  ``int8_matmul`` is checked
     bit-equal at the five GEMM shapes of the quantized model (M = 8192)
     and a ragged one; its numbers in the kernels line are sums over the
     five (the bound is the sum of each shape's bound, "by" the kind
     that bounds most of it).  The per-row activation quantization in front of each GEMM is
     timed on its own;
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
     ``tests/test_torch_quant.py``).

Each serving path resets the launch counts just before it and reads them
just after.  The line before the last is a JSON object with every
kernel's numbers; the last is ``{"ok": true, "device": {...}}``.
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
ATTN_TOL = 1e-4             # float32 attention, kernel vs plain, absolute
POOL_TOL = 1e-6             # mean of four floats, absolute
E2E_RTOL = 1e-3             # 8-block forward, card vs CPU, relative
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
}


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
    from repro_torch.kernels import build
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
    vb.disable_tf32()
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

    def measure(kernel, plain_fn, lib_fn, nbytes, nops, peak):
        """Kernel alone (its latest launch relaunched), plain version and
        library call in ms, and the bound in ms with what sets it."""
        k_ms = timed(torch, lambda: kernel.relaunch(1))
        p_ms = timed(torch, plain_fn)
        l_ms = timed(torch, lib_fn) if lib_fn is not None else None
        return (k_ms, p_ms, l_ms) + bound(nbytes, nops, peak)

    def record(name, err, kernel, plain_fn, lib_fn, nbytes, nops,
               peak=PEAK_FP32):
        put(name, err, *measure(kernel, plain_fn, lib_fn, nbytes, nops,
                                peak))

    def put(name, err, k_ms, p_ms, l_ms, bound_ms, bound_by):
        rows[name] = {"max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
                      "bound_ms": bound_ms, "bound_by": bound_by,
                      "library_ms": l_ms}
        say(f"  {name}: max_abs_err={err:.3g} kernel_ms={k_ms:.4f} "
            f"plain_ms={p_ms:.4f} library_ms="
            f"{'null' if l_ms is None else f'{l_ms:.4f}'} "
            f"bound_ms={bound_ms:.4f} ({bound_by})")

    def max_err(a, b):
        return float((a - b).abs().max())

    # avg_pool: the raw frame, pooled before the low-resolution embedding
    x = torch.rand((B, *cfg.vit.img_size, 3), generator=gen, device=dev)
    got, want = pool.avg_pool_cuda(x, 2), pool.avg_pool_plain(x, 2)
    err = max_err(got, want)
    check(err <= POOL_TOL, f"avg_pool: max error {err} > {POOL_TOL}")
    xc = x.permute(0, 3, 1, 2)
    record("avg_pool", err, pool.KERNEL, lambda: pool.avg_pool_plain(x, 2),
           lambda: F.avg_pool2d(xc, 2),
           4 * (x.numel() + got.numel()), x.numel() + got.numel())

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

    # window attention: column views of a fused QKV product, as the
    # blocks hand them over; the padded shape with win_valid first
    def qkv_views(tokens):
        qkv = torch.randn((B, tokens, 3 * D), generator=gen, device=dev)
        return [t.reshape(B, tokens, H, Dh) for t in qkv.split(D, dim=-1)]

    qp, kp, vp = qkv_views(lb * w2)
    wv = lay["nw"]
    err_p = max_err(win.window_attention_cuda(qp, kp, vp, w2, wv),
                    win.window_attention_plain(qp, kp, vp, w2, wv))
    q, k, v = qkv_views(T)
    got = win.window_attention_cuda(q, k, v, w2)
    err = max(err_p, max_err(got, win.window_attention_plain(q, k, v, w2)))
    check(err <= ATTN_TOL, f"window_attention: max error {err}")
    qw, kw, vw = (t.reshape(B, T // w2, w2, H, Dh).permute(0, 1, 3, 2, 4)
                  .reshape(-1, H, w2, Dh).contiguous() for t in (q, k, v))
    record("window_attention", err, win.KERNEL,
           lambda: win.window_attention_plain(q, k, v, w2),
           lambda: F.scaled_dot_product_attention(qw, kw, vw),
           4 * 4 * B * T * H * Dh, 4 * B * (T // w2) * H * w2 * w2 * Dh)

    # flash attention: the unmasked global blocks after restoration; a
    # causal GQA call first (the kernel keeps both options)
    qs, ks, vs = (torch.randn((1, 1000, H, Dh), generator=gen, device=dev),
                  torch.randn((1, 1000, 4, Dh), generator=gen, device=dev),
                  torch.randn((1, 1000, 4, Dh), generator=gen, device=dev))
    err_c = max_err(flash.flash_attention_cuda(qs, ks, vs, causal=True),
                    flash.flash_attention_plain(qs, ks, vs, causal=True))
    got = flash.flash_attention_cuda(q, k, v)
    err = max(err_c, max_err(got, flash.flash_attention_plain(q, k, v)))
    check(err <= ATTN_TOL, f"flash_attention: max error {err}")
    qf, kf, vf = (t.permute(0, 2, 1, 3).contiguous() for t in (q, k, v))
    record("flash_attention", err, flash.KERNEL,
           lambda: flash.flash_attention_plain(q, k, v),
           lambda: F.scaled_dot_product_attention(qf, kf, vf),
           4 * 4 * B * T * H * Dh, 4 * B * H * T * T * Dh)
    del bank, pos_bank, windows, tiles, q, k, v, qw, kw, vw, qf, kf, vf
    torch.cuda.empty_cache()

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
        max(by, key=by.get))
    del x, got, want
    torch.cuda.empty_cache()

    # phase 3 -------------------------------------------------------------
    launches, lat = serve(torch, cfg, dev, gen, plans, pt)
    for name, row in rows.items():
        row["launches"] = launches[name]

    # phase 4 -------------------------------------------------------------
    cross_check(torch, cfg.replace(n_layers=8), dev, plans, pt, vb)

    # phase 5 -------------------------------------------------------------
    qlaunches, qlat = serve_quant(torch, cfg, dev, gen, plans, pt, qt)
    rows["int8_matmul"]["launches"] = qlaunches["int8_matmul"]
    lat["quant"] = qlat

    # phase 6 -------------------------------------------------------------
    quant_cross_check(torch, cfg.replace(n_layers=8), dev, plans, pt, vb)

    out = []
    for name in KERNEL_SOURCES:
        src, replaces = KERNEL_SOURCES[name]
        r = rows[name]
        out.append({"name": name, "route": "cuda", "source": src,
                    "replaces": replaces, "launches": r["launches"],
                    "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                    "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                    "bound_by": r["bound_by"],
                    "library_ms": r["library_ms"]})
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
            [(1000, 100, 130)]:
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
        p_ms = timed(torch, lambda: i8.int8_matmul_plain(xq, wq, sx, sw))
        l_ms = timed(torch, lambda: torch._int_mm(xq, wq))
        xf = torch.randn((M, K), generator=gen, device=dev)
        wf = torch.randn((K, N), generator=gen, device=dev)
        f_ms = timed(torch, lambda: torch.matmul(xf, wf))
        r_ms = timed(torch, lambda: qt._quantize_rows(xf))
        b_ms, b_by = bound(M * K + K * N + 4 * (M + N) + 4 * M * N,
                           2 * M * N * K, PEAK_INT8)
        row = {"M": M, "K": K, "N": N, "ms": k_ms, "plain_ms": p_ms,
               "library_ms": l_ms, "fp32_matmul_ms": f_ms,
               "row_quant_ms": r_ms, "bound_ms": b_ms, "bound_by": b_by}
        out.append(row)
        say(f"  int8_matmul {M}x{K}x{N}: bit-equal kernel_ms={k_ms:.4f} "
            f"({2 * M * N * K / k_ms / 1e9:.1f} TOPS) plain_ms={p_ms:.4f} "
            f"int_mm_ms={l_ms:.4f} fp32_matmul_ms={f_ms:.4f} "
            f"row_quant_ms={r_ms:.4f} bound_ms={b_ms:.4f} ({b_by})")
        del xq, wq, xf, wf, got, want
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
    launches["nn_upsample"] = b0_launches["nn_upsample"]
    del srv, params
    torch.cuda.empty_cache()
    return launches, lat


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
            ("pack_pos", "fused_serving"), ("restore_gather", "fused_serving"),
            ("avg_pool_kernel", "avg_pool"),
            ("nn_upsample_kernel", "nn_upsample"),
            ("int8_matmul_kernel", "int8_gemm"),
            ("fprop", "conv"), ("fft", "conv"), ("cf32", "conv"),
            ("region_transform", "conv"), ("cudnn", "conv"),
            ("gemm", "gemm"),
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


if __name__ == "__main__":
    sys.exit(main())
