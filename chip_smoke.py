#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Run from the root of a checkout, on a machine with an NVIDIA H100, the
CUDA toolkit and PyTorch built for CUDA:

    python3 chip_smoke.py

Phases; any failure exits non-zero and prints no result:

  1. print the card's name and power limit; build the five CUDA kernels
     from ``src/repro_torch/csrc`` (one nvcc per source, all at once);
  2. hold each kernel against its plain PyTorch version on the card, at
     the full-width ViTDet-L shapes the serving path gives it, and time
     the kernel alone, the plain version and, where one PyTorch call
     computes the same function, that call;
  3. serve full-width ViTDet-L (24 blocks, D=1024, 1024x1024 frames,
     weights drawn from a seed) through ``ServerModel.infer_wave``: warm
     up, then a full-resolution wave that captures restoration-point
     tiles and a mixed FULL/LOW/REUSE wave at beta 2 that splices them.
     Detections must be finite, every kernel must have launched during
     the two waves, and no grid key may first run after warmup;
     One more wave of each kind is traced with ``torch.profiler``: device
     time by kernel family (GEMM, attention kernels, convolutions, ...)
     and the device's busy share of the wave; the full tables go to
     ``chiprun_out/profile_*.txt``;
  4. one mixed wave of an 8-block full-width model on the card and,
     through the plain versions, on the CPU: features and captured tiles
     agree to 1e-3 relative.

The line before the last is a JSON object with every kernel's numbers;
the last is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

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
ATTN_TOL = 1e-4             # float32 attention, kernel vs plain, absolute
POOL_TOL = 1e-6             # mean of four floats, absolute
E2E_RTOL = 1e-3             # 8-block forward, card vs CPU, relative

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
    from repro_torch.kernels.mixed_res_pool import ops as pool
    from repro_torch.kernels.window_attention import ops as win

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

    def record(name, err, kernel, plain_fn, lib_fn, nbytes, nops):
        k_ms = timed(torch, lambda: kernel.relaunch(1))
        p_ms = timed(torch, plain_fn)
        l_ms = timed(torch, lib_fn) if lib_fn is not None else None
        t_b, t_o = nbytes / PEAK_BYTES * 1e3, nops / PEAK_FP32 * 1e3
        rows[name] = {"max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
                      "bound_ms": max(t_b, t_o),
                      "bound_by": "bytes" if t_b >= t_o else "operations",
                      "library_ms": l_ms}
        say(f"  {name}: max_abs_err={err:.3g} kernel_ms={k_ms:.4f} "
            f"plain_ms={p_ms:.4f} library_ms="
            f"{'null' if l_ms is None else f'{l_ms:.4f}'} "
            f"bound_ms={max(t_b, t_o):.4f} ({rows[name]['bound_by']})")

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

    # phase 3 -------------------------------------------------------------
    launches, lat = serve(torch, cfg, dev, gen, plans, pt)
    for name, row in rows.items():
        row["launches"] = launches[name]

    # phase 4 -------------------------------------------------------------
    cross_check(torch, cfg.replace(n_layers=8), dev, plans, pt, vb)

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
        {"card": smi.stdout.strip(), "kernels": out, "waves": lat},
        indent=1))
    return out


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
    space = srv.default_plan_space([BETA], reuse_edges=(0, 4),
                                   captures=(BETA,))
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
    check(all(n > 0 for n in launches.values()),
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
    del srv, params
    torch.cuda.empty_cache()
    return launches, lat


# kernel-name fragments -> family, first match wins.  cuDNN's
# convolutions run as implicit GEMMs, FFTs and complex GEMMs, so their
# fragments come before the plain "gemm" of the cuBLAS/CUTLASS matmuls.
FAMILIES = (("window_attention", "window_attention"),
            ("flash_attention", "flash_attention"),
            ("pack_pos", "fused_serving"), ("restore_gather", "fused_serving"),
            ("avg_pool_kernel", "avg_pool"),
            ("fprop", "conv"), ("fft", "conv"), ("cf32", "conv"),
            ("region_transform", "conv"), ("cudnn", "conv"),
            ("gemm", "gemm"),
            ("softmax", "softmax"), ("reduce_kernel", "reduce"),
            ("elementwise", "elementwise"),
            ("Memcpy", "memcpy"), ("Memset", "memset"))


def profile_wave(torch, name, run_wave, wall_s):
    """Trace one wave; device time by kernel family, and the share of the
    untraced wave's wall time (``wall_s``) the device was busy."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run_wave()
    events = prof.key_averages()
    (OUT_DIR / f"profile_{name}.txt").write_text(events.table(
        sort_by="self_device_time_total", row_limit=60))
    fam: dict = {}
    for e in events:
        if e.device_type != DeviceType.CUDA or e.self_device_time_total <= 0:
            continue
        key = next((f for frag, f in FAMILIES if frag in e.key), "other")
        fam[key] = fam.get(key, 0.0) + e.self_device_time_total / 1e3
    busy = sum(fam.values())
    check(busy > 0, f"profile {name}: no device time traced")
    out = {"device_ms": busy, "busy_share": busy / (wall_s * 1e3),
           "families_ms": dict(sorted(fam.items(), key=lambda kv: -kv[1]))}
    say(f"  profile {name}: device {busy:.2f} ms of {wall_s * 1e3:.2f} ms "
        f"wall (busy {out['busy_share']:.3f}); " + ", ".join(
            f"{k} {v:.2f}" for k, v in out["families_ms"].items()))
    return out


def cross_check(torch, cfg, dev, plans, pt, vb):
    """One mixed wave of an 8-block full-width model on the card and on
    the CPU (plain versions): features and tiles to E2E_RTOL."""
    from repro_torch import convert
    from repro_torch.offload.simulator import to_device
    say(f"phase 4: {cfg.n_layers}-block full-width wave, card vs CPU")
    torch.set_num_threads(os.cpu_count() or 1)
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    p_gpu = convert.init_vitdet_params(cfg, gen, device=dev)
    part = vb.vit_partition(cfg)
    img = torch.rand((1, *cfg.vit.img_size, 3), generator=gen, device=dev)
    tiles = torch.randn((1, part.n_regions, part.windows_per_full_region,
                         part.tokens_low_region, cfg.d_model), generator=gen,
                        device=dev)
    lb = max(pt.length_bucket_set(part))
    lay = pt.plan_layout(plans[0].states, lb, part)
    layout = {k: torch.as_tensor(getattr(lay, k)[None], device=dev)
              for k in ("win_src", "out_src", "out_map")}
    layout["nw"] = torch.tensor([lay.nw], dtype=torch.int32, device=dev)

    def run_on(device, params):
        return vb.forward_features(
            cfg, params, img.to(device), beta=BETA,
            layout={k: v.to(device) for k, v in layout.items()},
            reuse_tiles=tiles.to(device), capture_beta=BETA)

    gf, gt = run_on(dev, p_gpu)
    t0 = time.perf_counter()
    p_cpu = to_device(p_gpu, torch.device("cpu"))
    cf, ct = run_on("cpu", p_cpu)
    for what, g, c in (("features", gf, cf), ("tiles", gt, ct)):
        g = g.cpu()
        check(bool(torch.isfinite(g).all()), f"{what}: non-finite on card")
        rel = float((g - c).abs().max() / c.abs().max())
        say(f"  {what} {tuple(g.shape)}: max relative error {rel:.3g} "
            f"(limit {E2E_RTOL})")
        check(rel <= E2E_RTOL, f"{what}: card vs CPU {rel} > {E2E_RTOL}")
    say(f"  CPU forward {time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    sys.exit(main())
