"""Check and time the flash and window attention kernels of whichever
``repro_torch`` is first on ``PYTHONPATH``, at float32, fp16 and bf16,
with PyTorch's ``scaled_dot_product_attention`` at the same type beside
each.

    PYTHONPATH=src python3 flash_ab.py --label change

Shapes: flash at phase 3's ViT wave (column views of the fused QKV
product, token pitch 3072), the LM prefill (causal GQA (8, 128, 32/8,
128)), phase 16's Qwen3-4B and ~100M steps and zamba2-1.2b's shared
block; window at the full-resolution ViT wave and the int8 lane's 15
heads (views of a 2880-wide fused QKV).  To compare two versions of the
kernels on one card, unpack the other tree into a directory that
``.gitignore`` lists (``build/``) and run both in one call, in the order
A, B, B, A:

    for t in build/parent . . build/parent; do
        PYTHONPATH=$t/src python3 flash_ab.py --label $t; done

Each tree builds its own libraries (``build/repro_torch_kernels`` under
that tree).  Every case is first held against the plain version on the
same inputs (``chip_smoke.agree``: 1e-4 at float32, one ULP and
``HALF_EQUAL`` bit-equal at half).  Its time is the median of ``--runs``
runs of ``--reps`` uncounted relaunches of the kernel alone
(``CudaKernel.relaunch``: no wrapper, inputs warm in the L2), by CUDA
events, and the kernel's own device time per launch from a
``torch.profiler`` trace (``chip_smoke.device_us``); SDPA by CUDA events
around back-to-back calls.  Printed: the card's name and power limit,
each library's register and spill counts from ``nvcc -Xptxas -v``, and
one JSON line per case.  Exits 1 if a case disagrees.  Needs a CUDA
card.
"""
from __future__ import annotations

import argparse
import json
import re
import statistics
import subprocess
import sys

import chip_smoke as cs

# (label, B, T, H, KV, Dh, causal, fused QKV view)
FLASH_SHAPES = (("vit", 2, 4096, 16, 16, 64, False, True),
                ("lm-prefill", 8, 128, 32, 8, 128, True, False),
                ("qwen3-4b", 1, 1024, 32, 8, 128, True, False),
                ("qwen3-100m", 4, 256, 10, 2, 64, True, False),
                ("zamba2", 2, 1024, 32, 32, 64, True, False))
# (label, B, T, H, w2, Dh), each as views of a fused QKV product
WINDOW_SHAPES = (("vit-full", 2, 4096, 16, 64, 64),
                 ("vit-int8", 2, 4096, 15, 64, 64))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--label", default="")
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--runs", type=int, default=7)
    ap.add_argument("--dtypes", default="f32,f16,bf16")
    args = ap.parse_args()

    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("flash_ab: no CUDA card", file=sys.stderr)
        return 1
    import repro_torch
    from repro_torch.kernels import build, dispatch
    from repro_torch.kernels.flash_attention import ops as flash
    from repro_torch.kernels.window_attention import ops as win

    dispatch.disable_tf32()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    logs = build.build(["flash_attention", "window_attention"])
    print(f"{args.label}: {repro_torch.__file__}; {smi}", flush=True)
    for name in ("flash_attention", "window_attention"):
        log = logs.get(name, "")
        for fn in re.findall(r"Compiling entry function '(\w+)'", log):
            print(f"  ptxas {name}: {fn}", flush=True)
        regs = re.findall(r"Used (\d+) registers", log)
        spills = re.findall(r"(\d+) bytes spill stores", log)
        print(f"  {name}: registers {regs}, spill stores {spills}",
              flush=True)

    def kernel_ms(kernel):
        kernel.relaunch(args.reps)
        times = []
        for _ in range(args.runs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            kernel.relaunch(args.reps)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / args.reps)
        return statistics.median(times), times

    gen = torch.Generator(device="cuda").manual_seed(0)
    dtypes = [d for d in build.FLOAT_TYPES
              if build.FLOAT_SUFFIX[d] in args.dtypes.split(",")]
    failed = []

    def case(kind, label, dt, kernel, got, want, sdpa, tag, **shape):
        suf = build.FLOAT_SUFFIX[dt]
        rec = {"label": args.label, "kernel": kind, "shape": label,
               "dtype": suf, **shape}
        try:
            rec["max_abs_err"], rec["equal_frac"] = cs.agree(
                torch, f"{kind} {label} {suf}", got, want, cs.ATTN_TOL)
        except cs.SmokeFailure as e:
            rec["failed"] = str(e)
            failed.append(rec["failed"])
        rec["ms"], rec["ms_runs"] = kernel_ms(kernel)
        rec["device_us"] = cs.device_us(torch, lambda: kernel.relaunch(1),
                                        tag)
        rec["sdpa_ms"] = cs.timed(torch, sdpa)
        print(json.dumps(rec), flush=True)

    def fused(B, T, H, Dh, dt):
        qkv = torch.randn((B, T, 3 * H * Dh), generator=gen,
                          device="cuda").to(dt)
        return [t.reshape(B, T, H, Dh) for t in qkv.split(H * Dh, dim=-1)]

    for dt in dtypes:
        for label, B, T, H, KV, Dh, causal, view in FLASH_SHAPES:
            if view:
                q, k, v = fused(B, T, H, Dh, dt)
            else:
                q, k, v = (torch.randn((B, T, n, Dh), generator=gen,
                                       device="cuda").to(dt)
                           for n in (H, KV, KV))
            got = flash.flash_attention_cuda(q, k, v, causal=causal)
            want = flash.flash_attention_plain(q, k, v, causal=causal)
            qs, ks, vs = (t.transpose(1, 2).contiguous() for t in (q, k, v))
            case("flash_attention", label, dt, flash.KERNEL, got, want,
                 lambda: F.scaled_dot_product_attention(
                     qs, ks, vs, is_causal=causal, enable_gqa=KV != H),
                 cs.DEVICE_NAMES["flash_attention"], q=[B, T, H, Dh],
                 kv_heads=KV, causal=causal)
            del q, k, v, qs, ks, vs, got, want
        for label, B, T, H, w2, Dh in WINDOW_SHAPES:
            q, k, v = fused(B, T, H, Dh, dt)
            got = win.window_attention_cuda(q, k, v, w2)
            want = win.window_attention_plain(q, k, v, w2)
            qw, kw, vw = (t.reshape(B, T // w2, w2, H, Dh)
                          .permute(0, 1, 3, 2, 4).reshape(-1, H, w2, Dh)
                          .contiguous() for t in (q, k, v))
            case("window_attention", label, dt, win.KERNEL, got, want,
                 lambda: F.scaled_dot_product_attention(qw, kw, vw),
                 cs.DEVICE_NAMES["window_attention"], q=[B, T, H, Dh],
                 w2=w2)
            del q, k, v, qw, kw, vw, got, want
        torch.cuda.empty_cache()
    if failed:
        print(f"flash_ab: {len(failed)} case(s) disagree: {failed}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
