"""Time the flash attention kernel of whichever ``repro_torch`` is first
on ``PYTHONPATH``, at the ViT serving shape and the LM training shapes.

    PYTHONPATH=src python3 flash_ab.py --label change

To compare two versions of ``csrc/flash_attention.cu`` on one card, unpack
the other tree into a directory that ``.gitignore`` lists (``build/``)
and run both in one call, in the order A, B, B, A:

    for t in build/parent . . build/parent; do
        PYTHONPATH=$t/src python3 flash_ab.py --label $t; done

Each tree builds its own library (``build/repro_torch_kernels`` under
that tree).  A shape is timed by CUDA events around ``--reps`` uncounted
relaunches of the kernel alone (``CudaKernel.relaunch``: no wrapper, the
inputs warm in the L2 after the first), the median of ``--runs`` such
runs, after as many launches to warm up.  Printed: the card's name and
power limit, the kernel's register and spill counts from ``nvcc -Xptxas
-v``, and one JSON line per shape.  Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import re
import statistics
import subprocess
import sys

# (label, B, T, H, KV, Dh, causal): phase 3's ViT wave, phase 16's
# Qwen3-4B and ~100M steps, zamba2-1.2b's shared block
SHAPES = (("vit", 2, 4096, 16, 16, 64, False),
          ("qwen3-4b", 1, 1024, 32, 8, 128, True),
          ("qwen3-100m", 4, 256, 10, 2, 64, True),
          ("zamba2", 2, 1024, 32, 32, 64, True))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--label", default="")
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--runs", type=int, default=7)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("flash_ab: no CUDA card", file=sys.stderr)
        return 1
    import repro_torch
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import ops

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    log = build.build(["flash_attention"]).get("flash_attention", "")
    regs = sorted(set(re.findall(r"Used (\d+) registers", log)))
    spills = sorted(set(re.findall(r"(\d+) bytes spill stores", log)))
    print(f"{args.label}: {repro_torch.__file__}; {smi}; registers {regs}, "
          f"spill stores {spills}", flush=True)

    gen = torch.Generator(device="cuda").manual_seed(0)
    for name, B, T, H, KV, Dh, causal in SHAPES:
        q = torch.randn((B, T, H, Dh), generator=gen, device="cuda")
        k = torch.randn((B, T, KV, Dh), generator=gen, device="cuda")
        v = torch.randn((B, T, KV, Dh), generator=gen, device="cuda")
        ops.flash_attention_cuda(q, k, v, causal=causal)
        ops.KERNEL.relaunch(args.reps)
        times = []
        for _ in range(args.runs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            ops.KERNEL.relaunch(args.reps)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / args.reps)
        print(json.dumps({"label": args.label, "shape": name,
                          "q": [B, T, H, Dh], "kv_heads": KV,
                          "causal": causal,
                          "ms": statistics.median(times),
                          "ms_runs": times}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
