#!/usr/bin/env python3
"""Device time of ``decode_attention`` and ``avg_pool`` at the shapes
``chip_smoke.py``'s phase 2 gives them, for one checkout's port.  Flash
and window attention, at float32, fp16 and bf16 with SDPA beside each,
are timed by ``flash_ab.py``, which takes a tree the same way (its
``PYTHONPATH``).

Run on a machine with an NVIDIA GPU, from the root of this checkout:

    python3 kernel_times.py [--src DIR] [--label NAME]

``DIR`` is the ``src`` directory whose ``repro_torch`` is timed (default:
this checkout's), so the kernels of another tree (a ``git archive`` of a
parent commit, say) can be timed by the same code; its kernels build
into that tree's own ``build/``.  For every shape it checks the kernel
against its plain version and reports the milliseconds of back-to-back
relaunches by CUDA events (which the host's launch rate can bound), the
device microseconds per launch from a ``torch.profiler`` trace, and the
cold device microseconds when the launches rotate over enough inputs to
leave the 50 MB L2 (``chip_smoke.cold_us``).  It prints the card's name
and power limit, then one JSON line, which it also writes to
``kernel_times_<NAME>.json`` in ``chip_smoke.OUT_DIR``.  To compare two
trees, run both in one call on one card, in turns: parent, change,
change, parent.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import chip_smoke as cs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(cs.ROOT / "src"))
    ap.add_argument("--label", default="this")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.src).resolve()))
    import torch
    if not torch.cuda.is_available():
        print("kernel_times: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.decode_attention import ops as dec
    from repro_torch.kernels.mixed_res_pool import ops as pool
    import repro_torch
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    cs.say(smi.stdout.strip())
    dispatch.disable_tf32()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    out = {"label": args.label, "src": str(Path(repro_torch.__file__).parent),
           "card": smi.stdout.strip()}

    for name, ((b, S, H, KV, Dh), lens) in cs.DECODE_SHAPES.items():
        sets = cs.cold_sets(2 * 4 * b * S * KV * Dh)
        caches = [[torch.randn((b, S, KV, Dh), generator=gen, device=dev)
                   for _ in range(2)] for _ in range(sets)]
        q = torch.randn((b, 1, H, Dh), generator=gen, device=dev)
        kl = torch.tensor(lens, dtype=torch.int32, device=dev)
        k, v = caches[0]
        err = float((dec.decode_attention_cuda(q, k, v, kl)
                     - dec.decode_attention_plain(q, k, v, kl)).abs().max())
        cs.check(err <= cs.DECODE_TOL, f"decode_attention {name}: {err}")
        row = {"shape": [b, S, H, KV, Dh], "kv_len": list(lens),
               "max_abs_err": err,
               "ms": cs.timed(torch, lambda: dec.KERNEL.relaunch(1)),
               "device_us": cs.device_us(
                   torch, lambda: dec.KERNEL.relaunch(1), "decode_"),
               "cold_sets": sets,
               "cold_us": cs.cold_us(torch, [
                   lambda k=k, v=v: dec.decode_attention_cuda(q, k, v, kl)
                   for k, v in caches], "decode_")}
        out[f"decode_attention_{name}"] = row
        cs.say(f"decode_attention {name}: {row}")
        del caches, k, v
        torch.cuda.empty_cache()

    frames = [torch.rand((cs.B, 1024, 1024, 3), generator=gen, device=dev)
              for _ in range(4)]
    x = frames[0]
    err = float((pool.avg_pool_cuda(x, 2) - pool.avg_pool_plain(x, 2))
                .abs().max())
    cs.check(err <= cs.POOL_TOL, f"avg_pool: {err}")
    row = {"shape": list(x.shape), "d": 2, "max_abs_err": err,
           "ms": cs.timed(torch, lambda: pool.KERNEL.relaunch(1)),
           "device_us": cs.device_us(torch, lambda: pool.KERNEL.relaunch(1),
                                     "avg_pool"),
           "cold_sets": len(frames),
           "cold_us": cs.cold_us(torch, [lambda f=f: pool.avg_pool_cuda(f, 2)
                                         for f in frames], "avg_pool")}
    out["avg_pool"] = row
    cs.say(f"avg_pool: {row}")
    cs.OUT_DIR.mkdir(exist_ok=True)
    (cs.OUT_DIR / f"kernel_times_{args.label}.json").write_text(
        json.dumps(out, indent=1))
    cs.say(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
