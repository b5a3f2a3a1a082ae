"""The readings the correctness limits are set from, on the card: a
cell run on many seeds (the lower readings) or with its configuration's
lower-precision control in the program's place (the upper readings).

    python3 edgebench/control.py --workload <cell> \\
        --lane program|control|bf16 --seeds 11,12,13 --seconds 4 \\
        --out <file.jsonl>

One process serves every seed (each with its own weights, traffic and
warmup), so set-up is paid once for the imports and the kernels.  The
control is the configuration's ``control``: ``{"quant": ...}`` serves
the program's own lower-precision lane, ``{"arith": "tf32"}`` puts the
reference at TF32 in the program's place.  ``bf16`` serves the
program's bf16 lane, a reading beside the control's.  The benchmark's
runs never run this.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--lane", choices=("program", "control", "bf16"),
                    required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)

    sys.path.insert(0, str(ROOT))
    from edgebench import harness
    from edgebench.reference.vitdet_ref import Arith

    harness.prepare_environment(ROOT)
    import torch

    if not torch.cuda.is_available():
        harness.log("no CUDA device: no readings")
        return 2
    cell = harness.load_cell(ROOT / "BENCHMARK.json", args.workload)
    kw = {}
    if args.lane == "control":
        ctrl = cell.config["control"]
        if "quant" in ctrl:
            kw["quant"] = ctrl["quant"]
        else:
            kw["control_arith"] = Arith(tf32=ctrl["arith"] == "tf32")
    elif args.lane == "bf16":
        kw["quant"] = {"weight_dtype": "bf16", "act_dtype": "fp32",
                       "prune_heads": 0}
    with open(args.out, "a") as f:
        for seed in (int(s) for s in args.seeds.split(",")):
            t = time.perf_counter()
            numbers = {}
            res = harness.run_cell(cell, seed, args.seconds, False,
                                   device="cuda:0", t_start=t,
                                   numbers_out=numbers, **kw)
            line = {"workload": args.workload, "lane": args.lane,
                    "seed": seed, "correct": res["correct"],
                    "checks": numbers,
                    "attempted": res["attempted"],
                    "wall_s": time.perf_counter() - t}
            f.write(json.dumps(line) + "\n")
            f.flush()
            harness.log(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
