"""Run one cell of the benchmark once, on the card this process finds.

    python3 edgebench/run.py --workload <cell> --seed <n> \\
        --seconds <run_seconds> --trace <0|1>

from the root of a checkout.  The last line of standard output is the
result (one JSON object); the last lines of standard error give each
number the correctness check compared, beside its limit.  A run that
finds no card, or fewer cards than the cell asks for, exits with code 2
and prints no result; one that finds JAX or the JAX package loaded once
the window has closed exits with code 3 and prints no result.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    sys.path.insert(0, str(ROOT))
    from edgebench import harness

    harness.prepare_environment(ROOT)
    import torch

    manifest = ROOT / "BENCHMARK.json"
    cell = harness.load_cell(manifest, args.workload)
    chips = {w["name"]: w["chips"] for w in
             json.loads(manifest.read_text())["workloads"]}[args.workload]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        harness.log(f"{args.workload} needs {chips} CUDA device(s); found "
                    f"{torch.cuda.device_count()}: no result")
        return 2
    torch.set_num_threads(4)
    result = harness.run_cell(cell, args.seed, args.seconds,
                              bool(args.trace), device="cuda:0")
    bad = harness.forbidden_modules()
    if bad:
        harness.log(f"loaded in this process: {', '.join(bad)}: no result")
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
