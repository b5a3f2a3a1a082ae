"""Run the ~100M example's training recipe on the CPU through either
package, to read where its loss settles.

    PYTHONPATH=src JAX_PLATFORMS=cpu python3 lm_recipe_witness.py --impl jax
    PYTHONPATH=src python3 lm_recipe_witness.py --impl torch
    PYTHONPATH=src JAX_PLATFORMS=cpu python3 lm_recipe_witness.py \
        --impl jax --width example

The config is ``examples/train_lm_100m.py``'s (qwen3-4b's family, vocab
32768): at ``--width example`` as it stands (12 layers, D=640, GQA
10/2, ~80M parameters), at ``--width narrow`` (the default) cut to 2
layers, D=256, GQA 4/2, d_ff 1024.  The recipe is the example's:
``launch.train.train`` with its default
``TrainConfig`` (peak lr 3e-4, warmup steps // 20, cosine to ``steps``,
weight decay 0.1, clip 1.0) at batch 4, seq 256 over
``synthetic_batches``.  ``--peak-lr`` replaces only the peak rate.
Each run imports one package: ``--impl jax`` the reference
(``repro``), ``--impl torch`` the port (``repro_torch``, on the CPU).

Printed: the loss every 50 steps, the first loss, the mean of the last
ten, and the stream's two reference levels: ln(active vocab), the loss
of a model that knows only which tokens the stream draws, and the
entropy of its bigram table, the least loss any model can reach.  The
last line is one JSON object with all of it.
"""
from __future__ import annotations

import argparse
import json
import math
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

ACTIVE_VOCAB = 4096          # synthetic_batches' default
P_BIGRAM, N_SUCC = 0.9, 4    # its successor probability and fan-out
WIDTHS = {"example": dict(n_layers=12, d_model=640, n_heads=10,
                          n_kv_heads=2, d_ff=2048),
          "narrow": dict(n_layers=2, d_model=256, n_heads=4, n_kv_heads=2,
                         d_ff=1024)}


def stream_levels(active: int = ACTIVE_VOCAB) -> dict:
    """ln(active) and the per-token entropy of the stream's next token
    given the current one (four successors at 0.9 / 4 each, any of the
    ``active`` tokens at 0.1 / active; repeated successors ignored)."""
    p_succ = P_BIGRAM / N_SUCC + (1 - P_BIGRAM) / active
    p_rest = (1 - P_BIGRAM) / active
    h = (-N_SUCC * p_succ * math.log(p_succ)
         - (active - N_SUCC) * p_rest * math.log(p_rest))
    return {"unigram_nats": math.log(active), "bigram_nats": h}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--impl", choices=("jax", "torch"), required=True)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--width", choices=tuple(WIDTHS), default="narrow")
    ap.add_argument("--peak-lr", type=float, default=None)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    widths = dict(WIDTHS[args.width], head_dim=64, vocab_size=32768,
                  max_seq_len=4096)
    if args.impl == "jax":
        from repro.configs import get_config
        from repro.launch.train import train
        from repro.train.trainer import TrainConfig
        kw = {}
    else:
        from repro_torch.configs import get_config
        from repro_torch.launch.train import train
        from repro_torch.train.trainer import TrainConfig
        kw = {"device": "cpu"}
    cfg = get_config("qwen3-4b").replace(name="qwen3-witness", **widths)
    tc = None
    if args.peak_lr is not None:
        tc = TrainConfig(remat=False, total_steps=args.steps,
                         warmup_steps=max(args.steps // 20, 5),
                         peak_lr=args.peak_lr)
    print(f"{args.impl}: {cfg.name} params={cfg.param_count()} "
          f"({cfg.n_layers}L d={cfg.d_model}), {args.steps} steps, "
          f"peak lr {tc.peak_lr if tc else 3e-4}", flush=True)
    t0 = time.time()
    out = train(cfg, steps=args.steps, batch=4, seq=256, tc=tc,
                log_every=50, seed=args.seed, **kw)
    res = {"impl": args.impl, "steps": args.steps, "width": args.width,
           "n_layers": cfg.n_layers,
           "d_model": cfg.d_model, "params": cfg.param_count(),
           "peak_lr": tc.peak_lr if tc else 3e-4, "seed": args.seed,
           "first_loss": out["first_loss"],
           "mean_last10": out["mean_last10"],
           "wall_s": time.time() - t0, **stream_levels()}
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
