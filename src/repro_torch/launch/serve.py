"""Serving launcher: wave-batched KV-cache serving with the paper's
mixed-granularity prefill as a per-request knob (the port of
``repro.launch.serve``).  Weights are drawn from seed 0.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-4b \\
      [--reduced] [--requests 16 --prompt-len 128 --max-new 16] \\
      [--mixed --beta 2 --low-frac 0.5] [--quant int8|fp16|bf16] \\
      [--device cpu]

``--arch`` is one of the LM archs of ``repro_torch.configs.ARCH_MODULES``;
the SSM and hybrid families serve the plain path (``--mixed`` is turned
off for them, as in the reference), a VLM its text decoder.
whisper-medium raises before any weight is drawn
(``serve.engine.check_servable``: the engine passes no encoder frames).
``--quant int8`` serves ``quant.ptq.quantize_lm_params``'s tree (int8
attention and MLP projections, float32 activations; a MoE layer's
experts and router stay float, and deepseek-v2-236b, whose int8 lane
fails in the reference, is refused before any weight is drawn); ``fp16`` / ``bf16`` cast the whole
tree (``qtensor.cast_tree``: half activations, the kernels' half entry
points, float32 caches), MoE trees included.  Each prints the tree's
size before and after.

Exits 0 only if every request got ``--max-new`` tokens.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from repro_torch.configs import get_config, get_reduced
from repro_torch.models import registry
from repro_torch.quant import qtensor as qt
from repro_torch.quant.ptq import (DTYPES, check_lm_int8,
                                    quantize_lm_params)
from repro_torch.serve.engine import (ServeConfig, ServeEngine,
                                     check_servable)
from repro_torch.serve.request import Request


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--prompt-len", type=int, default=128)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--mixed", action="store_true",
                    help="pool low-relevance prompt spans (paper C1, 1-D)")
    ap.add_argument("--beta", type=int, default=2)
    ap.add_argument("--low-frac", type=float, default=0.5,
                    help="fraction of spans pooled when --mixed")
    ap.add_argument("--mask-variants", type=int, default=1,
                    help="with --mixed: rotate the pooled spans across K "
                    "distinct layouts (same n_low, different content: the "
                    "requests split into K waves)")
    ap.add_argument("--quant", choices=("fp32", "fp16", "bf16", "int8"),
                    default="fp32",
                    help="serving weight lane: int8 quantizes the "
                    "projection weights (per-output-channel, "
                    "repro_torch.quant; MoE experts stay float, MLA trees "
                    "are refused), fp16/bf16 cast the whole tree")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    check_servable(cfg)
    if args.quant == "int8":
        check_lm_int8(cfg)
    if cfg.family in ("ssm", "hybrid", "vit"):
        print(f"[serve] mixed prefill demo targets decoder LMs; "
              f"{args.arch} family={cfg.family} runs the plain path")
        args.mixed = False
    dev = torch.device(args.device)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = registry.init_params(cfg, gen, device=dev)
    if args.quant != "fp32":
        bytes0 = qt.tree_bytes(params)
        if args.quant == "int8":
            params = quantize_lm_params(params)
        else:
            params = qt.cast_tree(params, DTYPES[args.quant])
        print(f"[serve] quant={args.quant}: {bytes0 / 2**20:.1f} MiB -> "
              f"{qt.tree_bytes(params) / 2**20:.1f} MiB")
    sc = ServeConfig(max_batch=args.batch,
                     max_len=args.prompt_len + args.max_new + 8,
                     buckets=(args.prompt_len,), device=args.device)
    engine = ServeEngine(cfg, params, sc)

    rng = np.random.default_rng(0)
    masks = [None]
    beta = 0
    if args.mixed and cfg.mixed_res is not None:
        span = cfg.mixed_res.window * cfg.mixed_res.downsample
        n_spans = args.prompt_len // span
        n_low = int(n_spans * args.low_frac)
        masks = []
        for k in range(max(args.mask_variants, 1)):
            m = np.zeros((n_spans,), np.int32)
            for j in range(n_low):                # rotated pooled spans
                m[(k + j) % n_spans] = 1
            masks.append(m)
        beta = args.beta

    for rid in range(args.requests):
        prompt = rng.integers(0, cfg.vocab_size,
                              (args.prompt_len,)).astype(np.int32)
        engine.submit(Request(rid=rid, prompt=prompt,
                              max_new_tokens=args.max_new,
                              low_span_mask=masks[rid % len(masks)],
                              beta=beta))

    t0 = time.time()
    responses = engine.run()
    wall = time.time() - t0
    n_tok = sum(r.n_tokens for r in responses)
    print(f"[serve] {len(responses)} requests, {n_tok} tokens, "
          f"{wall:.2f}s ({n_tok / max(wall, 1e-9):.1f} tok/s), "
          f"waves={len(engine.wave_latencies)} "
          f"mixed={'on' if beta else 'off'}")
    ok = (len(responses) == args.requests and
          all(r.n_tokens == args.max_new for r in responses))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
