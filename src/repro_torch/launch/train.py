"""LM training launcher: seeded weights, the reference's synthetic token
stream, checkpoints with async saves and resume, and a heartbeat monitor
(the port of ``repro.launch.train``).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-4b \\
      --reduced --steps 200 --batch 8 --seq 256 [--ckpt-dir DIR] \\
      [--resume] [--device cpu]
  PYTHONPATH=src python -m torch.distributed.run --nproc_per_node 2 \\
      -m repro_torch.launch.train --reduced --device cpu --model-par 2

``--arch`` is one of ``repro_torch.configs.ARCH_MODULES`` (every LM
arch of the reference: dense, MoE, SSM, hybrid, whisper-medium, whose
batches carry stub encoder frames, and llava-next-mistral-7b, whose
batches carry stub image embeddings).  Without ``--device cpu`` it
trains on the card, where every causal or cross attention of a GQA
layer launches the flash kernel (its ``autograd.Function``).  The reference's ``--backend``
chooses its kernel lane; the port routes by device, so it is refused.
Under ``torchrun`` (world size > 1) the step runs on the (world /
model_par, model_par) ("data", "model") mesh (``make_mesh``): NCCL with
one card a rank, or gloo with ``--device cpu``; every rank draws the
seeded tree and keeps its pieces, and rank 0 logs.  At world size 1
there is no mesh, as in the reference.

Exits 0 when the final loss is finite.
"""
from __future__ import annotations

import argparse
import os
import sys
import time
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch.configs import get_config, get_reduced
from repro_torch.distributed import sharding as shd
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models.config import ModelConfig
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import trainer as tr
from repro_torch.train.straggler import HeartbeatMonitor

# ---------------------------------------------------------------------------
# data: the reference's deterministic synthetic token stream, token for
# token (numpy, the same seed and draws)


def synthetic_batches(cfg: ModelConfig, batch: int, seq: int,
                      seed: int = 0, active_vocab: int = 4096
                      ) -> Iterator[Dict[str, np.ndarray]]:
    """Markov-chain token stream with a learnable bigram structure: each
    token of an ``active_vocab``-sized head of the vocabulary has four
    likely successors, taken with probability 0.9.  An encoder-decoder
    batch also carries "frames" (batch, encoder_seq_len, d_model) and a
    VLM batch "image_embeds" (batch, n_image_tokens, vision_hidden),
    float32 standard normals drawn after the batch's tokens from the
    same generator, as the reference draws them."""
    rng = np.random.default_rng(seed)
    V = min(cfg.vocab_size, active_vocab)
    succ = rng.integers(0, V, (V, 4))
    while True:
        toks = np.zeros((batch, seq + 1), np.int64)
        toks[:, 0] = rng.integers(0, V, (batch,))
        r = rng.random((batch, seq))
        pick = rng.integers(0, 4, (batch, seq))
        for t in range(seq):
            nxt = succ[toks[:, t], pick[:, t]]
            rand = rng.integers(0, V, (batch,))
            toks[:, t + 1] = np.where(r[:, t] < 0.9, nxt, rand)
        out = {"tokens": toks[:, :-1].astype(np.int32),
               "labels": toks[:, 1:].astype(np.int32)}
        if cfg.family == "encdec":
            out["frames"] = rng.normal(
                0, 1, (batch, cfg.encdec.encoder_seq_len, cfg.d_model)
            ).astype(np.float32)
        if cfg.family == "vlm":
            out["image_embeds"] = rng.normal(
                0, 1, (batch, cfg.vlm.n_image_tokens, cfg.vlm.vision_hidden)
            ).astype(np.float32)
        yield out


# ---------------------------------------------------------------------------


def make_mesh(model_par: int = 1, device: str = "cuda"):
    """None at world size 1 (the reference's rule), else the (world /
    model_par, model_par) mesh over the initialised world."""
    world = (torch.distributed.get_world_size()
             if torch.distributed.is_initialized() else 1)
    if world == 1:
        return None
    if world % model_par:
        raise ValueError(f"--model-par {model_par} does not divide the "
                         f"world of {world} ranks")
    return mesh_lib.make_local_mesh(world // model_par, model_par,
                                    torch.device(device).type)


def train(cfg: ModelConfig, steps: int, batch: int, seq: int,
          ckpt_dir: Optional[str] = None, resume: bool = False,
          save_every: int = 100, tc: Optional[tr.TrainConfig] = None,
          log_every: int = 10, seed: int = 0, device="cuda",
          log=print, mesh=None) -> Dict[str, float]:
    """Run the training loop from seed ``seed`` (or, with ``resume``, from
    the latest checkpoint under ``ckpt_dir``) up to step ``steps``;
    returns the reference's {final_loss, mean_last10, first_loss,
    wall_s}, plus every step's loss and host seconds (``losses``,
    ``step_s``; each step ends in a sync when its loss is read), the step
    it started from and the final ``(params, opt_state)`` (``state``).
    On a ``mesh`` the state is this rank's pieces; checkpoints hold full
    leaves (rank 0 writes; saves are synchronous)."""
    tc = tc or tr.TrainConfig(remat=False, total_steps=steps,
                              warmup_steps=max(steps // 20, 5))
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    named = None
    if mesh is None:
        params, opt_state = tr.init_train_state(cfg, gen, dev)
    else:
        params = tr.registry.init_params(cfg, gen, dev)
        named = shd.to_named(mesh, tr.train_shardings(cfg, mesh, params)[:2])
        params, opt_state = tr.shard_train_state(cfg, mesh, params)
    start_step = 0
    if resume and ckpt_dir and ckpt.latest_step(ckpt_dir) is not None:
        start_step = ckpt.latest_step(ckpt_dir)
        params, opt_state = ckpt.restore((params, opt_state), ckpt_dir,
                                         shardings=named)
        log(f"[train] resumed from step {start_step}")

    step_fn = tr.make_train_step(cfg, tc, mesh)
    monitor = HeartbeatMonitor(hosts=[0], interval=300.0)
    data = synthetic_batches(cfg, batch, seq, seed=seed + start_step)
    losses, step_s = [], []
    t_start = time.time()
    for s in range(start_step, steps):
        b = {k: torch.as_tensor(v, device=dev) for k, v in next(data).items()}
        t0 = time.time()
        params, opt_state, metrics = step_fn(params, opt_state, b)
        loss = float(metrics["loss"])
        losses.append(loss)
        step_s.append(time.time() - t0)
        monitor.beat(0, time.time(), step_time=step_s[-1])
        if log_every and (s % log_every == 0 or s == steps - 1):
            log(f"[train] step {s} loss {loss:.4f} lr {metrics['lr']:.2e} "
                f"({step_s[-1]:.2f}s/step)")
        if not np.isfinite(loss):
            raise FloatingPointError(f"loss diverged at step {s}")
        if ckpt_dir and save_every and (s + 1) % save_every == 0:
            if mesh is None:
                ckpt.save_async((params, opt_state), ckpt_dir, s + 1)
            else:
                ckpt.save((params, opt_state), ckpt_dir, s + 1, named)

    if ckpt_dir:
        ckpt.wait_pending_saves()
        ckpt.save((params, opt_state), ckpt_dir, steps, named)
    nan = float("nan")
    out = {"final_loss": losses[-1] if losses else nan,
           "mean_last10": float(np.mean(losses[-10:])) if losses else nan,
           "first_loss": losses[0] if losses else nan,
           "wall_s": time.time() - t_start,
           "losses": losses, "step_s": step_s, "start_step": start_step,
           "state": (params, opt_state)}
    log(f"[train] done: first={out['first_loss']:.4f} "
        f"last10={out['mean_last10']:.4f} wall={out['wall_s']:.0f}s")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--reduced", action="store_true",
                    help="use the CPU-scale reduced config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--save-every", type=int, default=100)
    ap.add_argument("--model-par", type=int, default=1,
                    help="the mesh's model axis (under torchrun)")
    ap.add_argument("--backend",
                    help="refused: the port routes each kernel by the "
                         "device of its input (kernels.dispatch)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.backend is not None:
        ap.error("--backend has no counterpart in repro_torch: a CUDA "
                 "tensor launches the kernel, a CPU tensor takes the plain "
                 "version (choose with --device)")
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world == 1:
        if args.model_par != 1:
            ap.error("--model-par above 1 needs a world of ranks: run "
                     "under torchrun (python -m torch.distributed.run)")
        out = train(cfg, args.steps, args.batch, args.seq,
                    ckpt_dir=args.ckpt_dir, resume=args.resume,
                    save_every=args.save_every, device=args.device)
        return 0 if np.isfinite(out["final_loss"]) else 1
    return _main_distributed(args, cfg)


def _main_distributed(args, cfg: ModelConfig) -> int:
    """One rank of a torchrun world: NCCL on this rank's card, or gloo
    with ``--device cpu``; rank 0 logs."""
    import torch.distributed as dist
    cpu = torch.device(args.device).type == "cpu"
    device = args.device
    if not cpu:
        local = int(os.environ.get("LOCAL_RANK", "0"))
        torch.cuda.set_device(local)
        device = f"cuda:{local}"
    dist.init_process_group("gloo" if cpu else "nccl")
    try:
        rank0 = dist.get_rank() == 0
        out = train(cfg, args.steps, args.batch, args.seq,
                    ckpt_dir=args.ckpt_dir, resume=args.resume,
                    save_every=args.save_every, device=device,
                    log=print if rank0 else (lambda *a: None),
                    mesh=make_mesh(args.model_par, device))
    finally:
        dist.destroy_process_group()
    return 0 if np.isfinite(out["final_loss"]) else 1


if __name__ == "__main__":
    sys.exit(main())
