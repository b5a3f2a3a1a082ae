"""Train the detector the edge serves: the port of the reference's
``benchmarks/common.py:train_server_params`` and ``get_server`` (the
trained SIM server behind its examples and F1 benches), over the port's
parameter tree.

The recipe is the reference's: weights from a seed; a pool of frames
with analytic targets (``data.synthetic_video.render_targets``) from
16-frame ``make_clip(name, 16, size, seed=7)`` clips of ``walkS``,
``walkB`` and ``cycleS``; ``np.random.default_rng(0)`` draws each batch;
``forward_det`` -> ``det_loss`` -> gradients (the attention kernels'
analytic backward, ``kernels/*/ops.py``) -> AdamW (``grad_clip`` 1.0,
in place on a copy of the weights) at ``warmup_cosine`` (warmup 50
steps).  The same function trains the
full-width ViTDet-L given ``CONFIG``: the frames are drawn at the
config's ``img_size`` and the targets carry its classes.

The optimiser runs over the flat view of the tree
(``train.checkpoint.flatten``) without the derived position layouts
(``vit_backbone.DERIVED_KEYS``): the loss derives ``pos_seq`` from
``pos_emb`` inside the graph, so ``pos_emb`` gets its gradient and the
layout is never stale; the returned tree has both layouts derived anew
for serving.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import convert
from repro_torch.configs.vitdet_l import SIM
from repro_torch.core import det_head as dh
from repro_torch.core import vit_backbone as vb
from repro_torch.data import synthetic_video as sv
from repro_torch.models.config import ModelConfig
from repro_torch.offload.simulator import ServerModel
from repro_torch.optim import adam
from repro_torch.optim.schedules import warmup_cosine
from repro_torch.train import checkpoint as ckpt

PROFILE_VIDEOS = ("walkS", "walkB", "cycleS")   # the training clips
CLIP_FRAMES = 16
CLIP_SEED = 7
WARMUP_STEPS = 50
TARGET_KEYS = ("cls", "box", "pos")


def seed0_params(cfg: ModelConfig, device: torch.device) -> Dict:
    """``cfg``'s ViTDet weights drawn from seed 0, as the reference's
    recipe starts from ``PRNGKey(0)``."""
    return convert.init_vitdet_params(
        cfg, torch.Generator(device=device).manual_seed(0), device=device)


def training_pool(cfg: ModelConfig) -> Tuple[np.ndarray, List]:
    """Frames (N, S, S, 3) and their per-level targets."""
    size = cfg.vit.img_size[0]
    frames, targets = [], []
    for name in PROFILE_VIDEOS:
        fs, gts = sv.make_clip(name, CLIP_FRAMES, size=size, seed=CLIP_SEED)
        for f, g in zip(fs, gts):
            frames.append(f)
            targets.append(sv.render_targets(g, size,
                                             n_classes=cfg.vit.n_classes))
    return np.stack(frames), targets


def make_batch(frames: np.ndarray, targets: List, idx: np.ndarray,
               device) -> Tuple[torch.Tensor, List[Dict[str, torch.Tensor]]]:
    """The frames and stacked per-level targets of pool rows ``idx``."""
    img = torch.from_numpy(frames[idx]).to(device)
    tgt = [{k: torch.from_numpy(np.stack([targets[i][lv][k] for i in idx]))
            .to(device) for k in TARGET_KEYS}
           for lv in range(len(targets[0]))]
    return img, tgt


def loss_fn(cfg: ModelConfig, params: Dict, img: torch.Tensor,
            tgt: List[Dict[str, torch.Tensor]]):
    """``det_loss`` of ``forward_det`` on the full-resolution lane.
    ``params`` is the tree without the derived layouts; the one this lane
    reads, ``pos_seq``, is derived here from its ``pos_emb``, inside the
    autograd graph."""
    p = {**params, "pos_seq": vb.position_seq(cfg, params["pos_emb"])}
    return dh.det_loss(cfg, vb.forward_det(cfg, p, img), tgt)


def value_and_grad(cfg: ModelConfig, flat: Dict[str, torch.Tensor],
                   like: Dict, img: torch.Tensor, tgt
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The loss and the gradient of every leaf of ``flat`` (the flat
    view of ``like``).  A leaf the loss does not reach raises."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in flat.items()}
    loss, _ = loss_fn(cfg, ckpt.unflatten(leaves, like), img, tgt)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.detach(), dict(zip(leaves, grads))


def train_server_params(cfg: ModelConfig = SIM, steps: int = 1800,
                        peak_lr: float = 5e-4, batch: int = 2,
                        log_every: int = 200, *, params: Optional[Dict] = None,
                        device="cuda", log=print) -> Tuple[Dict, Dict]:
    """Train ``cfg``'s ViTDet on the synthetic clips; returns the trained
    tree (position layouts derived) and the run's metrics: every step's
    loss (``losses``) and host wall seconds (``step_s``, each step ends
    in a device sync when its loss is read), the total ``wall_s``, and
    the first and last losses.  ``params`` (default: the seed-0 init,
    ``convert.init_vitdet_params``) is not modified.

    peak_lr above ~5e-4 destabilises the SIM run in the reference (the
    loss climbs back after the warmup)."""
    dev = torch.device(device)
    if params is None:
        params = seed0_params(cfg, dev)
    like = vb.strip_derived(params)
    # AdamW updates in place: train a copy, leave ``params`` as it is
    flat = {k: v.detach().clone() for k, v in ckpt.flatten(like).items()}
    opt = adam.init_adam(flat)
    frames, targets = training_pool(cfg)
    rng = np.random.default_rng(0)
    losses: List[float] = []
    step_s: List[float] = []
    t_run = time.perf_counter()
    for s in range(steps):
        t0 = time.perf_counter()
        img, tgt = make_batch(frames, targets,
                              rng.integers(0, len(frames), batch), dev)
        loss, grads = value_and_grad(cfg, flat, like, img, tgt)
        lr = warmup_cosine(s, peak_lr=peak_lr, warmup_steps=WARMUP_STEPS,
                           total_steps=steps)
        _, opt, _ = adam.adam_update(grads, opt, flat, lr=lr,
                                     grad_clip=1.0)
        del grads
        losses.append(float(loss))
        step_s.append(time.perf_counter() - t0)
        if log_every and s % log_every == 0:
            log(f"[server-train] step {s} loss {losses[-1]:.3f} lr {lr:.1e}")
    if not all(bool(torch.isfinite(t).all()) for t in flat.values()):
        raise FloatingPointError("server training diverged: a parameter is "
                                 "not finite")
    trained = vb.add_position_banks(cfg, ckpt.unflatten(flat, like))
    return trained, {"losses": losses, "step_s": step_s,
                     "wall_s": time.perf_counter() - t_run,
                     "first_loss": losses[0] if losses else None,
                     "last_loss": losses[-1] if losses else None}


def get_server(ckpt_dir: str, steps: int = 1800, device="cuda",
               log=print) -> ServerModel:
    """The trained SIM server: restored from the checkpoint of step
    ``steps`` under ``ckpt_dir``, else trained for ``steps`` and saved
    there (the reference restores whatever step it finds; a run asking
    for another step count here trains anew).  Served as the reference
    serves it: top 32 detections at score 0.4."""
    dev = torch.device(device)
    init = seed0_params(SIM, dev)
    like = vb.strip_derived(init)
    if steps in ckpt.steps(ckpt_dir):
        params = vb.add_position_banks(SIM, ckpt.restore(like, ckpt_dir,
                                                         steps))
    else:
        params, _ = train_server_params(SIM, steps, params=init,
                                        device=dev, log=log)
        ckpt.save(vb.strip_derived(params), ckpt_dir, step=steps)
    return ServerModel(SIM, params, top_k=32, score_thresh=0.4, device=dev)
