"""End-to-end offloading simulation (paper §VI): TrackB2B, ViTMAlis and
ViTMAlis+Reuse on one synthetic video against one emulated network
trace, the port of ``examples/offload_simulation.py``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.offload [--video cycleS]
      [--trace 4g] [--frames 40] [--policies TrackB2B,ViTMAlis,...]
      [--device cpu] [--sim]

The server is ViTDet-L at full width (``--sim``: the SIM config) with
weights drawn from seed 0; no trained checkpoint is used, so every F1
here measures what LOW regions, REUSE and tracking lose against the
same model at full resolution (the ground truth), not detection
quality.  Before the simulations the launcher does, in a few lines each,
what the reference benchmarks' shared code does (without its disk
cache): it profiles (features, payload size, F1) over sample configs,
fits the size and accuracy MLP estimators, builds Algorithm 1's
optimizer, and computes the ground truth as full-resolution outputs.

The inference-delay model is the served config's FLOP curve anchored to
this device's own median full-resolution B=1 ``infer`` time after
warmup; the anchor is printed beside the device's name.  One summary
line per policy follows.  Exits 1 if a grid key first ran after warmup.
"""
from __future__ import annotations

import argparse
import inspect
import statistics
import subprocess
import sys
import time
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch import convert
from repro_torch.configs.vitdet_l import CONFIG, SIM
from repro_torch.core import vit_backbone as vb
from repro_torch.core.partition import Partition
from repro_torch.data import synthetic_video as sv
from repro_torch.data.network_traces import make_trace
from repro_torch.models.config import ModelConfig
from repro_torch.offload import baselines as bl
from repro_torch.offload import detection as det
from repro_torch.offload import motion as mo
from repro_torch.offload.codec import CodecDelayModel, MixedResCodec
from repro_torch.offload.estimator import (InferenceDelayModel, MLPEstimator,
                                           ThroughputEstimator,
                                           feature_vector,
                                           regression_metrics)
from repro_torch.offload.optimizer import (DelayModels, OffloadOptimizer,
                                           candidate_configs)
from repro_torch.offload.simulator import ServerModel, Simulation

FPS = 10
POLICIES = ("TrackB2B", "ViTMAlis", "ViTMAlis+Reuse")
BETAS = (1, 2, 3, 4)              # the restoration points Algorithm 1 picks
# the restoration point ViTMAlis+Reuse captures at on a full-res offload
REUSE_CAPTURE = inspect.signature(bl.ViTMAlisReuse).parameters[
    "capture_beta_default"].default
PROFILE_VIDEOS = ("walkS",)       # the profiling clips
PROFILE_FRAMES = 8                # frames of each profiling clip
PROFILE_SKIP = 2                  # frames that warm the motion model up
PROFILE_SEED = 11                 # the profiling clips' seed
GT_SEED = 23                      # the simulated clips' seed
FIT_STEPS = 1500                  # MLP estimator training steps
ANCHOR_REPS = 9                   # timed infers behind the delay anchor


def make_server(cfg: ModelConfig, dev: torch.device) -> ServerModel:
    """``cfg``'s ViTDet with weights from seed 0, decoding the top 32
    detections at score threshold 0 (random weights score near the
    focal prior), at batch bucket 1, warmed over every plan the policies
    can send (:func:`reachable_plan_space`)."""
    params = convert.init_vitdet_params(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    server = ServerModel(cfg, params, top_k=32, score_thresh=0.0,
                         b_buckets=(1,), device=dev)
    server.warmup(reachable_plan_space(server.part), (1,))
    return server


def sample_configs():
    """The profile's configs, as the reference benchmarks pick them:
    qualities 70 / 85 / 100 x beta 0 / 1 / 2 / 4, 21 of the candidate
    space (3 at tau_d 0, 9 each at tau_d 1 and 2)."""
    return [c for c in candidate_configs()
            if c.quality in (70, 85, 100) and c.beta in (0, 1, 2, 4)]


def build_profile_dataset(server: ServerModel, part: Partition, patch: int
                          ) -> Dict[str, np.ndarray]:
    """Offline profiling: (features, payload KiB, F1 against the frame's
    full-resolution output) for every sample config on every frame past
    the motion model's warm-up."""
    size = server.cfg.vit.img_size[0]
    codec = MixedResCodec(part, patch, part.downsample)
    X, y_size, y_acc = [], [], []
    for name in PROFILE_VIDEOS:
        frames, gts = sv.make_clip(name, PROFILE_FRAMES, size=size,
                                   seed=PROFILE_SEED)
        analyzer = mo.RegionMotionAnalyzer(part, patch)
        for fi, frame in enumerate(frames):
            m, m_f = analyzer.update(frame)
            if fi < PROFILE_SKIP:
                continue
            gt_dets = server.infer(frame)
            rho = mo.region_density(gts[fi], part, patch)
            phi = mo.classify_regions(m, rho)
            mu_r, sg_r = float(rho.mean()), float(rho.std())
            for c in sample_configs():
                mask = mo.downsample_mask(phi, c.tau_d)
                n_d = int(mask.sum())
                m_d = float((mask * m).sum())
                enc, decoded = codec.encode(frame, mask, c.quality)
                dets = server.infer(decoded, mask if n_d > 0 else None,
                                    c.beta if n_d > 0 else 0)
                X.append(feature_vector(c.tau_d, n_d, m_d, m_f, c.quality,
                                        mu_r, sg_r, c.beta))
                y_size.append(enc.payload_bytes / 1024.0)
                y_acc.append(det.frame_f1(dets, gt_dets))
    return {"X": np.stack(X), "y_size": np.array(y_size, np.float32),
            "y_acc": np.array(y_acc, np.float32)}


def fit_estimators(data: Dict[str, np.ndarray], device
                   ) -> Tuple[MLPEstimator, MLPEstimator, Dict]:
    """The size and accuracy MLPs on a seeded 80% split; returns them and
    their held-out regression metrics."""
    X, ys, ya = data["X"], data["y_size"], data["y_acc"]
    idx = np.random.default_rng(0).permutation(len(X))
    tr, te = idx[:int(len(X) * 0.8)], idx[int(len(X) * 0.8):]
    size_e, acc_e = MLPEstimator(device=device), MLPEstimator(device=device)
    size_e.fit(X[tr], ys[tr], steps=FIT_STEPS)
    acc_e.fit(X[tr], ya[tr], steps=FIT_STEPS)
    metrics = {k: regression_metrics(y[te], e.predict(X[te]))
               for k, e, y in (("size", size_e, ys), ("acc", acc_e, ya))}
    return size_e, acc_e, metrics


def delay_model(cfg: ModelConfig, anchor_s: float) -> InferenceDelayModel:
    """LM^inf_beta(N_d): the exact-length FLOP curve of ``cfg``, anchored
    so a full-resolution offload costs ``anchor_s``."""
    part = vb.vit_partition(cfg)
    return InferenceDelayModel.fit_from_flops(
        lambda n, b: vb.backbone_flops(cfg, n, b), part.n_regions,
        betas=(0,) + BETAS, full_res_delay_s=anchor_s)


def make_optimizer(part: Partition, size_est, acc_est,
                   inf_delay: InferenceDelayModel) -> OffloadOptimizer:
    delays = DelayModels(enc=CodecDelayModel(), inf=inf_delay,
                         net=ThroughputEstimator())
    return OffloadOptimizer(part, size_est, acc_est, delays)


def make_policy(name: str, size_est=None, acc_est=None, part=None,
                inf_delay=None):
    """A fresh policy of ``POLICIES`` by name (its own optimizer and
    throughput state)."""
    if name == "TrackB2B":
        return bl.TrackB2B()
    opt = make_optimizer(part, size_est, acc_est, inf_delay)
    if name == "ViTMAlis":
        return bl.ViTMAlis(opt)
    if name == "ViTMAlis+Reuse":
        return bl.ViTMAlisReuse(opt)
    raise ValueError(f"unknown policy {name!r}; choose from {POLICIES}")


def reachable_plan_space(part: Partition
                         ) -> List[Tuple[int, int, int, int]]:
    """Every (n_low, n_reuse, beta, capture) an offload of these policies
    can send: full resolution with and without a capture, and every
    FULL/LOW/REUSE mix that transmits a region at every beta (REUSE can
    turn LOW regions of a bucketed mask into any n_low).  It collapses
    onto a few grid keys in ``ServerModel.warmup``."""
    nR = part.n_regions
    space = [(0, 0, 0, 0), (0, 0, 0, REUSE_CAPTURE)]
    for beta in BETAS:
        for n_low in range(nR + 1):
            for n_reuse in range(nR - n_low + 1):
                if (n_low or n_reuse) and n_reuse < nR:
                    space.append((n_low, n_reuse, beta, beta))
    return space


def video_with_gt(server: ServerModel, name: str, n_frames: int):
    """Frames and the full-resolution outputs (the paper's ground
    truth)."""
    frames, _ = sv.make_clip(name, n_frames,
                             size=server.cfg.vit.img_size[0], seed=GT_SEED)
    return frames, [server.infer(f) for f in frames]


def median_infer_s(server: ServerModel, frame: np.ndarray) -> float:
    """Median wall time of a full-resolution B=1 ``infer`` (detections
    decoded on the host, so the device work is inside it)."""
    server.infer(frame)
    ts = []
    for _ in range(ANCHOR_REPS):
        t0 = time.perf_counter()
        server.infer(frame)
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts)


def recording(cls):
    """``cls``, a Simulation class, keeping each offload's job in
    ``jobs`` with the host wall time of its server call (the
    scheduler's ``submit``) in ``server_wall``."""
    class Recording(cls):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.jobs: List[Dict] = []
            submit = self.scheduler.submit

            def timed_submit(job, now):
                t0 = time.perf_counter()
                submit(job, now)
                job["server_wall"] = time.perf_counter() - t0
                self.jobs.append(job)
            self.scheduler.submit = timed_submit
    return Recording


RecordingSimulation = recording(Simulation)


def run_policy(server: ServerModel, frames, gt, trace, policy, part, patch,
               inf_delay, video: str):
    sim = RecordingSimulation(frames, gt, trace, policy, server, part, patch,
                              fps=FPS, inf_delay=inf_delay)
    return sim, sim.run(video_name=video)


def summary_line(name: str, res, jobs: Sequence[Dict]) -> str:
    s = res.summary()
    return (f"{name:>14}: rendering_f1={s['median_rendering_f1']:.3f} "
            f"inference_f1={s['mean_inference_f1']:.3f} "
            f"e2e={s['median_e2e_latency'] * 1e3:.0f}ms "
            f"net={s['median_net_delay'] * 1e3:.0f}ms "
            f"inf={s['median_inf_delay'] * 1e3:.0f}ms "
            f"interval={s['median_interval']:.0f} frames "
            f"offloads={len(jobs)} "
            f"reuse_offloads={sum(1 for j in jobs if j['n_r'] > 0)}")


def device_name(dev: torch.device) -> str:
    """The card's name and power limit as nvidia-smi gives them, or the
    CPU."""
    if dev.type != "cuda":
        return "cpu"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return smi.stdout.strip() or torch.cuda.get_device_name(dev)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--video", default="cycleS")
    ap.add_argument("--trace", default="4g")
    ap.add_argument("--frames", type=int, default=40)
    ap.add_argument("--policies", default=",".join(POLICIES))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--sim", action="store_true",
                    help="serve the SIM config (256x256, 8 blocks, D=64)")
    args = ap.parse_args(argv)
    policies = args.policies.split(",")
    if not set(policies) <= set(POLICIES):
        ap.error(f"--policies: choose from {','.join(POLICIES)}")

    cfg = SIM if args.sim else CONFIG
    dev = torch.device(args.device)
    part = vb.vit_partition(cfg)
    patch = cfg.vit.patch_size
    server = make_server(cfg, dev)
    n_keys = server.stats.compiles

    frames, gt = video_with_gt(server, args.video, args.frames)
    anchor = median_infer_s(server, frames[0])
    inf_delay = delay_model(cfg, anchor)
    data = build_profile_dataset(server, part, patch)
    size_e, acc_e, metrics = fit_estimators(data, dev)
    trace = make_trace(args.trace, 0, duration_s=args.frames // FPS + 60)

    print(f"{cfg.name} ({cfg.n_layers} blocks, D={cfg.d_model}, "
          f"{cfg.vit.img_size[0]}px) on {device_name(dev)}: {n_keys} grid "
          f"keys warmed; full-res anchor {anchor * 1e3:.2f} ms (measured)")
    print(f"profile {len(data['X'])} samples; held-out R2 size "
          f"{metrics['size']['R2']:.3f} acc {metrics['acc']['R2']:.3f}")
    print(f"video={args.video} ({args.frames} frames @ {FPS} FPS), "
          f"trace={args.trace} (mean {trace.mean_mbps:.1f} Mbps)\n")
    for name in policies:
        policy = make_policy(name, size_e, acc_e, part, inf_delay)
        sim, res = run_policy(server, frames, gt, trace, policy, part, patch,
                              inf_delay, args.video)
        print(summary_line(name, res, sim.jobs))
    print(f"\nsteady first uses {server.stats.steady_compiles}")
    return 1 if server.stats.steady_compiles else 0


if __name__ == "__main__":
    sys.exit(main())
