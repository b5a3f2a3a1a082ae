#!/usr/bin/env python3
"""The JAX reference's trained SIM server, scored as ``chip_smoke.py``'s
phase 15 scores the port's: the reference's recipe
(``benchmarks/common.train_server_params``, 1800 steps at peak lr 5e-4,
B = 2), then ``ServerModel(SIM, params, top_k=32, score_thresh=0.4)``,
as ``benchmarks/common.get_server`` builds it, against the ground-truth
boxes of 16-frame ``walkS`` / ``walkB`` / ``cycleS`` clips: held-out
(seed 23) and the training clips (seed 7), beside the untrained seed-0
model, with each clip set's mean ``det_loss`` a frame.

Run on the CPU from the root of this checkout (about 9 min on 8 cores):

    PYTHONPATH=src JAX_PLATFORMS=cpu python3 reference_sim_f1.py

It writes no checkpoint and prints one line per scoring, then one JSON
line: mean frame F1, detections, boxes and mean loss for each.
"""
from __future__ import annotations

import json
import statistics
import sys
import time
from pathlib import Path

sys.path[:0] = [str(Path(__file__).resolve().parent),
                str(Path(__file__).resolve().parent / "src")]

import jax                                               # noqa: E402
import jax.numpy as jnp                                  # noqa: E402

from benchmarks import common as C                       # noqa: E402
from repro.configs.vitdet_l import SIM                   # noqa: E402
from repro.core import det_head as dh                    # noqa: E402
from repro.core import vit_backbone as vb                # noqa: E402
from repro.data import synthetic_video as sv             # noqa: E402
from repro.offload import detection as det               # noqa: E402
from repro.offload.simulator import ServerModel          # noqa: E402

VIDEOS, FRAMES = ("walkS", "walkB", "cycleS"), 16
CLIPS = (("held-out", 23), ("training", 7))


def main() -> None:
    t0 = time.perf_counter()
    trained = C.train_server_params(1800)
    print(f"trained in {time.perf_counter() - t0:.1f} s", flush=True)
    loss_fn = jax.jit(lambda p, img, tgt: dh.det_loss(
        SIM, vb.forward_det(SIM, p, img), tgt)[0])
    size = SIM.vit.img_size[0]
    out = {}
    for what, params in (("trained", trained), ("seed 0", C.registry_init())):
        server = ServerModel(SIM, params, top_k=32, score_thresh=0.4)
        for clips, seed in CLIPS:
            scores, losses, n_det, n_gt = [], [], 0, 0
            for name in VIDEOS:
                frames, gts = sv.make_clip(name, FRAMES, size=size, seed=seed)
                for frame, gt in zip(frames, gts):
                    dets = server.infer(frame)
                    scores.append(det.frame_f1(dets, gt))
                    n_det, n_gt = n_det + len(dets), n_gt + len(gt)
                    tgt = [{k: jnp.asarray(lv[k])[None]
                            for k in ("cls", "box", "pos")}
                           for lv in sv.render_targets(gt, size)]
                    losses.append(float(loss_fn(
                        params, jnp.asarray(frame)[None], tgt)))
            key = f"{what} {clips}"
            out[key] = {"f1": statistics.mean(scores), "detections": n_det,
                        "boxes": n_gt, "loss": statistics.mean(losses)}
            print(f"{key}: F1 {out[key]['f1']:.3f}, {n_det} detections, "
                  f"{n_gt} boxes, mean loss {out[key]['loss']:.3f}",
                  flush=True)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
