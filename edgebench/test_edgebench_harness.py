"""Whole runs on the CPU at the SIM size (ViTDet's 8-block, D 64, 256 px
variant): the harness's look for a card skipped, everything else as on
the card.  The plain reference holds the port's CPU path; a bf16 run of
the port, and runs with the timed path broken underneath, come out not
correct."""
from __future__ import annotations

import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from edgebench import harness
from edgebench import traffic_gen as tg
from edgebench.reference import vitdet_ref as ref

ROOT = Path(__file__).resolve().parents[1]
SEED = 2 ** 31 + 4321
SIM = {"n_layers": 8, "d_model": 64, "n_heads": 4, "head_dim": 16,
       "d_ff": 128, "img_size": 256, "patch_size": 16, "window_size": 2,
       "n_subsets": 4, "downsample": 2, "out_channels": 32, "n_classes": 8,
       "norm_eps": 1e-05}
# float32 on the CPU agrees with the reference to ~1e-7 (tiles) and
# ~1e-5 px (boxes); bf16 misses by ~1e-2 and ~0.1 px
LIMITS = {"score_gap": 1e-5, "box_gap_rel": 1e-3, "tile_err": 1e-4}


def sim_cell(tmp: Path, traffic: str, precision: str = "fp32") -> harness.Cell:
    """A cell at the SIM size with few clients, as a later change would
    add one: new files and a manifest entry, nothing edited."""
    bench = tmp / "edgebench"
    (bench / "configs").mkdir(parents=True)
    (bench / "traffic").mkdir()
    shutil.copytree(ROOT / "edgebench" / "metrics", bench / "metrics")
    cfg = json.loads((ROOT / "edgebench/configs/vitdet-l.fp32.json")
                     .read_text())
    cfg.update(name="sim", sizes=SIM, limits=LIMITS, precision=precision)
    if precision != "fp32":
        cfg["quant"] = {"weight_dtype": precision, "act_dtype": "fp32",
                        "prune_heads": 0}
    (bench / "configs" / "sim.json").write_text(json.dumps(cfg))
    mix = json.loads((ROOT / f"edgebench/traffic/{traffic}.json")
                     .read_text())
    mix.update(name="few", clients=4, frame_pool=4, preroll_s=0.0)
    if mix["plans"] == "mixed":
        mix["check"].update(clients=2, per_client=3)
        mix["region_bytes"].update(full=3000, low=600)
    else:
        mix.update(batch_buckets=[4])
        mix["check"].update(clients=4)
    (bench / "traffic" / "few.json").write_text(json.dumps(mix))
    man = json.loads((ROOT / "BENCHMARK.json").read_text())
    man["configs"] = [{"name": "sim", "source": "test",
                       "file": "edgebench/configs/sim.json", "reduced": [],
                       "why": "test"}]
    man["workloads"] = [{"name": "sim.few", "config": "sim",
                         "traffic": "few", "chips": 1, "why": "test"}]
    part = "mixed16" if mix["plans"] == "mixed" else "full32"
    for m in man["per_layer"] + man["end_to_end"]:
        if "workloads" in m:
            m["workloads"] = ["sim.few"] if m["name"].endswith(part) else []
    (tmp / "BENCHMARK.json").write_text(json.dumps(man))
    return harness.load_cell(tmp / "BENCHMARK.json", "sim.few")


class StepClock:
    """A clock that moves 5 ms a reading: a window serves the same
    offloads however busy the machine is."""

    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        self.t += 0.005
        return self.t


def run(cell, trace=False, seconds=1.0, **kw):
    return harness.run_cell(cell, SEED, seconds, trace, device="cpu",
                            t_start=0.0, clock=StepClock(), **kw)


def test_port_holds_to_the_reference_in_a_mixed_session(tmp_path):
    res = run(sim_cell(tmp_path, "phones-mixed"))
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 8
    assert set(res["checks"]) == {"score_gap", "box_gap_rel", "tile_err"}
    assert list(res["checks"]) == ["score_gap", "box_gap_rel", "tile_err"]
    assert list(res)[-1] == "checks"
    m = res["metrics"]
    assert set(m) == {"offloads_per_s.mixed16", "setup_s"}
    assert m["offloads_per_s.mixed16"]["value"] > 0


def test_traced_run_reports_per_layer_metrics(tmp_path):
    res = run(sim_cell(tmp_path, "cams-full"), trace=True)
    assert res["correct"], res["checks"]
    # the host's spans and counts read on any device; the device
    # metrics need a card's trace and are left out
    assert set(res["metrics"]) == {"dispatch_ms.full32", "wave_mfu.full32"}
    res = run(sim_cell(tmp_path / "m", "phones-mixed"), trace=True)
    assert res["correct"], res["checks"]
    m = {k: v["value"] for k, v in res["metrics"].items()}
    assert set(m) == {"dispatch_ms.mixed16", "frames_per_wave.mixed16",
                      "latency_p50_ms.mixed16", "latency_p95_ms.mixed16",
                      "useful_window_share.mixed16", "wave_mfu.mixed16"}
    assert m["latency_p95_ms.mixed16"] >= m["latency_p50_ms.mixed16"] > 0
    assert 0 < m["useful_window_share.mixed16"] <= 1
    assert 1 <= m["frames_per_wave.mixed16"] <= 4
    assert res["device"]["platform"] == "cpu"


def test_bf16_lane_fails_the_comparison(tmp_path):
    res = run(sim_cell(tmp_path, "cams-full", precision="bf16"))
    assert not res["correct"]
    assert res["checks"]["box_gap_rel"]["value"] > LIMITS["box_gap_rel"]


@pytest.mark.parametrize("control", [
    {"control_arith": ref.Arith(tf32=True)},
    {"quant": {"weight_dtype": "int8", "act_dtype": "fp16",
               "prune_heads": 0}}], ids=["reference-at-tf32", "int8-lane"])
def test_controls_fail_the_comparison(tmp_path, control):
    """Each configuration's control (the float32 one's reference at
    TF32, the fp16 one's int8 lane) in the program's place."""
    res = run(sim_cell(tmp_path, "phones-mixed"), **control)
    assert not res["correct"], res["checks"]


def _stale_cache(monkeypatch):
    """A session's state that never moves past its bootstrap."""
    from repro_torch.serve.request import FeatureCache
    orig = FeatureCache.update

    def update(self, tiles, reuse_ids, beta, frame, epoch=None, host=False):
        if self.tiles is None:
            return orig(self, tiles, reuse_ids, beta, frame, epoch, host)
        self.note(reuse_ids, beta, frame, epoch=epoch)
    monkeypatch.setattr(FeatureCache, "update", update)


def _half_batch(monkeypatch):
    """Each wave's second half served the first frame's pixels."""
    from repro_torch.offload.simulator import ServerModel
    orig = ServerModel.stage_frames

    def stage(self, frames):
        frames = list(frames)
        h = (len(frames) + 1) // 2
        return orig(self, frames[:h] + [frames[0]] * (len(frames) - h))
    monkeypatch.setattr(ServerModel, "stage_frames", stage)


def _altered_answer(monkeypatch):
    """One detection's score changed where the wave decodes it."""
    from repro_torch.offload.simulator import PendingWave
    orig = PendingWave.wait

    def wait(self):
        dets = orig(self)
        dets[-1][0] = dict(dets[-1][0], score=dets[-1][0]["score"] + 0.01)
        return dets
    monkeypatch.setattr(PendingWave, "wait", wait)


def _altered_class(monkeypatch):
    """One detection's class changed where the wave decodes it."""
    from repro_torch.offload.simulator import PendingWave
    orig = PendingWave.wait

    def wait(self):
        dets = orig(self)
        d = dets[0][0]
        dets[0][0] = dict(d, cls=(d["cls"] + 1) % 8)
        return dets
    monkeypatch.setattr(PendingWave, "wait", wait)


def _norm_without_affine(monkeypatch):
    """Every layer norm served without its scale and shift."""
    from repro_torch.models import layers
    orig = layers.layer_norm

    def layer_norm(x, weight, bias, eps=1e-5):
        return orig(x, torch.ones_like(weight), torch.zeros_like(bias), eps)
    monkeypatch.setattr(layers, "layer_norm", layer_norm)


def _no_qkv_bias(monkeypatch):
    """The q, k and v projections served without their bias."""
    from repro_torch.models import attention
    orig = attention._project_qkv

    def project(cfg, p, x, rope=None):
        return orig(cfg, {k: v for k, v in p.items() if k != "b_qkv"}, x,
                    rope)
    monkeypatch.setattr(attention, "_project_qkv", project)


def _no_ctr_bias(monkeypatch):
    """The head's centerness convolution served without its bias (one
    output channel: the smallest of the head's biases in effect)."""
    from repro_torch.core import det_head
    orig = det_head.conv2d

    def conv2d(x, p):
        if p["b"].numel() == 1:
            p = dict(p, b=torch.zeros_like(p["b"]))
        return orig(x, p)
    monkeypatch.setattr(det_head, "conv2d", conv2d)


@pytest.mark.parametrize("fault,traffic", [
    (_stale_cache, "phones-mixed"), (_half_batch, "cams-full"),
    (_altered_answer, "cams-full"), (_altered_class, "cams-full"),
    (_norm_without_affine, "phones-mixed"), (_no_qkv_bias, "phones-mixed"),
    (_no_ctr_bias, "cams-full")])
def test_broken_path_is_not_correct(tmp_path, monkeypatch, fault, traffic):
    fault(monkeypatch)
    res = run(sim_cell(tmp_path, traffic))
    assert not res["correct"], res["checks"]


def test_reference_replays_a_session(tmp_path):
    """The port serves a bootstrap and two REUSE offloads of one client;
    the reference, replaying the plans alone, gives the same tiles and
    detections."""
    cell = sim_cell(tmp_path, "phones-mixed")
    prog = harness.load_program()
    cfg = harness.model_config(prog, cell.config)
    params = harness.make_weights(prog, cfg, SIM, SEED, "cpu")
    srv = harness.make_server(prog, cfg, params, cell.config, None, "cpu")
    frames = harness.make_frames(SEED, 3, 256, "cpu")
    F, L, R = tg.FULL, tg.LOW, tg.REUSE
    plans = [[F] * 16, [R] * 4 + [L] * 6 + [F] * 6,
             [R] * 2 + [F] * 2 + [R] * 3 + [L] * 3 + [F] * 6]
    plans = [torch.tensor(p, dtype=torch.int8).numpy() for p in plans]
    cache = prog.FeatureCache(16, max_age=4)
    served = []
    for k, st in enumerate(plans):
        dets = srv.infer_wave(frames[k][None], [prog.RegionPlan(st)], beta=2,
                              caches=[cache], frame_ids=[k], capture_beta=2)
        served.append((dets[0], cache.tiles.clone()))
    raw = harness.raw_weights(SIM, SEED, "cpu")
    R_ = ref.ViTDetRef(ref.Geometry.from_sizes(SIM), raw)
    for k in range(3):
        reuse = {}
        for r, j in ref.reuse_sources(plans, k).items():
            reuse[r] = R_.forward(torch.from_numpy(frames[j]), plans[j], 2,
                                  stop_at_restore=True).tiles[r]
        out = R_.forward(torch.from_numpy(frames[k]), plans[k], 2, reuse)
        from edgebench import compare
        gaps = compare.detection_gaps(served[k][0], out.probs, out.boxes)
        assert gaps["box_gap_rel"] < LIMITS["box_gap_rel"], (k, gaps)
        assert gaps["score_gap"] < LIMITS["score_gap"], (k, gaps)
        assert compare.tile_error(served[k][1], out.tiles) < 1e-5
    assert ref.reuse_sources(plans, 2) == {0: 0, 1: 0, 4: 1, 5: 1, 6: 1}


def test_weights_are_the_benchmarks_own():
    """Every bias, shift and scale is drawn (none 0 or 1 throughout, so
    a program that drops one serves other answers); a seed gives one
    tree."""
    a = harness.raw_weights(SIM, SEED, "cpu")
    b = harness.raw_weights(SIM, SEED, "cpu")
    blk = a["blocks"][3]
    for leaf in (blk["attn"]["b_qkv"], blk["attn"]["b_o"],
                 blk["ffn"]["b_up"], blk["ffn"]["b_down"], blk["ln1"]["b"],
                 a["patch_embed"]["b"], a["head"]["box"]["b"]):
        assert leaf.abs().min() > 0 and 0.05 < leaf.std() < 0.2
    assert a["head"]["ctr"]["b"].abs().item() > 0
    assert (blk["ln2"]["w"] - 1).abs().mean() > 0.05
    assert -4.5 < a["head"]["cls"]["b"].mean() < -3.5
    assert len(a["blocks"]) == SIM["n_layers"]
    assert a["blocks"][0]["attn"]["w_qkv"].shape == (64, 192)
    assert a["head"]["smooth"][2]["w"].shape == (32, 32, 3, 3)
    assert torch.equal(a["blocks"][7]["ffn"]["w_down"],
                       b["blocks"][7]["ffn"]["w_down"])
    c = harness.raw_weights(SIM, SEED + 1, "cpu")
    assert not torch.equal(a["pos_emb"], c["pos_emb"])


def test_reference_keeps_float32_products_whatever_the_flags():
    """The reference turns TF32 off around its forward and puts the
    process's flags back after."""
    cuda, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    was = (cuda.allow_tf32, cudnn.allow_tf32)
    seen = []
    g = ref.Geometry.from_sizes(SIM)
    R = ref.ViTDetRef(g, harness.raw_weights(SIM, SEED, "cpu"))
    orig = R.block

    def block(*a):
        seen.append((cuda.allow_tf32, cudnn.allow_tf32))
        return orig(*a)
    R.block = block
    try:
        cuda.allow_tf32 = cudnn.allow_tf32 = True
        img = torch.rand(256, 256, 3)
        R.forward(img, torch.zeros(16, dtype=torch.int8).numpy(), 2)
        assert set(seen) == {(False, False)}
        assert (cuda.allow_tf32, cudnn.allow_tf32) == (True, True)
    finally:
        cuda.allow_tf32, cudnn.allow_tf32 = was


def test_throughput_counts_the_waves_at_the_edges_by_share():
    """Waves of 8 every 0.5 s give 16 offloads/s over any window, where
    a bare count would move by a wave as the window's edges fall."""
    done = [0.5 * k for k in range(1, 41) for _ in range(8)]
    for t0 in (2.0, 2.1, 2.37):
        n = harness.completed_between(done, t0, t0 + 10.0)
        assert n == pytest.approx(160.0)
    assert harness.completed_between(done, 0.7, 0.95) == pytest.approx(4.0)


def test_score_gap_is_read_against_the_frames_scores():
    """``score_gap_rel`` is the widest score gap over the mean of the
    reference's top scores; served answers equal to the reference's top
    read 0."""
    from edgebench import compare
    probs = torch.tensor([[0.02, 0.01], [0.04, 0.03], [0.005, 0.001]])
    boxes = torch.tensor([[0.0, 0.0, 8.0, 8.0], [4.0, 4.0, 12.0, 16.0],
                          [1.0, 1.0, 2.0, 2.0]])
    dets = [{"box": (4.0, 4.0, 12.0, 16.0), "score": 0.04, "cls": 0},
            {"box": (0.0, 0.0, 8.0, 8.0), "score": 0.02, "cls": 0}]
    g = compare.detection_gaps(dets, probs, boxes)
    assert g == {"score_gap": 0.0, "score_gap_rel": 0.0, "box_gap_rel": 0.0}
    dets[0]["score"] += 0.003
    g = compare.detection_gaps(dets, probs, boxes)
    assert g["score_gap"] == pytest.approx(0.003, rel=1e-5)
    assert g["score_gap_rel"] == pytest.approx(0.003 / 0.03, rel=1e-5)
    numbers = dict(g, tile_err=0.5)
    limits = {"score_gap_rel": 0.2, "box_gap_rel": 0.1}
    assert compare.verdict(numbers, limits)
    assert list(compare.checks_line(numbers, limits)) == [
        "score_gap_rel", "box_gap_rel"]
    assert not compare.verdict(numbers, dict(limits, score_gap_rel=0.05))


def test_tf32_control_rounds_the_products():
    x = torch.tensor([1.0 + 2 ** -12, 1.0 + 3 * 2 ** -11, -3.0 - 2 ** -20])
    assert ref.round_tf32(x).tolist() == [1.0, 1.0 + 2 ** -9, -3.0]


def test_no_card_no_number():
    """On a machine without a CUDA device the command prints no result
    and exits with another code than 0."""
    p = subprocess.run(
        [sys.executable, "edgebench/run.py", "--workload",
         "vitdet-l.fp32.cams-full", "--seed", str(SEED), "--seconds", "1",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=300, env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert p.returncode == 2
    assert p.stdout.strip() == ""
