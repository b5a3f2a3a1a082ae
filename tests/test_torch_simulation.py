"""Port parity of the single-client offloading system: the reference
``Simulation`` against the port's on the same frames, trace, delay
models and policy, each driving its own package's ``ServerModel`` at SIM
scale on the same parameters (the port's on the CPU).

Policies: TrackB2B, a deterministic fixed-reuse policy (static LOW mask,
motion-gated REUSE at beta 2), ViTMAlis and ViTMAlis+Reuse with the
estimators carried across (the reference's MLPs, their parameters
converted).  One run injects an edge crash-restart, so that
``SoloScheduler.fault_tick``, ``ServerModel.restart`` and the
``StaleCacheEpoch`` NACK path are held against the reference.

Per offload, the decision (mask, quality, beta, plan states, capture
point), the payload size and every Eq. (2) delay term must be equal, the
decoded frame bit-equal, and the detections equal as sets within
DET_TOL (top-k may order ties differently).  ``SimResult.summary()``
agrees within SUMMARY_RTOL.  Both servers get one fixed inference-delay
anchor, so no wall clock enters a decision.
"""
import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs.vitdet_l import CONFIG as JCONFIG, SIM as JSIM
from repro.core import vit_backbone as jvb
from repro.data import network_traces as jnt
from repro.data import synthetic_video as jsv
from repro.models import registry
from repro.offload import baselines as jbl
from repro.offload import codec as jcd
from repro.offload import estimator as jest
from repro.offload import faults as jfa
from repro.offload import motion as jmo
from repro.offload import optimizer as jopt
from repro.offload import simulator as jsim
from repro_torch import convert
from repro_torch.configs.vitdet_l import CONFIG, SIM
from repro_torch.core import vit_backbone as vb
from repro_torch.data import network_traces as nt
from repro_torch.launch.offload import recording
from repro_torch.offload import baselines as bl
from repro_torch.offload import codec as cd
from repro_torch.offload import estimator as est
from repro_torch.offload import faults as fa
from repro_torch.offload import optimizer as opt
from repro_torch.offload import simulator as sim

ROOT = Path(__file__).resolve().parents[1]
SIZE, PATCH, FPS = 256, 16, 10
ANCHOR_S = 0.07              # the full-resolution delay both models share
DET_TOL = 1e-4               # detections: score and box, absolute
SUMMARY_RTOL = 1e-4
torch.set_num_threads(2)


@pytest.fixture(scope="module")
def servers():
    jparams = registry.init_params(JSIM, jax.random.PRNGKey(0))
    jsrv = jsim.ServerModel(JSIM, jparams, top_k=8, score_thresh=0.0)
    tsrv = sim.ServerModel(SIM, convert.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams), SIM, device="cpu"),
        top_k=8, score_thresh=0.0, device="cpu")
    return jsrv, tsrv


class FixedReuse:
    """Static LOW mask + motion-gated reuse at a fixed restoration point
    (as the reference's reuse and fault tests define it), over either
    package's Policy and ``build_reuse_plan``."""

    @staticmethod
    def make(policy_cls, build_reuse_plan, n_regions, lows=(0, 1, 2, 3),
             beta=2):
        class FixedReusePolicy(policy_cls):
            name = "fixed-reuse"
            use_tracker = True
            reuse_k = 3

            def decide(self, s, frame_idx):
                mask = np.zeros(n_regions, np.int32)
                mask[list(lows)] = 1
                cache = s.feature_cache
                elig = (cache.eligible(beta) if cache is not None
                        else np.zeros(n_regions, bool))
                plan = build_reuse_plan(s.part, mask, s.m, elig)
                return {"mask": mask, "quality": 85, "beta": beta,
                        "plan": plan, "capture_beta": beta}
        return FixedReusePolicy()


@pytest.fixture(scope="module")
def estimators():
    """Size and accuracy MLPs fitted by the reference on a small profile
    (sizes from the codec; a seeded accuracy stand-in that falls with
    LOW regions, early restoration and quality), and their port copies
    on converted parameters."""
    part = jvb.vit_partition(JSIM)
    frames, gts = jsv.make_clip("walkS", 6, size=SIZE, seed=11)
    an = jmo.RegionMotionAnalyzer(part, PATCH)
    codec = jcd.MixedResCodec(part, PATCH, part.downsample)
    rng = np.random.default_rng(0)
    X, ys, ya = [], [], []
    for fi, f in enumerate(frames):
        m, m_f = an.update(f)
        if fi < 2:
            continue
        rho = jmo.region_density(gts[fi], part, PATCH)
        phi = jmo.classify_regions(m, rho)
        for c in jopt.candidate_configs():
            mask = jmo.downsample_mask(phi, c.tau_d)
            n_d = int(mask.sum())
            X.append(jest.feature_vector(
                c.tau_d, n_d, float((mask * m).sum()), m_f, c.quality,
                float(rho.mean()), float(rho.std()), c.beta))
            ys.append(codec.encode_size_only(f, mask, c.quality) / 1024.0)
            ya.append(1.0 - 0.04 * n_d / max(c.beta, 1)
                      - 0.004 * (100 - c.quality) + rng.normal(0, 0.01))
    X = np.stack(X)
    out = []
    for y in (np.array(ys, np.float32), np.array(ya, np.float32)):
        je = jest.MLPEstimator(seed=0)
        je.fit(X, y, steps=300)
        te = est.MLPEstimator(device="cpu")
        te.load_params(convert.mlp_params_from_jax(
            jax.tree_util.tree_map(np.asarray, je.params), device="cpu"))
        te.x_mean, te.x_std = je.x_mean, je.x_std
        te.y_mean, te.y_std = je.y_mean, je.y_std
        out.append((je, te))
    return out


def _policies(name, part_j, part_t, ests):
    if name == "TrackB2B":
        return jbl.TrackB2B(), bl.TrackB2B()
    if name == "fixed-reuse":
        return (FixedReuse.make(jsim.Policy, jopt.build_reuse_plan,
                                part_j.n_regions),
                FixedReuse.make(sim.Policy, opt.build_reuse_plan,
                                part_t.n_regions))
    (js, ts), (ja, ta) = ests
    jo = jopt.OffloadOptimizer(part_j, js, ja, jopt.DelayModels(
        jcd.CodecDelayModel(), _inf(jest, jvb, JCONFIG),
        jest.ThroughputEstimator()))
    to = opt.OffloadOptimizer(part_t, ts, ta, opt.DelayModels(
        cd.CodecDelayModel(), _inf(est, vb, CONFIG),
        est.ThroughputEstimator()))
    if name == "ViTMAlis":
        return jbl.ViTMAlis(jo), bl.ViTMAlis(to)
    return jbl.ViTMAlisReuse(jo), bl.ViTMAlisReuse(to)


def _inf(estimator, backbone, cfg):
    part = backbone.vit_partition(cfg)
    return estimator.InferenceDelayModel.fit_from_flops(
        lambda n, b: backbone.backbone_flops(cfg, n, b), part.n_regions,
        betas=(0, 1, 2, 3, 4), full_res_delay_s=ANCHOR_S)


def _match(got, want):
    assert len(got) == len(want)
    left = list(want)
    for g in got:
        hit = [w for w in left if w["cls"] == g["cls"]
               and abs(w["score"] - g["score"]) <= DET_TOL
               and np.allclose(w["box"], g["box"], atol=DET_TOL, rtol=0)]
        assert hit, g
        left.remove(hit[0])


def _same_job(jj, tj):
    for k in ("frame", "n_d", "beta", "n_r", "capture_beta", "seq"):
        assert jj[k] == tj[k], k
    for k in ("submit", "size", "tput", "rtt", "t_enc", "t_up", "t_dec",
              "t_inf", "deadline", "spec_frac", "spec_conf", "done_at"):
        assert jj[k] == tj[k], k
    np.testing.assert_array_equal(jj["mask"], tj["mask"])
    np.testing.assert_array_equal(jj["plan"].states, tj["plan"].states)
    np.testing.assert_array_equal(jj["decoded"], tj["decoded"])
    for k in ("stale_epoch", "lost", "dup", "abandoned"):
        assert jj.get(k) == tj.get(k), k
    if jj.get("parts") is not None:
        assert jj["parts"] == tj["parts"]
        assert jj["e2e"] == tj["e2e"]
        assert jj["inf_f1"] == tj["inf_f1"]
    _match(tj["dets"], jj["dets"])


def _same_summary(a, b):
    assert a.keys() == b.keys()
    for k, v in a.items():
        if isinstance(v, str):
            assert v == b[k]
        elif math.isnan(v):
            assert math.isnan(b[k]), k
        else:
            assert b[k] == pytest.approx(v, rel=SUMMARY_RTOL, abs=1e-9), k


CASES = [  # (policy, video, frames, edge restart)
    ("TrackB2B", "cycleS", 16, False),
    ("fixed-reuse", "parkS", 16, False),
    ("ViTMAlis", "cycleS", 16, False),
    ("ViTMAlis+Reuse", "parkS", 16, False),
    # last: a real restart drops both servers' warm state
    ("fixed-reuse", "parkS", 24, True),
]


@pytest.mark.parametrize("policy,video,n_frames,restart", CASES,
                         ids=[f"{c[0]}-{c[1]}{'-restart' * c[3]}"
                              for c in CASES])
def test_simulation_matches_reference(servers, estimators, policy, video,
                                      n_frames, restart):
    jsrv, tsrv = servers
    part_j, part_t = jvb.vit_partition(JSIM), vb.vit_partition(SIM)
    frames, _ = jsv.make_clip(video, n_frames, size=SIZE, seed=23)
    jgt = [jsrv.infer(f) for f in frames]
    tgt = [tsrv.infer(f) for f in frames]
    jpol, tpol = _policies(policy, part_j, part_t, estimators)
    jkw, tkw = {}, {}
    if restart:
        spec = dict(edge_restarts=((0.45, 0.2),))
        jkw = dict(faults=jfa.FaultInjector(jfa.FaultSpec(**spec)),
                   robust=jfa.RobustConfig(slo_s=1.0))
        tkw = dict(faults=fa.FaultInjector(fa.FaultSpec(**spec)),
                   robust=fa.RobustConfig(slo_s=1.0))
    js = recording(jsim.Simulation)(
        frames, jgt, jnt.make_trace("4g", 3, duration_s=60), jpol, jsrv,
        part_j, PATCH, fps=FPS, inf_delay=_inf(jest, jvb, JCONFIG), **jkw)
    ts = recording(sim.Simulation)(
        frames, tgt, nt.make_trace("4g", 3, duration_s=60), tpol, tsrv,
        part_t, PATCH, fps=FPS, inf_delay=_inf(est, vb, CONFIG), **tkw)
    jstats0 = (jsrv.stats.reuse_splices, jsrv.stats.stale_epoch_rejects,
               jsrv.stats.restarts)
    tstats0 = (tsrv.stats.reuse_splices, tsrv.stats.stale_epoch_rejects,
               tsrv.stats.restarts)
    jr, tr = js.run(video), ts.run(video)

    assert len(js.jobs) == len(ts.jobs) >= 3
    for jj, tj in zip(js.jobs, ts.jobs):
        _same_job(jj, tj)
    _same_summary(jr.summary(), tr.summary())
    assert jr.sizes == tr.sizes
    assert jr.delay_parts == tr.delay_parts
    assert jr.offload_interval == tr.offload_interval
    assert jr.rendering_f1 == tr.rendering_f1
    assert js.rstats == ts.rstats
    assert (jsrv.stats.reuse_splices - jstats0[0],
            jsrv.stats.stale_epoch_rejects - jstats0[1],
            jsrv.stats.restarts - jstats0[2]) == \
        (tsrv.stats.reuse_splices - tstats0[0],
         tsrv.stats.stale_epoch_rejects - tstats0[1],
         tsrv.stats.restarts - tstats0[2])
    assert jsrv.epoch == tsrv.epoch
    if js.feature_cache is not None:
        jc, tc = js.feature_cache, ts.feature_cache
        np.testing.assert_array_equal(jc.age, tc.age)
        assert (jc.beta, jc.frame, jc.warm, jc.epoch) == \
            (tc.beta, tc.frame, tc.warm, tc.epoch)
        if "reuse" in policy.lower():
            assert any(j["n_r"] > 0 for j in ts.jobs), "REUSE never fired"
    if restart:
        assert ts.rstats["edge_restarts"] == 1
        assert ts.rstats["stale_epoch_nacks"] >= 1
        assert not tsrv.stats.warmed


def test_restart_drops_warm_state_and_bumps_epoch():
    tsrv = sim.ServerModel(SIM, convert.init_vitdet_params(
        SIM, torch.Generator().manual_seed(0), "cpu"), device="cpu",
        b_buckets=(1,))
    tsrv.warmup([(0, 0, 0, 0)], (1,))
    assert tsrv.stats.warmed and tsrv._keys
    e = tsrv.epoch
    assert tsrv.restart(preserve_executables=True) == e + 1
    assert tsrv.stats.warmed and tsrv._keys
    assert tsrv.restart() == e + 2
    assert tsrv.stats.restarts == 2
    assert not tsrv.stats.warmed and not tsrv._keys
    frame = np.zeros((SIZE, SIZE, 3), np.float32)
    tsrv.infer(frame)          # a first use of the new process, not a stall
    assert tsrv.stats.steady_compiles == 0
    tsrv.warmup([(0, 0, 0, 0)], (1,))
    assert tsrv.stats.warmed


def test_offload_launcher_runs_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.offload", "--sim",
         "--device", "cpu", "--frames", "12"], env=env, cwd=ROOT,
        capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.splitlines()
    for name in ("TrackB2B", "ViTMAlis", "ViTMAlis+Reuse"):
        hits = [ln for ln in lines if ln.split(":")[0].strip() == name]
        assert len(hits) == 1, out.stdout
        assert "rendering_f1=" in hits[0] and "e2e=" in hits[0]
    assert "steady first uses 0" in out.stdout
