"""Port parity of the offload plane's client side: the numpy modules the
port copies (network traces, synthetic clips, region motion analysis,
the mixed-resolution codec and its delay model, the LK tracker,
detection F1, fault schedules and the degradation ladder, Algorithm 1's
helpers) against the reference on the same seeds.

The copies must be bit-equal: every array is compared with
``np.testing.assert_array_equal`` and every scalar with ``==``.  The
FLOP cost model is plain arithmetic and must be equal too.
``OffloadOptimizer.select`` must make the same choice in both packages
given the same estimators: least squares fitted on the same data, or
MLPs whose parameters are carried across (their predictions then differ
by float rounding only, which no choice here is near).
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs.vitdet_l import CONFIG as JCONFIG, SIM as JSIM
from repro.core import vit_backbone as jvb
from repro.core import partition as jpt
from repro.data import network_traces as jnt
from repro.data import synthetic_video as jsv
from repro.offload import codec as jcd
from repro.offload import detection as jdet
from repro.offload import estimator as jest
from repro.offload import faults as jfa
from repro.offload import motion as jmo
from repro.offload import optimizer as jopt
from repro.offload import tracker as jtk
from repro_torch import convert
from repro_torch.configs.vitdet_l import CONFIG, SIM
from repro_torch.core import partition as pt
from repro_torch.core import vit_backbone as vb
from repro_torch.data import network_traces as nt
from repro_torch.data import synthetic_video as sv
from repro_torch.offload import codec as cd
from repro_torch.offload import detection as det
from repro_torch.offload import estimator as est
from repro_torch.offload import faults as fa
from repro_torch.offload import motion as mo
from repro_torch.offload import optimizer as opt
from repro_torch.offload import tracker as tk

SIZE = 256                      # the SIM frame
PATCH = 16
PART = vb.vit_partition(SIM)
JPART = jvb.vit_partition(JSIM)


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _clip(name, n=8, seed=23):
    return jsv.make_clip(name, n, size=SIZE, seed=seed)


# ---------------------------------------------------------------------------
# traces and clips


@pytest.mark.parametrize("kind,kw", [
    ("4g", {}), ("5g", {}),
    ("4g", {"blackouts": 2, "storms": 1, "bufferbloat": 1,
            "extend": "wrap"})])
def test_make_trace_bit_equal(kind, kw):
    for index in range(3):
        a = jnt.make_trace(kind, index, duration_s=120, **kw)
        b = nt.make_trace(kind, index, duration_s=120, **kw)
        assert (a.name, a.kind, a.extend) == (b.name, b.kind, b.extend)
        _eq(a.tput_bps, b.tput_bps)
        _eq(a.rtt_s, b.rtt_s)
        for t in (0.0, 3.7, 119.9, 500.0):
            assert a.at(t) == b.at(t)


def test_trace_set_bit_equal():
    ja, pa = jnt.trace_set(2, 40), nt.trace_set(2, 40)
    assert [t.name for t in ja] == [t.name for t in pa]
    for a, b in zip(ja, pa):
        _eq(a.tput_bps, b.tput_bps)
        _eq(a.rtt_s, b.rtt_s)


@pytest.mark.parametrize("name", sorted(jsv.SCENARIOS))
def test_make_clip_bit_equal(name):
    fa_, ga = jsv.make_clip(name, 4, size=SIZE, seed=23)
    fb, gb = sv.make_clip(name, 4, size=SIZE, seed=23)
    _eq(fa_, fb)
    assert ga == gb
    for boxes in ga:
        for lv_a, lv_b in zip(jsv.render_targets(boxes, SIZE),
                              sv.render_targets(boxes, SIZE)):
            for k in lv_a:
                _eq(lv_a[k], lv_b[k])


# ---------------------------------------------------------------------------
# region motion analysis


@pytest.mark.parametrize("name", ["walkS", "cycleS", "parkS"])
def test_motion_analyzer_bit_equal(name):
    frames, gts = _clip(name)
    ja = jmo.RegionMotionAnalyzer(JPART, PATCH)
    pa = mo.RegionMotionAnalyzer(PART, PATCH)
    for f, g in zip(frames, gts):
        m_a, mf_a = ja.update(f)
        m_b, mf_b = pa.update(f)
        _eq(m_a, m_b)
        assert mf_a == mf_b
        rho_a = jmo.region_density(g, JPART, PATCH)
        rho_b = mo.region_density(g, PART, PATCH)
        _eq(rho_a, rho_b)
        phi_a = jmo.classify_regions(m_a, rho_a)
        phi_b = mo.classify_regions(m_b, rho_b)
        _eq(phi_a, phi_b)
        for tau in (0, 1, 2):
            _eq(jmo.downsample_mask(phi_a, tau), mo.downsample_mask(phi_b,
                                                                    tau))
        states = np.where(jmo.downsample_mask(phi_a, 2) != 0, pt.LOW,
                          pt.FULL).astype(np.int8)
        states[:3] = pt.REUSE
        assert jmo.prediction_confidence(m_a, states, m_f=mf_a) == \
            mo.prediction_confidence(m_b, states, m_f=mf_b)


# ---------------------------------------------------------------------------
# codec


@pytest.mark.parametrize("quality", [70, 95, 100])
@pytest.mark.parametrize("with_reuse", [False, True])
def test_codec_bit_equal(quality, with_reuse):
    frames, _ = _clip("cycleS", 3)
    mask = np.zeros(PART.n_regions, np.int32)
    mask[[1, 4, 6, 9, 15]] = 1
    reuse = None
    if with_reuse:
        reuse = np.zeros(PART.n_regions, np.int32)
        reuse[[0, 2, 12]] = 1
    ja = jcd.MixedResCodec(JPART, PATCH, JPART.downsample)
    pa = cd.MixedResCodec(PART, PATCH, PART.downsample)
    for f in frames:
        ea, da = ja.encode(f, mask, quality, reuse_mask=reuse)
        eb, db = pa.encode(f, mask, quality, reuse_mask=reuse)
        assert ea.payload_bytes == eb.payload_bytes
        assert ea.streams == eb.streams
        _eq(da, db)
        assert pa.encode_size_only(f, mask, quality, reuse_mask=reuse) == \
            eb.payload_bytes


def test_codec_delay_model_equal():
    ja, pa = jcd.CodecDelayModel(), cd.CodecDelayModel()
    for n_low in range(PART.n_regions + 1):
        for n_reuse in range(PART.n_regions + 1 - n_low):
            for q in (70, 95, 100):
                assert ja.encode_delay(JPART, n_low, q, n_reuse=n_reuse) \
                    == pa.encode_delay(PART, n_low, q, n_reuse=n_reuse)
            assert ja.decode_delay(JPART, n_low, n_reuse=n_reuse) == \
                pa.decode_delay(PART, n_low, n_reuse=n_reuse)


# ---------------------------------------------------------------------------
# tracker and detection F1


@pytest.mark.parametrize("name", ["cycleS", "walkB"])
def test_tracker_bit_equal(name):
    frames, gts = _clip(name, 10)
    dets = [dict(g, score=0.9) for g in gts[0]]
    ja, pa = jtk.LKTracker(), tk.LKTracker()
    ja.reinit(frames[0], dets)
    pa.reinit(frames[0], dets)
    for f in frames[1:]:
        assert ja.step(f) == pa.step(f)
        assert ja.retention == pa.retention
    assert ja.boxes() == pa.boxes()


def _random_dets(rng, n):
    xy = rng.uniform(0, 200, (n, 2))
    wh = rng.uniform(5, 60, (n, 2))
    return [{"box": tuple(float(v) for v in np.r_[p, p + s]),
             "score": float(rng.uniform()), "cls": int(rng.integers(0, 3))}
            for p, s in zip(xy, wh)]


@pytest.mark.parametrize("seed", range(4))
def test_frame_f1_equal(seed):
    rng = np.random.default_rng(seed)
    gts = _random_dets(rng, 6)
    # predictions: jittered ground truth plus strays
    preds = [{"box": tuple(v + float(rng.normal(0, 4)) for v in g["box"]),
              "score": float(rng.uniform()), "cls": g["cls"]}
             for g in gts[:4]] + _random_dets(rng, 3)
    for iou_t in (0.3, 0.5, 0.7):
        assert jdet.frame_f1(preds, gts, iou_t) == \
            det.frame_f1(preds, gts, iou_t)
        assert jdet.match_detections(preds, gts, iou_t) == \
            det.match_detections(preds, gts, iou_t)
    for a in preds:
        for b in gts:
            assert jdet.iou(a["box"], b["box"]) == det.iou(a["box"], b["box"])
    assert jdet.f1_score(0, 0, 0) == det.f1_score(0, 0, 0) == 1.0


# ---------------------------------------------------------------------------
# faults


@pytest.mark.parametrize("profile", ["none", "blackout", "handover_storm",
                                     "bufferbloat", "edge_restart",
                                     "response_loss"])
def test_fault_injector_schedule_equal(profile):
    for index in range(3):
        ja = jfa.FaultInjector.from_profile(profile, index)
        pa = fa.FaultInjector.from_profile(profile, index)
        assert ja.spec.__dict__ == pa.spec.__dict__
        ts = np.arange(0.0, 6.0, 0.05)
        for t in ts:
            assert ja.net(t, 2e7, 0.04) == pa.net(t, 2e7, 0.04)
            assert ja.uplink_down(t) == pa.uplink_down(t)
            assert ja.stall_extra(t) == pa.stall_extra(t)
            assert ja.edge_down(t) == pa.edge_down(t)
        for seq in range(12):
            assert ja.response_dropped(seq) == pa.response_dropped(seq)
            assert ja.response_duplicated(seq) == \
                pa.response_duplicated(seq)
        assert list(ja.restarts_between(0.0, 6.0)) == \
            list(pa.restarts_between(0.0, 6.0))
        trace = jnt.make_trace("4g", index, duration_s=10)
        jt, ptr = jfa.FaultyTrace(trace, ja), fa.FaultyTrace(trace, pa)
        assert (jt.name, jt.kind) == (ptr.name, ptr.kind)
        for t in ts:
            assert jt.at(t) == ptr.at(t)


def test_degradation_ladder_equal():
    rng = np.random.default_rng(3)
    ja = jfa.DegradationLadder(jfa.RobustConfig(slo_s=0.8))
    pa = fa.DegradationLadder(fa.RobustConfig(slo_s=0.8))
    now = 0.0
    for step in range(40):
        now += 0.1
        if rng.uniform() < 0.45:
            ja.on_failure(now)
            pa.on_failure(now)
        else:
            ja.on_success()
            pa.on_success()
        assert (ja.level, ja.retry_at, ja.backoff, ja.shedding) == \
            (pa.level, pa.retry_at, pa.backoff, pa.shedding)
        m = rng.uniform(0, 0.2, PART.n_regions).astype(np.float32)
        states = rng.integers(0, 3, PART.n_regions).astype(np.int8)
        for dec in ({"mask": (states == pt.LOW).astype(np.int32),
                     "quality": 95, "beta": 0},
                    {"mask": (states == pt.LOW).astype(np.int32),
                     "quality": 85, "beta": 2,
                     "plan": jpt.RegionPlan(states)}):
            da = ja.degrade(dict(dec), m)
            dec_b = dict(dec)
            if "plan" in dec_b:
                dec_b["plan"] = pt.RegionPlan(states)
            db = pa.degrade(dec_b, m)
            assert sorted(da) == sorted(db)
            for k in da:
                if k == "plan":
                    _eq(da[k].states, db[k].states)
                else:
                    _eq(da[k], db[k])
    assert jfa.fresh_rstats() == fa.fresh_rstats()


# ---------------------------------------------------------------------------
# the FLOP cost model


@pytest.mark.parametrize("which", ["full", "sim"])
def test_backbone_flops_equal(which):
    jcfg, cfg = (JCONFIG, CONFIG) if which == "full" else (JSIM, SIM)
    part = vb.vit_partition(cfg)
    edges = (None, pt.length_bucket_set(part))
    assert jpt.length_bucket_set(jvb.vit_partition(jcfg)) == edges[1]
    for n_low in range(part.n_regions + 1):
        for n_reuse in range(part.n_regions + 1 - n_low):
            for beta in range(cfg.vit.n_subsets + 1):
                for le in edges:
                    assert jvb.backbone_flops(jcfg, n_low, beta, n_reuse,
                                              length_edges=le) == \
                        vb.backbone_flops(cfg, n_low, beta, n_reuse,
                                          length_edges=le)
    for nw in range(1, part.n_regions * part.windows_per_full_region + 1):
        for beta in range(cfg.vit.n_subsets + 1):
            assert jvb.backbone_flops_windows(jcfg, nw, beta) == \
                vb.backbone_flops_windows(cfg, nw, beta)


# ---------------------------------------------------------------------------
# Algorithm 1 and its helpers


def test_candidate_configs_and_reuse_plan_equal():
    assert [c.astuple() for c in jopt.candidate_configs()] == \
        [c.astuple() for c in opt.candidate_configs()]
    rng = np.random.default_rng(5)
    for _ in range(20):
        mask = (rng.uniform(size=PART.n_regions) < 0.4).astype(np.int32)
        m = np.where(rng.uniform(size=PART.n_regions) < 0.5, 0.0,
                     rng.uniform(0, 0.1, PART.n_regions)).astype(np.float32)
        elig = rng.uniform(size=PART.n_regions) < 0.7
        _eq(jopt.build_reuse_plan(JPART, mask, m, elig).states,
            opt.build_reuse_plan(PART, mask, m, elig).states)
        Z = [{"T": float(t), "A": float(a)}
             for t, a in rng.uniform(size=(12, 2))]
        fa_, fb = jopt.pareto_frontier(Z), opt.pareto_frontier(Z)
        assert fa_ == fb
        assert jopt.knee_point(fa_) == opt.knee_point(fb)


def _profile():
    """A small (features, size, accuracy) set from one clip, as the
    launcher's profile builds it (F1 replaced by a seeded stand-in)."""
    frames, gts = _clip("walkS", 6, seed=11)
    an = jmo.RegionMotionAnalyzer(JPART, PATCH)
    codec = jcd.MixedResCodec(JPART, PATCH, JPART.downsample)
    rng = np.random.default_rng(0)
    X, ys, ya = [], [], []
    for fi, f in enumerate(frames):
        m, m_f = an.update(f)
        if fi < 2:
            continue
        rho = jmo.region_density(gts[fi], JPART, PATCH)
        phi = jmo.classify_regions(m, rho)
        for c in jopt.candidate_configs():
            mask = jmo.downsample_mask(phi, c.tau_d)
            X.append(jest.feature_vector(
                c.tau_d, int(mask.sum()), float((mask * m).sum()), m_f,
                c.quality, float(rho.mean()), float(rho.std()), c.beta))
            ys.append(codec.encode_size_only(f, mask, c.quality) / 1024.0)
            ya.append(float(np.clip(1.0 - 0.1 * mask.sum() / c.beta
                                    if c.beta else 1.0, 0, 1)
                            - 0.002 * (100 - c.quality)
                            + rng.normal(0, 0.01)))
    return (np.stack(X), np.array(ys, np.float32),
            np.array(ya, np.float32))


def _estimators(kind, X, ys, ya):
    if kind == "linear":
        pairs = []
        for y in (ys, ya):
            a, b = jest.LinearEstimator(), est.LinearEstimator()
            a.fit(X, y)
            b.fit(X, y)
            pairs.append((a, b))
        return pairs
    pairs = []
    for y in (ys, ya):
        a = jest.MLPEstimator(seed=0)
        a.fit(X, y, steps=60)
        b = est.MLPEstimator(device="cpu")
        b.load_params(convert.mlp_params_from_jax(
            jax.tree_util.tree_map(np.asarray, a.params), device="cpu"))
        b.x_mean, b.x_std = a.x_mean, a.x_std
        b.y_mean, b.y_std = a.y_mean, a.y_std
        pairs.append((a, b))
    return pairs


@pytest.mark.parametrize("kind", ["linear", "mlp"])
def test_optimizer_select_same_choice(kind):
    torch.set_num_threads(2)
    X, ys, ya = _profile()
    (sa, sb), (aa, ab) = _estimators(kind, X, ys, ya)
    inf_a = jest.InferenceDelayModel.fit_from_flops(
        lambda n, b: jvb.backbone_flops(JCONFIG, n, b), JPART.n_regions,
        betas=(0, 1, 2, 3, 4), full_res_delay_s=0.07)
    inf_b = est.InferenceDelayModel.fit_from_flops(
        lambda n, b: vb.backbone_flops(CONFIG, n, b), PART.n_regions,
        betas=(0, 1, 2, 3, 4), full_res_delay_s=0.07)
    oa = jopt.OffloadOptimizer(JPART, sa, aa, jopt.DelayModels(
        jcd.CodecDelayModel(), inf_a, jest.ThroughputEstimator()))
    ob = opt.OffloadOptimizer(PART, sb, ab, opt.DelayModels(
        cd.CodecDelayModel(), inf_b, est.ThroughputEstimator()))
    frames, gts = _clip("cycleS", 8)
    an = jmo.RegionMotionAnalyzer(JPART, PATCH)
    rng = np.random.default_rng(1)
    for fi, f in enumerate(frames):
        m, m_f = an.update(f)
        rho = jmo.region_density(gts[fi], JPART, PATCH)
        for state in (jopt.SystemState(), jopt.SystemState(eta=40),
                      jopt.SystemState(kappa=0.5)):
            tput = float(rng.uniform(5e6, 5e7))
            for o in (oa, ob):
                o.delays.net = type(o.delays.net)()
                o.delays.net.observe(tput, 0.04, t=0.0)
            za = oa.select(m, m_f, rho, state)
            zb = ob.select(m, m_f, rho, opt.SystemState(**state.__dict__))
            assert za["config"].astuple() == zb["config"].astuple()
            assert za["N_d"] == zb["N_d"]
            _eq(za["mask"], zb["mask"])
            _eq(za["phi"], zb["phi"])
            if kind == "linear":
                assert (za["T"], za["A"]) == (zb["T"], zb["A"])
            else:
                np.testing.assert_allclose(zb["T"], za["T"], rtol=1e-5)
                np.testing.assert_allclose(zb["A"], za["A"], rtol=1e-5,
                                           atol=1e-6)
