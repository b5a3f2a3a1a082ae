"""Port parity of the multi-client edge: ``repro.serve.edge`` against
``repro_torch.serve.edge`` at SIM scale, each package driving its own
``BatchedServerModel`` on the same seed-0 parameters (the port's on the
CPU).

* ``infer_batch`` / ``infer_plans`` waves against solo runs (different
  masks, mixed length buckets, per-client REUSE caches) and against the
  reference's waves; ``stage_frames`` on a CPU server; the partition's
  region-id helpers and the speculative helpers equal to the reference.
* The speculative clone: a discarded speculation leaves the live
  session's tiles byte-identical (``FeatureCache.update`` must not write
  a buffer the clone shares with the live session).
* ``MultiClientSimulation`` for three or four clients: barrier,
  continuous with ``stage_ahead``, cross-bucket coalescing, admission
  degrade and shed, ``max_batch`` above the largest bucket, an edge
  crash-restart and continuous + ``speculate`` on the bench's slow uplink.
  Per job: equal decisions, plan states, Eq. (2) terms and outcome
  flags, detections equal as sets within DET_TOL; ``EdgeStats`` equal.
  Both packages get the same fixed inference-delay models, so no wall
  clock enters a decision.
"""
import dataclasses
import warnings
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from repro.configs.vitdet_l import SIM as JSIM
from repro.core import partition as jpt
from repro.core import vit_backbone as jvb
from repro.data import network_traces as jnt
from repro.data import synthetic_video as jsv
from repro.models import registry
from repro.offload import estimator as jest
from repro.offload import faults as jfa
from repro.offload import optimizer as jopt
from repro.offload import simulator as jsim
from repro.serve import edge as jedge
from repro.serve import request as jreq
from repro_torch import convert
from repro_torch.configs.vitdet_l import SIM
from repro_torch.core import partition as tpt
from repro_torch.core import vit_backbone as tvb
from repro_torch.data import network_traces as tnt
from repro_torch.data import synthetic_video as tsv
from repro_torch.offload import estimator as tes
from repro_torch.offload import faults as tfa
from repro_torch.offload import optimizer as topt
from repro_torch.offload import simulator as tsim
from repro_torch.serve import edge as tedge
from repro_torch.serve import request as treq

SIZE, PATCH, FPS = 256, 16, 10
DET_TOL = 1e-4               # detections: score and box, absolute
TILE_TOL = 1e-4              # captured tiles, absolute
torch.set_num_threads(2)

PKGS = {
    "ref": SimpleNamespace(sim=jsim, edge=jedge, sv=jsv, nt=jnt, fa=jfa,
                           opt=jopt, pt=jpt, req=jreq, vb=jvb, est=jest,
                           cfg=JSIM),
    "port": SimpleNamespace(sim=tsim, edge=tedge, sv=tsv, nt=tnt, fa=tfa,
                            opt=topt, pt=tpt, req=treq, vb=tvb, est=tes,
                            cfg=SIM)}


@pytest.fixture(scope="module")
def params():
    jparams = registry.init_params(JSIM, jax.random.PRNGKey(0))
    tparams = convert.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams), SIM, device="cpu")
    return jparams, tparams


def make_servers(params, **kw):
    jparams, tparams = params
    kw = dict(top_k=8, score_thresh=0.0, **kw)
    return {"ref": jedge.BatchedServerModel(JSIM, jparams, **kw),
            "port": tedge.BatchedServerModel(SIM, tparams, device="cpu",
                                             **kw)}


@pytest.fixture(scope="module")
def servers(params):
    return make_servers(params)


@pytest.fixture(scope="module")
def servers_b4(params):
    """One batch bucket (4): coalesced waves share one key with solo
    reruns, as ``tests/test_serving_hotpath.py`` sets it up."""
    return make_servers(params, b_buckets=(4,))


def _match(got, want, tol=DET_TOL):
    assert len(got) == len(want)
    left = list(want)
    for g in got:
        hit = [w for w in left if w["cls"] == g["cls"]
               and abs(w["score"] - g["score"]) <= tol
               and np.allclose(w["box"], g["box"], atol=tol, rtol=0)]
        assert hit, g
        left.remove(hit[0])


def _mask(n_regions, lows):
    m = np.zeros(n_regions, np.int32)
    m[list(lows)] = 1
    return m


def _frames(n, seed):
    return np.random.default_rng(seed).uniform(
        0, 1, (n, SIZE, SIZE, 3)).astype(np.float32)


# ---------------------------------------------------------------------------
# host-side helpers


def test_region_id_helpers_match_reference():
    rng = np.random.default_rng(4)
    nR = 16
    for _ in range(20):
        states = rng.integers(0, 3, nR).astype(np.int8)
        n_low = int(rng.integers(0, 9))
        n_reuse = int(rng.integers(0, nR - n_low + 1))
        for a, b in zip(tpt.plan_to_region_ids(states, n_low, n_reuse),
                        jpt.plan_to_region_ids(states, n_low, n_reuse)):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype
        mask = (states == 1).astype(np.int32)
        for a, b in zip(tpt.mask_to_region_ids(mask, n_low),
                        jpt.mask_to_region_ids(mask, n_low)):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(
            tpt.region_ids_to_mask(np.nonzero(mask)[0], nR),
            jpt.region_ids_to_mask(np.nonzero(mask)[0], nR))
    masks = [_mask(nR, range(s, s + 4)) for s in (0, 4, 8)]
    for a, b in zip(tedge.stack_region_ids(masks, 4),
                    jedge.stack_region_ids(masks, 4)):
        np.testing.assert_array_equal(a, b)
    full, low = tedge.stack_region_ids(masks, 4)
    assert full.shape == (3, nR - 4) and sorted(low[1]) == [4, 5, 6, 7]
    states = [np.array([0] * 8 + [1] * 4 + [2] * 4, np.int8),
              np.array([2] * 4 + [1] * 4 + [0] * 8, np.int8)]
    tp = [tpt.RegionPlan(s) for s in states]
    jp = [jpt.RegionPlan(s) for s in states]
    for a, b in zip(tedge.stack_plan_ids(tp, 4, 4),
                    jedge.stack_plan_ids(jp, 4, 4)):
        np.testing.assert_array_equal(a, b)


def test_speculative_helpers_match_reference():
    tpart, jpart = tvb.vit_partition(SIM), jvb.vit_partition(JSIM)
    rpx = tpart.region * PATCH
    rng = np.random.default_rng(9)
    pred = rng.uniform(0, 1, (SIZE, SIZE, 3)).astype(np.float32)
    dec = pred.copy()
    dec[:rpx, :rpx] += 0.3
    states = np.array([1, 0, 2, 2] * 4, np.int8)
    tplan, jplan = tpt.RegionPlan(states), jpt.RegionPlan(states)
    tc = tsim.predict_canvas(tpart, rpx, pred, tplan)
    jc = jsim.predict_canvas(jpart, rpx, pred, jplan)
    np.testing.assert_array_equal(tc, jc)
    td = tsim.region_divergence(tpart, rpx, dec, tc, tplan)
    np.testing.assert_array_equal(
        td, jsim.region_divergence(jpart, rpx, dec, jc, jplan))
    diverged = td > 0.02
    np.testing.assert_array_equal(
        tsim.build_patch_plan(tplan, diverged).states,
        jsim.build_patch_plan(jplan, diverged).states)
    with pytest.raises(AssertionError):
        tsim.build_patch_plan(tplan, np.zeros(16, bool))


# ---------------------------------------------------------------------------
# batched waves


@pytest.mark.parametrize("lows", [((0, 1, 2, 3), (12, 13, 14, 15)),
                                  ((0, 1, 2, 3), tuple(range(8))),
                                  ((0, 1, 2, 3), (4, 5, 6, 7), (8, 9, 10))],
                         ids=["same-bucket", "mixed-buckets", "B3-padded"])
def test_infer_batch_matches_solo_and_reference(servers, lows):
    """Different masks in one wave (the per-sample layout rows), also in
    different length buckets and padded to the B bucket: each frame
    equals its solo run, and the wave equals the reference's."""
    srv, ref = servers["port"], servers["ref"]
    nR = srv.part.n_regions
    frames = _frames(len(lows), seed=len(lows[1]))
    masks = [_mask(nR, l) for l in lows]
    batched = srv.infer_batch(frames, masks, beta=2)
    want = ref.infer_batch(frames, masks, beta=2)
    for i, m in enumerate(masks):
        _match(batched[i], srv.infer(frames[i], m, beta=2))
        _match(batched[i], want[i])


def test_infer_plans_batched_matches_solo_and_reference(servers):
    """Co-batched REUSE wave: each sample splices from its OWN cache and
    refreshes only that cache; tiles and ages equal solo runs and the
    reference's."""
    srv, ref = servers["port"], servers["ref"]
    nR = srv.part.n_regions
    frames = _frames(3, seed=2)
    plan_warm = [tpt.RegionPlan.from_mask(_mask(nR, range(4))),
                 jpt.RegionPlan.from_mask(_mask(nR, range(4)))]

    def warm(s, req, plan):
        caches = [req.FeatureCache(nR, max_age=4) for _ in range(3)]
        for i, c in enumerate(caches):
            s.infer_plan(frames[i], plan, beta=2, cache=c, frame_idx=0)
        return caches

    sels = ((8, 9, 10, 11), (12, 13, 14, 15), (4, 5))
    plans = []
    for mod, base in ((tpt, plan_warm[0]), (jpt, plan_warm[1])):
        ps = []
        for sel in sels:
            st = base.states.copy()
            st[list(sel)] = mod.REUSE
            ps.append(mod.RegionPlan(st))
        plans.append(ps)
    cb = warm(srv, treq, plan_warm[0])
    batched = srv.infer_plans(frames, plans[0], 2, cb, [1, 1, 1])
    cs = warm(srv, treq, plan_warm[0])
    cr = warm(ref, jreq, plan_warm[1])
    want = ref.infer_plans(frames, plans[1], 2, cr, [1, 1, 1])
    for i in range(3):
        solo = srv.infer_plan(frames[i], plans[0][i], beta=2, cache=cs[i],
                              frame_idx=1)
        _match(batched[i], solo)
        _match(batched[i], want[i])
        np.testing.assert_allclose(cb[i].tiles.numpy(), cs[i].tiles.numpy(),
                                   atol=TILE_TOL, rtol=0)
        np.testing.assert_allclose(cb[i].tiles.numpy(),
                                   np.asarray(cr[i].tiles), atol=TILE_TOL,
                                   rtol=0)
        assert cb[i].age.tolist() == cs[i].age.tolist() == \
            cr[i].age.tolist()
    # every sample refreshed its own cache: no two share content
    assert not torch.equal(cb[0].tiles, cb[1].tiles)


def test_stage_frames_on_a_cpu_server(servers):
    """A CPU server stages a padded CPU tensor (the caller's choice, not a
    fallback); serving it equals serving the frames, and a staged wave
    padded to the wrong bucket is refused."""
    srv = servers["port"]
    nR = srv.part.n_regions
    frames = _frames(3, seed=5)
    staged = srv.stage_frames(frames)
    assert staged.B == 3 and staged.ready is None
    assert staged.imgs.shape[0] == 4 and staged.imgs.device.type == "cpu"
    assert torch.equal(staged.imgs[3], staged.imgs[0])
    plans = [tpt.RegionPlan.from_mask(_mask(nR, range(4 * i, 4 * i + 4)))
             for i in range(3)]
    got = srv.infer_wave(staged, plans, 2, defer=True)
    assert isinstance(got, tsim.PendingWave)
    got = got.wait()
    want = srv.infer_wave(frames, plans, 2)
    assert got == want
    bad = tsim.StagedWave(B=3, imgs=staged.imgs[:3])
    with pytest.raises(AssertionError, match="B bucket"):
        srv.infer_wave(bad, plans, 2)


def test_discarded_speculation_leaves_live_tiles_byte_identical(servers):
    """The regression behind ``FeatureCache.owns_tiles``: a speculative
    clone shares the live session's tile buffer, so its capture must not
    be written into that buffer.  After a speculation is launched and
    discarded, the live cache is byte-identical to before the launch;
    the clone's tiles equal the reference's clone."""
    srv, ref = servers["port"], servers["ref"]
    nR = srv.part.n_regions
    frames = _frames(2, seed=8)
    rpx = srv.part.region * PATCH
    live = treq.FeatureCache(nR, max_age=4)
    jlive = jreq.FeatureCache(nR, max_age=4)
    low = _mask(nR, range(4))
    srv.infer_plan(frames[0], tpt.RegionPlan.from_mask(low), beta=2,
                   cache=live, frame_idx=0)
    ref.infer_plan(frames[0], jpt.RegionPlan.from_mask(low), beta=2,
                   cache=jlive, frame_idx=0)
    live.note_pred(frames[0], 0, srv.epoch)
    before = live.tiles.clone()
    state = (live.age.copy(), live.beta, live.frame, live.epoch,
             live.pred_age)
    states = np.array([1] * 4 + [0] * 4 + [2] * 8, np.int8)
    plan = tpt.RegionPlan(states)
    canvas = tsim.predict_canvas(srv.part, rpx, frames[1], plan)
    dets, clone = srv.infer_speculative(canvas, plan, 2, live, 1)
    jdets, jclone = ref.infer_speculative(canvas, jpt.RegionPlan(states),
                                          2, jlive, 1)
    assert torch.equal(live.tiles, before)
    _match(dets, jdets)
    assert clone.owns_tiles and clone.tiles.data_ptr() != \
        live.tiles.data_ptr()
    assert not torch.equal(clone.tiles, before)       # it captured
    np.testing.assert_allclose(clone.tiles.numpy(), np.asarray(jclone.tiles),
                               atol=TILE_TOL, rtol=0)
    del clone                                           # discarded
    assert torch.equal(live.tiles, before)
    assert live.owns_tiles
    assert (live.age.tolist(), live.beta, live.frame, live.epoch,
            live.pred_age) == (state[0].tolist(),) + state[1:]
    # commit instead: the live session adopts the clone's tiles and ages
    dets, clone = srv.infer_speculative(canvas, plan, 2, live, 1)
    live.commit_speculative(clone, np.nonzero(states == 2)[0], 2, 1,
                            srv.epoch)
    assert live.tiles is clone.tiles and live.age[8:].tolist() == [1] * 8
    assert live.pred_age == 1           # note() aged the source


# ---------------------------------------------------------------------------
# policies over either package (as the reference's tests define them)


def policy(pkg, kind, n_regions, lows=(0, 1, 2, 3), beta=2, offset=0):
    P = pkg.sim.Policy

    class Fixed(P):
        name = "fixed"
        use_tracker = True

        def decide(self, sim, frame_idx):
            return {"mask": _mask(n_regions, lows), "quality": 85,
                    "beta": beta}

    class FullRes(P):
        name = "fullres"
        use_tracker = True

        def decide(self, sim, frame_idx):
            return {"mask": np.zeros(n_regions, np.int32), "quality": 95,
                    "beta": 0}

    class FixedReuse(P):
        name = "fixed-reuse"
        use_tracker = True
        reuse_k = 3

        def decide(self, sim, frame_idx):
            mask = _mask(n_regions, lows)
            cache = sim.feature_cache
            elig = (cache.eligible(beta) if cache is not None
                    else np.zeros(n_regions, bool))
            plan = pkg.opt.build_reuse_plan(sim.part, mask, sim.m, elig)
            return {"mask": mask, "quality": 85, "beta": beta,
                    "plan": plan, "capture_beta": beta}

    class ReuseRotating(FixedReuse):
        """bench_multiclient's ReuseRotatingPolicy: a rotating LOW mask
        with the motion-gated REUSE lift, K = 4."""
        name = "reuse-rotating"
        reuse_k = 4

    if kind == "reuse-rotating":
        lows = [(offset + k) % n_regions for k in range(n_regions // 4)]
    return {"fixed": Fixed, "fullres": FullRes, "fixed-reuse": FixedReuse,
            "reuse-rotating": ReuseRotating}[kind]()


GT = {}


def clip(pkg_name, server, video, n, seed):
    """Frames and the server's full-resolution outputs (cached)."""
    key = (pkg_name, id(server), video, n, seed)
    if key not in GT:
        frames, _ = PKGS[pkg_name].sv.make_clip(video, n, size=SIZE,
                                                seed=seed)
        GT[key] = (frames, [server.infer(f) for f in frames])
    return GT[key]


# bench_multiclient's congested-cell overlay: ten compounded bufferbloat
# windows (~3% of the 4G uplink at ~4x RTT)
SLOW_UPLINK = dict(bufferbloat=tuple((0.0, 3600.0, 1.15) for _ in range(10)))

MC_CASES = {
    # 3 clients, fixed distinct masks, slow inference: real waves
    "barrier": dict(clients=[("fixed", "walkS", 10 + i, dict(
        lows=tuple(range(4 * i, 4 * i + 4)))) for i in range(3)],
        frames=12, inf=0.5, ec={}),
    "continuous-stage-ahead": dict(clients=[("fixed", "walkS", 10 + i, dict(
        lows=tuple(range(4 * i, 4 * i + 4)))) for i in range(3)],
        frames=12, inf=0.5, ec=dict(scheduler="continuous",
                                    stage_ahead=True)),
    # 4 clients in two length buckets, one B bucket (4)
    "coalesce": dict(clients=[("fixed", "walkS", 10 + i, dict(lows=lows))
                              for i, lows in enumerate(
                                  (range(4), range(8), range(4, 8),
                                   range(8, 16)))],
                     frames=12, inf=0.5, ec=dict(coalesce=True),
                     servers="b4"),
    # mutually incompatible configs under sustained overload
    "admission": dict(clients=[("fullres", "parkS", 20, {}),
                               ("fixed", "parkS", 21, {}),
                               ("fixed", "parkS", 22,
                                dict(lows=tuple(range(8))))],
                      frames=30, inf=1.5, robust=8.0,
                      ec=dict(admission=True, degrade_backlog_s=0.3,
                              shed_backlog_s=1.0, degrade_depth=2,
                              shed_depth=4)),
    "max-batch-above-buckets": dict(
        clients=[("fixed", "walkS", 10 + i, dict(
            lows=tuple(range(4 * i, 4 * i + 4)))) for i in range(4)],
        frames=12, inf=0.5, ec=dict(max_batch=16), warns=True,
        servers="b4"),
    "edge-restart": dict(clients=[("fixed-reuse", "parkS", 30 + i, {})
                                  for i in range(2)],
                         frames=40, robust=1.0,
                         edge=dict(edge_restarts=((0.55, 0.2),)),
                         ec=dict(preserve_executables=True)),
    "speculate-slow-uplink": dict(
        clients=[("reuse-rotating", v, 17, dict(offset=4 * i))
                 for i, v in enumerate(("parkS", "parkS", "parkS",
                                        "driveN"))],
        frames=30, inf="flops", uplink=SLOW_UPLINK,
        ec=dict(scheduler="continuous", speculate=True)),
}


def inf_delay(pkg, spec):
    if spec == "flops":
        # bench_multiclient's model: the padded length bucket's FLOPs,
        # anchored at a fixed full-resolution delay
        part = pkg.vb.vit_partition(pkg.cfg)
        edges = pkg.pt.length_bucket_set(part)
        return pkg.est.InferenceDelayModel.fit_from_flops(
            lambda n, b: pkg.vb.backbone_flops(pkg.cfg, n, b,
                                               length_edges=edges),
            part.n_regions, betas=tuple(range(pkg.cfg.vit.n_subsets + 1)),
            full_res_delay_s=0.25)
    return lambda beta, n_d, n_r=0: spec


def run_mc(pkg_name, server, case):
    pkg = PKGS[pkg_name]
    part = pkg.vb.vit_partition(pkg.cfg)
    clients = []
    for i, (kind, video, seed, kw) in enumerate(case["clients"]):
        frames, gt = clip(pkg_name, server, video, case["frames"], seed)
        trace = pkg.nt.make_trace("4g", seed if "uplink" not in case
                                  else i, duration_s=240)
        if "uplink" in case:
            trace = pkg.fa.FaultyTrace(trace, pkg.fa.FaultInjector(
                pkg.fa.FaultSpec(**case["uplink"])))
        robust = (pkg.fa.RobustConfig(slo_s=case["robust"])
                  if "robust" in case else None)
        clients.append(pkg.sim.Simulation(
            frames, gt, trace, policy(pkg, kind, part.n_regions, **kw),
            server, part, PATCH, fps=FPS,
            inf_delay=inf_delay(pkg, case.get("inf", 0.5)), robust=robust))
    faults = (pkg.fa.FaultInjector(pkg.fa.FaultSpec(**case["edge"]))
              if "edge" in case else None)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        mc = pkg.edge.MultiClientSimulation(
            clients, server, pkg.edge.EdgeConfig(**case["ec"]),
            faults=faults)
    jobs, waves = [], []
    enqueue = mc.scheduler.enqueue

    def tap(ci, job):
        jobs.append(job)
        enqueue(ci, job)
    mc.scheduler.enqueue = tap
    run_wave = mc._run_wave

    def record(wave, t_start, key):
        waves.append(([(ci, j["frame"]) for ci, j in wave], t_start,
                      tuple(key)))
        return run_wave(wave, t_start, key)
    mc._run_wave = record
    results = mc.run([c[1] for c in case["clients"]])
    return SimpleNamespace(mc=mc, jobs=jobs, waves=waves, results=results,
                           warned=[str(w.message) for w in caught])


def _same_job(jj, tj):
    for k in ("frame", "_client", "n_d", "beta", "n_r", "capture_beta",
              "seq", "submit", "size", "tput", "rtt", "t_enc", "t_up",
              "t_dec", "t_inf", "arrival", "deadline", "spec_frac",
              "spec_conf", "done_at", "e2e", "parts", "t_inf_exec",
              "promoted_lb", "_bound_at", "speculation", "stale_epoch",
              "lost", "rejected", "abandoned", "edge_degraded", "dup"):
        assert jj.get(k) == tj.get(k), k
    np.testing.assert_array_equal(jj["mask"], tj["mask"])
    np.testing.assert_array_equal(jj["plan"].states, tj["plan"].states)
    np.testing.assert_array_equal(jj["decoded"], tj["decoded"])
    if jj.get("dets"):
        _match(tj["dets"], jj["dets"])
    else:
        assert not tj.get("dets")


@pytest.mark.parametrize("name", list(MC_CASES))
def test_multiclient_matches_reference(servers, servers_b4, name):
    case = MC_CASES[name]
    srv = servers_b4 if case.get("servers") == "b4" else servers
    jrun = run_mc("ref", srv["ref"], case)
    trun = run_mc("port", srv["port"], case)

    assert jrun.waves == trun.waves and len(trun.waves) >= 3
    assert len(jrun.jobs) == len(trun.jobs)
    for jj, tj in zip(jrun.jobs, trun.jobs):
        _same_job(jj, tj)
    assert dataclasses.asdict(jrun.mc.stats) == \
        dataclasses.asdict(trun.mc.stats)
    assert jrun.mc.free_at == trun.mc.free_at
    assert jrun.mc.max_wave == trun.mc.max_wave
    for jc, tc in zip(jrun.mc.clients, trun.mc.clients):
        assert jc.rstats == tc.rstats
        if tc.feature_cache is not None:
            a, b = jc.feature_cache, tc.feature_cache
            assert (a.age.tolist(), a.beta, a.frame, a.warm, a.epoch,
                    a.pred_age, a.pred_epoch, a.pred_frame_idx) == \
                (b.age.tolist(), b.beta, b.frame, b.warm, b.epoch,
                 b.pred_age, b.pred_epoch, b.pred_frame_idx)
    for jr, tr in zip(jrun.results, trun.results):
        assert jr.e2e_latency == tr.e2e_latency
        assert jr.delay_parts == tr.delay_parts
        assert jr.sizes == tr.sizes
        assert jr.offload_interval == tr.offload_interval
    assert jrun.warned == trun.warned

    st = trun.mc.stats
    if name in ("barrier", "continuous-stage-ahead", "coalesce"):
        assert max(st.wave_sizes) > 1
    if name == "coalesce":
        assert st.promoted > 0 and st.mixed_plan_waves > 0
    if name == "admission":
        assert st.degraded >= 1 and st.shed >= 1
        assert sum(c.rstats["rejected"] for c in trun.mc.clients) == \
            st.shed
    if name == "max-batch-above-buckets":
        assert trun.mc.max_wave == 4 and "exceeds" in trun.warned[0]
        assert max(st.wave_sizes) <= 4
    if name == "edge-restart":
        assert st.restarts == 1 and srv["port"].epoch >= 1
        assert all(len(r.e2e_latency) >= 2 for r in trun.results)
    if name == "speculate-slow-uplink":
        assert st.spec_launched >= 1
        assert st.spec_patched + st.spec_discarded == st.spec_launched
        assert any(j["n_r"] > 0 for j in trun.jobs)
