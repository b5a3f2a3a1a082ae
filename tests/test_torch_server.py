"""Port parity: repro_torch.offload.simulator.ServerModel against the
reference ServerModel (its Pallas lane in interpret mode, eager), on the
same parameters, frames and plans.

A full-resolution wave captures restoration-point tiles into three
FeatureCaches; a B=3 wave of mixed FULL/LOW/REUSE plans at beta 2 then
splices from them.  Detections match as sets (top-k ties may order
differently), scores and boxes to 1e-4, cached tiles to 1e-4.  Waves at
beta 0 (restore at input) and at an ``lb_override`` length bucket are
held to the same limits.

The quantized server (int8 weights, one head pruned) is held against the
reference's quantized server on the reference's own compressed tree.
Its row quantization can flip an int8 code where a one-ulp difference
upstream lands on a rounding tie (see ``test_torch_quant.py``), so there
detections match as sets to QUANT_SCORE_TOL in score and QUANT_BOX_TOL
pixels, and tiles to QUANT_RTOL of their largest magnitude.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs.vitdet_l import SIM as JSIM
from repro.core import vit_backbone as jvb
from repro.offload.simulator import ServerModel as JServerModel
from repro.quant import ptq as jptq
from repro.serve.request import FeatureCache as JFeatureCache
from repro_torch import convert
from repro_torch.configs.vitdet_l import SIM
from repro_torch.core.partition import FULL, LOW, REUSE, RegionPlan
from repro_torch.kernels import dispatch
from repro_torch.offload.simulator import ServerModel
from repro_torch.quant.ptq import QuantSpec
from repro_torch.serve.request import FeatureCache, StaleCacheEpoch

torch.set_num_threads(2)
TOL = 1e-4
BETA = 2
QUANT_SCORE_TOL = 2e-3
QUANT_BOX_TOL = 1.0
QUANT_RTOL = 0.05


class RecordingCache(FeatureCache):
    """FeatureCache that counts its refreshes."""

    def __post_init__(self):
        super().__post_init__()
        self.updates = 0

    def update(self, *a, **kw):
        self.updates += 1
        super().update(*a, **kw)


@pytest.fixture(scope="module")
def servers():
    jparams = jvb.init_vitdet_params(JSIM, jax.random.PRNGKey(0))
    tparams = convert.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams), SIM, device="cpu")
    kw = dict(top_k=16, score_thresh=0.0)
    jsrv = JServerModel(JSIM, jparams, backend="pallas", jit=False, **kw)
    tsrv = ServerModel(SIM, tparams, device="cpu", **kw)
    return jsrv, tsrv


def _plans(n_regions: int):
    a = np.zeros(n_regions, np.int8)
    a[[1, 6]] = LOW
    a[[2, 12]] = REUSE
    b = np.full(n_regions, LOW, np.int8)
    b[[0, 9, 15]] = REUSE
    c = np.zeros(n_regions, np.int8)
    c[[3, 4, 5]] = REUSE
    return [RegionPlan(s) for s in (a, b, c)]


def _match(got, want, tol=TOL, box_tol=TOL):
    assert len(got) == len(want)
    left = list(want)
    for g in got:
        hit = [w for w in left if abs(w["score"] - g["score"]) <= tol
               and w["cls"] == g["cls"]
               and np.allclose(w["box"], g["box"], atol=box_tol, rtol=TOL)]
        assert hit, g
        left.remove(hit[0])


def _frames(seed, n=3):
    H, W = SIM.vit.img_size
    return np.random.default_rng(seed).uniform(0, 1, (n, H, W, 3)) \
        .astype(np.float32)


def test_server_waves_match_reference(servers):
    jsrv, tsrv = servers
    space = tsrv.default_plan_space([BETA], reuse_edges=(0, 4),
                                    captures=(BETA,))
    assert tsrv.warmup(space, (4,)) > 0
    rng = np.random.default_rng(0)
    H, W = SIM.vit.img_size
    nR = tsrv.part.n_regions
    frames = rng.uniform(0, 1, (3, H, W, 3)).astype(np.float32)
    jc = [JFeatureCache(nR) for _ in range(3)]
    tc = [RecordingCache(nR) for _ in range(3)]
    full = [RegionPlan(np.full(nR, FULL, np.int8))] * 3
    jd = jsrv.infer_wave(frames, full, BETA, caches=jc, frame_ids=[0, 0, 0],
                         capture_beta=BETA)
    td = tsrv.infer_wave(frames, full, BETA, caches=tc, frame_ids=[0, 0, 0],
                         capture_beta=BETA)
    for g, w in zip(td, jd):
        _match(g, w)
    # B=3 pads to the B bucket 4: the pad row refreshes no cache
    assert [c.updates for c in tc] == [1, 1, 1]
    for c, j in zip(tc, jc):
        assert float(np.abs(c.tiles.numpy() - np.asarray(j.tiles)).max()) \
            <= TOL

    frames2 = rng.uniform(0, 1, (3, H, W, 3)).astype(np.float32)
    plans = _plans(nR)
    jd = jsrv.infer_wave(frames2, plans, BETA, caches=jc,
                         frame_ids=[1, 1, 1])
    td = tsrv.infer_wave(frames2, plans, BETA, caches=tc,
                         frame_ids=[1, 1, 1])
    for g, w in zip(td, jd):
        _match(g, w)
    assert [c.updates for c in tc] == [2, 2, 2]
    for c, j, p in zip(tc, jc, plans):
        assert float(np.abs(c.tiles.numpy() - np.asarray(j.tiles)).max()) \
            <= TOL
        np.testing.assert_array_equal(c.age, j.age)
        assert c.age[p.states == REUSE].min() == 1
    assert tsrv.stats.steady_compiles == 0
    assert tsrv.stats.reuse_splices == 3
    assert tsrv.stats.offloads == 6


def test_stateless_row_in_sessionful_wave_keeps_cache_empty(servers):
    _, tsrv = servers
    nR = tsrv.part.n_regions
    H, W = SIM.vit.img_size
    frames = np.random.default_rng(1).uniform(0, 1, (3, H, W, 3)) \
        .astype(np.float32)
    caches = [RecordingCache(nR), None, RecordingCache(nR)]
    plan = np.zeros(nR, np.int8)
    plan[[0, 1]] = LOW
    tsrv.infer_wave(frames, [RegionPlan(plan)] * 3, BETA, caches=caches)
    assert caches[0].updates == 1 and caches[2].updates == 1
    assert caches[0].warm and caches[0].beta == BETA


def test_stale_epoch_refused(servers):
    _, tsrv = servers
    nR = tsrv.part.n_regions
    H, W = SIM.vit.img_size
    cache = FeatureCache(nR, epoch=tsrv.epoch + 1, warm=True, beta=BETA,
                         tiles=torch.zeros(nR, 4, 4, SIM.d_model))
    plan = np.zeros(nR, np.int8)
    plan[0] = REUSE
    with pytest.raises(StaleCacheEpoch):
        tsrv.infer_wave(np.zeros((1, H, W, 3), np.float32),
                        [RegionPlan(plan)], BETA, caches=[cache])


def _low_only(n_regions: int):
    a = np.zeros(n_regions, np.int8)
    a[[1, 6, 11]] = LOW
    b = np.full(n_regions, LOW, np.int8)
    b[[0, 9]] = FULL
    return [RegionPlan(a), RegionPlan(b)]


def test_beta0_wave_matches_reference(servers):
    """Restore at input: key (lb, 0, 0, B bucket), warmed from an explicit
    plan space; no capture, so caches stay cold; REUSE plans refused."""
    jsrv, tsrv = servers
    nR = tsrv.part.n_regions
    plans = _low_only(nR)
    space = [(int(p.n_low), 0, 0, 0) for p in plans]
    before = tsrv.stats.compiles
    tsrv.warmup(space, (2,))
    # a later warmup of an already warmed replica counts its keys as
    # steady-state first uses, as the reference does; none may follow
    steady = tsrv.stats.steady_compiles
    lb = tsrv.length_bucket(max(tsrv.part.n_windows(p.n_low, 0)
                                for p in plans))
    assert (lb, 0, 0, 2) in tsrv._keys and tsrv.stats.compiles > before
    frames = _frames(2, 2)
    caches = [RecordingCache(nR) for _ in range(2)]
    jd = jsrv.infer_wave(frames, plans, 0,
                         caches=[JFeatureCache(nR) for _ in range(2)])
    td = tsrv.infer_wave(frames, plans, 0, caches=caches)
    for g, w in zip(td, jd):
        _match(g, w)
    assert [c.updates for c in caches] == [0, 0]
    assert tsrv.stats.steady_compiles == steady
    reuse = np.zeros(nR, np.int8)
    reuse[3] = REUSE
    with pytest.raises(AssertionError):
        tsrv.infer_wave(frames[:1], [RegionPlan(reuse)], 0,
                        caches=[FeatureCache(nR)])


def test_lb_override_wave_matches_reference(servers):
    """``lb_override`` pads a wave further: mixed plans and an all-FULL
    wave (which then runs on the mixed key at beta 1) match the reference
    at the same bucket; a bucket that cannot hold the plans is refused."""
    jsrv, tsrv = servers
    nR = tsrv.part.n_regions
    top = max(tsrv.length_edges)
    frames = _frames(3, 2)
    for plans, beta in ((_low_only(nR), BETA),
                        ([RegionPlan(np.zeros(nR, np.int8))] * 2, 0)):
        jd = jsrv.infer_wave(frames, plans, beta, lb_override=top)
        td = tsrv.infer_wave(frames, plans, beta, lb_override=top)
        for g, w in zip(td, jd):
            _match(g, w)
    assert (top, 1, 1, 2) in tsrv._keys
    small = min(tsrv.length_edges)
    full = [RegionPlan(np.zeros(nR, np.int8))] * 2
    with pytest.raises(AssertionError):
        tsrv.infer_wave(frames, full, BETA, lb_override=small)
    with pytest.raises(AssertionError):
        tsrv.infer_wave(frames, full, BETA, lb_override=small + 1)


# ---------------------------------------------------------------------------
# quantized lane


SPEC = ("int8", "fp32", 1)


@pytest.fixture(scope="module")
def qservers():
    jparams = jvb.init_vitdet_params(JSIM, jax.random.PRNGKey(0))
    jc2, jq, jrep = jptq.compress(JSIM, jparams, jptq.QuantSpec(*SPEC))
    tc2 = SIM.replace(n_heads=jc2.n_heads, n_kv_heads=jc2.n_kv_heads)
    tq = convert.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jq), tc2, device="cpu")
    kw = dict(top_k=16, score_thresh=0.0)
    jsrv = JServerModel(jc2, jq, backend="pallas", jit=False, **kw)
    tsrv = ServerModel(tc2, tq, device="cpu", **kw)
    tparams = convert.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams), SIM, device="cpu")
    own = ServerModel(SIM, tparams, device="cpu", quant=QuantSpec(*SPEC),
                      **kw)
    return jsrv, tsrv, own, jrep


def test_quantized_server_waves_match_reference(qservers):
    jsrv, tsrv, _, _ = qservers
    space = tsrv.default_plan_space([BETA], reuse_edges=(0, 4),
                                    captures=(BETA,))
    assert tsrv.warmup(space, (4,)) > 0
    nR = tsrv.part.n_regions
    jc = [JFeatureCache(nR) for _ in range(3)]
    tc = [RecordingCache(nR) for _ in range(3)]
    full = [RegionPlan(np.full(nR, FULL, np.int8))] * 3
    dispatch.reset_launch_counts()
    for frames, plans, kw in ((_frames(4), full, {"capture_beta": BETA}),
                              (_frames(5), _plans(nR), {})):
        jd = jsrv.infer_wave(frames, plans, BETA, caches=jc,
                             frame_ids=[0, 0, 0], **kw)
        td = tsrv.infer_wave(frames, plans, BETA, caches=tc,
                             frame_ids=[0, 0, 0], **kw)
        for g, w in zip(td, jd):
            _match(g, w, QUANT_SCORE_TOL, QUANT_BOX_TOL)
        for c, j in zip(tc, jc):
            want = np.asarray(j.tiles)
            assert float(np.abs(c.tiles.numpy() - want).max()) \
                <= QUANT_RTOL * float(np.abs(want).max())
            np.testing.assert_array_equal(c.age, j.age)
    assert [c.updates for c in tc] == [2, 2, 2]
    assert tsrv.stats.steady_compiles == 0
    # the CPU plain versions ran: no kernel launched
    assert set(dispatch.launch_counts().values()) == {0}


def test_quantized_server_from_spec(qservers):
    """ServerModel(quant=spec) compresses the float tree itself: the same
    report and the same detections as a server on the reference's
    compressed tree."""
    _, tsrv, own, jrep = qservers
    for key in ("spec", "bytes_fp32", "bytes", "ratio", "kept_heads"):
        assert own.quant_report[key] == jrep[key], key
    assert own.cfg.n_heads == tsrv.cfg.n_heads
    assert own.act_dtype == torch.float32
    nR = own.part.n_regions
    frames = _frames(6, 2)
    plans = _plans(nR)[:2]
    plans[0] = RegionPlan(np.where(plans[0].states == REUSE, LOW,
                                   plans[0].states).astype(np.int8))
    plans[1] = RegionPlan(np.where(plans[1].states == REUSE, FULL,
                                   plans[1].states).astype(np.int8))
    for beta in (0, BETA):
        got = own.infer_wave(frames, plans, beta)
        want = tsrv.infer_wave(frames, plans, beta)
        assert got == want
