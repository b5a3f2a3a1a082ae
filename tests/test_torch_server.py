"""Port parity: repro_torch.offload.simulator.ServerModel against the
reference ServerModel (its Pallas lane in interpret mode, eager), on the
same parameters, frames and plans.

A full-resolution wave captures restoration-point tiles into three
FeatureCaches; a B=3 wave of mixed FULL/LOW/REUSE plans at beta 2 then
splices from them.  Detections match as sets (top-k ties may order
differently), scores and boxes to 1e-4, cached tiles to 1e-4.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs.vitdet_l import SIM as JSIM
from repro.core import vit_backbone as jvb
from repro.offload.simulator import ServerModel as JServerModel
from repro.serve.request import FeatureCache as JFeatureCache
from repro_torch import convert
from repro_torch.configs.vitdet_l import SIM
from repro_torch.core.partition import FULL, LOW, REUSE, RegionPlan
from repro_torch.offload.simulator import ServerModel
from repro_torch.serve.request import FeatureCache, StaleCacheEpoch

torch.set_num_threads(2)
TOL = 1e-4
BETA = 2


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


def _match(got, want):
    assert len(got) == len(want)
    left = list(want)
    for g in got:
        hit = [w for w in left if abs(w["score"] - g["score"]) <= TOL
               and w["cls"] == g["cls"]
               and np.allclose(w["box"], g["box"], atol=TOL, rtol=TOL)]
        assert hit, g
        left.remove(hit[0])


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
