"""The host-resident tile cache (``ServerModel(device_cache=False)``)
against the default device-resident one and against the reference's
``ServerModel(device_cache=False)``, on SIM.

Over a reuse-heavy sequence of waves (a full-resolution wave capturing
tiles, then mixed FULL/LOW/REUSE waves splicing from and refreshing the
caches) the two modes differ only in where the tiles live and what is
copied: detections are equal (dict floats compare bitwise) and the
cached tiles byte-identical.  The host mode's ``tile_bytes_d2h`` /
``tile_bytes_h2d`` equal the reference host mode's on the same plans;
the device mode counts 0 bytes.
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
from repro_torch.serve.edge import BatchedServerModel
from repro_torch.serve.request import FeatureCache, ServingStats

torch.set_num_threads(2)
BETA = 2
B = 2


@pytest.fixture(scope="module")
def params():
    jparams = jvb.init_vitdet_params(JSIM, jax.random.PRNGKey(0))
    tparams = convert.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams), SIM, device="cpu")
    return jparams, tparams


def _frames(seed):
    H, W = SIM.vit.img_size
    return np.random.default_rng(seed).uniform(0, 1, (B, H, W, 3)) \
        .astype(np.float32)


def _sequence(nR):
    """Per wave, one plan per client: full resolution, then three
    REUSE-heavy waves (REUSE sets that move, a LOW region, a client
    whose plan reuses nothing)."""
    def plan(low=(), reuse=()):
        s = np.full(nR, FULL, np.int8)
        s[list(low)] = LOW
        s[list(reuse)] = REUSE
        return RegionPlan(s)
    return [[plan(), plan()],
            [plan(low=(1,), reuse=(2, 3, 4, 5)), plan(reuse=(0, 9, 15))],
            [plan(reuse=(2, 3, 6, 7, 8)), plan(low=(4,))],
            [plan(low=(0, 1), reuse=(10, 11, 12)),
             plan(reuse=(0, 1, 2, 3))]]


def _serve(server, caches, seq):
    out = []
    for t, plans in enumerate(seq):
        out.append(server.infer_wave(_frames(t), plans, BETA, caches=caches,
                                     frame_ids=[t] * B, capture_beta=BETA))
    return out


def test_host_and_device_modes_equal_with_reference_byte_counts(params):
    jparams, tparams = params
    kw = dict(top_k=8, score_thresh=0.0)
    dev_srv = ServerModel(SIM, tparams, device="cpu", **kw)
    host_srv = ServerModel(SIM, tparams, device="cpu", device_cache=False,
                           **kw)
    ref_srv = JServerModel(JSIM, jparams, backend="xla", jit=False,
                           device_cache=False, **kw)
    nR = dev_srv.part.n_regions
    seq = _sequence(nR)
    dev_c = [FeatureCache(nR) for _ in range(B)]
    host_c = [FeatureCache(nR) for _ in range(B)]
    ref_c = [JFeatureCache(nR) for _ in range(B)]
    got_dev = _serve(dev_srv, dev_c, seq)
    got_host = _serve(host_srv, host_c, seq)
    _serve(ref_srv, ref_c, seq)
    assert got_host == got_dev
    for h, d, r in zip(host_c, dev_c, ref_c):
        assert h.host_tiles and not h.tiles_on_device
        assert d.tiles_on_device and not d.host_tiles
        assert not r.tiles_on_device              # the reference's host mode
        assert torch.equal(h.tiles, d.tiles)
        np.testing.assert_array_equal(h.age, d.age)
    assert host_srv.stats.reuse_splices == dev_srv.stats.reuse_splices == 5
    assert host_srv.stats.tile_bytes_d2h == ref_srv.stats.tile_bytes_d2h > 0
    assert host_srv.stats.tile_bytes_h2d == ref_srv.stats.tile_bytes_h2d > 0
    assert host_srv.stats.tile_bytes_per_offload() == \
        ref_srv.stats.tile_bytes_per_offload()
    assert dev_srv.stats.tile_bytes == 0
    assert dev_srv.stats.tile_bytes_per_offload() == 0.0


def test_host_mode_speculative_clone_leaves_live_tiles(params):
    """A speculation in host mode captures into the clone's own host
    buffer: the live session's tiles stay byte-identical."""
    _, tparams = params
    srv = ServerModel(SIM, tparams, device="cpu", device_cache=False,
                      top_k=8, score_thresh=0.0)
    nR = srv.part.n_regions
    cache = FeatureCache(nR)
    full = RegionPlan(np.full(nR, FULL, np.int8))
    srv.infer_wave(_frames(0)[:1], [full], BETA, caches=[cache],
                   frame_ids=[0], capture_beta=BETA)
    before = cache.tiles.clone()
    states = np.full(nR, FULL, np.int8)
    states[[0, 5]] = REUSE
    _, clone = srv.infer_speculative(_frames(1)[0], RegionPlan(states), BETA,
                                     cache, 1)
    assert clone.host_tiles and clone.tiles is not cache.tiles
    assert torch.equal(cache.tiles, before)


def test_batched_server_inherits_the_flag(params):
    _, tparams = params
    srv = BatchedServerModel(SIM, tparams, device="cpu", device_cache=False,
                             top_k=8, score_thresh=0.0)
    assert not srv.device_cache
    nR = srv.part.n_regions
    caches = [FeatureCache(nR) for _ in range(B)]
    full = [RegionPlan(np.full(nR, FULL, np.int8))] * B
    srv.infer_wave(_frames(0), full, BETA, caches=caches, frame_ids=[0, 0],
                   capture_beta=BETA)
    per = caches[0].tiles.nbytes
    assert srv.stats.tile_bytes_d2h == B * per
    assert srv.stats.tile_bytes_per_offload() == per


def test_serving_stats_tile_bytes():
    s = ServingStats(offloads=4, tile_bytes_d2h=100, tile_bytes_h2d=60)
    assert s.tile_bytes == 160 and s.tile_bytes_per_offload() == 40.0
    assert ServingStats().tile_bytes_per_offload() == 0.0
