"""Port parity of the ViT half-precision lanes: ``ptq.compress`` at the
reference's half specs (its shipped point ``int8+fp16-p1``, ``int8+fp16``,
``fp16+fp16`` and ``bf16``), the half forwards, and a half
``ServerModel`` on the CPU, against the reference's on the same seeded
weights (SIM and the 8-block narrow config of ``test_torch_quant.py``).

Tolerances and why:
  * compression reports (bytes, ratio, kept heads) are equal: the same
    bytes in both packages;
  * features, as a share of the reference's largest feature: both
    packages run the same half arithmetic but sum in other orders and
    round intermediates at other places, so they differ by the half
    type's own rounding (the reference's half forward differs from its
    float32 forward by 1.3e-3 at fp16 and 1.3e-2 at bf16 on SIM).  fp16:
    FP16_RTOL 3e-3 at most, FP16_MEAN_RTOL 5e-4 on average; bf16:
    BF16_RTOL 2.5e-2 / BF16_MEAN_RTOL 4e-3; int8 weights with half
    activations: ``test_torch_quant.py``'s QUANT_RTOL 5% / QUANT_MEAN_RTOL
    1% (a row-quantization code flips at a rounding tie);
  * detections of the half server match the reference's as sets to
    SCORE_TOL in score and BOX_TOL pixels.  On seeded weights the scores
    around the k-th place lie a few fp16 ULPs apart, and with int8
    weights over half activations the two packages' scores for one box
    differ by about as much as the reference's own jit and eager
    forwards' do (``test_torch_calibrate.py::
    test_native_half_lane_score_noise_is_the_references_own``), so the
    two may keep different boxes at the k-th place: each package's top-k
    must lie within the other's top 2k;
  * the host-resident cache mode equals the device mode (detections
    equal, tiles byte-equal), and its tiles move in half the bytes of
    float32's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import vitdet_l as jcfg
from repro.core import vit_backbone as jvb
from repro.models import config as jmc
from repro.offload.simulator import ServerModel as JServerModel
from repro.quant import ptq as jptq
from repro_torch import convert
from repro_torch.configs import vitdet_l as tcfg
from repro_torch.core import vit_backbone as tvb
from repro_torch.core.partition import RegionPlan
from repro_torch.models import config as tmc
from repro_torch.offload.simulator import ServerModel
from repro_torch.quant import ptq as tptq
from repro_torch.serve.edge import BatchedServerModel
from repro_torch.serve.request import FeatureCache

from test_torch_host_cache import _sequence
from test_torch_quant import QUANT_MEAN_RTOL, QUANT_RTOL, _layout, _narrow

torch.set_num_threads(2)
FP16_RTOL, FP16_MEAN_RTOL = 3e-3, 5e-4
BF16_RTOL, BF16_MEAN_RTOL = 2.5e-2, 4e-3
SCORE_TOL, BOX_TOL = 2e-3, 1.0
SPECS = {"int8+fp16-p1": ("int8", "fp16", 1), "int8+fp16": ("int8", "fp16", 0),
         "fp16+fp16": ("fp16", "fp16", 0), "bf16": ("bf16", "fp32", 0)}
CONFIGS = {"sim": (jcfg.SIM, tcfg.SIM),
           "narrow": (_narrow(jmc, jcfg.CONFIG), _narrow(tmc, tcfg.CONFIG))}


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _tol(spec):
    if spec[0] == "int8":
        return QUANT_RTOL, QUANT_MEAN_RTOL
    half = spec[0] if spec[0] in ("fp16", "bf16") else spec[1]
    return {"fp16": (FP16_RTOL, FP16_MEAN_RTOL),
            "bf16": (BF16_RTOL, BF16_MEAN_RTOL)}[half]


class Compressed(dict):
    """Each spec compressed once a config, in both packages."""

    def __init__(self, jc, tc, jp, tp):
        super().__init__()
        self.jc, self.tc, self.jp, self.tp = jc, tc, jp, tp

    def __missing__(self, name):
        spec = SPECS[name]
        self[name] = (jptq.compress(self.jc, self.jp, jptq.QuantSpec(*spec)),
                      tptq.compress(self.tc, self.tp, tptq.QuantSpec(*spec)))
        return self[name]


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def model(request):
    jc, tc = CONFIGS[request.param]
    jp = jvb.init_vitdet_params(jc, jax.random.PRNGKey(0))
    tp = convert.params_from_jax(_np_tree(jp), tc, device="cpu")
    return Compressed(jc, tc, jp, tp)


@pytest.mark.parametrize("name", sorted(SPECS))
def test_compress_report_matches_reference_at_half(model, name):
    spec = SPECS[name]
    (jc2, _, jrep), (tc2, tq, trep) = model[name]
    assert trep["spec"] == jrep["spec"] == name
    for key in ("bytes_fp32", "bytes", "ratio", "prune_heads"):
        assert trep[key] == jrep[key], key
    assert trep.get("kept_heads") == jrep.get("kept_heads")
    assert tc2.n_heads == jc2.n_heads
    assert tq["patch_embed"]["b"].dtype == tptq.DTYPES[
        spec[0] if spec[0] in ("fp16", "bf16") else spec[1]]


def _rel(got: torch.Tensor, want) -> tuple:
    want = np.asarray(want.astype(jnp.float32))
    got = got.float().numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    m = np.abs(want).max()
    return np.abs(got - want).max() / m, np.abs(got - want).mean() / m


@pytest.mark.parametrize("name", ["int8+fp16-p1", "fp16+fp16", "bf16"])
@pytest.mark.parametrize("beta", [None, 0, 1, 2])
def test_half_forward_matches_reference(model, name, beta):
    """Full resolution (beta None), restore at input (0) and the padded
    mixed lane at beta 1 and 2 with REUSE tiles and capture; the port's
    own compression against the reference's."""
    jc, tc, spec = model.jc, model.tc, SPECS[name]
    (jc2, jq, _), (tc2, tq, _) = model[name]
    act = tq["patch_embed"]["b"].dtype
    H, W = jc.vit.img_size
    img = np.random.default_rng(0).uniform(0, 1, (2, H, W, 3)) \
        .astype(np.float32)
    kw_j, kw_t = {}, {}
    if beta is not None:
        arrays = _layout(jc, beta)
        kw_j = {"beta": beta,
                "layout": {k: jnp.asarray(v) for k, v in arrays.items()}}
        kw_t = {"beta": beta,
                "layout": {k: torch.from_numpy(np.array(v))
                           for k, v in arrays.items()}}
        if beta:
            part = tvb.vit_partition(tc)
            tiles = np.random.default_rng(1).standard_normal(
                (2, part.n_regions, part.windows_per_full_region,
                 part.tokens_low_region, tc.d_model)).astype(np.float32)
            tt = torch.from_numpy(tiles).to(act)
            kw_j.update(reuse_tiles=jnp.asarray(tt.float().numpy())
                        .astype(jnp.dtype(str(act)[6:])), capture_beta=beta)
            kw_t.update(reuse_tiles=tt, capture_beta=beta)
    want = jvb.forward_features(jc2, jq, jnp.asarray(img), backend="xla",
                                **kw_j)
    with torch.no_grad():
        got = tvb.forward_features(tc2, tq, torch.from_numpy(img), **kw_t)
    rtol, mean_rtol = _tol(spec)
    if beta:
        (got, got_tiles), (want, want_tiles) = got, want
        assert got_tiles.dtype == act
        assert _rel(got_tiles, want_tiles)[0] <= rtol
    assert got.dtype == act
    mx, mean = _rel(got, want)
    assert mx <= rtol and mean <= mean_rtol, (mx, mean)


# ---------------------------------------------------------------------------
# the half server on the CPU


def _frames(seed, n=2, cfg=tcfg.SIM):
    H, W = cfg.vit.img_size
    return np.random.default_rng(seed).uniform(0, 1, (n, H, W, 3)) \
        .astype(np.float32)


def _within_top(got, want_wide):
    """Every detection of ``got`` matches one of ``want_wide``."""
    left = list(want_wide)
    for g in got:
        hit = [w for w in left if abs(w["score"] - g["score"]) <= SCORE_TOL
               and w["cls"] == g["cls"]
               and np.allclose(w["box"], g["box"], atol=BOX_TOL)]
        assert hit, g
        left.remove(hit[0])


@pytest.fixture(scope="module")
def sim():
    jp = jvb.init_vitdet_params(jcfg.SIM, jax.random.PRNGKey(0))
    tp = convert.params_from_jax(_np_tree(jp), tcfg.SIM, device="cpu")
    return jp, tp


K = 8


def test_half_server_grid_and_detections_match_reference(sim):
    """``ServerModel(quant=int8+fp16-p1)``: the float32 grid's keys, no
    steady first use, and the reference's detections at the same spec
    (full resolution and mixed at beta 2)."""
    jp, tp = sim
    spec = SPECS["int8+fp16-p1"]
    kw = dict(score_thresh=0.0, b_buckets=(1, 2))
    ref32 = ServerModel(tcfg.SIM, tp, device="cpu", top_k=K, **kw)
    space = ref32.default_plan_space([2], reuse_edges=(0,), captures=(0,))
    ref32.warmup(space)
    srv = ServerModel(tcfg.SIM, tp, device="cpu", top_k=K,
                      quant=tptq.QuantSpec(*spec), **kw)
    assert srv.act_dtype == torch.float16
    assert srv.quant_report["ratio"] >= 3.5
    srv.warmup(space)
    assert srv._keys == ref32._keys
    wide = ServerModel(tcfg.SIM, tp, device="cpu", top_k=2 * K,
                       quant=tptq.QuantSpec(*spec), **kw)
    jsrv = {k: JServerModel(jcfg.SIM, jp, backend="xla", jit=False, top_k=k,
                            quant=jptq.QuantSpec(*spec), **kw)
            for k in (K, 2 * K)}
    frames = _frames(5)
    nR = srv.part.n_regions
    mask = np.r_[np.ones(4, np.int32), np.zeros(nR - 4, np.int32)]
    for args in ((), (mask, 2)):
        got, want = srv.infer(frames[0], *args), jsrv[K].infer(frames[0],
                                                              *args)
        assert len(got) == len(want) == K
        _within_top(got, jsrv[2 * K].infer(frames[0], *args))
        _within_top(want, wide.infer(frames[0], *args))
        assert all(isinstance(d["score"], float) for d in got)
    srv.infer_wave(frames, [RegionPlan.from_mask(mask)] * 2, beta=2)
    assert srv.stats.steady_compiles == 0


def _serve(server, seq):
    caches = [FeatureCache(server.part.n_regions) for _ in range(2)]
    out = [server.infer_wave(_frames(t), plans, 2, caches=caches,
                             frame_ids=[t] * 2, capture_beta=2)
           for t, plans in enumerate(seq)]
    return out, caches


def test_half_host_cache_equals_device_cache_at_half_the_bytes(sim):
    _, tp = sim
    kw = dict(device="cpu", top_k=K, score_thresh=0.0)
    fp16 = tptq.QuantSpec("fp16", "fp16", 0)
    dev_srv = ServerModel(tcfg.SIM, tp, quant=fp16, **kw)
    host_srv = ServerModel(tcfg.SIM, tp, quant=fp16, device_cache=False,
                           **kw)
    f32_host = ServerModel(tcfg.SIM, tp, device_cache=False, **kw)
    seq = _sequence(dev_srv.part.n_regions)
    got_dev, dev_c = _serve(dev_srv, seq)
    got_host, host_c = _serve(host_srv, seq)
    _serve(f32_host, seq)
    assert got_host == got_dev
    for h, d in zip(host_c, dev_c):
        assert h.host_tiles and d.tiles_on_device
        assert h.tiles.dtype == d.tiles.dtype == torch.float16
        assert torch.equal(h.tiles, d.tiles)
    assert dev_srv.stats.tile_bytes == 0
    assert host_srv.stats.tile_bytes_d2h * 2 == \
        f32_host.stats.tile_bytes_d2h > 0
    assert host_srv.stats.tile_bytes_h2d * 2 == \
        f32_host.stats.tile_bytes_h2d > 0


def test_batched_server_serves_a_half_server_unchanged(sim):
    """``BatchedServerModel`` over a half tree: a B = 2 wave keeps each
    client's solo detections (``serve.edge`` needs no change at half;
    at half the wave's GEMM shapes round differently from the solo
    waves', so near-tied k-th boxes may differ: each frame's wave top-k
    lies within its solo top 2k)."""
    _, tp = sim
    kw = dict(device="cpu", score_thresh=0.0,
              quant=tptq.QuantSpec("int8", "fp16", 1))
    bsrv = BatchedServerModel(tcfg.SIM, tp, top_k=K, **kw)
    wide = ServerModel(tcfg.SIM, tp, top_k=2 * K, **kw)
    assert bsrv.act_dtype == torch.float16
    nR = bsrv.part.n_regions
    frames = _frames(7)
    masks = [None, (np.arange(nR) < 4).astype(np.int32)]
    batch = bsrv.infer_batch(frames, masks, beta=2)
    for i, m in enumerate(masks):
        solo = wide.infer(frames[i], m, 2) if m is not None \
            else wide.infer(frames[i])
        assert len(batch[i]) == K
        _within_top(batch[i], solo)


def test_simulation_runs_a_half_server_unchanged(sim):
    """The offloading ``Simulation`` over a half server (the fixed-reuse
    policy of ``test_torch_simulation.py`` on parkS): the same offloads,
    plans and payloads as over the float32 server, REUSE splices
    through half tiles, no steady first use."""
    from repro_torch.data import network_traces as nt
    from repro_torch.data import synthetic_video as sv
    from repro_torch.offload import estimator as est
    from repro_torch.offload import optimizer as opt
    from repro_torch.offload import simulator as simu

    from test_torch_simulation import (ANCHOR_S, FPS, PATCH, SIZE,
                                       FixedReuse)
    _, tp = sim
    part = tvb.vit_partition(tcfg.SIM)
    frames, _ = sv.make_clip("parkS", 16, size=SIZE, seed=23)
    inf = est.InferenceDelayModel.fit_from_flops(
        lambda n, b: tvb.backbone_flops(tcfg.CONFIG, n, b), part.n_regions,
        betas=(0, 1, 2, 3, 4), full_res_delay_s=ANCHOR_S)
    runs = {}
    for name, quant in (("fp32", None),
                        ("int8+fp16-p1", tptq.QuantSpec("int8", "fp16", 1))):
        srv = ServerModel(tcfg.SIM, tp, device="cpu", top_k=K,
                          score_thresh=0.0, quant=quant)
        gt = [srv.infer(f) for f in frames]
        s = simu.Simulation(
            frames, gt, nt.make_trace("4g", 3, duration_s=60),
            FixedReuse.make(simu.Policy, opt.build_reuse_plan,
                            part.n_regions),
            srv, part, PATCH, fps=FPS, inf_delay=inf)
        runs[name] = (s.run("parkS"), srv)
    (r32, s32), (rh, sh) = runs["fp32"], runs["int8+fp16-p1"]
    assert sh.act_dtype == torch.float16
    assert rh.sizes == r32.sizes and len(rh.sizes) >= 3
    assert sh.stats.reuse_splices == s32.stats.reuse_splices > 0
    assert sh.stats.steady_compiles == 0
