"""Port parity: repro_torch.core.vit_backbone against the reference
forward, on the same parameters (converted with
``repro_torch.convert.params_from_jax``) and the same seeded inputs.

The reference runs its Pallas lane in interpret mode (the fused
pack/restore, window and flash kernels), the port its plain versions.
Features and captured tiles agree to 1e-4 absolute: both are float32,
and only the order of the sums in the GEMMs and softmaxes differs.

Two sizes: SIM, and a narrow model with ViTDet's own window geometry
(window 8, head dim 64) so the kernels' shapes are covered here.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import vitdet_l as jcfg
from repro.core import partition as jpt
from repro.core import vit_backbone as jvb
from repro.models import config as jmc
from repro_torch import convert
from repro_torch.configs import vitdet_l as tcfg
from repro_torch.core import det_head as tdh
from repro_torch.core import vit_backbone as tvb
from repro_torch.models import config as tmc

torch.set_num_threads(2)
TOL = 1e-4


def _narrow(mc, base):
    return base.replace(
        n_layers=8, d_model=128, n_heads=2, n_kv_heads=2, head_dim=64,
        d_ff=256,
        vit=mc.ViTConfig(img_size=(512, 512), patch_size=16, window_size=8,
                         n_subsets=4, out_channels=32, n_classes=8),
        mixed_res=mc.MixedResConfig(enabled=True, window=8, downsample=2,
                                    n_subsets=4))


CONFIGS = {
    "sim": (jcfg.SIM, tcfg.SIM),
    "narrow": (_narrow(jmc, jcfg.CONFIG), _narrow(tmc, tcfg.CONFIG)),
}


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def model(request):
    jc, tc = CONFIGS[request.param]
    jparams = jvb.init_vitdet_params(jc, jax.random.PRNGKey(0))
    tparams = convert.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams), tc, device="cpu")
    rng = np.random.default_rng(0)
    H, W = jc.vit.img_size
    img = rng.uniform(0, 1, (2, H, W, 3)).astype(np.float32)
    return jc, tc, jparams, tparams, img


def _close(got: torch.Tensor, want) -> float:
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    return float(np.abs(got.numpy() - want).max())


def test_full_resolution_lane(model):
    jc, tc, jparams, tparams, img = model
    want = jvb.forward_features(jc, jparams, jnp.asarray(img),
                                backend="pallas")
    got = tvb.forward_features(tc, tparams, torch.from_numpy(img))
    assert _close(got, want) <= TOL


def test_full_resolution_lane_with_capture(model):
    jc, tc, jparams, tparams, img = model
    wf, wt = jvb.forward_features(jc, jparams, jnp.asarray(img),
                                  backend="pallas", capture_beta=2)
    gf, gt = tvb.forward_features(tc, tparams, torch.from_numpy(img),
                                  capture_beta=2)
    assert _close(gf, wf) <= TOL
    assert _close(gt, wt) <= TOL


def _plans(n_regions: int):
    a = np.zeros(n_regions, np.int8)
    a[1] = jpt.LOW
    a[2] = jpt.REUSE
    b = np.zeros(n_regions, np.int8)
    b[[0, n_regions - 1]] = jpt.LOW
    b[n_regions // 2] = jpt.REUSE
    return [a, b]


@pytest.mark.parametrize("beta", [1, 2, 3, 4])
def test_padded_lane_with_reuse_and_capture(model, beta):
    jc, tc, jparams, tparams, img = model
    part = tvb.vit_partition(tc)
    plans = _plans(part.n_regions)
    lb = max(jpt.length_bucket_set(jvb.vit_partition(jc)))
    arrays, _ = jpt.stack_plan_layouts(
        [jpt.plan_layout(s, lb, jvb.vit_partition(jc)) for s in plans])
    rng = np.random.default_rng(beta)
    tiles = rng.standard_normal(
        (2, part.n_regions, part.windows_per_full_region,
         part.tokens_low_region, tc.d_model)).astype(np.float32)
    wf, wt = jvb.forward_features(
        jc, jparams, jnp.asarray(img), beta=beta, backend="pallas",
        layout={k: jnp.asarray(v) for k, v in arrays.items()},
        reuse_tiles=jnp.asarray(tiles), capture_beta=beta)
    gf, gt = tvb.forward_features(
        tc, tparams, torch.from_numpy(img), beta=beta,
        layout={k: torch.from_numpy(v) for k, v in arrays.items()},
        reuse_tiles=torch.from_numpy(tiles), capture_beta=beta)
    assert _close(gf, wf) <= TOL
    assert _close(gt, wt) <= TOL


@pytest.mark.parametrize("capture", [0, 2])
def test_padded_lane_beta0_matches_reference(model, capture):
    """Restore at input: the unfused window gather, the LOW windows
    upsampled (the reference's nn_upsample kernel in interpret mode, the
    port's plain version), full-resolution positions, every block at
    full length."""
    jc, tc, jparams, tparams, img = model
    part = tvb.vit_partition(tc)
    a, b = _plans(part.n_regions)
    a[a == jpt.REUSE] = jpt.LOW            # no REUSE at beta 0
    b[b == jpt.REUSE] = jpt.FULL
    lb = max(jpt.length_bucket_set(jvb.vit_partition(jc)))
    arrays, _ = jpt.stack_plan_layouts(
        [jpt.plan_layout(s, lb, jvb.vit_partition(jc)) for s in (a, b)])
    want = jvb.forward_features(
        jc, jparams, jnp.asarray(img), beta=0, backend="pallas",
        layout={k: jnp.asarray(v) for k, v in arrays.items()},
        capture_beta=capture)
    got = tvb.forward_features(
        tc, tparams, torch.from_numpy(img), beta=0,
        layout={k: torch.from_numpy(v) for k, v in arrays.items()},
        capture_beta=capture)
    if capture:
        assert _close(got[1], want[1]) <= TOL
        got, want = got[0], want[0]
    assert _close(got, want) <= TOL
    with pytest.raises(AssertionError):    # REUSE tiles cannot splice
        tvb.forward_features(
            tc, tparams, torch.from_numpy(img), beta=0,
            layout={k: torch.from_numpy(v) for k, v in arrays.items()},
            reuse_tiles=torch.zeros(2, part.n_regions,
                                    part.windows_per_full_region,
                                    part.tokens_low_region, tc.d_model))


def test_det_head_and_decode(model):
    jc, tc, jparams, tparams, _ = model
    from repro.core import det_head as jdh
    rng = np.random.default_rng(3)
    part = tvb.vit_partition(tc)
    feats = rng.standard_normal((2, part.grid_h, part.grid_w,
                                 tc.d_model)).astype(np.float32)
    wo = jdh.det_head_forward(jc, jparams["head"], jnp.asarray(feats))
    go = tdh.det_head_forward(tc, tparams["head"], torch.from_numpy(feats))
    for w, g in zip(wo, go):
        assert g["stride"] == w["stride"]
        for k in ("cls", "box", "ctr"):
            assert _close(g[k].contiguous(), w[k]) <= TOL
    # decode the same head outputs: top-k scores agree as sorted values
    wb, ws, wc = jdh.decode_detections(jc, wo, top_k=16, score_thresh=0.0)
    gb, gs, gc = tdh.decode_detections(tc, go, top_k=16, score_thresh=0.0)
    np.testing.assert_allclose(np.sort(gs.numpy(), axis=1),
                               np.sort(np.asarray(ws), axis=1), atol=TOL)
