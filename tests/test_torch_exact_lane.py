"""Port parity: the exact-shape mixed-resolution lane (the reference's
unpadded form of the paper's C1) against ``repro.core.mixed_res`` and
``repro.core.vit_backbone`` on the same seeded inputs.

``pack_mixed``, ``pack_positions``, ``pack_positions_padded``,
``_dups_to_sentinel`` and ``restore_full`` are data movement: bit-equal
to the reference, for shared (n,) and per-sample (B, n) ids, REUSE
splices and padded duplicate ids (first write wins).  The forwards
(``forward_features`` / ``forward_det`` on region ids) agree to 1e-4
absolute at every restoration point, with and without capture; the
reference runs its xla lane and, for one config, its Pallas lane in
interpret mode.  The port's padded lane matches its exact lane to
1e-5 (the padded one masks pad keys in the pre-restoration global
blocks, so the sums run over other lengths), bit for bit at beta 1.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import vitdet_l as jcfg
from repro.core import mixed_res as jmr
from repro.core import partition as jpt
from repro.core import vit_backbone as jvb
from repro.models import config as jmc
from repro_torch import convert
from repro_torch.configs import vitdet_l as tcfg
from repro_torch.core import mixed_res as tmr
from repro_torch.core import partition as tpt
from repro_torch.core import vit_backbone as tvb
from repro_torch.models import config as tmc

torch.set_num_threads(2)
TOL = 1e-4                  # exact-lane forward, port vs reference
LANE_TOL = 1e-5             # the port's padded lane vs its exact lane
FULL, LOW, REUSE = jpt.FULL, jpt.LOW, jpt.REUSE


def _part():
    # 16x16 patch grid, window 2, downsample 2: 4x4 regions of 4 windows
    return tpt.make_partition(16, 16, window=2, downsample=2)


def _jpart():
    return jpt.make_partition(16, 16, window=2, downsample=2)


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _eq(got, want):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _states(n, low=(), reuse=()):
    s = np.full(n, FULL, np.int8)
    s[list(low)] = LOW
    s[list(reuse)] = REUSE
    return s


# ---------------------------------------------------------------------------
# layout ops, bit for bit


@pytest.mark.parametrize("lows", [(), (0, 9), (3, 5, 6, 7, 15)])
def test_pack_mixed_and_positions_shared_ids(lows):
    x = _x((2, 16, 16, 8))
    fi, li = jpt.mask_to_region_ids(
        np.isin(np.arange(16), lows).astype(np.int32), len(lows))
    want_tok, want_win = jmr.pack_mixed(jnp.asarray(x), _jpart(),
                                        jnp.asarray(fi), jnp.asarray(li))
    got_tok, got_win = tmr.pack_mixed(torch.from_numpy(x), _part(),
                                      torch.from_numpy(fi),
                                      torch.from_numpy(li))
    _eq(got_tok, want_tok)
    _eq(got_win, want_win)
    pos = _x((16, 16, 8), 1)
    _eq(tmr.pack_positions(torch.from_numpy(pos), _part(), fi, li),
        jmr.pack_positions(jnp.asarray(pos), _jpart(), jnp.asarray(fi),
                           jnp.asarray(li)))


def test_pack_mixed_and_positions_per_sample_ids():
    x = _x((2, 16, 16, 4), 2)
    plans = [_states(16, low=(0, 9), reuse=(4,)),
             _states(16, low=(3,), reuse=(12,))]          # padded dup low
    ids = [jpt.plan_to_region_ids(s, 2, 1) for s in plans]
    assert ids[1][1].tolist() == [3, 3]
    fb, lb = (np.stack([i[k] for i in ids]) for k in (0, 1))
    want, _ = jmr.pack_mixed(jnp.asarray(x), _jpart(), jnp.asarray(fb),
                             jnp.asarray(lb))
    got, _ = tmr.pack_mixed(torch.from_numpy(x), _part(), fb, lb)
    _eq(got, want)
    pos = _x((16, 16, 4), 3)
    _eq(tmr.pack_positions(torch.from_numpy(pos), _part(), fb, lb),
        jmr.pack_positions(jnp.asarray(pos), _jpart(), jnp.asarray(fb),
                           jnp.asarray(lb)))


def test_packed_positions_gather_the_bank_bit_equal():
    """The backbone's packed positions (a gather from the tree's derived
    window bank) are the bytes the reference's ``pack_positions``
    computes from the grid; ``pack_positions_padded`` is bit-equal too."""
    part, jpart = _part(), _jpart()
    pos = _x((16, 16, 8), 4)
    params = {"pos_bank": tvb.pos_window_bank(torch.from_numpy(pos), part),
              "pos_seq": None}
    np.testing.assert_array_equal(
        params["pos_bank"].numpy(),
        np.asarray(jvb.pos_window_bank(jnp.asarray(pos), jpart)))
    plans = [_states(16, low=(1, 6, 9), reuse=(2, 12)),
             _states(16, low=(0,), reuse=(5, 7))]
    ids = [jpt.plan_to_region_ids(s, 3, 2) for s in plans]
    fb, lb = (np.stack([i[k] for i in ids]) for k in (0, 1))
    _eq(tvb.packed_positions(params, part, fb, lb),
        jmr.pack_positions(jnp.asarray(pos), jpart, jnp.asarray(fb),
                           jnp.asarray(lb)))
    _eq(tvb.packed_positions(params, part, ids[0][0], ids[0][1]),
        jmr.pack_positions(jnp.asarray(pos), jpart, jnp.asarray(ids[0][0]),
                           jnp.asarray(ids[0][1])))
    lay = jpt.plan_layout(plans[0], 64, jpart)
    _eq(tmr.pack_positions_padded(torch.from_numpy(pos), part,
                                  torch.from_numpy(lay.win_src)),
        jmr.pack_positions_padded(jnp.asarray(pos), jpart,
                                  jnp.asarray(lay.win_src)))
    src = np.stack([lay.win_src, lay.win_src[::-1].copy()])
    _eq(tmr.pack_positions_padded(torch.from_numpy(pos), part,
                                  torch.from_numpy(src)),
        jmr.pack_positions_padded(jnp.asarray(pos), jpart, jnp.asarray(src)))


@pytest.mark.parametrize("shape", [(5,), (3, 7), (1,), (2, 0)])
def test_dups_to_sentinel(shape):
    ids = np.random.default_rng(5).integers(0, 4, shape).astype(np.int32)
    _eq(tmr._dups_to_sentinel(torch.from_numpy(ids), 99),
        jmr._dups_to_sentinel(jnp.asarray(ids), 99))


def _restore_pair(x, states, n_low, n_reuse, tiles=None, per_sample=None):
    """restore_full of pack_mixed, both packages, one plan (or one plan a
    sample when ``per_sample`` lists them)."""
    part, jpart = _part(), _jpart()
    plans = per_sample or [states]
    ids = [jpt.plan_to_region_ids(s, n_low, n_reuse) for s in plans]
    fi, li, ri = (np.stack([i[k] for i in ids]) if per_sample else ids[0][k]
                  for k in range(3))
    kw_j, kw_t = {}, {}
    if tiles is not None:
        kw_j = dict(reuse_ids=jnp.asarray(ri), reuse_tiles=jnp.asarray(tiles))
        kw_t = dict(reuse_ids=torch.from_numpy(ri),
                    reuse_tiles=torch.from_numpy(tiles))
    jtok, _ = jmr.pack_mixed(jnp.asarray(x), jpart, jnp.asarray(fi),
                             jnp.asarray(li))
    want = jmr.restore_full(jtok, jpart, jnp.asarray(fi), jnp.asarray(li),
                            backend="xla", **kw_j)
    ttok, _ = tmr.pack_mixed(torch.from_numpy(x), part, fi, li)
    got = tmr.restore_full(ttok, part, fi, li, **kw_t)
    return got, want, (fi, li, ri)


def test_restore_full_all_full_is_identity():
    x = _x((2, 16, 16, 8))
    got, want, _ = _restore_pair(x, _states(16), 0, 0)
    _eq(got, want)
    _eq(got, tmr.grid_to_full_seq(torch.from_numpy(x), _part()))


def test_restore_full_low_and_reuse_splice():
    part = _part()
    x = _x((2, 16, 16, 8), 6)
    tiles = _x((2, 2, part.windows_per_full_region, part.tokens_low_region,
                8), 7)
    got, want, (_, _, ri) = _restore_pair(
        x, _states(16, low=(2, 9), reuse=(4, 11)), 2, 2, tiles)
    _eq(got, want)
    out = got.reshape(2, 16, part.windows_per_full_region, -1, 8).numpy()
    for k, rid in enumerate(ri.tolist()):
        np.testing.assert_array_equal(out[:, rid], tiles[:, k])


def test_restore_full_reuse_only_plan():
    """n_low = 0: no LOW window is packed; REUSE splices alone."""
    part = _part()
    x = _x((1, 16, 16, 4), 8)
    tiles = _x((1, 3, part.windows_per_full_region, part.tokens_low_region,
                4), 9)
    got, want, _ = _restore_pair(x, _states(16, reuse=(0, 5, 15)), 0, 3,
                                 tiles)
    _eq(got, want)


def test_restore_full_empty_reuse_bit_identical():
    part = _part()
    x = _x((1, 16, 16, 4), 2)
    fi, li = jpt.mask_to_region_ids(
        np.isin(np.arange(16), (0, 9)).astype(np.int32), 2)
    tok, _ = tmr.pack_mixed(torch.from_numpy(x), part, fi, li)
    a = tmr.restore_full(tok, part, fi, li)
    b = tmr.restore_full(tok, part, fi, li,
                         reuse_ids=torch.zeros((0,), dtype=torch.int32),
                         reuse_tiles=torch.zeros(
                             (1, 0, part.windows_per_full_region,
                              part.tokens_low_region, 4)))
    assert torch.equal(a, b)


def test_restore_full_duplicate_pad_ids_first_write_wins():
    """Padded duplicate LOW and REUSE ids whose window slots hold
    different data: the first occurrence wins, in both packages."""
    part, jpart = _part(), _jpart()
    w2, dd = part.tokens_low_region, part.windows_per_full_region
    nF = part.n_regions - 4
    full_ids = np.array([i for i in range(16) if i not in (3, 6)][:nF],
                        np.int32)
    low_ids = np.array([3, 3], np.int32)
    reuse_ids = np.array([6, 6], np.int32)
    D = 4
    tokens = _x((1, nF * part.tokens_full_region + 2 * w2, D), 10)
    tiles = _x((1, 2, dd, w2, D), 11)
    want = jmr.restore_full(jnp.asarray(tokens), jpart,
                            jnp.asarray(full_ids), jnp.asarray(low_ids),
                            backend="xla", reuse_ids=jnp.asarray(reuse_ids),
                            reuse_tiles=jnp.asarray(tiles))
    got = tmr.restore_full(torch.from_numpy(tokens), part, full_ids, low_ids,
                           reuse_ids=reuse_ids,
                           reuse_tiles=torch.from_numpy(tiles))
    _eq(got, want)
    out = got.reshape(1, 16, dd, w2, D).numpy()
    np.testing.assert_array_equal(out[0, 6], tiles[0, 0])


def test_restore_full_per_sample_duplicate_pad_ids():
    part = _part()
    x = _x((2, 16, 16, 4), 3)
    tiles = _x((2, 2, part.windows_per_full_region, part.tokens_low_region,
                4), 12)
    plans = [_states(16, low=(0, 9), reuse=(1, 2)),
             _states(16, low=(5,), reuse=(7,))]       # dup low and reuse
    got, want, (_, li, ri) = _restore_pair(x, None, 2, 2, tiles,
                                           per_sample=plans)
    assert li[1].tolist() == [5, 5] and ri[1].tolist() == [7, 7]
    _eq(got, want)


def test_restore_full_low_pad_colliding_with_full():
    """A LOW bucket over a plan with no LOW region pads with region 0,
    which the FULL ids also hold: the LOW write lands after the FULL one,
    as in the reference."""
    x = _x((1, 16, 16, 4), 13)
    got, want, (fi, li, _) = _restore_pair(x, _states(16), 2, 0)
    assert 0 in fi.tolist() and li.tolist() == [0, 0]
    _eq(got, want)


# ---------------------------------------------------------------------------
# the backbone on region ids


def _narrow(mc, base):
    return base.replace(
        n_layers=8, d_model=128, n_heads=2, n_kv_heads=2, head_dim=64,
        d_ff=256,
        vit=mc.ViTConfig(img_size=(512, 512), patch_size=16, window_size=8,
                         n_subsets=4, out_channels=32, n_classes=8),
        mixed_res=mc.MixedResConfig(enabled=True, window=8, downsample=2,
                                    n_subsets=4))


CONFIGS = {
    "sim": (jcfg.SIM, tcfg.SIM, "pallas"),
    "narrow": (_narrow(jmc, jcfg.CONFIG), _narrow(tmc, tcfg.CONFIG), "xla"),
}


@functools.lru_cache(maxsize=None)
def _model(name):
    jc, tc, backend = CONFIGS[name]
    jparams = jvb.init_vitdet_params(jc, jax.random.PRNGKey(0))
    tparams = convert.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams), tc, device="cpu")
    H, W = jc.vit.img_size
    img = np.random.default_rng(0).uniform(0, 1, (2, H, W, 3)).astype(
        np.float32)
    return jc, tc, jparams, tparams, img, backend


@pytest.fixture(params=sorted(CONFIGS))
def model(request):
    return _model(request.param)


# every restoration point on SIM (the reference's Pallas lane); three on
# the narrow model (its xla lane)
BETA_CASES = [("sim", b) for b in range(5)] + [("narrow", b)
                                               for b in (0, 2, 4)]


def _wave_ids(part, beta):
    """Per-sample ids of a two-frame wave at one (n_low, n_reuse) bucket:
    LOW and (beta >= 1) REUSE regions; sample 1's LOW ids carry a padded
    duplicate."""
    nR = part.n_regions
    reuse = ((2,), (1,)) if beta else ((), ())
    plans = [_states(nR, low=(0, 1), reuse=reuse[0]),
             _states(nR, low=(nR - 1,), reuse=reuse[1])]
    ids = [jpt.plan_to_region_ids(s, 2, len(reuse[0])) for s in plans]
    return plans, tuple(np.stack([i[k] for i in ids]) for k in range(3))


def _filled_wave_ids(part, beta):
    """As :func:`_wave_ids`, but each plan fills its buckets: a plan with
    fewer LOW or REUSE regions than its bucket leaves a FULL region out
    of the exact lane (``plan_to_region_ids`` trims FULL ids to the
    static size), where the padded lane keeps it."""
    nR = part.n_regions
    reuse = ((2,), (0,)) if beta else ((), ())
    plans = [_states(nR, low=(0, 1), reuse=reuse[0]),
             _states(nR, low=(nR - 2, nR - 1), reuse=reuse[1])]
    ids = [jpt.plan_to_region_ids(s, 2, len(reuse[0])) for s in plans]
    return plans, tuple(np.stack([i[k] for i in ids]) for k in range(3))


@pytest.mark.parametrize("name,beta", BETA_CASES)
def test_forward_features_on_ids_matches_reference(name, beta):
    """Every restoration point; at beta >= 1 REUSE tiles splice in and
    the forward captures the restored tiles."""
    jc, tc, jparams, tparams, img, backend = _model(name)
    part = tvb.vit_partition(tc)
    _, (fi, li, ri) = _wave_ids(part, beta)
    cap = beta
    kw_j = dict(backend=backend, capture_beta=cap)
    kw_t = dict(capture_beta=cap)
    if beta:
        tiles = _x((2, ri.shape[1], part.windows_per_full_region,
                    part.tokens_low_region, tc.d_model), 20 + beta)
        kw_j.update(reuse_ids=jnp.asarray(ri),
                    reuse_tiles=jnp.asarray(tiles))
        kw_t.update(reuse_ids=torch.from_numpy(ri),
                    reuse_tiles=torch.from_numpy(tiles))
    want = jvb.forward_features(jc, jparams, jnp.asarray(img),
                                jnp.asarray(fi), jnp.asarray(li), beta,
                                **kw_j)
    got = tvb.forward_features(tc, tparams, torch.from_numpy(img),
                               torch.from_numpy(fi), torch.from_numpy(li),
                               beta, **kw_t)
    if cap:
        assert np.abs(got[1].numpy() - np.asarray(want[1])).max() <= TOL
        got, want = got[0], want[0]
    assert np.abs(got.numpy() - np.asarray(want)).max() <= TOL


@pytest.mark.parametrize("beta", [0, 2])
def test_forward_det_on_shared_ids_matches_reference(model, beta):
    """forward_det on (n,) ids shared by the wave, no capture."""
    jc, tc, jparams, tparams, img, backend = model
    part = tvb.vit_partition(tc)
    fi, li = jpt.mask_to_region_ids(
        np.isin(np.arange(part.n_regions), (0, part.n_regions - 1))
        .astype(np.int32), 2)
    want = jvb.forward_det(jc, jparams, jnp.asarray(img), jnp.asarray(fi),
                           jnp.asarray(li), beta, backend=backend)
    got = tvb.forward_det(tc, tparams, torch.from_numpy(img),
                          torch.from_numpy(fi), torch.from_numpy(li), beta)
    for g, w in zip(got, want):
        for k in ("cls", "box", "ctr"):
            assert np.abs(g[k].numpy() - np.asarray(w[k])).max() <= TOL


@pytest.mark.parametrize("name,beta", [c for c in BETA_CASES if c[1]])
def test_padded_lane_equals_exact_lane(name, beta):
    """The port's padded lane (pack_pos / restore_gather kernels' plain
    versions, pad windows masked) against its exact lane, features and
    the tiles captured at beta, on the same plans and REUSE tiles."""
    _, tc, _, tparams, img, _ = _model(name)
    part = tvb.vit_partition(tc)
    plans, (fi, li, ri) = _filled_wave_ids(part, beta)
    rng = np.random.default_rng(beta)
    tiles = rng.standard_normal(
        (2, ri.shape[1], part.windows_per_full_region,
         part.tokens_low_region, tc.d_model)).astype(np.float32)
    exact = tvb.forward_features(
        tc, tparams, torch.from_numpy(img), torch.from_numpy(fi),
        torch.from_numpy(li), beta, reuse_ids=torch.from_numpy(ri),
        reuse_tiles=torch.from_numpy(tiles), capture_beta=beta)
    lb = max(tpt.length_bucket_set(part))
    arrays, _ = tpt.stack_plan_layouts(
        [tpt.plan_layout(s, lb, part) for s in plans])
    tiles_pad = np.zeros((2, part.n_regions) + tiles.shape[2:], np.float32)
    for b in range(2):
        n = int((plans[b] == REUSE).sum())
        tiles_pad[b, :n] = tiles[b, :n]
    padded = tvb.forward_features(
        tc, tparams, torch.from_numpy(img), beta=beta,
        layout={k: torch.from_numpy(v) for k, v in arrays.items()},
        reuse_tiles=torch.from_numpy(tiles_pad), capture_beta=beta)
    for e, p in zip(exact, padded):
        if beta == 1:
            assert torch.equal(e, p)
        assert float((e - p).abs().max()) <= LANE_TOL


def test_padded_beta0_equals_exact_beta0(model):
    _, tc, _, tparams, img, _ = model
    part = tvb.vit_partition(tc)
    plans, (fi, li, _) = _filled_wave_ids(part, 0)
    exact = tvb.forward_features(tc, tparams, torch.from_numpy(img),
                                 torch.from_numpy(fi), torch.from_numpy(li))
    lb = max(tpt.length_bucket_set(part))
    arrays, _ = tpt.stack_plan_layouts(
        [tpt.plan_layout(s, lb, part) for s in plans])
    padded = tvb.forward_features(
        tc, tparams, torch.from_numpy(img), beta=0,
        layout={k: torch.from_numpy(v) for k, v in arrays.items()})
    assert torch.equal(exact, padded)


def test_empty_reuse_set_leaves_the_lane_bit_identical(model):
    _, tc, _, tparams, img, _ = model
    part = tvb.vit_partition(tc)
    fi, li = tpt.mask_to_region_ids(
        np.isin(np.arange(part.n_regions), (1, 2)).astype(np.int32), 2)
    img_t = torch.from_numpy(img)
    a = tvb.forward_det(tc, tparams, img_t, fi, li, 2, capture_beta=2)
    b = tvb.forward_det(
        tc, tparams, img_t, fi, li, 2, capture_beta=2,
        reuse_ids=np.zeros((0,), np.int32),
        reuse_tiles=torch.zeros((2, 0, part.windows_per_full_region,
                                 part.tokens_low_region, tc.d_model)))
    assert torch.equal(a[1], b[1])
    for x, y in zip(a[0], b[0]):
        for k in ("cls", "box", "ctr"):
            assert torch.equal(x[k], y[k])


def test_exact_lane_refusals(model):
    _, tc, _, tparams, img, _ = model
    part = tvb.vit_partition(tc)
    fi, li, ri = tpt.plan_to_region_ids(
        _states(part.n_regions, low=(1,), reuse=(2,)), 1, 1)
    tiles = torch.zeros((2, 1, part.windows_per_full_region,
                         part.tokens_low_region, tc.d_model))
    img_t = torch.from_numpy(img)
    with pytest.raises(AssertionError):     # REUSE needs beta >= 1
        tvb.forward_features(tc, tparams, img_t, fi, li, 0, reuse_ids=ri,
                             reuse_tiles=tiles)
    with pytest.raises(AssertionError):     # capture before restoring
        tvb.forward_features(tc, tparams, img_t, fi, li, 3, reuse_ids=ri,
                             reuse_tiles=tiles, capture_beta=2)
