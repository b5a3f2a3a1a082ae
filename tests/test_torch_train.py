"""Port parity for training: the kernels' autograd Functions, ``det_loss``,
the schedules, gradients through ``forward_det``, the training recipe
(``train.server``) and checkpoints, each against the JAX package on the
same seeded inputs and parameters (``convert.params_from_jax``).

The reference's kernel VJPs run as its own tests run them
(``tests/test_kernels.py``): ``jax.grad`` through the custom-VJP entry
(the Pallas kernels in interpret mode) and through the XLA oracle, at
its ``GRAD_TOL``.  The port's Functions are also held against torch
autograd through the port's plain versions.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import vitdet_l as jcfg
from repro.core import det_head as jdh
from repro.core import vit_backbone as jvb
from repro.data import synthetic_video as jsv
from repro.kernels.flash_attention.ops import flash_attention as jflash
from repro.kernels.flash_attention.ref import flash_attention_ref
from repro.kernels.mixed_res_pool.ops import avg_pool_2d, nn_upsample_2d
from repro.kernels.mixed_res_pool.ref import (avg_pool_2d_ref,
                                              nn_upsample_2d_ref)
from repro.kernels.window_attention.ops import window_attention as jwin
from repro.kernels.window_attention.ref import window_attention_ref
from repro.optim import adam as jadam
from repro.optim import schedules as jsched
from repro.train import checkpoint as jckpt
from repro_torch import convert
from repro_torch.configs import vitdet_l as tcfg
from repro_torch.core import det_head as tdh
from repro_torch.core import vit_backbone as tvb
from repro_torch.kernels import dispatch
from repro_torch.kernels.flash_attention import ops as tflash
from repro_torch.kernels.mixed_res_pool import ops as tpool
from repro_torch.kernels.window_attention import ops as twin
from repro_torch.optim import schedules as tsched
from repro_torch.train import checkpoint as tckpt
from repro_torch.train import server as tserver

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]
GRAD_TOL = dict(rtol=2e-4, atol=2e-4)     # tests/test_kernels.py GRAD_TOL


def _t(a):
    return torch.from_numpy(np.array(a))


def _torch_grads(fn, args):
    """Gradients of sum(sin(fn(*args))) w.r.t. every arg (float64-free:
    float32 throughout, as the reference)."""
    xs = [_t(a).requires_grad_(True) for a in args]
    torch.sum(torch.sin(fn(*xs))).backward()
    return [x.grad.numpy() for x in xs]


def _jax_grads(fn, args):
    loss = lambda *a: jnp.sum(jnp.sin(fn(*a)))      # noqa: E731
    g = jax.grad(loss, argnums=tuple(range(len(args))))(
        *[jnp.asarray(a) for a in args])
    return [np.asarray(x) for x in g]


def _close_all(got, *wants):
    for want in wants:
        for a, b in zip(got, want):
            np.testing.assert_allclose(a, b, **GRAD_TOL)


def _qkv(seed, B, T, H, KV, Dh):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, T, H, Dh)).astype(np.float32),
            rng.standard_normal((B, T, KV, Dh)).astype(np.float32),
            rng.standard_normal((B, T, KV, Dh)).astype(np.float32))


# ---------------------------------------------------------------------------
# the kernels' Functions (tests/test_kernels.py:310-375 of the reference)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_function_matches_reference_vjp(causal):
    args = _qkv(41, 2, 48, 8, 2, 32)
    got = _torch_grads(lambda q, k, v: dispatch.flash_attention(
        q, k, v, causal=causal), args)
    plain = _torch_grads(lambda q, k, v: tflash.flash_attention_plain(
        q, k, v, causal=causal), args)
    _close_all(got, plain,
               _jax_grads(lambda q, k, v: jflash(q, k, v, causal=causal),
                          args),
               _jax_grads(lambda q, k, v: flash_attention_ref(
                   q, k, v, causal=causal), args))


def test_flash_attention_bwd_chunks_rows(monkeypatch):
    """Rows beyond one ``Q_CHUNK`` (here 16 of 48, causal GQA): the
    chunked backward equals the one-chunk one."""
    args = [_t(a) for a in _qkv(42, 1, 48, 4, 2, 16)]
    g = _t(np.random.default_rng(3).standard_normal((1, 48, 4, 16))
           .astype(np.float32))
    whole = tflash.flash_attention_bwd(*args, g, causal=True)
    monkeypatch.setattr(tflash, "Q_CHUNK", 16)
    for a, b in zip(tflash.flash_attention_bwd(*args, g, causal=True),
                    whole):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-6)


def test_window_attention_function_matches_reference_vjp():
    win, W = 16, 4
    args = _qkv(43, 2, W * win, 4, 2, 32)
    got = _torch_grads(lambda q, k, v: dispatch.window_attention(
        q, k, v, win), args)
    plain = _torch_grads(lambda q, k, v: twin.window_attention_plain(
        q, k, v, win), args)
    _close_all(got, plain,
               _jax_grads(lambda q, k, v: jwin(q, k, v, win), args),
               _jax_grads(lambda q, k, v: window_attention_ref(
                   q, k, v, win), args))


def test_window_attention_function_with_win_valid():
    """Pad windows (beyond ``win_valid``) contribute no gradient."""
    win, W = 16, 4
    wv = np.array([3, 2], np.int32)
    args = _qkv(47, 2, W * win, 4, 4, 32)

    def jref(q, k, v):
        o = window_attention_ref(q, k, v, win)
        keep = (jnp.arange(W)[None, :] < wv[:, None]).astype(o.dtype)
        return o * jnp.repeat(keep, win, axis=1)[:, :, None, None]

    got = _torch_grads(lambda q, k, v: dispatch.window_attention(
        q, k, v, win, _t(wv)), args)
    plain = _torch_grads(lambda q, k, v: twin.window_attention_plain(
        q, k, v, win, _t(wv)), args)
    _close_all(got, plain,
               _jax_grads(lambda q, k, v: jwin(q, k, v, win,
                                               win_valid=jnp.asarray(wv)),
                          args),
               _jax_grads(jref, args))
    # sample 1's windows 2 and 3 are pad: every gradient there is 0
    for g in got:
        assert not np.any(g[1, 2 * win:])


@pytest.mark.parametrize("op", ["avg_pool", "nn_upsample"])
def test_pool_functions_match_reference_vjp(op):
    x = np.random.default_rng(53).standard_normal((2, 16, 16, 8)).astype(
        np.float32)
    route, plain, jop, jref = {
        "avg_pool": (dispatch.avg_pool, tpool.avg_pool_plain, avg_pool_2d,
                     avg_pool_2d_ref),
        "nn_upsample": (dispatch.nn_upsample, tpool.nn_upsample_plain,
                        nn_upsample_2d, nn_upsample_2d_ref)}[op]
    got = _torch_grads(lambda a: route(a, 2), [x])
    # the closed-form adjoints are exact: equal to autograd through the
    # plain version
    np.testing.assert_array_equal(got[0], _torch_grads(
        lambda a: plain(a, 2), [x])[0])
    _close_all(got, _jax_grads(lambda a: jop(a, 2), [x]),
               _jax_grads(lambda a: jref(a, 2), [x]))


def test_functions_launch_nothing_on_the_cpu():
    dispatch.reset_launch_counts()
    args = _qkv(5, 1, 64, 2, 2, 16)
    _torch_grads(lambda q, k, v: dispatch.window_attention(q, k, v, 16),
                 args)
    _torch_grads(lambda q, k, v: dispatch.flash_attention(q, k, v), args)
    assert dispatch.launch_counts() == dict.fromkeys(dispatch.KERNELS, 0)


def _no_vjp_call(op):
    """A call of a route without a backward, its float inputs requiring
    grad."""
    r = lambda *s: torch.randn(*s, requires_grad=True)
    if op == "decode_attention":
        return lambda: dispatch.decode_attention(
            r(1, 1, 2, 8), r(1, 4, 2, 8), r(1, 4, 2, 8),
            torch.tensor([3], dtype=torch.int32))
    if op == "ssd_scan":
        return lambda: dispatch.ssd_scan(r(1, 8, 2, 4), r(1, 8, 2), r(2),
                                         r(1, 8, 1, 4), r(1, 8, 1, 4), 4)
    if op == "int8_matmul":
        return lambda: dispatch.int8_matmul(
            torch.ones(4, 8, dtype=torch.int8),
            torch.ones(8, 3, dtype=torch.int8), r(4), r(3))
    if op == "pack_pos":
        return lambda: dispatch.pack_pos(r(1, 3, 4, 2), r(3, 4, 2),
                                         torch.tensor([0, 2]),
                                         torch.tensor([2]))
    return lambda: dispatch.restore_gather(
        r(1, 2, 4, 2), torch.tensor([[0, 1]]), torch.tensor([[0, 1]]), 2, 1)


@pytest.mark.parametrize("op", ["decode_attention", "ssd_scan",
                                "int8_matmul", "pack_pos",
                                "restore_gather"])
def test_routes_without_a_backward_refuse_grad(op):
    """The reference gives these kernels no VJP: a loss through them
    raises on both devices instead of training differently on the card
    (whose kernel output carries no grad_fn) than on the CPU."""
    with pytest.raises(RuntimeError, match=f"{op} has no backward"):
        _no_vjp_call(op)()
    with torch.no_grad():
        try:
            _no_vjp_call(op)()
        except RuntimeError as e:
            assert "no backward" not in str(e)
        except (IndexError, ValueError):
            pass                        # past the guard: the op's own checks


# ---------------------------------------------------------------------------
# det_loss


def _head_case(seed, B=2, nc=8, sizes=(8, 4, 2)):
    """Head outputs and targets: frame 0 has positives, frame 1 none;
    some class and centerness logits saturate at +-60."""
    rng = np.random.default_rng(seed)
    outs, tgts = [], []
    for s in sizes:
        cls = rng.standard_normal((B, s, s, nc)).astype(np.float32) * 3
        cls[0, 0, 0, :2] = (60.0, -60.0)
        ctr = rng.standard_normal((B, s, s, 1)).astype(np.float32)
        ctr[0, 1, 1, 0] = 60.0
        box = rng.uniform(0.1, 3, (B, s, s, 4)).astype(np.float32)
        pos = (rng.uniform(size=(B, s, s, 1)) < 0.2).astype(np.float32)
        pos[1] = 0.0
        pos[0, 0, 0] = pos[0, 1, 1] = 1.0
        tcls = np.zeros((B, s, s, nc), np.float32)
        tcls[..., 0] = pos[..., 0]
        tcls[0, 0, 0, 1] = 1.0               # a saturated wrong class
        tbox = rng.uniform(0, 3, (B, s, s, 4)).astype(np.float32) * pos
        outs.append({"cls": cls, "box": box, "ctr": ctr})
        tgts.append({"cls": tcls, "box": tbox, "pos": pos})
    return outs, tgts


@pytest.mark.parametrize("frames", ["both", "no_positives"])
def test_det_loss_and_its_gradient_match_reference(frames):
    outs, tgts = _head_case(11)
    if frames == "no_positives":           # only the positive-free frame
        outs = [{k: v[1:] for k, v in o.items()} for o in outs]
        tgts = [{k: v[1:] for k, v in t.items()} for t in tgts]
    keys = ("cls", "box", "ctr")

    def jloss(flat):
        o = [dict(zip(keys, flat[3 * i:3 * i + 3])) for i in range(len(outs))]
        return jdh.det_loss(jcfg.SIM, o, [{k: jnp.asarray(v) for k, v in
                                           t.items()} for t in tgts])[0]

    flat = [o[k] for o in outs for k in keys]
    want_loss, want_g = jax.jit(jax.value_and_grad(jloss))(
        [jnp.asarray(a) for a in flat])
    xs = [_t(a).requires_grad_(True) for a in flat]
    to = [dict(zip(keys, xs[3 * i:3 * i + 3])) for i in range(len(outs))]
    loss, metrics = tdh.det_loss(tcfg.SIM, to, [{k: _t(v) for k, v in
                                                 t.items()} for t in tgts])
    loss.backward()
    _, jm = jdh.det_loss(jcfg.SIM, [{k: jnp.asarray(v) for k, v in o.items()}
                                    for o in outs],
                         [{k: jnp.asarray(v) for k, v in t.items()}
                          for t in tgts])
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               rtol=1e-5)
    for k in ("cls", "box", "n_pos"):
        np.testing.assert_allclose(float(metrics[k].detach()), float(jm[k]),
                                   rtol=1e-5)
    if frames == "no_positives":
        assert float(metrics["n_pos"]) == 1.0      # clamped, not 0
    n_nan = 0
    for x, g in zip(xs, want_g):
        g = np.asarray(g)
        assert torch.isfinite(x.grad).all()
        ok = np.isfinite(g)
        np.testing.assert_allclose(x.grad.numpy()[ok], g[ok], rtol=1e-5,
                                   atol=1e-7)
        # the reference's only NaN: JAX differentiates (1 - pt) ** 0 at
        # pt = 1 as 0 * inf (a centerness logit of 60 at a positive); the
        # port's gradient there is the limit, 0
        n_nan += int((~ok).sum())
        assert np.abs(x.grad.numpy()[~ok]).max(initial=0.0) < 1e-20
    assert n_nan == (3 if frames == "both" else 0)     # one a level


# ---------------------------------------------------------------------------
# schedules


@pytest.mark.parametrize("step", [0, 25, 50, 900, 1800])
def test_warmup_cosine_matches_reference(step):
    kw = dict(peak_lr=5e-4, warmup_steps=50, total_steps=1800)
    want = np.float32(jsched.warmup_cosine(jnp.asarray(step), **kw))
    got = tsched.warmup_cosine(step, **kw)
    np.testing.assert_allclose(np.float32(got), want, rtol=1e-6)
    assert np.float32(tsched.constant(step, lr=3e-4)) == \
        np.float32(jsched.constant(step, lr=3e-4))


# ---------------------------------------------------------------------------
# gradients through forward_det + det_loss at SIM


@pytest.fixture(scope="module")
def sim_case():
    jparams = jvb.init_vitdet_params(jcfg.SIM, jax.random.PRNGKey(0))
    size = jcfg.SIM.vit.img_size[0]
    frames, gts = jsv.make_clip("walkS", 2, size=size, seed=7)
    tgts = [jsv.render_targets(g, size) for g in gts]
    tgt = [{k: np.stack([t[lv][k] for t in tgts]) for k in
            ("cls", "box", "pos")} for lv in range(3)]
    return jparams, frames, tgt


def _flat_grads_from_jax(gtree):
    tree = convert.params_from_jax(jax.tree_util.tree_map(np.asarray, gtree),
                                   tcfg.SIM, device="cpu")
    return tckpt.flatten(tvb.strip_derived(tree))


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_forward_det_loss_gradients_match_reference(sim_case, backend):
    jparams, frames, tgt = sim_case

    def jloss(p):
        outs = jvb.forward_det(jcfg.SIM, p, jnp.asarray(frames),
                               backend=backend)
        return jdh.det_loss(jcfg.SIM, outs, [{k: jnp.asarray(v) for k, v in
                                              t.items()} for t in tgt])[0]

    want_loss, want_g = jax.jit(jax.value_and_grad(jloss))(jparams)
    tparams = convert.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams), tcfg.SIM, device="cpu")
    like = tvb.strip_derived(tparams)
    loss, grads = tserver.value_and_grad(
        tcfg.SIM, tckpt.flatten(like), like, _t(frames),
        [{k: _t(v) for k, v in t.items()} for t in tgt])
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    want = _flat_grads_from_jax(want_g)
    assert set(grads) == set(want)
    assert float(grads["pos_emb"].abs().max()) > 0
    for name, g in grads.items():
        w = want[name].numpy()
        err = float(np.abs(g.numpy() - w).max())
        assert err <= 1e-4 * max(float(np.abs(w).max()), 1e-12), (name, err)


def test_stale_position_layouts_give_pos_emb_no_gradient(sim_case):
    """The trap the loss avoids: a forward that adds the pre-derived
    ``pos_seq`` leaves ``pos_emb`` out of the graph."""
    jparams, frames, tgt = sim_case
    tparams = convert.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams), tcfg.SIM, device="cpu")
    pos = tparams["pos_emb"].requires_grad_(True)
    w = tparams["patch_embed"]["w"].requires_grad_(True)
    outs = tvb.forward_det(tcfg.SIM, tparams, _t(frames))
    loss, _ = tdh.det_loss(tcfg.SIM, outs, [{k: _t(v) for k, v in t.items()}
                                           for t in tgt])
    g_pos, g_w = torch.autograd.grad(loss, [pos, w], allow_unused=True)
    assert g_pos is None and g_w is not None


def _reference_steps(jparams, steps, batch=2):
    """The reference recipe's loop body (``benchmarks/common.py:
    train_server_params``), its losses step by step."""
    size = jcfg.SIM.vit.img_size[0]
    frames, targets = [], []
    for name in ("walkS", "walkB", "cycleS"):
        fs, gts = jsv.make_clip(name, 16, size=size, seed=7)
        for f, g in zip(fs, gts):
            frames.append(f)
            targets.append(jsv.render_targets(g, size))
    frames = np.stack(frames)

    def loss_fn(p, img, tgt):
        return jdh.det_loss(jcfg.SIM, jvb.forward_det(jcfg.SIM, p, img),
                            tgt)[0]

    step_fn = jax.jit(jax.value_and_grad(loss_fn))
    params, opt = jparams, jadam.init_adam(jparams)
    rng = np.random.default_rng(0)
    losses = []
    for s in range(steps):
        idx = rng.integers(0, len(frames), batch)
        tgt = [{k: jnp.asarray(np.stack([targets[i][lv][k] for i in idx]))
                for k in ("cls", "box", "pos")} for lv in range(3)]
        loss, grads = step_fn(params, jnp.asarray(frames[idx]), tgt)
        lr = jsched.warmup_cosine(jnp.asarray(s), peak_lr=5e-4,
                                  warmup_steps=50, total_steps=steps)
        params, opt, _ = jadam.adam_update(grads, opt, params, lr=lr,
                                           grad_clip=1.0)
        losses.append(float(loss))
    return losses, params


def test_train_server_params_matches_reference_recipe(sim_case):
    jparams = sim_case[0]
    want, jtrained = _reference_steps(jparams, 3)
    tparams = convert.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams), tcfg.SIM, device="cpu")
    trained, metrics = tserver.train_server_params(
        tcfg.SIM, steps=3, params=tparams, device="cpu", log_every=0)
    np.testing.assert_allclose(metrics["losses"], want, rtol=1e-4)
    assert metrics["first_loss"] == metrics["losses"][0]
    assert len(metrics["step_s"]) == 3
    # the returned tree serves: its layouts are derived from the trained
    # pos_emb, and the input tree was not changed
    np.testing.assert_array_equal(
        trained["pos_seq"].numpy(),
        tvb.add_position_banks(tcfg.SIM, dict(trained))["pos_seq"].numpy())
    np.testing.assert_array_equal(tparams["pos_emb"].numpy(),
                                  np.asarray(jparams["pos_emb"]))
    assert not np.array_equal(trained["pos_emb"].numpy(),
                              tparams["pos_emb"].numpy())
    # the trained trees agree leaf for leaf
    got = tckpt.flatten(tvb.strip_derived(trained))
    ref = _flat_grads_from_jax(jtrained)
    for name, w in ref.items():
        err = float((got[name] - w).abs().max())
        assert err <= 1e-4 * float(w.abs().max()) + 1e-6, (name, err)


# ---------------------------------------------------------------------------
# checkpoints


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"w": torch.randn(3, 4, generator=g),
            "blocks": [{"a": torch.randn(5, generator=g),
                        "h": torch.randn(2, 2, generator=g).to(torch.bfloat16)}
                       for _ in range(3)],
            "step": torch.tensor(7, dtype=torch.int32)}


def _equal(a, b):
    fa, fb = tckpt.flatten(a), tckpt.flatten(b)
    assert list(fa) == list(fb)
    for k in fa:
        assert fa[k].dtype == fb[k].dtype and torch.equal(fa[k], fb[k]), k


def test_flatten_names_leaves_as_the_reference():
    tree = _tree()
    jtree = jax.tree_util.tree_map(lambda t: np.asarray(t.float()), tree)
    assert list(tckpt.flatten(tree)) == [n for n, _ in
                                         jckpt._tree_paths(jtree)]
    _equal(tckpt.unflatten(tckpt.flatten(tree), tree), tree)


def test_checkpoint_round_trip_is_bit_equal(tmp_path):
    tree = _tree()
    path = tckpt.save(tree, str(tmp_path), step=5)
    assert Path(path).name == "step_00000005"
    assert tckpt.latest_step(str(tmp_path)) == 5
    _equal(tckpt.restore(_tree(1), str(tmp_path)), tree)
    manifest = json.loads((Path(path) / "manifest.json").read_text())
    assert manifest["leaves"]["blocks/1/h"]["dtype"] == "bfloat16"


def test_checkpoint_refuses_a_corrupted_shard(tmp_path):
    tree = _tree()
    path = Path(tckpt.save(tree, str(tmp_path), step=1))
    shard = path / "shard_0_0.npz"
    with np.load(shard) as f:
        arrays = {k: f[k].copy() for k in f.files}
    arrays["a0"].reshape(-1)[0] += 1
    np.savez(shard, **arrays)            # the name ends in .npz: kept
    with pytest.raises(IOError, match="corruption"):
        tckpt.restore(tree, str(tmp_path))
    tckpt.restore(tree, str(tmp_path), verify=False)


def test_checkpoint_manifest_comes_after_its_shards(tmp_path, monkeypatch):
    """No manifest exists while a shard is written, and a step without a
    manifest is not a checkpoint."""
    seen = []
    real = np.savez

    def spy(file, **arrays):
        seen.append((Path(file).parent / "manifest.json").exists())
        real(file, **arrays)

    monkeypatch.setattr(np, "savez", spy)
    big = {f"l{i}": torch.ones(2) * i for i in range(70)}   # two shards
    tckpt.save(big, str(tmp_path), step=3)
    assert seen == [False, False]
    (tmp_path / "step_00000009").mkdir()
    assert tckpt.steps(str(tmp_path)) == [3]
    _equal(tckpt.restore(big, str(tmp_path)), big)


def test_checkpoint_save_async_and_prune(tmp_path):
    tree = _tree()
    snap = tckpt.flatten(_tree())
    for step in (1, 2, 3, 4):
        tckpt.save_async(tree, str(tmp_path), step)
        tree["w"].add_(1.0)              # after the snapshot: not saved
    tckpt.wait_pending_saves()
    assert tckpt.steps(str(tmp_path)) == [1, 2, 3, 4]
    got = tckpt.flatten(tckpt.restore(_tree(), str(tmp_path), step=1))
    assert torch.equal(got["w"], snap["w"])
    tckpt.prune_old(str(tmp_path), keep=2)
    assert tckpt.steps(str(tmp_path)) == [3, 4]


def test_get_server_trains_then_restores(tmp_path):
    lines = []
    first = tserver.get_server(str(tmp_path), steps=2, device="cpu",
                               log=lines.append)
    assert tckpt.steps(str(tmp_path)) == [2] and lines
    again = tserver.get_server(str(tmp_path), steps=2, device="cpu",
                               log=lines.append)
    assert len(lines) == 1                  # restored, not trained again
    _equal(first.params, again.params)
    assert again.score_thresh == 0.4 and again.top_k == 32


def test_offload_launcher_serves_a_trained_sim_server(tmp_path):
    # two threads, as this file's own torch: the suite runs files in
    # parallel workers, and a child on every core oversubscribes them
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="2")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.offload", "--sim",
         "--device", "cpu", "--frames", "8", "--train-steps", "20",
         "--ckpt-dir", str(tmp_path)], env=env, cwd=ROOT,
        capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "trained SIM server: 20 steps" in out.stdout
    assert "score threshold 0.4" in out.stdout
    for name in ("TrackB2B", "ViTMAlis", "ViTMAlis+Reuse"):
        assert f"{name}: rendering_f1=" in out.stdout
    assert tckpt.steps(str(tmp_path)) == [20]


# ---------------------------------------------------------------------------
# on the card (chip_smoke.py phase 15 runs the full-width checks)


@pytest.mark.cuda
def test_functions_match_plain_autograd_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (chip_smoke.py phase 15 "
                    "runs this check on the H100)")
    args = _qkv(7, 2, 256, 4, 2, 64)
    wv = torch.tensor([3, 4], dtype=torch.int32, device="cuda")

    def grads(fn):
        xs = [_t(a).cuda().requires_grad_(True) for a in args]
        torch.sum(torch.sin(fn(*xs))).backward()
        return [x.grad for x in xs]

    for route, plain in (
            (lambda q, k, v: dispatch.window_attention(q, k, v, 64, wv),
             lambda q, k, v: twin.window_attention_plain(q, k, v, 64, wv)),
            (lambda q, k, v: dispatch.flash_attention(q, k, v, causal=True),
             lambda q, k, v: tflash.flash_attention_plain(q, k, v,
                                                          causal=True))):
        for a, b in zip(grads(route), grads(plain)):
            assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())
