"""The port's mesh code on several ranks, against the JAX package's.

Two gloo worlds on the CPU (``torch_mesh_worker.py``, 4 ranks then 2),
each spawned once for the module, and the reference's sharded code on
four CPU devices (``torch_mesh_ref.py``, a subprocess with
``XLA_FLAGS=--xla_force_host_platform_device_count=4``), which also
draws the shared inputs.  Reduced configs at 2 layers; MoE capacity
factor 0.5, so tokens drop and the per-shard capacity shows.

  * ``moe.moe_sharded`` on (1, 4) and (2, 2) against the reference's
    ``moe_sharded`` (dbrx-132b; deepseek-v2-236b with shared experts):
    outputs and aux 1e-5, the gradients of sum(out * w) + aux 1e-4 of
    each leaf's largest;
  * two steps of ``make_train_step(cfg, tc, mesh)`` on (2, 2) and
    (4, 1), ``sp`` off and on, against the reference's
    ``make_train_step(cfg, mesh, tc)`` on the same mesh (its sharded step
    runs on CPU devices): losses, parameters and both AdamW moments 1e-4;
    the dense config also against the port's mesh-free step (GSPMD's
    numbers do not depend on the layout); the MoE config not, since on a
    mesh its capacity and aux are per data shard, as the reference's;
  * each rank's stored bytes at (4, 1) a quarter of the tree's (full-width
    Qwen3-4B on the meta device, and the reduced config);
  * ``compressed_psum_tree`` over a 4-way ``pod`` axis against the
    reference's under ``shard_map``: codes and int32 sums equal, means
    and errors 1e-6;
  * the GPipe forward on 4 stages at 1, 2 and 4 microbatches against the
    sequential stack (2e-5, as ``tests/test_pipeline.py``);
  * a checkpoint saved from (2, 2) and ``elastic_restart`` in a world of
    2 ranks: every full tensor equal; ``rebuild_mesh`` over three
    survivors of four;
  * two steps of the dense config at bf16 parameters, accumulation 2,
    on a (2, 1) mesh of 2 gloo ranks (bf16 reduce-scatters, a float32
    gradient sum) against the reference's mesh-free bf16 step: losses
    1e-2 relative, each step's gradients and the reference's AdamW on
    them at ``test_torch_half_train.py``'s bounds (3e-2 of a leaf's
    largest; one bf16 ULP, >= 99.9% bit-equal);
  * ``torch.distributed.run`` of ``launch.train --model-par 2`` on 2 CPU
    ranks exits 0.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.launch import mesh as mesh_lib
from repro_torch.optim import adam
from repro_torch.train import checkpoint as tckpt
from repro_torch.train import trainer as ttr

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_mesh_worker as W  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TESTS = ROOT / "tests"
TOL = 1e-4
MOE_CASES = [(a, m) for a in W.MOE_ARCHS for m in W.MOE_MESHES]
TRAIN_CASES = [(a, m, sp) for a in W.TRAIN_ARCHS for m in W.TRAIN_MESHES
               for sp in (False, True)]


def _run(args, env, timeout):
    out = subprocess.run([sys.executable, *args], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=timeout)
    assert out.returncode == 0, out.stderr[-4000:]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's run, then the 4-rank and 2-rank worlds."""
    d = tmp_path_factory.mktemp("mesh")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               OMP_NUM_THREADS="1")
    _run([str(TESTS / "torch_mesh_ref.py"), str(d)], env, 600)
    _run([str(TESTS / "torch_mesh_worker.py"), str(d), "4"], env, 600)
    _run([str(TESTS / "torch_mesh_worker.py"), str(d), "2"], env, 300)
    return {k: np.load(d / f"{k}.npz") for k in ("ref", "w4", "w2")}


def _close(got, want, tol, what):
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= tol * max(float(np.abs(want).max()), 1e-12), (what, err)


def _port_leaves(cfg, z, prefix):
    """The reference's tree under ``prefix`` as the port's flat leaves."""
    return {k: v.numpy() for k, v in tckpt.flatten(
        convert.lm_params_from_jax(W.nest(z, prefix), cfg, "cpu")).items()}


@pytest.mark.parametrize("arch,mesh", MOE_CASES)
def test_moe_sharded_matches_reference(runs, arch, mesh):
    ref, got = runs["ref"], runs["w4"]
    key = f"moe/{arch}/{mesh[0]}x{mesh[1]}/"
    _close(got[key + "out"], ref[key + "out"], 1e-5, "out")
    # the reference's host reads data shard 0's aux; so does rank 0
    _close(got[key + "aux"], ref[key + "aux"], 1e-5, "aux")
    leaves = [k for k in ref.files if k.startswith(key + "g/")]
    assert leaves and set(leaves) == {k for k in got.files
                                      if k.startswith(key + "g/")}
    for k in leaves:
        _close(got[k], ref[k], TOL, k)


@pytest.mark.parametrize("arch,mesh,sp", TRAIN_CASES)
def test_sharded_train_steps_match_reference(runs, arch, mesh, sp):
    ref, got = runs["ref"], runs["w4"]
    cfg = W.config(arch)
    key = f"train/{arch}/{mesh[0]}x{mesh[1]}/{int(sp)}/"
    np.testing.assert_allclose(got[key + "loss"], ref[key + "loss"],
                               rtol=TOL)
    for part in ("p", "m", "v"):
        want = _port_leaves(cfg, ref, key + part + "/")
        assert {k for k in got.files if k.startswith(key + part + "/")} == \
            {key + part + "/" + k for k in want}
        for k, w in want.items():
            _close(got[key + part + "/" + k], w, TOL, (part, k))


def test_dense_sharded_steps_match_the_mesh_free_step(runs):
    """GSPMD's numbers do not depend on the layout: every mesh's dense
    run against the port's own step without a mesh."""
    ref, got = runs["ref"], runs["w4"]
    cfg = W.config("qwen3-4b")
    params = convert.lm_params_from_jax(W.nest(ref, "in/train/qwen3-4b/p/"),
                                        cfg, "cpu")
    opt = adam.init_adam(tckpt.flatten(params))
    step = ttr.make_train_step(cfg, W.train_config(False))
    losses = []
    for i in range(2):
        b = {k: torch.from_numpy(v) for k, v in
             W.nest(ref, f"in/train/qwen3-4b/batch{i}/").items()}
        params, opt, m = step(params, opt, b)
        losses.append(float(m["loss"]))
    flat = {k: v.numpy() for k, v in tckpt.flatten(params).items()}
    for mesh in W.TRAIN_MESHES:
        for sp in (0, 1):
            key = f"train/qwen3-4b/{mesh[0]}x{mesh[1]}/{sp}/"
            np.testing.assert_allclose(got[key + "loss"], losses, rtol=TOL)
            for k, w in flat.items():
                _close(got[key + "p/" + k], w, TOL, k)
            for k, w in opt.m.items():
                _close(got[key + "m/" + k], w.numpy(), TOL, k)


def test_bf16_sharded_steps_match_the_reference(runs, monkeypatch):
    """The 2-rank world's bf16 steps on (2, 1) against the reference's
    jitted mesh-free step on the same bf16 tree (its numbers do not
    depend on the layout), with ``test_torch_half_train.py``'s bounds:
    each step's gradients as AdamW got them (float32 sums of the two
    microbatches' bf16 reduce-scatters) against the reference's, the
    reference's AdamW applied to them against the mesh's parameters,
    and the losses."""
    import jax
    import jax.numpy as jnp

    from repro import configs as jc
    from repro.optim import adam as jadam
    from repro.train import trainer as jtr
    from test_torch_half_train import check_adam_on_own_grads, check_grads
    ref, got = runs["ref"], runs["w2"]
    jcfg = jc.get_reduced("qwen3-4b").replace(n_layers=2)
    cfg = W.config("qwen3-4b")
    start = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16),
                                   W.nest(ref, "in/train/qwen3-4b/p/"))
    start.setdefault("lm_head", {})     # tied: the archive drops it
    tc = jtr.TrainConfig(accum_steps=W.HALF_ACCUM, remat=True, peak_lr=1e-3,
                         warmup_steps=1, total_steps=10)
    update = jadam.adam_update

    def record(grads, state, params, **kw):
        p, s, m = update(grads, state, params, **kw)
        return p, s, {**m, "grads": grads}

    monkeypatch.setattr(jadam, "adam_update", record)
    jstep = jax.jit(jtr.make_train_step(jcfg, None, tc))
    batches = [{k: jnp.asarray(v) for k, v in
                W.nest(ref, f"in/train/qwen3-4b/batch{i}/").items()}
               for i in range(2)]
    tree, opt, losses, ref_grads = start, jadam.init_adam(start), [], []
    for b in batches:
        tree, opt, m = jstep(tree, opt, b)
        losses.append(float(m["loss"]))
        ref_grads.append(m["grads"])
    np.testing.assert_allclose(got["half/loss"], losses, rtol=1e-2)

    def conv(t):
        return tckpt.flatten(convert.lm_params_from_jax(
            jax.tree_util.tree_map(np.asarray, t), cfg, "cpu"))

    def grads32(b):
        # the reference's float32 gradient at the same (unmoved: lr 0 at
        # the first step) parameters
        t32 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32),
                                     start)
        return conv(jstep(t32, jadam.init_adam(t32), b)[2]["grads"])

    grads = [{k[len(f"half/g{i}/"):]: torch.from_numpy(got[k]).to(
        getattr(torch, str(got["half/gdtype/" + k[len(f"half/g{i}/"):]])
                .split(".")[-1]))
        for k in got.files if k.startswith(f"half/g{i}/")}
        for i in range(2)]
    lr0, lr1 = got["half/lr"]
    assert lr0 == 0 < lr1
    for g, want, b in zip(grads, ref_grads, batches):
        check_grads(g, conv(want), lambda b=b: grads32(b))
    final = {k[len("half/p/"):]: torch.from_numpy(got[k]).to(torch.bfloat16)
             for k in got.files if k.startswith("half/p/")}
    check_adam_on_own_grads(conv(start), grads, list(got["half/lr"]), final,
                            tc.weight_decay, tc.grad_clip)


@pytest.mark.parametrize("which,hi", [("full", 0.2501), ("reduced", 0.26)])
def test_stored_bytes_are_a_quarter_at_4x1(runs, which, hi):
    """FSDP over 4 data ranks: each rank holds ~1/4 of the tree; what
    stays replicated is the vectors (norm scales)."""
    share = runs["w4"][f"bytes/{which}"]
    assert share.shape == (4,)
    assert np.all(share >= 0.25) and np.all(share <= hi), share


def test_compressed_psum_tree_matches_reference(runs):
    ref, got = runs["ref"], runs["w4"]
    for leaf in ("a", "b/c"):
        for part in ("q", "total"):
            k = f"psum/{part}/{leaf}"
            assert got[k].dtype == ref[k].dtype
            np.testing.assert_array_equal(got[k], ref[k])
        for part in ("mean", "err"):
            k = f"psum/{part}/{leaf}"
            np.testing.assert_allclose(got[k], ref[k], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("n_micro", [1, 2, 4])
def test_pipeline_matches_sequential(runs, n_micro):
    got = runs["w4"]
    want = got["pipe/want"]
    ys = got[f"pipe/{n_micro}"]           # every stage's output
    assert ys.shape == (4,) + want.shape
    for y in ys:
        np.testing.assert_allclose(y, want, rtol=2e-5, atol=2e-5)


def test_elastic_restart_reshards_the_checkpoint(runs):
    """Saved from the (2, 2) mesh of 4 ranks, restored on the (1, 2) mesh
    a world of 2 plans (model axis kept): full tensors equal."""
    w4, w2 = runs["w4"], runs["w2"]
    assert list(w2["mesh"]) == [1, 2]
    saved = [k for k in w4.files if k.startswith("ckpt/")]
    assert saved and set(saved) == {k for k in w2.files
                                    if k.startswith("ckpt/")}
    for k in saved:
        np.testing.assert_array_equal(w2[k], w4[k])
    # each rank holds its half of the model-split leaves
    cfg = W.config(W.CKPT[0])
    n = sum(v.numel() for v in tckpt.flatten(ttr.shape_tree(cfg)).values())
    assert n / 2 <= int(w2["local_bytes"]) < n


def test_rebuild_mesh_over_three_survivors(runs):
    """``plan_mesh(3, 2)`` keeps no model axis: a (3, 1) mesh over ranks
    0-2 of the world of 4; its data group sums 1 + 2 + 3 there and leaves
    rank 3 alone."""
    w4 = runs["w4"]
    assert list(w4["survivors/mesh"]) == [3, 1]
    np.testing.assert_array_equal(w4["survivors/sum"][:, 0], [6, 6, 6, 4])


def test_production_mesh_refuses_a_small_world(runs):
    assert "needs 256 ranks; the world has 2" in str(
        runs["w2"]["production_error"])


def test_mesh_module_import_touches_no_process_group():
    import torch.distributed as dist
    assert mesh_lib.PRODUCTION_SHAPES[True][0] == (2, 16, 16)
    assert not dist.is_initialized()


def test_torchrun_trains_with_model_par_2(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node",
         "2", "--master_port", str(W.free_port()), "-m",
         "repro_torch.launch.train", "--reduced", "--device", "cpu",
         "--model-par", "2", "--steps", "2", "--batch", "2", "--seq", "16",
         "--ckpt-dir", str(tmp_path)],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    assert out.stdout.count("[train] step 1 loss") == 1       # rank 0 logs
    assert tckpt.latest_step(str(tmp_path)) == 2
