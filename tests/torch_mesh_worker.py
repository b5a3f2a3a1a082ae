"""The port's side of ``tests/test_torch_mesh.py``: one gloo world of
WORLD ranks on the CPU, spawned once, runs every multi-rank check and
rank 0 writes ``<out>/w<WORLD>.npz``.  Imports no JAX.

    python tests/torch_mesh_worker.py OUT_DIR 4    # needs OUT_DIR/ref.npz
    python tests/torch_mesh_worker.py OUT_DIR 2    # needs OUT_DIR/ckpt

World 4: the expert-parallel layer and two sharded train steps on the
inputs ``torch_mesh_ref.py`` wrote, each rank's stored bytes at (4, 1),
the int8 all-reduce over a ``pod`` axis, the GPipe forward over a
``stage`` axis, and a sharded checkpoint at (2, 2).  World 2: the
elastic restart of that checkpoint on a (1, 2) mesh, the production
mesh's refusal of a world of the wrong size, and two sharded steps of
the dense config at bf16 parameters with accumulation 2 on a (2, 1)
mesh (gloo reduces bf16 on the CPU: each microbatch's gradients come
back reduce-scattered in bf16 and join a float32 sum).
"""
import dataclasses
import os
import socket
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config, get_reduced  # noqa: E402
from repro_torch.distributed import pipeline as pl  # noqa: E402
from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.optim import adam  # noqa: E402
from repro_torch.optim import grad_compression as gc  # noqa: E402
from repro_torch.quant import qtensor as qt  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train import elastic  # noqa: E402
from repro_torch.train import trainer as tr  # noqa: E402

MOE_ARCHS = ("dbrx-132b", "deepseek-v2-236b")
MOE_MESHES = ((1, 4), (2, 2))
TRAIN_ARCHS = ("qwen3-4b", "dbrx-132b")
TRAIN_MESHES = ((2, 2), (4, 1))
CAPACITY = 0.5
CKPT = ("qwen3-4b", (2, 2), False)        # the run saved for the restart
PIPE = dict(L=8, d=16, B=8, T=4)


def config(arch: str):
    cfg = get_reduced(arch).replace(n_layers=2)
    if cfg.moe is not None:
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe,
                                                  capacity_factor=CAPACITY))
    return cfg


def train_config(sp: bool):
    return tr.TrainConfig(remat=True, sp=sp, peak_lr=1e-3, warmup_steps=1,
                          total_steps=10)


def nest(z, prefix: str):
    """The "/"-joined archive keys under ``prefix`` as a nested dict."""
    out = {}
    for k in z.files:
        if k.startswith(prefix):
            d = out
            *head, last = k[len(prefix):].split("/")
            for h in head:
                d = d.setdefault(h, {})
            d[last] = z[k]
    return out


def _put(res, prefix, tree):
    for k, v in ckpt.flatten(tree).items():
        res[prefix + k] = (v.detach().numpy() if isinstance(v, torch.Tensor)
                           else np.asarray(v))


def _rows(mesh, x):
    return shd.shard_leaf(mesh, x, shd.Spec(shd.dp_axes(mesh),
                                            *([None] * (x.ndim - 1))))


def moe_checks(z, res):
    for arch in MOE_ARCHS:
        cfg = config(arch)
        for shape in MOE_MESHES:
            mesh = mesh_lib.make_local_mesh(*shape, device_type="cpu")
            p = convert._tensors(nest(z, f"in/moe/{arch}/p/"), "cpu")
            for t in ckpt.flatten(p).values():
                t.requires_grad_(True)
            x = torch.from_numpy(z[f"in/moe/{arch}/x"])
            w = torch.from_numpy(z[f"in/moe/{arch}/w"])
            out, aux = moe.moe_sharded(cfg, p, _rows(mesh, x), mesh)
            # this rank's term: summed over the ranks, sum(out * w) + the
            # mean over data shards of aux (the reference's gradient)
            term = (torch.sum(out * _rows(mesh, w))
                    + aux / shd.dp_size(mesh)) / shape[1]
            term.backward()
            key = f"moe/{arch}/{shape[0]}x{shape[1]}/"
            res[key + "out"] = shd.gather_leaf(
                out.detach(), mesh, shd.Spec(("data",), None, None)).numpy()
            res[key + "aux"] = aux.detach().numpy()
            for k, t in ckpt.flatten(p).items():
                dist.all_reduce(t.grad)
                res[key + "g/" + k] = t.grad.numpy()


def train_checks(z, res, out_dir):
    for arch in TRAIN_ARCHS:
        cfg = config(arch)
        tree = nest(z, f"in/train/{arch}/p/")
        batches = [{k: torch.from_numpy(v) for k, v in
                    nest(z, f"in/train/{arch}/batch{i}/").items()}
                   for i in range(2)]
        for shape in TRAIN_MESHES:
            for sp in (False, True):
                mesh = mesh_lib.make_local_mesh(*shape, device_type="cpu")
                params = convert.lm_params_from_jax(tree, cfg, "cpu")
                pspecs, ospecs, _ = tr.train_shardings(cfg, mesh, params)
                lp, lo = tr.shard_train_state(cfg, mesh, params)
                del params
                step = tr.make_train_step(cfg, train_config(sp), mesh)
                losses = []
                for b in batches:
                    lp, lo, met = step(lp, lo, b)
                    losses.append(float(met["loss"]))
                key = f"train/{arch}/{shape[0]}x{shape[1]}/{int(sp)}/"
                res[key + "loss"] = np.asarray(losses)
                with torch.no_grad():
                    _put(res, key + "p/", shd.gather_tree(mesh, lp, pspecs))
                    _put(res, key + "m/", shd.gather_tree(mesh, lo.m,
                                                          ospecs.m))
                    _put(res, key + "v/", shd.gather_tree(mesh, lo.v,
                                                          ospecs.v))
                if (arch, shape, sp) == CKPT:
                    named = shd.to_named(mesh, (pspecs, ospecs))
                    ckpt.save((lp, lo), os.path.join(out_dir, "ckpt"), 2,
                              named)
                    _put(res, "ckpt/", (shd.gather_tree(mesh, lp, pspecs),
                                        lo._replace(
                                            m=shd.gather_tree(mesh, lo.m,
                                                              ospecs.m),
                                            v=shd.gather_tree(mesh, lo.v,
                                                              ospecs.v))))


def storage_checks(res):
    """Each rank's stored bytes (parameters and both moments) at (4, 1):
    full-width Qwen3-4B on the meta device, and the reduced config."""
    mesh = mesh_lib.make_local_mesh(4, 1, device_type="cpu")
    for name, cfg in (("full", get_config("qwen3-4b")),
                      ("reduced", config("qwen3-4b"))):
        tree = tr.shape_tree(cfg)
        pspecs, _, _ = tr.train_shardings(cfg, mesh, tree)
        local = shd.shard_tree(mesh, tree, pspecs)
        mine = sum(4 * t.numel() for t in ckpt.flatten(local).values())
        full = sum(4 * t.numel() for t in ckpt.flatten(tree).values())
        got = [None] * dist.get_world_size()
        dist.all_gather_object(got, mine / full)
        res[f"bytes/{name}"] = np.asarray(got)


def psum_checks(z, res):
    mesh = torch.distributed.device_mesh.init_device_mesh(
        "cpu", (4,), mesh_dim_names=("pod",))
    r = dist.get_rank()
    x = {k: torch.from_numpy(v[r]) for k, v in
         ckpt.flatten(nest(z, "in/psum/x/")).items()}
    e = {k: torch.from_numpy(v[r]) for k, v in
         ckpt.flatten(nest(z, "in/psum/err/")).items()}
    group = mesh.get_group("pod")
    mean, err = gc.compressed_psum_tree(x, group, e)
    for name, tree in (("mean", mean), ("err", err)):
        for k, v in tree.items():
            res[f"psum/{name}/{k}"] = _stack(v)
    for k in x:
        q, _, total = gc.int8_psum(x[k] + e[k], group)
        res[f"psum/q/{k}"], res[f"psum/total/{k}"] = _stack(q), _stack(total)


def _stack(t):
    out = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(out, t.contiguous())
    return torch.stack(out).numpy()


def _layer(p, x):
    return torch.tanh(x @ p["w"] + p["b"])


def pipeline_checks(res):
    mesh = torch.distributed.device_mesh.init_device_mesh(
        "cpu", (4,), mesh_dim_names=("stage",))
    L, d, B, T = PIPE["L"], PIPE["d"], PIPE["B"], PIPE["T"]
    rng = np.random.default_rng(11)
    params = {"w": torch.from_numpy(
        (rng.standard_normal((L, d, d)) / d ** 0.5).astype(np.float32)),
              "b": torch.from_numpy(
        (rng.standard_normal((L, d)) * 0.01).astype(np.float32))}
    x = torch.from_numpy(rng.standard_normal((B, T, d)).astype(np.float32))
    want = x
    for i in range(L):
        want = _layer({k: v[i] for k, v in params.items()}, want)
    res["pipe/want"] = want.numpy()
    for m in (1, 2, 4):
        y = pl.pipeline_forward(mesh, _layer, params, x, m)
        res[f"pipe/{m}"] = _stack(y)


def survivors_check(res):
    """Three survivors of four ranks with model_par 2: ``plan_mesh``
    gives (3, 1), a mesh over ranks 0-2 that every rank builds; a sum
    over its data axis reaches those three only."""
    mesh = elastic.rebuild_mesh([0, 1, 2], 2, device_type="cpu")
    res["survivors/mesh"] = np.asarray(list(shd.mesh_shape(mesh).values()))
    total = torch.tensor([float(dist.get_rank() + 1)])
    if dist.get_rank() < 3:
        dist.all_reduce(total, group=mesh.get_group("data"))
    res["survivors/sum"] = _stack(total)


def world4(rank, port, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=4)
    try:
        z = np.load(os.path.join(out_dir, "ref.npz"))
        res = {}
        moe_checks(z, res)
        train_checks(z, res, out_dir)
        storage_checks(res)
        psum_checks(z, res)
        pipeline_checks(res)
        survivors_check(res)
        if rank == 0:
            np.savez(os.path.join(out_dir, "w4.npz"), **res)
    finally:
        dist.destroy_process_group()


def world2(rank, port, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=2)
    try:
        res = {}
        cfg = config(CKPT[0])
        like = tr.init_train_state(cfg, torch.Generator().manual_seed(1),
                                   "cpu")

        def shardings(mesh):
            return shd.to_named(mesh, tr.train_shardings(
                cfg, mesh, tr.shape_tree(cfg))[:2])

        mesh, (lp, lo) = elastic.elastic_restart(
            cfg, os.path.join(out_dir, "ckpt"), list(range(2)), 2,
            lambda: like, shardings, device_type="cpu")
        res["mesh"] = np.asarray(list(shd.mesh_shape(mesh).values()))
        pspecs, ospecs, _ = tr.train_shardings(cfg, mesh,
                                               tr.shape_tree(cfg))
        res["local_bytes"] = np.asarray(sum(
            t.numel() for t in ckpt.flatten(lp).values()))
        _put(res, "ckpt/", (shd.gather_tree(mesh, lp, pspecs),
                            lo._replace(m=shd.gather_tree(mesh, lo.m,
                                                          ospecs.m),
                                        v=shd.gather_tree(mesh, lo.v,
                                                          ospecs.v))))
        try:
            mesh_lib.make_production_mesh(device_type="cpu")
        except ValueError as e:
            res["production_error"] = np.asarray(str(e))
        half_train_check(np.load(os.path.join(out_dir, "ref.npz")), res)
        if rank == 0:
            np.savez(os.path.join(out_dir, "w2.npz"), **res)
    finally:
        dist.destroy_process_group()


HALF_ACCUM = 2


def half_train_check(z, res):
    """Two steps of the dense config on bf16 parameters (the float32
    inputs cast once) at ``HALF_ACCUM`` microbatches on a (2, 1) mesh;
    the losses, the learning rates, each step's gradients as AdamW got
    them (gathered to full tensors, with their type) and the gathered
    parameters after both steps (bf16 values stored as float32,
    exactly)."""
    cfg = config("qwen3-4b")
    params = qt.cast_tree(convert.lm_params_from_jax(
        nest(z, "in/train/qwen3-4b/p/"), cfg, "cpu"), torch.bfloat16)
    mesh = mesh_lib.make_local_mesh(2, 1, device_type="cpu")
    pspecs, _, _ = tr.train_shardings(cfg, mesh, params)
    flat_specs = ckpt.flatten(pspecs)
    lp, lo = tr.shard_train_state(cfg, mesh, params)
    del params
    step = tr.make_train_step(cfg, dataclasses.replace(
        train_config(False), accum_steps=HALF_ACCUM), mesh)
    seen = []
    update = adam.adam_update

    def record(grads, state, params, **kw):
        seen.append({k: g.detach().clone() for k, g in grads.items()})
        return update(grads, state, params, **kw)

    adam.adam_update = record
    try:
        losses, lrs = [], []
        for i in range(2):
            b = {k: torch.from_numpy(v) for k, v in
                 nest(z, f"in/train/qwen3-4b/batch{i}/").items()}
            lp, lo, met = step(lp, lo, b)
            losses.append(float(met["loss"]))
            lrs.append(float(met["lr"]))
    finally:
        adam.adam_update = update
    res["half/loss"], res["half/lr"] = np.asarray(losses), np.asarray(lrs)
    with torch.no_grad():
        for i, grads in enumerate(seen):
            for k in sorted(grads):
                g = shd.gather_leaf(grads[k], mesh, flat_specs[k])
                res[f"half/g{i}/{k}"] = g.float().numpy()
                res[f"half/gdtype/{k}"] = np.asarray(str(g.dtype))
        full = shd.gather_tree(mesh, lp, pspecs)
    for k, v in ckpt.flatten(full).items():
        assert v.dtype == torch.bfloat16, k
        res["half/p/" + k] = v.float().numpy()
    assert all(m.dtype == torch.float32 for m in lo.m.values())


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


if __name__ == "__main__":
    out, world = sys.argv[1], int(sys.argv[2])
    mp.spawn(world4 if world == 4 else world2, args=(free_port(), out),
             nprocs=world)
