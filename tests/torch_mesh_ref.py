"""The reference's side of ``tests/test_torch_mesh.py``: runs the JAX
package's sharded code on four CPU devices and writes its inputs and
results to ``<out>/ref.npz``.

Run as a subprocess with ``XLA_FLAGS=--xla_force_host_platform_device_count=4
JAX_PLATFORMS=cpu`` (the device count must be set before JAX starts):

    python tests/torch_mesh_ref.py OUT_DIR

Meshes are built with ``AxisType.Auto`` axes: the reference's
``ParallelCtx.constrain`` calls ``with_sharding_constraint``, which this
JAX refuses on the ``Explicit`` axes ``jax.make_mesh`` now defaults to.

Keys in the archive: ``moe/<arch>/<d>x<m>/{out,aux,g/<leaf>}`` (the
expert-parallel layer on a (d, m) mesh; ``aux`` as the host reads it,
``g`` the gradient of sum(out * w) + aux); ``train/<arch>/<d>x<m>/<sp>/
{loss,p/<leaf>,m/<leaf>,v/<leaf>}`` (two steps of the reference's
``make_train_step(cfg, mesh, tc)``); ``psum/{mean,err,q,total}`` (the
int8 all-reduce over a 4-way ``pod`` axis, stacked by shard); and the
inputs under ``in/``.  Tree leaves are "/"-joined dict paths of the
reference's trees.
"""
import dataclasses
import os
import sys

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=4")
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro import configs as jc  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.optim import adam as jadam  # noqa: E402
from repro.optim import grad_compression as jgc  # noqa: E402
from repro.train import trainer as jtr  # noqa: E402

MOE_ARCHS = ("dbrx-132b", "deepseek-v2-236b")
MOE_MESHES = ((1, 4), (2, 2))
TRAIN_ARCHS = ("qwen3-4b", "dbrx-132b")
TRAIN_MESHES = ((2, 2), (4, 1))
CAPACITY = 0.5          # tokens drop, so local capacity shows
B, T, STEPS = 4, 16, 2


def config(arch: str):
    cfg = jc.get_reduced(arch).replace(n_layers=2)
    if cfg.moe is not None:
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe,
                                                  capacity_factor=CAPACITY))
    return cfg


def train_config(sp: bool):
    return jtr.TrainConfig(remat=True, sp=sp, peak_lr=1e-3, warmup_steps=1,
                           total_steps=10)


def mesh(shape, axes=("data", "model")):
    return jax.make_mesh(shape, axes,
                         axis_types=(jax.sharding.AxisType.Auto,) * len(axes))


def flat(tree, prefix):
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out[prefix + "/".join(str(k.key) for k in path)] = np.asarray(leaf)
    return out


def batches(cfg, seed=3):
    rng = np.random.default_rng(seed)
    return [{"tokens": rng.integers(0, cfg.vocab_size, (B, T)
                                    ).astype(np.int32),
             "loss_mask": (rng.random((B, T)) < 0.7).astype(np.float32)}
            for _ in range(STEPS)]


def main(out_dir: str) -> None:
    res = {}
    # the expert-parallel layer
    for arch in MOE_ARCHS:
        cfg = config(arch)
        p = jmoe.init_moe(cfg, jax.random.PRNGKey(5), jnp.float32)
        rng = np.random.default_rng(6)
        x = rng.standard_normal((4, 8, cfg.d_model)).astype(np.float32)
        w = rng.standard_normal((4, 8, cfg.d_model)).astype(np.float32)
        res.update(flat(p, f"in/moe/{arch}/p/"))
        res[f"in/moe/{arch}/x"], res[f"in/moe/{arch}/w"] = x, w
        for shape in MOE_MESHES:
            m = mesh(shape)
            key = f"moe/{arch}/{shape[0]}x{shape[1]}/"

            def scalar(p, m=m, cfg=cfg):
                o, a = jmoe.moe_sharded(cfg, p, jnp.asarray(x), m)
                return jnp.sum(o * w) + a, (o, a)

            (_, (o, a)), g = jax.jit(jax.value_and_grad(
                scalar, has_aux=True))(p)
            res[key + "out"], res[key + "aux"] = np.asarray(o), np.asarray(a)
            res.update(flat(g, key + "g/"))
    # the sharded train step
    for arch in TRAIN_ARCHS:
        cfg = config(arch)
        tree = jreg.init_params(cfg, jax.random.PRNGKey(0))
        res.update(flat(tree, f"in/train/{arch}/p/"))
        bs = batches(cfg)
        for i, b in enumerate(bs):
            for k, v in b.items():
                res[f"in/train/{arch}/batch{i}/{k}"] = v
        for shape in TRAIN_MESHES:
            for sp in (False, True):
                m = mesh(shape)
                step = jax.jit(jtr.make_train_step(cfg, m, train_config(sp)))
                p, o = tree, jadam.init_adam(tree)
                losses = []
                for b in bs:
                    p, o, met = step(p, o, {k: jnp.asarray(v)
                                            for k, v in b.items()})
                    losses.append(float(met["loss"]))
                key = f"train/{arch}/{shape[0]}x{shape[1]}/{int(sp)}/"
                res[key + "loss"] = np.asarray(losses)
                res.update(flat(p, key + "p/"))
                res.update(flat(o.m, key + "m/"))
                res.update(flat(o.v, key + "v/"))
    # the int8 all-reduce over a 4-way pod axis
    rng = np.random.default_rng(9)
    xs = {"a": rng.standard_normal((4, 33)).astype(np.float32),
          "b": {"c": (rng.standard_normal((4, 5, 7)) * 1e-3
                      ).astype(np.float32)}}
    es = {"a": (rng.standard_normal((4, 33)) * 1e-3).astype(np.float32),
          "b": {"c": np.zeros((4, 5, 7), np.float32)}}
    res.update(flat(xs, "in/psum/x/"))
    res.update(flat(es, "in/psum/err/"))
    pm = mesh((4,), ("pod",))

    def body(x, e):
        x = jax.tree_util.tree_map(lambda a: a[0], x)
        e = jax.tree_util.tree_map(lambda a: a[0], e)
        mean, err = jgc.compressed_psum_tree(x, "pod", e)
        # the codes and their int32 sum, by the reference's own steps
        xe = jax.tree_util.tree_map(lambda a, b: a + b, x, e)
        scale = jax.tree_util.tree_map(lambda a: jnp.maximum(
            jax.lax.pmax(jnp.max(jnp.abs(a)), "pod") / 127.0, 1e-12), xe)
        q = jax.tree_util.tree_map(jgc.quantize, xe, scale)
        tot = jax.tree_util.tree_map(
            lambda a: jax.lax.psum(a.astype(jnp.int32), "pod"), q)
        return jax.tree_util.tree_map(lambda a: a[None],
                                      (mean, err, q, tot))

    spec = jax.tree_util.tree_map(lambda _: P("pod"), xs)
    outs = jax.jit(jax.shard_map(
        body, mesh=pm, in_specs=(spec, spec),
        out_specs=(spec,) * 4, check_vma=False))(xs, es)
    for name, tree in zip(("mean", "err", "q", "total"), outs):
        res.update(flat(tree, f"psum/{name}/"))
    np.savez(os.path.join(out_dir, "ref.npz"), **res)


if __name__ == "__main__":
    main(sys.argv[1])
