"""``distributed.sharding``'s spec trees against the reference's, entry
for entry, for all 11 archs at their REDUCED and full configs, from
shapes only: ``jax.eval_shape`` on the JAX side, meta tensors on the
port's.  Meshes stand in as axis-size maps, (16, 16), (2, 16, 16), (2, 2)
and (4, 1); no device is needed.

The port's parameter tree differs from the reference's in two ways that
``param_specs`` maps (its docstring): layers are lists of per-layer trees
(the reference stacks them on a leading axis whose spec entry is
``None``), and q / k / v are fused into ``w_qkv`` (``b_qkv``), which take
``w_q``'s (``b_q``'s) spec.  So each port leaf is held to its reference
leaf's unfixed spec without the layer entry; its fixed spec to the
reference's own ``fix_spec`` of that at the port leaf's shape; and, where
the two leaves have one shape, to the reference's fixed spec itself.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro import configs as jconfigs
from repro.distributed import sharding as jshd
from repro.models import moe as jmoe
from repro.models import registry as jreg
from repro_torch import configs as tconfigs
from repro_torch.distributed import sharding as tshd
from repro_torch.models import moe as tmoe
from repro_torch.models import registry as treg
from repro_torch.models import transformer as tfm
from repro_torch.train import checkpoint as tckpt
from repro_torch.train import trainer as ttr

ARCHS = list(tconfigs.ARCH_MODULES)
SIZES = ("reduced", "full")
MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16},
          "2x2": {"data": 2, "model": 2},
          "4x1": {"data": 4, "model": 1}}
STACKS = ("dense_blocks", "moe_blocks", "mamba_blocks", "enc_blocks",
          "dec_blocks")


def _jmesh(sizes):
    """An axis-size map in the shape the reference's functions read."""
    return types.SimpleNamespace(shape=dict(sizes),
                                 axis_names=tuple(sizes))


def _configs(arch, size):
    if size == "full":
        return jconfigs.get_config(arch), tconfigs.get_config(arch)
    return jconfigs.get_reduced(arch), tconfigs.get_reduced(arch)


def _jspecs(tree):
    """{path tuple (dict keys, list indices): spec} of a reference spec
    tree."""
    out = {}
    for path, s in jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: isinstance(x, P))[0]:
        out[tuple(k.key if hasattr(k, "key") else k.idx for k in path)] = s
    return out


def _ref_leaf(tcfg, port_path):
    """(reference path, stacked) of the leaf a port leaf stands for."""
    parts = [int(p) if p.isdigit() else p for p in port_path.split("/")]
    parts = [{"w_qkv": "w_q", "b_qkv": "b_q"}.get(p, p) for p in parts]
    if tcfg.family == "vit" or parts[0] not in ("blocks",) + STACKS:
        return tuple(parts), False
    i = parts[1]
    if parts[0] == "blocks":                      # the decoder families
        stack = ("dense_blocks" if i < tfm.n_dense_layers(tcfg)
                 else "moe_blocks")
    else:
        stack = parts[0]
    return (stack,) + tuple(parts[2:]), True


@pytest.fixture(scope="module", params=[(a, s) for a in ARCHS for s in SIZES],
                ids=lambda p: f"{p[0]}-{p[1]}")
def trees(request):
    arch, size = request.param
    jcfg, tcfg = _configs(arch, size)
    jtree = jax.eval_shape(lambda: jreg.init_params(jcfg,
                                                    jax.random.PRNGKey(0)))
    ttree = treg.init_params(tcfg, torch.Generator(), "meta")
    return jcfg, tcfg, jtree, ttree


def _held(jcfg, tcfg, jtree, ttree, mesh):
    """Checks every port leaf's spec; returns how many leaves matched
    the reference's fixed spec outright."""
    jm = None if mesh is None else _jmesh(mesh)
    jun = _jspecs(jshd.param_specs(jcfg, jtree))
    jfix = _jspecs(jshd.param_specs(jcfg, jtree, jm)) if jm else None
    jshape = {tuple(k.key if hasattr(k, "key") else k.idx for k in p):
              l.shape for p, l in
              jax.tree_util.tree_flatten_with_path(jtree)[0]}
    got = tckpt.flatten(tshd.param_specs(tcfg, ttree, mesh))
    shapes = tckpt.flatten(ttree)
    assert set(got) == set(shapes)
    exact = 0
    for path, spec in got.items():
        assert isinstance(spec, tshd.Spec)
        shape = tuple(shapes[path].shape)
        ref, stacked = _ref_leaf(tcfg, path)
        if ref not in jun:          # the ViT's derived position banks
            assert path.split("/")[-1] in ("pos_seq", "pos_bank"), path
            assert tuple(spec) == (None,) * len(shape)
            continue
        un = tuple(jun[ref])
        if stacked:
            assert un[0] is None, (path, un)
            un = un[1:]
        if mesh is None:
            assert tuple(spec) == un, (path, spec, un)
            continue
        assert tuple(spec) == tuple(jshd.fix_spec(jm, P(*un), shape)), path
        fixed = tuple(jfix[ref])
        if stacked:
            if fixed[0] is not None:     # the reference parks it on L
                continue
            fixed, jsh = fixed[1:], jshape[ref][1:]
        else:
            jsh = jshape[ref]
        if tuple(jsh) == shape:
            assert tuple(spec) == fixed, (path, spec, fixed)
            exact += 1
    return exact


@pytest.mark.parametrize("mesh", [None] + list(MESHES),
                         ids=["no-mesh"] + list(MESHES))
def test_param_specs_match_reference(trees, mesh):
    jcfg, tcfg, jtree, ttree = trees
    exact = _held(jcfg, tcfg, jtree, ttree,
                  None if mesh is None else MESHES[mesh])
    if mesh is not None:
        assert exact > 0


@pytest.mark.parametrize("arch", [a for a in ARCHS if a != "vitdet-l"])
@pytest.mark.parametrize("size", SIZES)
def test_batch_and_decode_state_specs_match_reference(arch, size):
    jcfg, tcfg = _configs(arch, size)
    B, T = 4, 32
    batch = {"tokens": np.zeros((B, T), np.int32),
             "labels": np.zeros((B, T), np.int32),
             "loss_mask": np.zeros((B, T), np.float32)}
    if tcfg.encdec is not None:
        batch["frames"] = np.zeros((B, 8, 4), np.float32)
    if tcfg.vlm is not None:
        batch["image_embeds"] = np.zeros((B, 8, 4), np.float32)
    jstate = jax.eval_shape(lambda: jreg.init_decode_state(
        jcfg, B, T, jnp.float32))
    tstate = treg.init_decode_state(tcfg, B, T, torch.float32, "meta")
    for sizes in MESHES.values():
        jm = _jmesh(sizes)
        got = tshd.batch_specs(tcfg, sizes, batch)
        want = jshd.batch_specs(jcfg, jm, batch)
        assert {k: tuple(v) for k, v in got.items()} == \
            {k: tuple(v) for k, v in want.items()}
        for shard in (True, False):
            got = tckpt.flatten(tshd.decode_state_specs(tcfg, sizes, tstate,
                                                        shard))
            want = {"/".join(str(k) for k in p): tuple(s) for p, s in
                    _jspecs(jshd.decode_state_specs(jcfg, jm, jstate,
                                                    shard)).items()}
            assert {k: tuple(v) for k, v in got.items()} == want


@pytest.mark.parametrize("arch", ["dbrx-132b", "deepseek-v2-236b"])
def test_moe_param_specs_match_reference(arch):
    want = _jspecs(jmoe.moe_param_specs(jconfigs.get_reduced(arch)))
    got = tckpt.flatten(tmoe.moe_param_specs(tconfigs.get_reduced(arch)))
    assert {k: tuple(v) for k, v in got.items()} == \
        {"/".join(k): tuple(s) for k, s in want.items()}


def test_dp_axes_and_sizes_match_reference():
    for sizes in MESHES.values():
        jm = _jmesh(sizes)
        assert tshd.dp_axes(sizes) == jshd.dp_axes(jm)
        assert tshd.dp_size(sizes) == jshd.dp_size(jm)
        assert tshd.fsdp_axis(sizes) == jshd.fsdp_axis(jm)


def test_train_shardings_store_the_fixed_specs():
    """The reference's ``train_shardings`` calls ``param_specs`` without a
    mesh; the port stores the fixed specs (as the reference's dry-run
    does), the moments over the flat view."""
    cfg = tconfigs.get_config("qwen3-4b")
    tree = ttr.shape_tree(cfg)
    sizes = MESHES["16x16"]
    p, o, b = ttr.train_shardings(cfg, sizes, tree,
                                  {"tokens": torch.zeros(2, 8)})
    assert tckpt.flatten(p) == tckpt.flatten(tshd.param_specs(cfg, tree,
                                                              sizes))
    assert o.m == tckpt.flatten(p) and o.v == o.m and tuple(o.step) == ()
    assert tuple(b["tokens"]) == ("data", None)


def test_placements_of_a_spec():
    from torch.distributed.tensor import Replicate, Shard
    mesh = types.SimpleNamespace(mesh_dim_names=("pod", "data", "model"))
    assert tshd.to_placements(mesh, tshd.Spec(("pod", "data"), None,
                                              "model")) == \
        [Shard(0), Shard(0), Shard(2)]
    assert tshd.to_placements(mesh, tshd.Spec(None, "data")) == \
        [Replicate(), Shard(1), Replicate()]
    with pytest.raises(ValueError, match="mesh's order"):
        tshd.to_placements(mesh, tshd.Spec(("data", "pod")))


def test_shapes_and_cells_match_reference():
    assert tconfigs.SHAPES == {
        k: tconfigs.ShapeSpec(v.name, v.seq_len, v.global_batch, v.kind)
        for k, v in jconfigs.SHAPES.items()}
    assert tconfigs.cells() == jconfigs.cells() and len(tconfigs.cells()) == 40
    for arch in tconfigs.ASSIGNED:
        for shape in tconfigs.SHAPES:
            assert tconfigs.shape_runnable(tconfigs.get_config(arch),
                                           shape) == \
                jconfigs.shape_runnable(jconfigs.get_config(arch), shape)
