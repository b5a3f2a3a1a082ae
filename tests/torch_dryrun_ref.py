"""The reference's side of ``tests/test_torch_dryrun.py``: evaluates the
JAX package's dry-run pieces (``repro.launch.{specs,costing}``,
``repro.roofline.{model,collectives}``) and writes the results to
``<out>/ref.json``.

Run as a subprocess with ``XLA_FLAGS=--xla_force_host_platform_device_count=512
JAX_PLATFORMS=cpu`` (the device count must be set before JAX starts):

    python tests/torch_dryrun_ref.py OUT_DIR

Keys: ``model_flops`` / ``floor`` / ``attn`` by ``<mesh>/<arch>/<shape>``
(``attn``: the local attention shapes and the kernel bytes of
``_attn_site_saving``, its XLA probe stubbed out: the kernel bytes are
its formula's); ``roofline`` (the terms of ``ROOFLINE_INPUTS``);
``collectives`` (one synthetic HLO line per op and group size, its
operand / result bytes and ``collective_bytes``); ``inputs``
(``input_specs``); ``accum`` (``accum_for_cell`` for every opt variant);
``params`` (each leaf's global shape and fixed spec, by mesh and arch);
``state`` (the decode state each serving cell stores); ``runnable``
(``shape_runnable`` by cell); ``stacks`` and
``attn_layers`` by arch; ``tiny`` (a reduced train cell on a (2, 2)
mesh of four devices, at bf16 and, ``_f32``, float32 parameters:
``memory_analysis`` and the HLO FLOPs with every scan unrolled);
``hlo_real`` (the parser on a compiled all-gather).
"""
import dataclasses
import json
import os
import sys
import types

os.environ.setdefault("XLA_FLAGS",
                      "--xla_force_host_platform_device_count=512")
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro import configs as jc  # noqa: E402
from repro.distributed import sharding as jshd  # noqa: E402
from repro.launch import costing as jcost  # noqa: E402
from repro.launch import specs as jsp  # noqa: E402
from repro.launch.mesh import make_production_mesh  # noqa: E402
from repro.models import layers as jL  # noqa: E402
from repro.roofline import collectives as jcoll  # noqa: E402
from repro.roofline import model as jrm  # noqa: E402

MESHES = {"pod1": False, "pod2": True}
OPTS = ("base", "sp", "accum2x", "accum4x", "sp_accum2x", "flash",
        "flash+sp", "accum2x+flash")
ROOFLINE_INPUTS = [
    dict(flops_per_device=3.1e14, bytes_per_device=2.2e12,
         collective_bytes_per_device=4.0e10, n_chips=256),
    dict(flops_per_device=1.0e12, bytes_per_device=5.5e11,
         collective_bytes_per_device=9.0e9, n_chips=512),
    dict(flops_per_device=7.7e16, bytes_per_device=1.0e9,
         collective_bytes_per_device=0.0, n_chips=256),
    dict(flops_per_device=0.0, bytes_per_device=0.0,
         collective_bytes_per_device=0.0, n_chips=1),
]
GROUPS = (2, 4, 16)
HLO_OPS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
           "collective-permute")
TINY = dict(arch="qwen3-4b", seq=32, batch=8, layers=2, mesh=(2, 2))


def _path(p):
    return "/".join(str(k.key if hasattr(k, "key") else k.idx) for k in p)


def _spec_list(s):
    return [list(e) if isinstance(e, tuple) else e for e in s]


def _leaves(tree, specs):
    flat_s = {_path(p): s for p, s in jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, P))[0]}
    return {_path(p): [list(x.shape), str(x.dtype), _spec_list(flat_s[
        _path(p)])] for p, x in jax.tree_util.tree_flatten_with_path(
        tree)[0]}


def _plain(v):
    if dataclasses.is_dataclass(v):
        return dataclasses.asdict(v)
    if isinstance(v, tuple):
        return list(v)
    return v


def hlo_line(op, g, n_elems):
    """A synthetic post-SPMD HLO line, bf16 operand of ``n_elems``.  The
    reference's parser reads the result's shape left of its first '='
    and the operands' inside the call's parentheses; compiled HLO prints
    only the result's name there (and, in this JAX, operands without
    shapes), so that its bytes read 0 on a real module.  The synthetic
    line carries both shapes where the parser looks, so that every ring
    factor is exercised."""
    res = {"all-gather": n_elems * g, "reduce-scatter": n_elems // g}.get(
        op, n_elems)
    groups = "{{" + ",".join(str(i) for i in range(g)) + "}}"
    return (f"  %x.1 bf16[{res}] = bf16[{res}] {op}(bf16[{n_elems}] "
            f"%p.0), replica_groups={groups}, to_apply=%add")


def _stub_probe():
    """``_attn_site_saving``'s jit stubbed: its XLA bytes read 0, so the
    record carries the kernel bytes alone."""
    class _C:
        def lower(self, *a):
            return self

        def compile(self):
            return self

        def cost_analysis(self):
            return {}
    stub = types.SimpleNamespace(
        jit=lambda *a, **k: _C(), remat=jax.remat,
        value_and_grad=jax.value_and_grad,
        ShapeDtypeStruct=jax.ShapeDtypeStruct)
    jcost.jax = stub


def serving_state(cfg, shape, mesh):
    """The decode state a serving cell stores, with its fixed specs."""
    if shape.kind == "prefill":
        n_img = cfg.vlm.n_image_tokens if cfg.family == "vlm" else 0
        state = jsp.decode_state_shape(cfg, shape.global_batch,
                                       shape.seq_len + n_img)
        if cfg.family == "encdec":
            state = state[1]
        shard = True
    else:
        state = jsp.decode_state_shape(cfg, shape.global_batch,
                                       shape.seq_len)
        shard = shape.global_batch >= jshd.dp_size(mesh)
    specs = jshd.fix_specs(mesh, jshd.decode_state_specs(
        cfg, mesh, state, shard_batch=shard), state)
    return _leaves(state, specs)


def tiny_cell():
    """A reduced qwen3 train cell on a (2, 2) mesh of four devices: at the
    reference's bf16 parameters its memory analysis, and with every scan
    unrolled its HLO FLOPs at bf16 and at float32 parameters (XLA counts
    a bf16 step's converts as FLOPs too; the GEMMs are the same)."""
    cfg = jc.get_reduced(TINY["arch"]).replace(n_layers=TINY["layers"])
    shape = jc.ShapeSpec("tiny", TINY["seq"], TINY["batch"], "train")
    mesh = jax.make_mesh(TINY["mesh"], ("data", "model"),
                         devices=jax.devices()[:4],
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    prev_dtype, prev_unroll = jsp.PARAM_DTYPE, jL.SCAN_UNROLL
    jL.SCAN_UNROLL = True
    try:
        out = {}
        for accum in (1, 2):
            for name, dt in (("", prev_dtype), ("_f32", jnp.float32)):
                jsp.PARAM_DTYPE = dt
                cell = jsp.build_cell_from(cfg, shape, mesh, accum=accum)
                with mesh:
                    jf = jax.jit(cell.fn, in_shardings=cell.in_shardings,
                                 out_shardings=cell.out_shardings,
                                 donate_argnums=cell.donate_argnums)
                    compiled = jf.lower(*cell.args).compile()
                ma = compiled.memory_analysis()
                ca = compiled.cost_analysis() or {}
                batch_local = sum(
                    int(np.prod(x.shape)) * x.dtype.itemsize
                    // jshd.dp_size(mesh) for x in cell.args[2].values())
                out[f"accum{accum}{name}"] = {
                    "argument_bytes": int(ma.argument_size_in_bytes),
                    "batch_local_bytes": batch_local,
                    "flops": float(ca.get("flops", 0.0)),
                    "bytes": float(ca.get("bytes accessed", 0.0))}
        return out
    finally:
        jsp.PARAM_DTYPE, jL.SCAN_UNROLL = prev_dtype, prev_unroll


def real_module_collectives():
    """The reference's parser on a compiled module: one all-gather of a
    (4096,) array over four devices."""
    from jax.sharding import NamedSharding
    mesh = jax.make_mesh((4,), ("x",), devices=jax.devices()[:4],
                         axis_types=(jax.sharding.AxisType.Auto,))
    f = jax.jit(lambda a: a * 2, in_shardings=NamedSharding(mesh, P("x")),
                out_shardings=NamedSharding(mesh, P()))
    text = f.lower(jax.ShapeDtypeStruct((4096,), jnp.float32)
                   ).compile().as_text()
    return {"lines": [ln for ln in text.splitlines() if "all-gather" in ln
                      and "=" in ln and "fusion(" not in ln],
            "stats": jcoll.collective_bytes(text)}


def main(out_dir):
    _stub_probe()
    res = {"model_flops": {}, "floor": {}, "attn": {}, "inputs": {},
           "runnable": {},
           "accum": {}, "params": {}, "state": {}, "stacks": {},
           "attn_layers": {}}
    res["roofline"] = [{"in": i, "out": jrm.roofline_terms(**i)}
                       for i in ROOFLINE_INPUTS]
    res["collectives"] = []
    for op in HLO_OPS:
        for g in GROUPS:
            line = hlo_line(op, g, 4096)
            lhs, _, rhs = line.partition("=")
            res["collectives"].append({
                "op": op, "g": g, "line": line,
                "result_bytes": jcoll._shape_bytes(lhs),
                "operand_bytes": jcoll._shape_bytes(rhs.split("(", 1)[-1]),
                "stats": jcoll.collective_bytes(line)})
    for arch in jc.ARCH_MODULES:
        cfg = jc.get_config(arch)
        base, stacks = jcost.stacks_for(cfg)
        res["stacks"][arch] = {
            "base": {k: _plain(v) for k, v in base.items()},
            "stacks": [{"name": s.name, "n_layers": s.n_layers,
                        "base": s.base,
                        "bump": {k: _plain(v) for k, v in s.bump.items()}}
                       for s in stacks]}
        res["attn_layers"][arch] = jcost.attn_layer_count(cfg)
    for mname, multi in MESHES.items():
        mesh = make_production_mesh(multi_pod=multi)
        for arch in jc.ASSIGNED:
            cfg = jc.get_config(arch)
            p_shape = jsp.params_shape(cfg)
            res["params"][f"{mname}/{arch}"] = _leaves(
                p_shape, jshd.param_specs(cfg, p_shape, mesh))
        for arch, sname in jc.cells():
            cfg, shape = jc.get_config(arch), jc.SHAPES[sname]
            key = f"{mname}/{arch}/{sname}"
            res["model_flops"][key] = jrm.model_flops(cfg, shape)
            res["inputs"][key] = {k: [list(v.shape), str(v.dtype)] for k, v
                                  in jsp.input_specs(cfg, shape).items()}
            res["runnable"][key] = list(jc.shape_runnable(cfg, sname))
            for opt in OPTS:
                res["accum"][f"{key}/{opt}"] = jsp.accum_for_cell(
                    arch, sname, mesh, opt)
            if not jc.shape_runnable(cfg, sname)[0]:
                continue
            accum = jsp.accum_for_cell(arch, sname, mesh)
            res["floor"][key] = jcost.min_traffic_floor(cfg, shape, mesh,
                                                        accum)
            loc = jcost._attn_local_shapes(cfg, shape, mesh, accum)
            if loc is not None:
                site = jcost._attn_site_saving(
                    loc["mode"], loc["b"], loc["t"], loc["s"], loc["h"],
                    loc["kv"], loc["dh"], 2)
                res["attn"][key] = {"local": loc, "kernel": site["kernel"]}
            if shape.kind != "train":
                res["state"][key] = serving_state(cfg, shape, mesh)
    res["tiny"] = tiny_cell()
    res["hlo_real"] = real_module_collectives()
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "ref.json"), "w") as f:
        json.dump(res, f)


if __name__ == "__main__":
    main(sys.argv[1])
