"""The dry-run (``launch.{specs,costing,dryrun}``, ``roofline.{model,
collectives}``) against the reference's.

The reference's side runs once, as a subprocess with 512 host devices
(``tests/torch_dryrun_ref.py``), and writes ``ref.json``; the port's
side builds its meshes on a fake process group (``dryrun.fake_world``)
and traces on fake tensors.  Tolerances: exact where both sides compute
the same integers or formula (model FLOPs, ring factors, shapes, accum
counts, the counter's fake vs real counts, probes vs the direct count);
rel 1e-12 for floating formulas evaluated in another order (roofline
terms scaled by the constants' ratios, the byte floor).
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F

from repro_torch import configs as tc
from repro_torch.distributed import sharding as shd
from repro_torch.launch import costing, dryrun
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import specs as sp
from repro_torch.models import transformer as tfm
from repro_torch.roofline import collectives as rc
from repro_torch.roofline import model as rm
from repro_torch.train import checkpoint as ckpt

ROOT = Path(__file__).resolve().parents[1]
MESHES = {"pod1": False, "pod2": True}
CELLS = [(m, a, s) for m in MESHES for a, s in tc.cells()]
RUNNABLE = [(m, a, s) for m, a, s in CELLS
            if tc.shape_runnable(tc.get_config(a), s)[0]]
OPTS = ("base", "sp", "accum2x", "accum4x", "sp_accum2x", "flash",
        "flash+sp", "accum2x+flash")
SIZES = {"pod1": {"data": 16, "model": 16},
         "pod2": {"pod": 2, "data": 16, "model": 16}}
STACKS = ("dense_blocks", "moe_blocks", "mamba_blocks", "enc_blocks",
          "dec_blocks")
# the reference's ICI_BW, PEAK_FLOPS and HBM_BW (roofline/model.py:15-17)
TPU = {"PEAK_FLOPS": 197e12, "HBM_BW": 819e9, "ICI_BW": 50e9}
REL = 1e-12


def _ids(p):
    return "-".join(p)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun_ref")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=512")
    run = subprocess.run([sys.executable, "tests/torch_dryrun_ref.py",
                          str(out)], env=env, cwd=ROOT, capture_output=True,
                         text=True, timeout=600)
    assert run.returncode == 0, run.stderr[-4000:]
    return json.loads((out / "ref.json").read_text())


def _close(a, b, rel=REL):
    return abs(a - b) <= rel * max(abs(a), abs(b))


# ---------------------------------------------------------------------------
# (a) model FLOPs and the roofline


@pytest.mark.parametrize("cell", CELLS, ids=_ids)
def test_model_flops_match_reference(ref, cell):
    m, arch, shape = cell
    got = rm.model_flops(tc.get_config(arch), tc.SHAPES[shape])
    assert got == ref["model_flops"][f"{m}/{arch}/{shape}"]


@pytest.mark.parametrize("i", range(4))
def test_roofline_terms_scale_by_the_constants(ref, i):
    r = ref["roofline"][i]
    got = rm.roofline_terms(**r["in"])
    want = r["out"]
    for k, c in (("t_compute", TPU["PEAK_FLOPS"] / rm.PEAK_FLOPS),
                 ("t_memory", TPU["HBM_BW"] / rm.HBM_BW),
                 ("t_collective", TPU["ICI_BW"] / rm.IB_BW)):
        assert _close(got[k], want[k] * c) or got[k] == want[k] == 0.0, k
    for k in ("total_flops", "total_bytes", "total_collective_bytes"):
        assert got[k] == want[k]
    terms = {k: got[k] for k in ("t_compute", "t_memory", "t_collective")}
    assert got["t_critical"] == max(terms.values())
    assert got["bound"] == max(terms, key=terms.get).replace("t_", "")
    assert set(got) == set(want)


def test_roofline_prices_flops_at_the_compute_dtype():
    """A float32 step's GEMMs (TF32 off) run at the card's float32 peak,
    bf16 / fp16 at the tensor-core peak; bf16 is the default (the
    reference's); a type without a peak raises."""
    kw = dict(flops_per_device=5.8e12, bytes_per_device=1.7e11,
              collective_bytes_per_device=0.0, n_chips=1)
    f32 = rm.roofline_terms(**kw, compute_dtype=torch.float32)
    assert rm.PEAK_FLOPS_FP32 == 67e12 and rm.PEAK_FLOPS == 989e12
    assert f32["t_compute"] == 5.8e12 / 67e12
    assert f32["bound"] == "compute" and f32["t_critical"] == f32["t_compute"]
    for dt in (torch.bfloat16, torch.float16):
        assert rm.roofline_terms(**kw, compute_dtype=dt)["t_compute"] == \
            5.8e12 / 989e12
    assert rm.roofline_terms(**kw) == rm.roofline_terms(
        **kw, compute_dtype=torch.bfloat16)
    assert rm.roofline_terms(**kw)["bound"] == "memory"
    with pytest.raises(ValueError):
        rm.roofline_terms(**kw, compute_dtype=torch.int8)


def test_intra_node_bytes_move_at_nvlink_rate():
    kw = dict(flops_per_device=0.0, bytes_per_device=0.0,
              collective_bytes_per_device=9e9, n_chips=256)
    assert rm.roofline_terms(**kw)["t_collective"] == 9e9 / rm.IB_BW
    got = rm.roofline_terms(**kw, intra_node_bytes_per_device=4e9)
    assert _close(got["t_collective"], 5e9 / rm.IB_BW + 4e9 / rm.NVLINK_BW)
    assert rc.intra_node(range(8)) and not rc.intra_node(range(16))
    assert rc.intra_node([8, 9, 15]) and not rc.intra_node([0, 256])


# ---------------------------------------------------------------------------
# (b) collective bytes


@pytest.mark.parametrize("k", range(15))
def test_collective_bytes_match_reference(ref, k):
    r = ref["collectives"][k]
    moved = rc.moved_bytes(r["op"], r["g"], r["operand_bytes"],
                           r["result_bytes"])
    assert moved == r["stats"]["bytes_per_device"]
    for intra in (False, True):
        rec = rc.Record(r["op"], r["g"], r["operand_bytes"],
                        r["result_bytes"], intra)
        got = rc.collective_bytes([rec, rec])
        want = r["stats"]
        assert got["bytes_per_device"] == 2 * want["bytes_per_device"]
        assert got["by_op_bytes"] == {o: 2 * v for o, v in
                                      want["by_op_bytes"].items()}
        assert got["op_counts"] == {o: 2 * v for o, v in
                                    want["op_counts"].items()}
        assert got["intra_node_bytes"] == (got["bytes_per_device"]
                                           if intra else 0.0)


# ---------------------------------------------------------------------------
# (c) input shapes, accum counts, local pieces


@pytest.mark.parametrize("cell", CELLS, ids=_ids)
def test_input_specs_and_accum_match_reference(ref, cell):
    m, arch, shape = cell
    key = f"{m}/{arch}/{shape}"
    got = sp.input_specs(tc.get_config(arch), tc.SHAPES[shape])
    assert {k: [list(v.shape), str(v.dtype).replace("torch.", "")]
            for k, v in got.items()} == ref["inputs"][key]
    for opt in OPTS:
        assert sp.accum_for_cell(arch, shape, SIZES[m], opt) == \
            ref["accum"][f"{key}/{opt}"], opt
    assert list(tc.shape_runnable(tc.get_config(arch), shape)) == \
        ref["runnable"][key]


def _split(shape, spec, sizes):
    """A global shape divided by a spec's axis sizes."""
    out = []
    for d, n in enumerate(shape):
        e = spec[d] if d < len(spec) else None
        k = 1
        for a in ([] if e is None else [e] if isinstance(e, str) else e):
            k *= sizes[a]
        out.append(n // k)
    return out


def _ref_param_local(tcfg, path, jleaves, sizes):
    """The local shape the reference's layout gives the leaf a port leaf
    stands for (None where the reference parks an axis on its layer
    axis, a layout a per-layer leaf cannot take)."""
    parts = [int(p) if p.isdigit() else p for p in path.split("/")]
    stacked = parts[0] in ("blocks",) + STACKS and tcfg.family != "vit"
    if stacked:
        i = parts[1]
        stack = parts[0]
        if stack == "blocks":
            stack = ("dense_blocks" if i < tfm.n_dense_layers(tcfg)
                     else "moe_blocks")
        parts = [stack] + parts[2:]
    names = [parts[:-1] + [n] for n in (("w_q", "w_k", "w_v")
                                        if parts[-1] == "w_qkv" else
                                        ("b_q", "b_k", "b_v")
                                        if parts[-1] == "b_qkv" else
                                        (parts[-1],))]
    locals_ = []
    for nm in names:
        shape, _, spec = jleaves["/".join(str(p) for p in nm)]
        if stacked:
            if spec and spec[0] is not None:
                return None
            shape, spec = shape[1:], spec[1:]
        locals_.append(_split(shape, spec, sizes))
    if len(locals_) == 1:
        return locals_[0]
    return locals_[0][:-1] + [sum(x[-1] for x in locals_)]


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_local_pieces_match_reference(ref, mesh_name):
    """Rank 0's local params (every arch) and decode state (every serving
    cell): the reference's global shapes divided by its specs."""
    sizes = SIZES[mesh_name]
    parked = checked = 0
    with dryrun.fake_world(512 if MESHES[mesh_name] else 256):
        mesh = dryrun.cell_mesh(MESHES[mesh_name])
        for arch in tc.ASSIGNED:
            cfg = tc.get_config(arch)
            p = sp.params_shape(cfg)
            specs = shd.param_specs(cfg, p, mesh)
            local = ckpt.flatten(shd.shard_tree(mesh, p, specs))
            jleaves = ref["params"][f"{mesh_name}/{arch}"]
            for path, x in local.items():
                want = _ref_param_local(cfg, path, jleaves, sizes)
                if want is None:
                    parked += 1
                    assert list(x.shape) == _split(
                        ckpt.flatten(p)[path].shape,
                        ckpt.flatten(specs)[path], sizes), path
                    continue
                assert list(x.shape) == want, (arch, path)
                checked += 1
        for m, arch, shape in RUNNABLE:
            if m != mesh_name or tc.SHAPES[shape].kind == "train":
                continue
            cell = sp.build_cell(arch, shape, mesh)
            got = ckpt.flatten(cell.args[2])
            want = ref["state"][f"{m}/{arch}/{shape}"]
            assert set(got) == set(want), (arch, shape)
            for path, x in got.items():
                gshape, dtype, spec = want[path]
                assert list(x.shape) == _split(gshape, spec, sizes), path
                assert str(x.dtype).replace("torch.", "") == dtype, path
                checked += 1
    assert checked > 10 * parked


# ---------------------------------------------------------------------------
# (d) stacks, attention sites, byte floors


@pytest.mark.parametrize("arch", list(tc.ARCH_MODULES))
def test_stacks_and_attn_layers_match_reference(ref, arch):
    cfg = tc.get_config(arch)
    base, stacks = costing.stacks_for(cfg)

    def plain(v):
        if dataclasses.is_dataclass(v):
            return json.loads(json.dumps(dataclasses.asdict(v)))
        return list(v) if isinstance(v, tuple) else v
    want = ref["stacks"][arch]
    assert {k: plain(v) for k, v in base.items()} == want["base"]
    assert [{"name": s.name, "n_layers": s.n_layers, "base": s.base,
             "bump": {k: plain(v) for k, v in s.bump.items()}}
            for s in stacks] == want["stacks"]
    assert costing.attn_layer_count(cfg) == ref["attn_layers"][arch]


@pytest.mark.parametrize("cell", RUNNABLE, ids=_ids)
def test_floor_and_attention_kernel_bytes_match_reference(ref, cell):
    m, arch, shape = cell
    key = f"{m}/{arch}/{shape}"
    cfg, spec = tc.get_config(arch), tc.SHAPES[shape]
    accum = sp.accum_for_cell(arch, shape, SIZES[m])
    got = costing.min_traffic_floor(cfg, spec, SIZES[m], accum)
    want = ref["floor"][key]
    assert _close(got["bytes_per_device"], want["bytes_per_device"])
    for k, v in want["parts"].items():
        assert _close(got["parts"][k], v) or got["parts"][k] == v == 0, k
    loc = costing._attn_local_shapes(cfg, spec, SIZES[m], accum)
    if key not in ref["attn"]:
        assert loc is None
        return
    # the reference's device splits heads over model; the port's rank
    # runs every head of the same rows
    want = ref["attn"][key]["local"]
    tp = SIZES[m]["model"]
    assert {**loc, "h": max(loc["h"] // tp, 1),
            "kv": max(loc["kv"] // tp, 1)} == want
    kb = costing.kernel_attn_bytes(want["mode"], want["b"], want["t"],
                                   want["s"], want["h"], want["kv"],
                                   want["dh"], 2)
    assert kb == ref["attn"][key]["kernel"]


@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
def test_attn_site_saving_counts_the_plain_attention(mode):
    """One site at a small shape: the kernel's bytes are the formula's,
    and the plain attention's counted bytes exceed them (it writes the
    (B, H, T, S) logits and probabilities)."""
    t = 1 if mode == "decode" else 256
    site = costing._attn_site_saving(mode, 2, t, 256, 4, 2, 64, 2)
    assert site["kernel"] == costing.kernel_attn_bytes(mode, 2, t, 256, 4,
                                                       2, 64, 2)
    assert site["plain"] > site["kernel"]
    assert site["saved"] == site["plain"] - site["kernel"]


# ---------------------------------------------------------------------------
# (e) the counter at a tiny config


TINY = dict(arch="qwen3-4b", seq=32, batch=8, layers=2, mesh=(2, 2))


def _tiny(layers=TINY["layers"]):
    cfg = tc.get_reduced(TINY["arch"]).replace(n_layers=layers)
    return cfg, tc.ShapeSpec("tiny", TINY["seq"], TINY["batch"], "train")


def _real_cost(cell):
    args = sp.materialize(cell.args, real=True)
    return costing.trace_cost(cell.fn, *args)


def test_build_cell_from_takes_a_float32_train_cell():
    """``build_cell_from(dtype=torch.float32)`` prices the port's float32
    step (phase 28 of the card run holds it to a float32 step): float32
    parameters and moments, the cell's dtype float32; by default bf16
    parameters (a mamba block's ``A_log`` / ``dt_bias`` / ``D`` float32
    aside, none in this config) and float32 moments."""
    cfg, shape = _tiny()
    with dryrun.fake_world(4):
        mesh = mesh_lib.make_local_mesh(*TINY["mesh"], device_type="cpu")
        for dt in (torch.float32, torch.bfloat16):
            kw = {} if dt == torch.bfloat16 else {"dtype": dt}
            cell = sp.build_cell_from(cfg, shape, mesh, accum=1, **kw)
            assert cell.dtype == dt
            params, opt, _ = cell.args
            assert {t.dtype for t in ckpt.flatten(params).values()} == {dt}
            assert {t.dtype for t in opt.m.values()} == {torch.float32}


def test_fake_count_equals_a_real_cpu_run():
    """FLOPs, bytes, every collective record and the memory tally of a
    tiny train step on a (2, 2) mesh: fake tensors vs a real CPU run of
    the same step (the fake group's collectives return at once)."""
    cfg, shape = _tiny()
    with dryrun.fake_world(4):
        mesh = mesh_lib.make_local_mesh(*TINY["mesh"], device_type="cpu")
        cell = sp.build_cell_from(cfg, shape, mesh, accum=2)
        from torch._subclasses.fake_tensor import FakeTensorMode
        with FakeTensorMode():
            args = sp.materialize(cell.args)
            fake_cost, fake_mem, _ = costing.trace_cost(cell.fn, *args)
        real_cost, real_mem, _ = _real_cost(
            sp.build_cell_from(cfg, shape, mesh, accum=2))
    assert fake_cost.flops == real_cost.flops > 0
    assert fake_cost.bytes == real_cost.bytes > 0
    assert fake_cost.coll == real_cost.coll > 0
    assert fake_cost.coll_by_op == real_cost.coll_by_op
    assert fake_cost.op_counts == real_cost.op_counts
    assert fake_cost.regions == real_cost.regions
    assert dataclasses.asdict(fake_mem) == dataclasses.asdict(real_mem)


def test_gemm_flops_equal_the_analytic_count():
    """mm, addmm (``F.linear`` with a bias), bmm and an einsum: the
    counter's FLOPs are sum(2 M N K), on fake and real tensors."""
    def f(x, w, b, p, q):
        y = x @ w                                    # (64, 96) x (96, 48)
        z = F.linear(y, w, b)                        # (64, 48) x (48, 96)
        u = torch.bmm(p, q)                          # 3 x (16, 8) x (8, 24)
        v = torch.einsum("bij,bjk->bik", u, q.transpose(1, 2))
        return y.sum() + z.sum() + v.sum()
    want = (2 * 64 * 48 * 96 + 2 * 64 * 96 * 48 + 3 * 2 * 16 * 24 * 8
            + 3 * 2 * 16 * 8 * 24)
    shapes = ((64, 96), (96, 48), (96,), (3, 16, 8), (3, 8, 24))
    real = costing.trace_cost(f, *(torch.randn(s) for s in shapes))[0]
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        fake = costing.trace_cost(f, *(torch.empty(s) for s in shapes))[0]
    assert real.flops == fake.flops == want


def test_plain_routes_are_tagged_while_a_trace_runs():
    """Each route that takes its plain version counts under its
    ``kernel:<name>`` region (``dispatch.tag_plain_routes``), the
    region's work also in the totals; untagged outside a trace."""
    from repro_torch.kernels import dispatch
    g = torch.Generator().manual_seed(0)

    def r(*s):
        return torch.randn(s, generator=g)
    i8 = torch.randint(-127, 128, (16, 32), generator=g, dtype=torch.int8)
    calls = {
        "flash_attention": lambda: dispatch.flash_attention(
            r(1, 16, 2, 8), r(1, 16, 2, 8), r(1, 16, 2, 8), causal=True),
        "window_attention": lambda: dispatch.window_attention(
            r(1, 16, 2, 8), r(1, 16, 2, 8), r(1, 16, 2, 8), 8),
        "decode_attention": lambda: dispatch.decode_attention(
            r(2, 1, 2, 8), r(2, 16, 2, 8), r(2, 16, 2, 8),
            torch.tensor([5, 16], dtype=torch.int32)),
        "int8_matmul": lambda: dispatch.int8_matmul(
            i8, i8.t().contiguous(), r(16).abs(), r(16).abs()),
        "ssd_scan": lambda: dispatch.ssd_scan(
            r(1, 16, 2, 4), r(1, 16, 2).abs(), -r(2).abs(), r(1, 16, 1, 4),
            r(1, 16, 1, 4), 8),
        "avg_pool": lambda: dispatch.avg_pool(r(1, 4, 4, 3), 2),
        "nn_upsample": lambda: dispatch.nn_upsample(r(1, 2, 2, 3), 2),
    }
    for name, call in calls.items():
        cost, _, _ = costing.trace_cost(call)
        assert set(cost.regions) == {f"kernel:{name}"}, name
        region = cost.regions[f"kernel:{name}"]
        assert 0 < region["bytes"] <= cost.bytes, name
        assert region["flops"] == cost.flops, name
    assert dispatch._PLAIN_TAGS is None
    stack = []
    with dispatch.tag_plain_routes(stack):
        calls["avg_pool"]()
        assert stack == []
    assert dispatch._PLAIN_TAGS is None


@pytest.mark.parametrize("arch,stacks", [
    ("qwen3-4b", {"blocks": 3}), ("whisper-medium", {"enc": 3, "dec": 3})])
def test_probe_extrapolation_equals_the_direct_count(arch, stacks):
    """``probe_costs`` (1- and 2-layer probes at one microbatch) against
    the direct count of a 3-layer step at accum 2: FLOPs equal.  The
    encoder-decoder's two stacks each bump the base probe (the
    reference bumps the full config: its whisper probes keep the other
    stack whole)."""
    cfg = tc.get_reduced(arch).replace(n_layers=3)
    if cfg.encdec is not None:
        cfg = cfg.replace(encdec=dataclasses.replace(cfg.encdec,
                                                     n_encoder_layers=3))
    shape = _tiny()[1]
    with dryrun.fake_world(4):
        mesh = mesh_lib.make_local_mesh(*TINY["mesh"], device_type="cpu")
        direct, _ = costing.cell_cost(sp.build_cell_from(cfg, shape, mesh,
                                                         accum=2))

        def bc(cfg_, shp_, mesh_, opt_, accum_):
            return sp.build_cell_from(cfg_, shp_, mesh_, opt=opt_,
                                      accum=accum_)
        probe = costing.probe_costs(arch, "tiny", mesh, bc, 2, cfg=cfg,
                                    shape=shape)
    assert probe["flops_per_device"] == direct.flops > 0
    assert probe["accum"] == 2 and probe["stacks"] == stacks


# measured band of the port's GEMM FLOPs over the reference's HLO FLOPs
# (every scan unrolled) at the tiny cell, 1.891 at accum 2 and 1.898 at
# accum 1 when measured: the port counts GEMMs alone
# (XLA also counts elementwise FLOPs: norms, softmax, SiLU, AdamW), and
# its rank computes its data shard's rows whole (tensor parallelism by
# gather), where GSPMD splits them over the model axis
FLOP_RATIO_BAND = (1.85, 1.95)


def test_tiny_train_cell_matches_reference_memory_and_flop_band(ref):
    """The tiny cell at bf16 parameters, the reference's: its argument
    bytes equal the reference's; its GEMM FLOPs against XLA's HLO FLOPs
    of the float32 cell (a bf16 module's count adds its converts), in
    the band both packages' float32 steps keep."""
    cfg, shape = _tiny()
    with dryrun.fake_world(4):
        mesh = mesh_lib.make_local_mesh(*TINY["mesh"], device_type="cpu")
        for accum in (1, 2):
            cost, mem = costing.cell_cost(sp.build_cell_from(
                cfg, shape, mesh, accum=accum))
            want = ref["tiny"][f"accum{accum}"]
            # bf16 params + float32 AdamW moments + the rank's batch rows
            # (the port's step holds the global batch; the reference's
            # AdamState adds its int32 step)
            params, moments, _ = mem.by_arg
            assert params + moments + want["batch_local_bytes"] + 4 == \
                want["argument_bytes"]
            cost32, _ = costing.cell_cost(sp.build_cell_from(
                cfg, shape, mesh, accum=accum, dtype=torch.float32))
            assert cost32.flops == cost.flops
            ratio = cost.flops / ref["tiny"][f"accum{accum}_f32"]["flops"]
            assert FLOP_RATIO_BAND[0] < ratio < FLOP_RATIO_BAND[1], ratio


# ---------------------------------------------------------------------------
# (f) run_cell on the production mesh


REC_KEYS = {"arch", "shape", "mesh", "opt", "status", "n_chips", "trace_s",
            "memory", "cost", "collectives", "roofline", "model_flops",
            "useful_flop_ratio"}
MEM_KEYS = {"argument_bytes", "output_bytes", "temp_bytes", "alias_bytes",
            "total_per_device", "total_with_donation"}


def _cut_depth(monkeypatch, layers):
    full = tc.get_config

    def cut(a):
        return full(a).replace(n_layers=layers)
    monkeypatch.setattr(dryrun, "get_config", cut)
    monkeypatch.setattr(sp, "get_config", cut)


@pytest.mark.parametrize("arch,shape,layers", [
    ("qwen3-4b", "decode_32k", None), ("qwen3-4b", "train_4k", 1)])
def test_run_cell_on_the_production_mesh(monkeypatch, arch, shape, layers):
    """A decode cell at full depth and a train cell cut to one layer (its
    widths, shape and 256-rank mesh the production cell's): the direct
    count alone (no probes), its FLOPs priced at the cell's dtype, its
    layout recorded."""
    if layers is not None:
        _cut_depth(monkeypatch, layers)
    rec = dryrun.run_cell(arch, shape, False)
    assert rec["status"] == "ok", rec
    assert REC_KEYS | {"layout", "compute_dtype"} <= set(rec)
    assert "probe_cost" not in rec
    kind = tc.SHAPES[shape].kind
    assert rec["layout"] == sp.LAYOUTS[kind]
    # every cell holds bf16 parameters, train cells too (the reference's)
    assert rec["compute_dtype"] == "bfloat16"
    assert rec["roofline"]["t_compute"] == \
        rec["cost"]["flops_per_device"] / rm.peak_flops(torch.bfloat16)
    assert ("serving layout" in rec["cost"]["source"]) == (kind != "train")
    assert MEM_KEYS <= set(rec["memory"])
    assert rec["n_chips"] == 256 and rec["mesh"] == "pod1"
    assert "source" in rec["cost"]
    assert {"bytes_per_device", "by_op_bytes", "op_counts",
            "intra_node_bytes"} <= set(rec["collectives"])
    assert rec["collectives"]["bytes_per_device"] > 0
    r = rec["roofline"]
    assert r["t_compute"] > 0 and r["t_memory"] > 0
    kernel = "decode_attention" if shape == "decode_32k" else \
        "flash_attention"
    assert rec["cost"]["kernel_regions"][f"kernel:{kernel}"]["flops"] > 0


def test_run_cell_flash_counts_a_train_cell_at_bf16(monkeypatch):
    """``--opt flash`` on a train cell (one layer of qwen3-4b train_4k on
    pod1), bf16 as the reference's: the kernel's bytes, the plain site
    and the byte floor at 2 bytes an element (a float32 cell's floor
    streams twice the parameter bytes)."""
    _cut_depth(monkeypatch, 1)
    rec = dryrun.run_cell("qwen3-4b", "train_4k", False, "flash")
    assert rec["status"] == "ok", rec
    cfg, spec = sp.get_config("qwen3-4b"), tc.SHAPES["train_4k"]
    accum = sp.accum_for_cell("qwen3-4b", "train_4k", SIZES["pod1"])
    (seg,) = rec["flash_correction"]["segments"]
    loc = rec["flash_correction"]["local_shapes"]
    assert seg["kernel"] == costing.kernel_attn_bytes(
        "train", loc["b"], seg["t"], seg["s"], loc["h"], loc["kv"],
        loc["dh"], 2)
    assert seg["plain"] == costing._attn_site_saving(
        "train", loc["b"], seg["t"], seg["s"], loc["h"], loc["kv"],
        loc["dh"], 2)["plain"]
    floor = costing.min_traffic_floor(cfg, spec, SIZES["pod1"], accum)
    assert rec["byte_floor"] == floor
    assert 2 * floor["parts"]["params"] == costing.min_traffic_floor(
        cfg, spec, SIZES["pod1"], accum, dtype_bytes=4)["parts"]["params"]
    assert rec["cost"]["bytes_per_device"] == max(
        rec["cost"]["direct_bytes"]
        - rec["flash_correction"]["bytes_saved_per_device"],
        floor["bytes_per_device"])


def test_run_cell_skips_long_context_full_attention():
    rec = dryrun.run_cell("qwen3-4b", "long_500k", False)
    ok, reason = tc.shape_runnable(tc.get_config("qwen3-4b"), "long_500k")
    assert not ok
    assert rec["status"] == "skipped" and rec["reason"] == reason


def test_fake_world_refuses_a_second_group():
    with dryrun.fake_world(4):
        with pytest.raises(RuntimeError):
            with dryrun.fake_world(4):
                pass
    assert not torch.distributed.is_initialized()
