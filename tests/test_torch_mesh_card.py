"""The mesh code on the card at world size 1, the checks of
``chip_smoke.py`` phase 27 at reduced widths (skipped where there is no
card):

    PYTHONPATH=src python3 -m pytest -q -m cuda tests/test_torch_mesh_card.py

An NCCL process group of one rank in the test process (a free local
port), the (1, 1) mesh: two sharded train steps bit-equal to two
mesh-free ones (reduced qwen3-4b, 4 layers, remat; every collective over
one rank is the identity and the gathers return the leaves themselves),
reduced dbrx-132b's MoE layer in bf16 through ``moe_sharded`` bit-equal
to ``moe_local`` (outputs, aux, gradients), ``compressed_psum`` bit-equal
to ``quantize_roundtrip``, a 1-stage GPipe forward against the sequential
stack (2e-5), and ``elastic_restart`` from a sharded checkpoint, every
leaf bit-equal.
"""
import socket

import pytest
import torch

from repro_torch.configs import get_reduced
from repro_torch.distributed import pipeline as pl
from repro_torch.distributed import sharding as shd
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import train as lt
from repro_torch.models import moe
from repro_torch.optim import adam
from repro_torch.optim import grad_compression as gc
from repro_torch.quant import qtensor as qt
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import elastic
from repro_torch.train import trainer as tr


@pytest.fixture(scope="module")
def mesh():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (chip_smoke.py phase 27 runs the "
                    "mesh at world size 1 on the H100)")
    import torch.distributed as dist
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            rank=0, world_size=1)
    try:
        yield mesh_lib.make_local_mesh(1, 1)
    finally:
        dist.destroy_process_group()


def _equal(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        assert torch.equal(got[k], w), k


def _steps(cfg, mesh, params, batches):
    if mesh is None:
        opt = adam.init_adam(ckpt.flatten(params))
    else:
        params, opt = tr.shard_train_state(cfg, mesh, params)
    step = tr.make_train_step(cfg, tr.TrainConfig(remat=True), mesh)
    losses = []
    for b in batches:
        params, opt, m = step(params, opt, b)
        losses.append(float(m["loss"]))
    return params, opt, losses


@pytest.mark.cuda
def test_mesh_steps_and_restart_bit_equal_on_card(mesh, tmp_path):
    cfg = get_reduced("qwen3-4b").replace(n_layers=4)
    dev = torch.device("cuda", 0)
    data = lt.synthetic_batches(cfg, 2, 64, seed=0)
    batches = [{k: torch.as_tensor(v, device=dev) for k, v in
                next(data).items()} for _ in range(2)]
    params = tr.init_train_state(
        cfg, torch.Generator(device=dev).manual_seed(0), dev)[0]
    copy = ckpt.unflatten({k: v.clone() for k, v in
                           ckpt.flatten(params).items()}, params)
    pf, of, lf = _steps(cfg, None, params, batches)
    pm, om, lm = _steps(cfg, mesh, copy, batches)
    assert lm == lf
    _equal(ckpt.flatten(pm), ckpt.flatten(pf))
    _equal(om.m, of.m)
    _equal(om.v, of.v)
    named = shd.to_named(mesh, tr.train_shardings(cfg, mesh,
                                                  tr.shape_tree(cfg))[:2])
    ckpt.save((pm, om), str(tmp_path), 2, named)
    like = (ckpt.unflatten({k: torch.empty(0, device=dev) for k in
                            ckpt.flatten(pm)}, pm),
            adam.AdamState(0, dict(om.m), dict(om.v)))
    m2, (p2, o2) = elastic.elastic_restart(
        cfg, str(tmp_path), [0], 1, lambda: like,
        lambda m: shd.to_named(m, tr.train_shardings(
            cfg, m, tr.shape_tree(cfg))[:2]))
    assert shd.mesh_shape(m2) == {"data": 1, "model": 1} and o2.step == 2
    _equal(ckpt.flatten(p2), ckpt.flatten(pm))
    _equal(o2.m, om.m)
    _equal(o2.v, om.v)


@pytest.mark.cuda
def test_moe_sharded_bit_equal_to_moe_local_on_card(mesh):
    cfg = get_reduced("dbrx-132b")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    p = qt.cast_tree(moe.init_moe(cfg, gen, dev), torch.bfloat16)
    x = torch.randn((4, 32, cfg.d_model), generator=gen,
                    device=dev).to(torch.bfloat16)
    w = torch.randn((4, 32, cfg.d_model), generator=gen, device=dev)
    res = []
    for sharded in (False, True):
        leaves = {k: v.detach().clone().requires_grad_(True)
                  for k, v in ckpt.flatten(p).items()}
        xs = x.clone().requires_grad_(True)
        tree = ckpt.unflatten(leaves, p)
        o, aux = (moe.moe_sharded(cfg, tree, xs, mesh) if sharded
                  else moe.moe_local(cfg, tree, xs))
        (torch.sum(o.float() * w) + aux).backward()
        res.append((o, aux, {**{k: v.grad for k, v in leaves.items()},
                             "x": xs.grad}))
    assert torch.equal(res[0][0], res[1][0])
    assert torch.equal(res[0][1], res[1][1])
    _equal(res[1][2], res[0][2])


@pytest.mark.cuda
def test_compressed_psum_and_pipeline_on_card(mesh):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn((4096, 33), generator=gen, device=dev)
    err = torch.randn((4096, 33), generator=gen, device=dev) * 1e-3
    mean, e1 = gc.compressed_psum(x, dist.group.WORLD, err)
    deq, e2 = gc.quantize_roundtrip(x, err)
    assert torch.equal(mean, deq) and torch.equal(e1, e2)
    params = {"w": torch.randn((4, 64, 64), generator=gen, device=dev) / 8,
              "b": torch.randn((4, 64), generator=gen, device=dev) * 0.01}
    h = torch.randn((8, 4, 64), generator=gen, device=dev)

    def layer(p, a):
        return torch.tanh(a @ p["w"] + p["b"])

    stage = init_device_mesh("cuda", (1,), mesh_dim_names=("stage",))
    y = pl.pipeline_forward(stage, layer, params, h, 4)
    want = h
    for i in range(4):
        want = layer({k: v[i] for k, v in params.items()}, want)
    torch.testing.assert_close(y, want, rtol=2e-5, atol=2e-5)
