"""Port parity for LM training: ``registry.lm_loss`` and its gradients,
``train.trainer.make_train_step``, the in-place AdamW, the synthetic
token stream, int8 gradient compression, the straggler / elastic
helpers, parameter counts, ``(params, AdamState)`` checkpoints and
``launch.train`` as a subprocess, each against the JAX package on the
same seeded inputs and parameters (the reference's ``init_params`` tree,
converted by ``convert.{lm,ssm,hybrid}_params_from_jax``; the
reference's gradient trees go through the same converters, so gradients
compare leaf for leaf).

Models are the reduced qwen3-4b and mamba2-370m, a 6-layer reduced
zamba2-1.2b (its shared block runs at layer 5), reduced whisper-medium
(2 + 2 layers over 64 stub frames), llava-next-mistral-7b (16 stub image
embeddings ahead of the text; the loss scores the text tail), dbrx-132b
(2 MoE layers) and deepseek-v2-236b (MLA, a dense layer, then a MoE
layer with shared experts; the loss carries the MoE aux), with norm
scales, biases, ``D`` and ``dt_bias`` moved off their init values.  Tolerances: losses
1e-5 relative, every gradient leaf 1e-4 of its largest; three train
steps' losses 1e-4 relative and parameters 1e-4 of each leaf's largest;
AdamW 1e-6 relative; AdamW on fp16 / bf16 / mixed trees one ULP of the
half type and >= 99.9% bit-equal (``test_torch_half_train.py`` holds
the half train steps).
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro import configs as jconfigs
from repro.launch import train as jlaunch
from repro.models import registry as jreg
from repro.models.transformer import ParallelCtx
from repro.optim import adam as jadam
from repro.optim import grad_compression as jgc
from repro.train import checkpoint as jckpt
from repro.train import elastic as jelastic
from repro.train import straggler as jstrag
from repro.train import trainer as jtr
from repro_torch import convert
from repro_torch.configs import get_reduced
from repro_torch.kernels import dispatch
from repro_torch.kernels.flash_attention import ops as tflash
from repro_torch.launch import train as tlaunch
from repro_torch.models import config as tmc
from repro_torch.models import mamba2 as tm2
from repro_torch.models import registry
from repro_torch.optim import adam
from repro_torch.optim import grad_compression as tgc
from repro_torch.train import checkpoint as tckpt
from repro_torch.train import elastic as telastic
from repro_torch.train import straggler as tstrag
from repro_torch.train import trainer as ttr

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4          # of each leaf's largest
STEP_TOL = 1e-4
ADAM_RTOL = 1e-6
ARCHS = ("qwen3-4b", "mamba2-370m", "zamba2-1.2b")
# the loss and gradient checks also run the encoder-decoder and the VLM
LOSS_ARCHS = ARCHS + ("whisper-medium", "llava-next-mistral-7b")
LAYERS = {"qwen3-4b": 2, "mamba2-370m": 2, "zamba2-1.2b": 6,
          "whisper-medium": 2, "llava-next-mistral-7b": 2, "dbrx-132b": 2,
          "deepseek-v2-236b": 2}
CONVERT = {"dense": convert.lm_params_from_jax,
           "ssm": convert.ssm_params_from_jax,
           "hybrid": convert.hybrid_params_from_jax,
           "encdec": convert.whisper_params_from_jax,
           "vlm": convert.lm_params_from_jax,
           "moe": convert.lm_params_from_jax}
# whisper's cross-attention LayerNorm and the biases of its attention and
# MLP, and the VLM projector's
BIASES = ("ln_x", "b_q", "b_k", "b_v", "b_o", "b_up", "b_down", "b1", "b2")


def _t(a):
    return torch.from_numpy(np.array(a))


def _perturb(tree, rng):
    """Norm scales, biases, ``D`` and ``dt_bias`` off their init values,
    so that a misplaced term shows."""
    def walk(t, path=()):
        if isinstance(t, dict):
            return {k: walk(v, path + (k,)) for k, v in t.items()}
        if any("norm" in k or k in ("ln", "ln1", "ln2", "conv_b", "D",
                                    "dt_bias") + BIASES for k in path):
            return (t + 0.1 * rng.standard_normal(t.shape)).astype(t.dtype)
        return t
    return walk(tree)


def _model(arch):
    n = LAYERS[arch]
    jcfg = jconfigs.get_reduced(arch).replace(n_layers=n)
    tcfg = get_reduced(arch).replace(n_layers=n)
    tree = _perturb(jax.tree_util.tree_map(
        np.asarray, jreg.init_params(jcfg, jax.random.PRNGKey(0))),
        np.random.default_rng(1))
    return jcfg, tcfg, tree


@pytest.fixture(scope="module", params=LOSS_ARCHS)
def model(request):
    return _model(request.param)


def _port_tree(tcfg, tree):
    """The reference's (parameter or gradient) tree -> the port's flat
    view."""
    return tckpt.flatten(CONVERT[tcfg.family](tree, tcfg, "cpu"))


def _batch(cfg, B, T, seed, mask=True):
    """Tokens (B, T), a loss mask, and the family's stub inputs: encoder
    frames or image embeddings, standard normals."""
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)}
    if mask:
        b["loss_mask"] = (rng.random((B, T)) < 0.7).astype(np.float32)
    if cfg.encdec is not None:
        b["frames"] = rng.standard_normal(
            (B, cfg.encdec.encoder_seq_len, cfg.d_model)).astype(np.float32)
    if cfg.vlm is not None:
        b["image_embeds"] = rng.standard_normal(
            (B, cfg.vlm.n_image_tokens, cfg.vlm.vision_hidden)
        ).astype(np.float32)
    return b


def _port_value_and_grad(tcfg, tree, batch, remat):
    params = CONVERT[tcfg.family](tree, tcfg, "cpu")
    flat = tckpt.flatten(params)
    for p in flat.values():
        p.requires_grad_(True)
    loss, metrics = registry.lm_loss(
        tcfg, params, {k: _t(v) for k, v in batch.items()}, remat)
    loss.backward()
    return loss, metrics, {k: p.grad for k, p in flat.items()}


def _ref_value_and_grad(jcfg, tree, batch, remat):
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    ctx = ParallelCtx(remat=remat)
    (loss, metrics), g = jax.jit(jax.value_and_grad(
        lambda p: jreg.lm_loss(jcfg, p, jb, ctx), has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, tree))
    return loss, metrics, jax.tree_util.tree_map(np.asarray, g)


def _close_leaves(got, want, tol):
    assert set(got) == set(want)
    for name, w in want.items():
        w = w.numpy()
        err = float(np.abs(got[name].detach().numpy() - w).max())
        assert err <= tol * max(float(np.abs(w).max()), 1e-12), (name, err)


# ---------------------------------------------------------------------------
# the loss and its gradients


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_lm_loss_and_gradients_match_reference(model, remat):
    jcfg, tcfg, tree = model
    batch = _batch(tcfg, 2, 48, seed=3)
    loss, metrics, grads = _port_value_and_grad(tcfg, tree, batch, remat)
    jloss, jmetrics, jgrads = _ref_value_and_grad(jcfg, tree, batch, remat)
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(metrics["ce"]), float(jmetrics["ce"]),
                               rtol=LOSS_RTOL)
    assert float(metrics["aux"]) == float(jmetrics["aux"]) == 0.0
    _close_leaves(grads, _port_tree(tcfg, jgrads), GRAD_TOL)


def test_lm_loss_chunked_ce_with_labels(monkeypatch):
    """T = 256 over 128-token CE chunks (``CE_CHUNK_ELEMS`` lowered in
    both packages, as a 151936-token vocabulary chunks T = 512), with
    explicit labels and a loss mask."""
    monkeypatch.setattr(registry, "CE_CHUNK_ELEMS", 128 * 256)
    monkeypatch.setattr(jreg, "CE_CHUNK_ELEMS", 128 * 256)
    jcfg, tcfg, tree = _model("qwen3-4b")
    batch = _batch(tcfg, 2, 256, seed=4)
    batch["labels"] = np.random.default_rng(5).integers(
        0, tcfg.vocab_size, (2, 256)).astype(np.int32)
    loss, _, grads = _port_value_and_grad(tcfg, tree, batch, True)
    jloss, _, jgrads = _ref_value_and_grad(jcfg, tree, batch, True)
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               rtol=LOSS_RTOL)
    _close_leaves(grads, _port_tree(tcfg, jgrads), GRAD_TOL)


@pytest.mark.parametrize("T", [512, 384, 100])
def test_ce_nll_chunks_by_the_reference_rule(monkeypatch, T):
    """At a 256-token chunk: T = 512 two chunks, 384 halves to 128-token
    chunks, 100 stays dense."""
    monkeypatch.setattr(registry, "CE_CHUNK_ELEMS", 256 * 64)
    monkeypatch.setattr(jreg, "CE_CHUNK_ELEMS", 256 * 64)
    rng = np.random.default_rng(T)
    logits = (3 * rng.standard_normal((2, T, 64))).astype(np.float32)
    targets = rng.integers(0, 64, (2, T)).astype(np.int32)
    got = registry._ce_nll(_t(logits), _t(targets))
    want = jreg._ce_nll(jnp.asarray(logits), jnp.asarray(targets))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-5)


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_remat_runs_each_layer_forward_again(monkeypatch, remat):
    """Under remat each dense layer's attention forward (the flash
    Function's) runs twice in a step, once without."""
    calls = []
    plain = tflash.flash_attention_plain
    monkeypatch.setattr(tflash, "flash_attention_plain",
                        lambda *a: calls.append(1) or plain(*a))
    jcfg, tcfg, tree = _model("qwen3-4b")
    _port_value_and_grad(tcfg, tree, _batch(tcfg, 1, 16, 6), remat)
    assert len(calls) == tcfg.n_layers * (2 if remat else 1)


def test_ssm_training_route_never_reaches_ssd_scan(monkeypatch):
    """The SSM loss trains through ``mamba2.ssd_chunked``; the
    ``ssd_scan`` route still refuses a gradient."""
    jcfg, tcfg, tree = _model("mamba2-370m")
    params = convert.ssm_params_from_jax(tree, tcfg, "cpu")
    x = torch.randn(1, 16, tcfg.d_model, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        tm2.mamba2_forward(tcfg, params["mamba_blocks"][0]["mamba"], x)

    def refuse(*a, **k):
        raise AssertionError("ssd_scan reached on the training route")
    monkeypatch.setattr(dispatch, "ssd_scan", refuse)
    loss, _, grads = _port_value_and_grad(tcfg, tree, _batch(tcfg, 1, 16, 7),
                                          False)
    assert torch.isfinite(loss) and all(g is not None for g in grads.values())


def test_whisper_remat_runs_encoder_and_decoder_forwards_again(
        monkeypatch):
    """Under remat the reference checkpoints the scan bodies of both
    ``encode`` and ``decode_train``: every attention forward (the
    encoder's, the decoder's causal self-attention and its
    cross-attention) runs twice a step, once without."""
    calls = []
    plain = tflash.flash_attention_plain
    monkeypatch.setattr(tflash, "flash_attention_plain",
                        lambda *a: calls.append(1) or plain(*a))
    jcfg, tcfg, tree = _model("whisper-medium")
    batch = _batch(tcfg, 1, 16, 8)
    per_forward = tcfg.encdec.n_encoder_layers + 2 * tcfg.n_layers
    for remat in (False, True):
        calls.clear()
        _port_value_and_grad(tcfg, tree, batch, remat)
        assert len(calls) == per_forward * (2 if remat else 1)


# ---------------------------------------------------------------------------
# the train step


def _train_config(accum):
    """Warmup of one step (lr 0 at step 0, as in the reference), then
    peak_lr 1e-3.  AdamW's step m / sqrt(v) drops the gradient's scale,
    so an entry whose gradient is ~1e-4 of its leaf's largest carries its
    float32 relative error (1-2% there, against 1e-4 of the largest
    gradient) into the parameter at the full step size lr: the parameter
    check's error scales with lr (zamba2's tied embedding: 1.3e-4 of its
    largest at lr 1e-2, 8e-5 at 3e-3)."""
    return dict(accum_steps=accum, remat=True, peak_lr=1e-3, warmup_steps=1,
                total_steps=6, weight_decay=0.1, grad_clip=1.0)


@pytest.mark.parametrize("arch,accum", [("qwen3-4b", 1), ("qwen3-4b", 2),
                                        ("mamba2-370m", 2),
                                        ("zamba2-1.2b", 1),
                                        ("whisper-medium", 1),
                                        ("llava-next-mistral-7b", 2),
                                        ("dbrx-132b", 1),
                                        ("deepseek-v2-236b", 2)])
def test_train_steps_match_reference(arch, accum):
    jcfg, tcfg, tree = _model(arch)
    batches = [_batch(tcfg, 4, 32, seed=10 + s, mask=False)
               for s in range(3)]
    for b in batches:
        b["labels"] = np.roll(b["tokens"], -1, axis=1)
    jstep = jax.jit(jtr.make_train_step(
        jcfg, None, jtr.TrainConfig(**_train_config(accum))))
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    jo = jadam.init_adam(jp)
    want = []
    for b in batches:
        jp, jo, m = jstep(jp, jo, {k: jnp.asarray(v) for k, v in b.items()})
        want.append(float(m["loss"]))

    params = CONVERT[tcfg.family](tree, tcfg, "cpu")
    opt = adam.init_adam(tckpt.flatten(params))
    step = ttr.make_train_step(tcfg, ttr.TrainConfig(**_train_config(accum)))
    got, lrs = [], []
    for b in batches:
        params, opt, m = step(params, opt, {k: _t(v) for k, v in b.items()})
        got.append(float(m["loss"]))
        lrs.append(float(m["lr"]))
        assert set(m) == set(jtr_metric_keys(accum))
    assert opt.step == 3 and int(jo.step) == 3
    np.testing.assert_allclose(got, want, rtol=STEP_TOL)
    flat = tckpt.flatten(params)
    # plain tensors again, as the reference's arrays: the serving routes
    # without a backward take them outside no_grad
    assert all(p.grad is None and not p.requires_grad for p in flat.values())
    ref = _port_tree(tcfg, jax.tree_util.tree_map(np.asarray, jp))
    if tcfg.attention_bias:
        _split_key_bias(tcfg, flat, ref, lrs)
    _close_leaves(flat, ref, STEP_TOL)


def _split_key_bias(tcfg, got, want, lrs):
    """Move the key columns of every fused ``b_qkv`` out of ``got`` and
    ``want`` and hold them apart.  Their exact gradient is zero (adding
    q . b_k to every key's logit leaves the softmax as it is), so each
    package's gradient there is rounding noise, which AdamW's step m /
    sqrt(v) scales up to a full step: the two may part by both packages'
    largest moves, lr (1 + weight_decay |p|) a step each (|m / sqrt(v)|
    <= 1 for these three steps at b1 = 0.9, b2 = 0.95)."""
    q, kv = tcfg.q_dim, tcfg.kv_dim
    for name in [k for k in want if k.endswith("b_qkv")]:
        g, w = got[name].detach(), want[name]
        keep = torch.cat([torch.arange(q), torch.arange(q + kv, q + 2 * kv)])
        move = sum(lrs) * (1 + _train_config(1)["weight_decay"]
                           * float(w.abs().max()))
        err = float((g[q:q + kv] - w[q:q + kv]).abs().max())
        assert err <= 2 * move, (name, err, move)
        got[name], want[name] = g[keep], w[keep]


@pytest.mark.parametrize("flag", ["sp", "compress_pod_grads"])
def test_make_train_step_refuses_mesh_options(flag):
    """Sequence parallelism and cross-pod compression need a mesh, which
    the port's trainer does not have: refused, not ignored."""
    cfg = get_reduced("qwen3-4b")
    with pytest.raises(ValueError, match=f"TrainConfig.{flag}"):
        ttr.make_train_step(cfg, ttr.TrainConfig(**{flag: True}))


def jtr_metric_keys(accum):
    """The reference's metrics: its ce and aux only without accumulation."""
    return ("loss", "lr", "grad_norm") + (("ce", "aux") if accum == 1
                                          else ())


# ---------------------------------------------------------------------------
# AdamW


def _functional_adam(grads, state, params, *, lr, b1=0.9, b2=0.95, eps=1e-8,
                     weight_decay=0.0, grad_clip=1.0):
    """The port's former functional AdamW, kept as an oracle."""
    step = state.step + 1
    gnorm = torch.sqrt(sum(torch.sum(torch.square(t)) for t in
                           grads.values()))
    scale = (torch.clamp(grad_clip / (gnorm + 1e-12), max=1.0)
             if grad_clip is not None else torch.ones_like(gnorm))
    ok = torch.isfinite(gnorm)
    scale = torch.where(ok, scale, torch.zeros_like(scale))
    bc1, bc2 = 1.0 - b1 ** step, 1.0 - b2 ** step
    new_m, new_v, new_p = {}, {}, {}
    for k, p in params.items():
        g = torch.where(ok, grads[k], torch.zeros_like(grads[k])) * scale
        m = b1 * state.m[k] + (1 - b1) * g
        v = b2 * state.v[k] + (1 - b2) * torch.square(g)
        delta = (m / bc1) / (torch.sqrt(v / bc2) + eps)
        if weight_decay:
            delta = delta + weight_decay * p
        new_m[k], new_v[k], new_p[k] = m, v, p - lr * delta
    return new_p, adam.AdamState(step, new_m, new_v), gnorm


ADAM_CASES = {"clipped": dict(gscale=10.0, grad_clip=1.0),
              "unclipped": dict(gscale=1e-3, grad_clip=None),
              "non_finite": dict(gscale=1.0, grad_clip=1.0, nan_step=1),
              "weight_decay": dict(gscale=1.0, grad_clip=1.0,
                                   weight_decay=0.1)}


def _adam_tree(rng):
    shapes = {"a": (7, 5), "b/0": (33,), "b/1": (4, 4, 3), "c": (1,)}
    return {k: rng.standard_normal(s).astype(np.float32)
            for k, s in shapes.items()}


@pytest.mark.parametrize("case", list(ADAM_CASES))
def test_adam_update_in_place_matches_reference(case):
    """Three steps, each against the reference's functional update and
    the port's former functional form (bit-equal); a non-finite step
    leaves the moments decayed by zero gradients (the reference's
    skip)."""
    c = dict(ADAM_CASES[case])
    rng = np.random.default_rng(0)
    p0 = _adam_tree(rng)
    params = {k: _t(v) for k, v in p0.items()}
    state = adam.init_adam(params)
    oracle_p, oracle_s = dict(params), adam.init_adam(params)
    oracle_p = {k: v.clone() for k, v in oracle_p.items()}
    jp, js = {k: jnp.asarray(v) for k, v in p0.items()}, None
    js = jadam.init_adam(jp)
    kw = dict(lr=3e-2, weight_decay=c.get("weight_decay", 0.0),
              grad_clip=c["grad_clip"])
    for s in range(3):
        g = {k: (c["gscale"] * rng.standard_normal(v.shape)).astype(
            np.float32) for k, v in p0.items()}
        if c.get("nan_step") == s:
            g["b/1"][1, 2, 0] = np.nan
        tg = {k: _t(v) for k, v in g.items()}
        before = {k: v.clone() for k, v in tg.items()}
        live = {k: v for k, v in params.items()}
        params, state, m = adam.adam_update(tg, state, params, **kw)
        assert all(params[k] is live[k] for k in live)     # in place
        assert all(torch.equal(tg[k].nan_to_num(), before[k].nan_to_num())
                   for k in tg)                            # grads kept
        jp, js, jm = jadam.adam_update({k: jnp.asarray(v) for k, v in
                                        g.items()}, js, jp, **kw)
        oracle_p, oracle_s, _ = _functional_adam(tg, oracle_s, oracle_p,
                                                 **kw)
        assert state.step == int(js.step) == s + 1
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=ADAM_RTOL)
        # the former form, bit for bit (each product rounded alone)
        for got, want in ((params, oracle_p), (state.m, oracle_s.m),
                          (state.v, oracle_s.v)):
            assert all(torch.equal(got[k], want[k]) for k in want)
        # the reference, relative to each tree's largest value: a
        # parameter the step takes near 0 keeps the rounding of its O(1)
        # operands
        for got, want in ((params, jp), (state.m, js.m), (state.v, js.v)):
            want = {k: np.asarray(w) for k, w in want.items()}
            top = max(float(np.abs(w).max()) for w in want.values())
            for k, w in want.items():
                np.testing.assert_allclose(got[k].numpy(), w, rtol=ADAM_RTOL,
                                           atol=ADAM_RTOL * top)
    if "nan_step" in c:
        assert all(torch.isfinite(v).all() for v in params.values())


# the half trees: every leaf bf16 or fp16, or a bf16 tree whose "b/0"
# and "c" leaves are float32 (as a mamba block's A_log / dt_bias / D)
HALF_TREES = {"bf16": {}, "fp16": {}, "mixed": {"b/0", "c"}}
HALF_SHARE = 0.999       # parameters bit-equal to the reference's


def _half_ulp(x: torch.Tensor) -> torch.Tensor:
    p, tiny = {torch.float16: (11, 2.0 ** -24),
               torch.bfloat16: (8, 2.0 ** -133)}[x.dtype]
    _, e = torch.frexp(x.float().abs())
    return torch.clamp(torch.ldexp(torch.ones_like(e, dtype=torch.float32),
                                   e - p), min=tiny)


def _to_jnp(t: torch.Tensor):
    """A copy (the port's update writes its tensors in place, and
    ``jnp.asarray`` may alias a numpy view of them)."""
    if t.dtype == torch.bfloat16:
        return jnp.array(t.float().numpy()).astype(jnp.bfloat16)
    return jnp.array(t.numpy(), copy=True)


@pytest.mark.parametrize("tree", list(HALF_TREES))
@pytest.mark.parametrize("case", list(ADAM_CASES))
def test_adam_update_in_place_at_half_matches_reference(case, tree):
    """The cases above on fp16 / bf16 parameters (gradients in each
    parameter's type, as a step at accum 1 gives them) and on a bf16 tree
    with float32 leaves: three in-place steps against the reference's
    update.  Half parameters bit-equal at >= 99.9% and within one ULP of
    their type everywhere (each update rounds once from float32, in both
    packages); float32 leaves and the float32 moments to ADAM_RTOL."""
    c = dict(ADAM_CASES[case])
    dt = torch.float16 if tree == "fp16" else torch.bfloat16
    rng = np.random.default_rng(0)
    p0 = _adam_tree(rng)
    params = {k: _t(v).to(torch.float32 if k in HALF_TREES[tree] else dt)
              for k, v in p0.items()}
    state = adam.init_adam(params)
    jp = {k: _to_jnp(v) for k, v in params.items()}
    js = jadam.init_adam(jp)
    kw = dict(lr=3e-2, weight_decay=c.get("weight_decay", 0.0),
              grad_clip=c["grad_clip"])
    n_eq = n = 0
    for s in range(3):
        g = {k: (c["gscale"] * rng.standard_normal(v.shape)).astype(
            np.float32) for k, v in p0.items()}
        if c.get("nan_step") == s:
            g["b/1"][1, 2, 0] = np.nan
        tg = {k: _t(v).to(params[k].dtype) for k, v in g.items()}
        live = dict(params)
        params, state, m = adam.adam_update(tg, state, params, **kw)
        assert all(params[k] is live[k] for k in live)     # in place
        jp, js, jm = jadam.adam_update({k: _to_jnp(v) for k, v in
                                        tg.items()}, js, jp, **kw)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=ADAM_RTOL)
        for k, w in jp.items():
            got = params[k]
            w = torch.from_numpy(np.asarray(w).astype(np.float32)).to(
                got.dtype)
            if got.dtype == torch.float32:
                np.testing.assert_allclose(got.numpy(), w.numpy(),
                                           rtol=ADAM_RTOL, atol=ADAM_RTOL)
                continue
            d = (got.float() - w.float()).abs()
            assert bool((d <= _half_ulp(w)).all()), (k, s)
            n_eq += int((got == w).sum())
            n += w.numel()
        for got, want in ((state.m, js.m), (state.v, js.v)):
            want = {k: np.asarray(w) for k, w in want.items()}
            top = max(float(np.abs(w).max()) for w in want.values())
            for k, w in want.items():
                assert got[k].dtype == torch.float32
                np.testing.assert_allclose(got[k].numpy(), w, rtol=ADAM_RTOL,
                                           atol=ADAM_RTOL * top)
    assert n_eq >= HALF_SHARE * n, n_eq / n
    if "nan_step" in c:
        assert all(torch.isfinite(v).all() for v in params.values())


class _Allocations(TorchDispatchMode):
    """The bytes of new tensors each op returns (in-place ops return
    their own inputs and count nothing)."""

    def __init__(self):
        super().__init__()
        self.per_op = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        ins = {id(t) for t in tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)}
        outs = [t for t in tree_leaves(out)
                if isinstance(t, torch.Tensor) and id(t) not in ins]
        self.per_op.append((str(func), sum(t.numel() * t.element_size()
                                           for t in outs)))
        return out


def test_adam_groups_bound_their_temporaries(monkeypatch):
    """With a 4 KB budget no op of the update allocates more than the
    budget, except for the one leaf larger than it (its own group), and
    the result equals a one-group update bit for bit."""
    rng = np.random.default_rng(1)
    shapes = [(100,), (300,), (2000,), (50, 7), (900,), (3,)]
    base = {f"l{i}": _t(rng.standard_normal(s).astype(np.float32))
            for i, s in enumerate(shapes)}
    grads = {k: _t(rng.standard_normal(tuple(v.shape)).astype(np.float32))
             for k, v in base.items()}
    budget = 4096
    monkeypatch.setattr(adam, "GROUP_BYTES", budget)
    groups = list(adam.groups(base))
    assert [k for g in groups for k in g] == list(base)
    for g in groups:
        assert len(g) == 1 or 4 * sum(base[k].numel() for k in g) <= budget
    assert ["l2"] in groups                         # 8000 bytes alone
    small = {k: v.clone() for k, v in base.items()}
    st = adam.init_adam(small)
    with _Allocations() as rec:
        adam.adam_update(grads, st, small, lr=1e-2, weight_decay=0.1)
    biggest = 4 * max(v.numel() for v in base.values())
    assert max(n for _, n in rec.per_op) <= biggest
    over = [(f, n) for f, n in rec.per_op if n > budget]
    assert over and all(n <= biggest for _, n in over)
    monkeypatch.setattr(adam, "GROUP_BYTES", 1 << 30)
    big = {k: v.clone() for k, v in base.items()}
    adam.adam_update(grads, adam.init_adam(big), big, lr=1e-2,
                     weight_decay=0.1)
    assert all(torch.equal(small[k], big[k]) for k in base)


# ---------------------------------------------------------------------------
# the data stream, compression, straggler and elastic helpers


@pytest.mark.parametrize("arch,reduced", [("qwen3-4b", True),
                                          ("qwen3-4b", False),
                                          ("mamba2-370m", False),
                                          ("zamba2-1.2b", True),
                                          ("dbrx-132b", True),
                                          ("whisper-medium", True),
                                          ("llava-next-mistral-7b", True)])
def test_synthetic_batches_match_reference(arch, reduced):
    get = jconfigs.get_reduced if reduced else jconfigs.get_config
    cfg = get(arch)
    ours = tlaunch.synthetic_batches(cfg, 3, 40, seed=5)
    ref = jlaunch.synthetic_batches(cfg, 3, 40, seed=5)
    for _ in range(3):
        a, b = next(ours), next(ref)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quantize_roundtrip_matches_reference(seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1e-2, (257,)).astype(np.float32)
    e = rng.normal(0, 1e-4, (257,)).astype(np.float32)
    for err in (None, e):
        got = tgc.quantize_roundtrip(_t(x), None if err is None else _t(err))
        want = jgc.quantize_roundtrip(jnp.asarray(x), None if err is None
                                      else jnp.asarray(err))
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-9)
    scale = torch.tensor(0.01)
    q = tgc.quantize(_t(x * 50), scale)
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(
        jgc.quantize(jnp.asarray(x * 50), jnp.float32(0.01))))


def test_grad_compression_error_feedback_converges():
    """``tests/test_properties.py``'s check: with error feedback the
    accumulated compressed sums track the true sum."""
    rng = np.random.default_rng(0)
    g = _t(rng.normal(0, 1e-3, (256,)).astype(np.float32))
    err = torch.zeros_like(g)
    total_true = np.zeros((256,), np.float64)
    total_comp = np.zeros((256,), np.float64)
    for _ in range(50):
        dec, err = tgc.quantize_roundtrip(g, err)
        total_true += g.double().numpy()
        total_comp += dec.double().numpy()
    denom = np.abs(total_true).mean()
    assert np.abs(total_comp - total_true).mean() < 0.05 * denom + 1e-6


def _monitor_scenario(mod):
    m = mod.HeartbeatMonitor(hosts=[0, 1, 2, 3], interval=10.0,
                             miss_limit=3, straggle_factor=2.0)
    out = []
    for t in range(1, 8):
        for h in (0, 1, 2):
            m.beat(h, float(t), step_time=1.0 if h != 2 else 3.5)
        out.append(m.check(float(t)))
    m.beat(3, 8.0, step_time=1.0)
    out += [m.check(t) for t in (20.0, 30.0, 45.0, 60.0)]
    return out, m.healthy_hosts(), sorted(m.failed)


def _dispatcher_scenario(mod):
    d = mod.DeadlineDispatcher(n_replicas=3, base_deadline=0.5,
                               p99_window=16)
    out = []
    now = 0.0
    for rid in range(30):
        d.dispatch(rid, now)
        now += 0.05
        if rid % 4 != 3:
            d.complete(rid, now + 0.1 * (rid % 3))
        out.append([(x.request_id, x.replica, x.sent_at, x.deadline)
                    for x in d.poll(now + 0.6)])
    return out, d.redispatches, sorted(d.inflight)


def test_heartbeat_monitor_matches_reference():
    assert _monitor_scenario(tstrag) == _monitor_scenario(jstrag)


def test_deadline_dispatcher_matches_reference():
    assert _dispatcher_scenario(tstrag) == _dispatcher_scenario(jstrag)


@pytest.mark.parametrize("n,model_par", [(8, 2), (6, 4), (7, 4), (1, 8),
                                         (12, 3)])
def test_plan_mesh_and_scaled_accum(n, model_par):
    assert telastic.plan_mesh(n, model_par) == jelastic.plan_mesh(
        n, model_par)
    for old, new in ((8, 4), (4, 6), (3, 8)):
        want = jelastic.ElasticState.scaled_accum(
            jelastic.ElasticState(None, 64, model_par), old, new)
        assert telastic.ElasticState(64, model_par).scaled_accum(
            old, new) == want


# ---------------------------------------------------------------------------
# parameter counts


def _port_config(jcfg):
    """The port's ModelConfig of a reference config, field for field."""
    kw = {}
    for f in dataclasses.fields(jcfg):
        v = getattr(jcfg, f.name)
        if dataclasses.is_dataclass(v):
            v = getattr(tmc, type(v).__name__)(**dataclasses.asdict(v))
        kw[f.name] = v
    return tmc.ModelConfig(**kw)


LM_100M = dict(name="qwen3-100m", n_layers=12, d_model=640, n_heads=10,
               n_kv_heads=2, head_dim=64, d_ff=2048, vocab_size=32768,
               max_seq_len=4096)     # examples/train_lm_100m.py


@pytest.mark.parametrize("arch", sorted(jconfigs.ARCH_MODULES) + ["100m"])
def test_param_count_matches_reference(arch):
    if arch == "100m":
        cfgs = [jconfigs.get_config("qwen3-4b").replace(**LM_100M)]
    else:
        cfgs = [jconfigs.get_config(arch), jconfigs.get_reduced(arch)]
    for jcfg in cfgs:
        tcfg = _port_config(jcfg)
        assert tcfg.param_count() == jcfg.param_count()
        assert tcfg.active_param_count() == jcfg.active_param_count()


NORMS = ("ln", "ln1", "ln2", "final_norm", "q_norm", "k_norm")


@pytest.mark.parametrize("arch", ARCHS)
def test_param_count_counts_the_port_tree(arch):
    """The analytic count is the port's seeded tree's element count
    without the norm scales, which it leaves out (the mamba block's
    gated-norm ``norm_w`` it counts)."""
    cfg = get_reduced(arch).replace(n_layers=LAYERS[arch])
    params = registry.init_params(cfg, torch.Generator().manual_seed(0),
                                  "cpu")
    assert sum(t.numel() for k, t in tckpt.flatten(params).items()
               if not set(k.split("/")) & set(NORMS)) == cfg.param_count()


# ---------------------------------------------------------------------------
# checkpoints and the launcher


def test_checkpoint_round_trip_of_params_and_adam_state(tmp_path):
    cfg = get_reduced("qwen3-4b")
    params, opt = ttr.init_train_state(cfg, torch.Generator().manual_seed(0),
                                       "cpu")
    step = ttr.make_train_step(cfg, ttr.TrainConfig(**_train_config(1)))
    for s in range(2):
        params, opt, _ = step(params, opt, {k: _t(v) for k, v in _batch(
            cfg, 2, 16, 20 + s, mask=False).items()})
    tckpt.save((params, opt), str(tmp_path), 2)
    fresh = ttr.init_train_state(cfg, torch.Generator().manual_seed(1),
                                 "cpu")
    back_p, back_o = tckpt.restore(fresh, str(tmp_path))
    assert isinstance(back_o, adam.AdamState)
    assert type(back_o.step) is int and back_o.step == opt.step == 2
    for a, b in ((tckpt.flatten(back_p), tckpt.flatten(params)),
                 (back_o.m, opt.m), (back_o.v, opt.v)):
        assert a.keys() == b.keys()
        assert all(torch.equal(a[k], b[k].detach()) for k in a)
    flat = {"a": torch.ones(2), "b": torch.zeros(3)}
    jflat = {k: jnp.asarray(v.numpy()) for k, v in flat.items()}
    assert list(tckpt.flatten((flat, adam.init_adam(flat)))) == [
        n for n, _ in jckpt._tree_paths((jflat, jadam.init_adam(jflat)))]


def _jnp_leaf(t):
    if isinstance(t, int):
        return jnp.asarray(t, jnp.int32)
    return jnp.array(t.float().numpy()).astype(jnp.bfloat16) \
        if t.dtype == torch.bfloat16 else jnp.array(t.numpy())


def test_half_train_state_checkpoints_cross_both_packages(tmp_path):
    """A bf16 train state of the SSM config (float32 ``A_log`` /
    ``dt_bias`` / ``D`` among bf16 leaves, float32 moments, after one
    step) saved by the port restores through the reference's
    ``checkpoint.restore`` bit for bit, dtypes kept; and a state the
    reference saves restores through the port's."""
    cfg = get_reduced("mamba2-370m")
    params, opt = ttr.init_train_state(cfg, torch.Generator().manual_seed(0),
                                       "cpu", torch.bfloat16)
    step = ttr.make_train_step(cfg, ttr.TrainConfig(**_train_config(1)))
    params, opt, _ = step(params, opt, {k: _t(v) for k, v in _batch(
        cfg, 2, 16, 30, mask=False).items()})
    state = (params, opt)
    tckpt.save(state, str(tmp_path / "port"), 1)
    jlike = jax.tree_util.tree_map(_jnp_leaf, state)
    back = jckpt.restore(jlike, str(tmp_path / "port"))
    got = tckpt.flatten(state)
    names = [n for n, _ in jckpt._tree_paths(back)]
    assert names == list(got)
    for name, leaf in zip(names, jax.tree_util.tree_leaves(back)):
        want = got[name]
        if isinstance(want, int):
            assert int(leaf) == want
            continue
        assert str(np.asarray(leaf).dtype) == str(want.dtype).replace(
            "torch.", ""), name
        assert np.array_equal(np.asarray(leaf).astype(np.float32),
                              want.float().numpy()), name
    assert {str(want.dtype) for name, want in got.items()
            if name.endswith("A_log")} == {"torch.float32"}
    # the reverse: the reference saves (each leaf moved one bf16 step),
    # the port restores
    moved = jax.tree_util.tree_map(
        lambda a: a if a.dtype == jnp.int32 else
        (a.astype(jnp.float32) * 1.5).astype(a.dtype), jlike)
    jckpt.save(moved, str(tmp_path / "ref"), 2)
    fresh = ttr.init_train_state(cfg, torch.Generator().manual_seed(1),
                                 "cpu", torch.bfloat16)
    mine = tckpt.flatten(tckpt.restore(fresh, str(tmp_path / "ref")))
    for name, leaf in zip(names, jax.tree_util.tree_leaves(moved)):
        if isinstance(mine[name], int):
            assert mine[name] == int(leaf)
            continue
        assert str(mine[name].dtype).replace("torch.", "") == \
            str(np.asarray(leaf).dtype), name
        assert np.array_equal(mine[name].float().numpy(),
                              np.asarray(leaf).astype(np.float32)), name


def _launch(*args, tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "qwen3-4b", "--reduced", "--device", "cpu", "--batch", "4",
         "--seq", "64", "--ckpt-dir", str(tmp_path), *args],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=300)


def test_launch_train_trains_and_resumes(tmp_path):
    out = _launch("--steps", "120", "--save-every", "60", tmp_path=tmp_path)
    assert out.returncode == 0, out.stderr
    done = [ln for ln in out.stdout.splitlines() if "done:" in ln][0]
    first = float(done.split("first=")[1].split()[0])
    last10 = float(done.split("last10=")[1].split()[0])
    assert last10 < first - 0.03, done
    assert tckpt.steps(str(tmp_path)) == [60, 120]
    out = _launch("--steps", "125", "--resume", tmp_path=tmp_path)
    assert out.returncode == 0, out.stderr
    assert "resumed from step 120" in out.stdout
    assert "step 120 loss" in out.stdout and "step 119" not in out.stdout
    assert tckpt.latest_step(str(tmp_path)) == 125


@pytest.mark.parametrize("arch", ["whisper-medium", "llava-next-mistral-7b",
                                  "dbrx-132b"])
def test_launch_train_runs_every_family(arch, capsys):
    """``launch.train`` on the encoder-decoder (frames in every batch),
    the VLM (image embeddings) and a MoE config: finite losses, exit 0."""
    assert tlaunch.main(["--arch", arch, "--reduced", "--device", "cpu",
                         "--steps", "3", "--batch", "2", "--seq", "16"]) == 0
    out = capsys.readouterr().out
    assert "[train] step 2 loss" in out and "done:" in out


@pytest.mark.parametrize("bad", [["--backend", "xla"],
                                 ["--model-par", "2"]])
def test_launch_train_refuses_what_it_cannot_do(tmp_path, bad):
    out = _launch("--steps", "1", *bad, tmp_path=tmp_path)
    assert out.returncode == 2 and bad[0] in out.stderr
    assert tckpt.latest_step(str(tmp_path)) is None


# ---------------------------------------------------------------------------
# on the card (chip_smoke.py phase 16 runs the full-width checks)


@pytest.mark.cuda
def test_lm_train_step_on_card_matches_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (chip_smoke.py phase 16 "
                    "runs this check on the H100)")
    cfg = get_reduced("qwen3-4b")
    batch = _batch(cfg, 2, 64, 30, mask=False)
    out = {}
    for dev in ("cpu", "cuda"):
        params, opt = ttr.init_train_state(
            cfg, torch.Generator().manual_seed(0), dev)
        step = ttr.make_train_step(cfg, ttr.TrainConfig(**_train_config(1)))
        _, _, m = step(params, opt, {k: _t(v).to(dev)
                                     for k, v in batch.items()})
        out[dev] = float(m["loss"])
    assert abs(out["cuda"] - out["cpu"]) <= 1e-4 * abs(out["cpu"])
