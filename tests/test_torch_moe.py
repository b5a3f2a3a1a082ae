"""Port parity for the MoE family: routing, capacity dispatch and the
MoE FFN (``models/moe.py``), MLA with its latent cache
(``attention.mla_forward``), the dense-to-MoE layer boundary, the
mixed-granularity prefill and forward, the serving engine and the
launcher, against the reference on the same parameters (its
``init_lm_params`` converted by ``convert.lm_params_from_jax``, norm
scales perturbed so they matter) and the same numpy-seeded inputs.

Configs: dbrx-132b ``REDUCED`` (2 MoE layers, 4 experts top-2, GQA at G
= 1) and deepseek-v2-236b ``REDUCED`` (a dense layer, then a MoE layer
with 2 shared experts; MLA at rank 32).  Tolerances: integer tables and
expert choices byte-equal; gates and aux 1e-6; single layers 1e-5
absolute (float32, another summation order); whole models, caches and
the mixed paths 1e-4.  Greedy tokens must be equal unless the
reference's top-2 margin at the first differing step lies below 1e-4.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jget_reduced
from repro.core import seq_mixed_res as jsmr
from repro.models import attention as jattn
from repro.models import moe as jmoe
from repro.models import registry as jregistry
from repro.models import transformer as jtfm
from repro.serve.engine import ServeConfig as JServeConfig
from repro.serve.engine import ServeEngine as JServeEngine
from repro.serve.request import Request as JRequest
from repro_torch import convert
from repro_torch.configs import get_reduced
from repro_torch.core import seq_mixed_res as tsmr
from repro_torch.launch import serve as tlaunch
from repro_torch.models import attention as tattn
from repro_torch.models import moe as tmoe
from repro_torch.models import registry
from repro_torch.models import transformer as ttfm
from repro_torch.offload.simulator import to_device
from repro_torch.quant.ptq import quantize_lm_params
from repro_torch.serve.engine import ServeConfig, ServeEngine
from repro_torch.serve.request import Request

torch.set_num_threads(2)
GATE_TOL = 1e-6
LAYER_TOL = 1e-5
MODEL_TOL = 1e-4
ARCHS = ("dbrx-132b", "deepseek-v2-236b")
T, NEW = 32, 4


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


def _np(tree):
    return jax.tree_util.tree_map(np.array, tree)


def _perturb_norms(tree, rng):
    """Norm scales of 1 +- 0.1 instead of ones, so a misplaced scale
    shows."""
    def walk(t, path=()):
        if isinstance(t, dict):
            return {k: walk(v, path + (k,)) for k, v in t.items()}
        if any("norm" in k or k in ("ln1", "ln2") for k in path):
            return (t + 0.1 * rng.standard_normal(t.shape)).astype(t.dtype)
        return t
    return walk(tree)


def _tokens(rng, cfg, B, n):
    return rng.integers(0, cfg.vocab_size, (B, n)).astype(np.int32)


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    jcfg, tcfg = jget_reduced(request.param), get_reduced(request.param)
    tree = _perturb_norms(
        _np(jtfm.init_lm_params(jcfg, jax.random.PRNGKey(0))),
        np.random.default_rng(1))
    return (jcfg, tcfg, jax.tree_util.tree_map(jnp.asarray, tree),
            convert.lm_params_from_jax(tree, tcfg, "cpu"))


# ---------------------------------------------------------------------------
# configs and parameters


def test_moe_configs_and_layer_layout():
    from repro.configs import get_config as jget_config
    from repro_torch.configs import get_config
    for arch in ARCHS:
        for get, jget in ((get_config, jget_config),
                          (get_reduced, jget_reduced)):
            assert dataclasses.asdict(get(arch)) == \
                dataclasses.asdict(jget(arch))
        cfg = get_config(arch)
        assert cfg.param_count() == jget_config(arch).param_count()
    ds = get_config("deepseek-v2-236b").replace(n_layers=4)
    assert [ttfm.layer_kind(ds, i) for i in range(4)] == \
        ["dense", "moe", "moe", "moe"]
    assert ttfm.restore_counts(ds, 2) == {"dense_blocks": 1, "moe_blocks": 1}
    assert ttfm.restore_counts(get_config("dbrx-132b"), 2) == \
        {"dense_blocks": 0, "moe_blocks": 2}


def test_seeded_init_has_the_reference_shapes_and_scales(model):
    """The port's own seeded init: the converted reference tree's shapes;
    the expert slabs at 1 / sqrt(E) (the reference's fan-in is the
    leading axis), the router at 0.02, dense weights at 1 /
    sqrt(fan_in)."""
    _, tcfg, _, ref = model
    got = registry.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    assert jax.tree_util.tree_map(lambda t: tuple(t.shape), got) == \
        jax.tree_util.tree_map(lambda t: tuple(t.shape), ref)
    wide = tcfg.replace(d_model=256, vocab_size=512)
    got = registry.init_params(wide, torch.Generator().manual_seed(0), "cpu")
    std = np.sqrt(1 - 4 * np.exp(-2) / np.sqrt(2 * np.pi)
                  / (2 * 0.9772498680518208 - 1))   # N(0,1) cut at +-2
    ffn = got["blocks"][-1]["ffn"]
    E = wide.moe.n_experts
    for a, scale in ((ffn["w_gate"], E ** -0.5), (ffn["w_down"], E ** -0.5),
                     (ffn["router"], 0.02),
                     (got["blocks"][0]["attn"]["w_o"],
                      got["blocks"][0]["attn"]["w_o"].shape[0] ** -0.5)):
        assert abs(float(a.std()) / (std * scale) - 1) < 0.05
        assert float(a.abs().max()) <= 2 * scale + 1e-6


# ---------------------------------------------------------------------------
# routing and dispatch


def _moe_params(jcfg, seed=3, tie=False):
    p = _np(jmoe.init_moe(jcfg, jax.random.PRNGKey(seed), jnp.float32))
    if tie:                   # experts 0 / 1 and 2 / 3 route identically
        p["router"][:, 1] = p["router"][:, 0]
        p["router"][:, 3] = p["router"][:, 2]
    return p


def _tmoe(p):
    return {k: (_tmoe(v) if isinstance(v, dict) else _t(v))
            for k, v in p.items()}


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("tie", [False, True])
def test_routing_matches_reference(arch, tie):
    """Expert choices byte-equal (tied probabilities pick the lower
    expert first, as ``jax.lax.top_k``), gates and aux to 1e-6."""
    jcfg, tcfg = jget_reduced(arch), get_reduced(arch)
    p = _moe_params(jcfg, tie=tie)
    x = np.random.default_rng(4).standard_normal(
        (96, tcfg.d_model)).astype(np.float32)
    ji, jg, ja = jmoe._route(jcfg, jnp.asarray(p["router"]), jnp.asarray(x))
    ti, tg, ta = tmoe.route(tcfg, _t(p["router"]), _t(x))
    assert np.array_equal(ti.numpy(), np.asarray(ji))
    _close(tg, jg, GATE_TOL)
    _close(ta, ja, GATE_TOL)
    if tie:
        assert (np.asarray(ji)[:, 0] % 2 == 0).all()


@pytest.mark.parametrize("cap_factor", [1.25, 0.25])
def test_dispatch_tables_byte_equal(cap_factor):
    """Static-capacity tables on the reference's own routing, at the
    configured capacity and at one cut so that tokens drop."""
    arch = "deepseek-v2-236b"
    moe = dataclasses.replace(get_reduced(arch).moe,
                              capacity_factor=cap_factor)
    jcfg = jget_reduced(arch).replace(moe=moe)
    tcfg = get_reduced(arch).replace(moe=moe)
    p = _moe_params(jcfg)
    x = np.random.default_rng(5).standard_normal(
        (64, tcfg.d_model)).astype(np.float32)
    ji, jg, _ = jmoe._route(jcfg, jnp.asarray(p["router"]), jnp.asarray(x))
    cap = tmoe.expert_capacity(tcfg, 64)
    assert cap == jmoe.expert_capacity(jcfg, 64)
    want = jmoe._dispatch_tables(jcfg, ji, jg, 0, tcfg.moe.n_experts, cap)
    got = tmoe.dispatch_tables(tcfg, _t(ji).long(), _t(jg), cap)
    for g, w in zip(got, want):
        assert g.numpy().dtype == np.asarray(w).dtype
        assert g.numpy().tobytes() == np.asarray(w).tobytes()
    kept = int((np.asarray(want[1]) > 0).sum())
    assert (kept < 64 * tcfg.moe.top_k) == (cap_factor < 1)


@pytest.mark.parametrize("arch,cap_factor", [
    ("dbrx-132b", 1.25), ("dbrx-132b", 0.25), ("deepseek-v2-236b", 1.25),
    ("deepseek-v2-236b", 0.25)])
def test_moe_local_matches_reference(arch, cap_factor):
    """The whole MoE FFN (deepseek-v2 with its shared experts), with and
    without dropped tokens."""
    moe = dataclasses.replace(get_reduced(arch).moe,
                              capacity_factor=cap_factor)
    jcfg = jget_reduced(arch).replace(moe=moe)
    tcfg = get_reduced(arch).replace(moe=moe)
    p = _moe_params(jcfg, seed=6)
    assert ("shared" in p) == (arch == "deepseek-v2-236b")
    x = np.random.default_rng(7).standard_normal(
        (2, 40, tcfg.d_model)).astype(np.float32)
    jout, jaux = jmoe.moe_local(jcfg, p, jnp.asarray(x))
    tout, taux = tmoe.moe_local(tcfg, _tmoe(p), _t(x))
    _close(tout, jout, LAYER_TOL)
    _close(taux, jaux, GATE_TOL)


# ---------------------------------------------------------------------------
# MLA


def _mla_params(jcfg, rng):
    p = _np(jattn.init_mla(jcfg, jax.random.PRNGKey(8), jnp.float32))
    for k in ("q_norm", "kv_norm"):
        p[k] = (1 + 0.1 * rng.standard_normal(p[k].shape)).astype(np.float32)
    return p


@pytest.mark.parametrize("B,Tq,S", [(2, 12, 20), (1, 3072, 3072)])
def test_mla_prefill_and_decode_with_latent_cache(B, Tq, S):
    """Prefill Tq tokens into the latent cache (Tq = 3072 runs the
    reference's blocked query path), then two decode steps; outputs and
    the cache written in place against the reference's functional
    update."""
    arch = "deepseek-v2-236b"
    jcfg, tcfg = jget_reduced(arch), get_reduced(arch)
    rng = np.random.default_rng(9)
    p = _mla_params(jcfg, rng)
    tp = {k: _t(v) for k, v in p.items()}
    x = rng.standard_normal((B, Tq, tcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(Tq), (B, Tq))
    steps = 2 if S > Tq else 0
    jcache = jattn.init_mla_cache(jcfg, B, S, jnp.float32)
    jout, jcache = jattn.mla_forward(jcfg, p, jnp.asarray(x),
                                     jnp.asarray(pos), cache=jcache)
    tcache = tattn.init_mla_cache(tcfg, B, S, device="cpu")
    tout = tattn.mla_forward(tcfg, tp, _t(x),
                             tattn.mla_rope(tcfg, _t(pos)), tcache)
    _close(tout, jout, LAYER_TOL)
    for step in range(steps):
        xd = rng.standard_normal((B, 1, tcfg.d_model)).astype(np.float32)
        jout, jcache = jattn.mla_forward(
            jcfg, p, jnp.asarray(xd), jnp.full((B, 1), Tq + step),
            cache=jcache, pos=Tq + step)
        tout = tattn.mla_forward(
            tcfg, tp, _t(xd),
            tattn.mla_rope(tcfg, torch.full((B, 1), Tq + step)), tcache,
            Tq + step)
        _close(tout, jout, LAYER_TOL)
    for k in ("c_kv", "k_rope"):
        _close(tcache[k], jcache[k], LAYER_TOL)


def test_mla_training_forward():
    arch = "deepseek-v2-236b"
    jcfg, tcfg = jget_reduced(arch), get_reduced(arch)
    rng = np.random.default_rng(10)
    p = _mla_params(jcfg, rng)
    x = rng.standard_normal((2, 24, tcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(24), (2, 24))
    _close(tattn.mla_forward(tcfg, {k: _t(v) for k, v in p.items()}, _t(x),
                             tattn.mla_rope(tcfg, _t(pos))),
           jattn.mla_forward(jcfg, p, jnp.asarray(x), jnp.asarray(pos)),
           LAYER_TOL)


# ---------------------------------------------------------------------------
# whole models


def _close_caches(tc, jc, tol, T=None):
    assert sorted(tc) == sorted(jc)
    for name in jc:
        assert sorted(tc[name]) == sorted(jc[name])
        for k in jc[name]:
            got, want = tc[name][k].numpy(), np.asarray(jc[name][k])
            if T is not None:
                got, want = got[:, :, :T], want[:, :, :T]
            _close(got, want, tol)


def test_prefill_decode_forward_and_loss(model):
    """Prefill hidden states and caches, two decode steps' logits, the
    training forward's hidden states and aux, and ``lm_loss`` with its
    aux term."""
    jcfg, tcfg, jp, tp = model
    rng = np.random.default_rng(11)
    B, S = 2, T + 8
    toks = _tokens(rng, tcfg, B, T)
    jc = jtfm.init_caches(jcfg, B, S, jnp.float32)
    jh, jc, jaux = jtfm.prefill(jcfg, jp, jnp.asarray(toks), jc)
    tc = ttfm.init_caches(tcfg, B, S, device="cpu")
    th, tc, taux = ttfm.prefill(tcfg, tp, _t(toks).long(), tc)
    _close(th, jh, MODEL_TOL)
    _close(taux, jaux, MODEL_TOL)
    _close_caches(tc, jc, MODEL_TOL)
    for step in range(2):
        tok = _tokens(rng, tcfg, B, 1)
        jl, jc = jtfm.decode_step(jcfg, jp, jnp.asarray(tok), T + step, jc)
        tl, tc = ttfm.decode_step(tcfg, tp, _t(tok).long(), T + step, tc)
        _close(tl, jl, MODEL_TOL)
    _close_caches(tc, jc, MODEL_TOL)
    batch = {"tokens": toks}
    jh, jaux = jregistry.forward_hidden(jcfg, jp, batch)
    th, taux = registry.forward_hidden(tcfg, tp, {"tokens": _t(toks).long()})
    _close(th, jh, MODEL_TOL)
    _close(taux, jaux, MODEL_TOL)
    jloss, jm = jregistry.lm_loss(jcfg, jp, batch)
    tloss, tm = registry.lm_loss(tcfg, tp, {"tokens": _t(toks).long()})
    assert float(jm["aux"]) > 0
    for got, want in ((tloss, jloss), (tm["ce"], jm["ce"]),
                      (tm["aux"], jm["aux"])):
        _close(got.detach(), want, MODEL_TOL)


def test_lm_loss_gradient_reaches_every_leaf(model):
    """The MoE loss trains: every leaf (router, experts, MLA latents)
    gets a finite gradient."""
    _, tcfg, _, tp = model
    params = jax.tree_util.tree_map(
        lambda t: t.clone().requires_grad_(True), tp)
    toks = _t(_tokens(np.random.default_rng(12), tcfg, 2, 16)).long()
    loss, _ = registry.lm_loss(tcfg, params, {"tokens": toks})
    loss.backward()
    leaves = jax.tree_util.tree_leaves(params)
    assert all(t.grad is not None and torch.isfinite(t.grad).all()
               for t in leaves)


@pytest.mark.parametrize("beta", [0, 2])
def test_mixed_prefill_and_forward(model, beta):
    """The mixed-granularity prefill (pre-RP layers in both stacks of
    deepseek-v2 at beta 2: its dense layer and its MoE layer), the
    restored caches and one decode step on them; the mixed training
    forward and its aux."""
    jcfg, tcfg, jp, tp = model
    rng = np.random.default_rng(13 + beta)
    B, S = 2, T + 8
    toks = _tokens(rng, tcfg, B, T)
    pack = tsmr.build_seq_pack(np.array([0, 1]), 1,
                               tsmr.seq_partition(tcfg, T))
    tpack = {k: torch.from_numpy(v.astype(np.int64)) for k, v in
             pack.items()}
    jpack = {k: jnp.asarray(v) for k, v in pack.items()}
    jc = jtfm.init_caches(jcfg, B, S, jnp.float32)
    jh, jc, jaux = jsmr.mixed_prefill(jcfg, jp, jnp.asarray(toks), jpack,
                                      beta, jc)
    tc = ttfm.init_caches(tcfg, B, S, device="cpu")
    th, tc, taux = tsmr.mixed_prefill(tcfg, tp, _t(toks).long(), tpack,
                                      beta, tc)
    _close(th, jh, MODEL_TOL)
    _close(taux, jaux, MODEL_TOL)
    _close_caches(tc, jc, MODEL_TOL, T=T)
    tok = _tokens(rng, tcfg, B, 1)
    jl, _ = jtfm.decode_step(jcfg, jp, jnp.asarray(tok), T, jc)
    tl, _ = ttfm.decode_step(tcfg, tp, _t(tok).long(), T, tc)
    _close(tl, jl, MODEL_TOL)
    jh, jaux = jsmr.mixed_forward_hidden(jcfg, jp, jnp.asarray(toks), jpack,
                                         beta)
    th, taux = tsmr.mixed_forward_hidden(tcfg, tp, _t(toks).long(), tpack,
                                         beta)
    _close(th, jh, MODEL_TOL)
    _close(taux, jaux, MODEL_TOL)


# ---------------------------------------------------------------------------
# serving


def _ref_margin(jcfg, jp, prompt, tokens, mask, beta, step):
    """The reference's top-2 logit margin at ``step`` of one request run
    alone, teacher-forced on ``tokens``."""
    state = jregistry.init_decode_state(jcfg, 1, T + NEW + 8, jnp.float32)
    toks = jnp.asarray(prompt)[None]
    if mask is None:
        h, state, _ = jregistry.prefill(jcfg, jp, {"tokens": toks}, state)
    else:
        part = jsmr.seq_partition(jcfg, T)
        pk = jsmr.build_seq_pack(mask, int(mask.sum()), part)
        h, state, _ = jsmr.mixed_prefill(
            jcfg, jp, toks, {k: jnp.asarray(v) for k, v in pk.items()}, beta,
            state)
    lg = jtfm.logits_from_hidden(jcfg, jp, h[:, -1:])
    for i, tok in enumerate(tokens[:step], start=1):
        lg, state = jregistry.decode_step(
            jcfg, jp, jnp.asarray([[tok]], jnp.int32), T + i - 1, state)
    f = np.sort(np.asarray(lg).reshape(-1))
    return float(f[-1] - f[-2])


def test_engine_waves_match_reference(model):
    """A plain wave, a padded wave (3 requests in the B = 4 bucket, whose
    pad slots copy slot 0 and compete for expert capacity in both
    engines) and a mixed wave at beta 2: equal greedy tokens, unless the
    reference's margin at the first differing step is below 1e-4."""
    jcfg, tcfg, jp, tp = model
    kw = dict(max_batch=4, max_len=T + NEW + 8, buckets=(T,))
    engines = (JServeEngine(jcfg, jp, JServeConfig(**kw)),
               ServeEngine(tcfg, tp, ServeConfig(device="cpu", **kw)))
    rng = np.random.default_rng(14)
    waves = (([None] * 4, 0), ([None] * 3, 0),
             ([np.array([1, 0], np.int32)] * 4, 2))
    rid = 0
    for masks, beta in waves:
        reqs = {}
        for mask in masks:
            prompt = _tokens(rng, tcfg, 1, T)[0]
            reqs[rid] = (prompt, mask)
            engines[0].submit(JRequest(rid=rid, prompt=prompt,
                                       max_new_tokens=NEW,
                                       low_span_mask=mask, beta=beta))
            engines[1].submit(Request(rid=rid, prompt=prompt,
                                      max_new_tokens=NEW,
                                      low_span_mask=mask, beta=beta))
            rid += 1
        want = {r.rid: r.tokens for r in engines[0].run()}
        got = {r.rid: r.tokens for r in engines[1].run()}
        assert sorted(got) == sorted(want) == sorted(reqs)
        for r, w in want.items():
            if got[r] == w:
                continue
            step = next(i for i, (a, b) in enumerate(zip(got[r], w))
                        if a != b)
            margin = _ref_margin(jcfg, jp, reqs[r][0], w, reqs[r][1], beta,
                                 step)
            assert margin < MODEL_TOL, (r, step, got[r], w, margin)
    assert len(engines[1].wave_latencies) == len(waves)
    assert engines[1].stats.compiles == engines[0].stats.compiles


@pytest.mark.parametrize("arch", ARCHS)
def test_launch_serve_on_cpu(arch, capsys):
    assert tlaunch.main(["--arch", arch, "--reduced", "--device", "cpu",
                         "--requests", "3", "--prompt-len", "32",
                         "--max-new", "3", "--mixed"]) == 0
    out = capsys.readouterr().out
    assert "[serve] 3 requests, 9 tokens" in out and "mixed=on" in out


@pytest.mark.parametrize("quant", ["int8", "bf16"])
def test_moe_quant_lanes_refuse(quant):
    """The MoE int8 and half lanes are not ported: the launcher and the
    int8 tree walk raise rather than quantize expert slabs the reference
    leaves float."""
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tlaunch.main(["--arch", "dbrx-132b", "--reduced", "--device", "cpu",
                      "--quant", quant])
    tcfg = get_reduced("deepseek-v2-236b")
    params = registry.init_params(tcfg, torch.Generator().manual_seed(0),
                                  "cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        quantize_lm_params(params)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_on_card_matches_cpu(arch):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (chip_smoke.py phase 23 "
                    "serves both MoE configs on the H100)")
    tcfg = get_reduced(arch)
    tp = registry.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    toks = _t(_tokens(np.random.default_rng(15), tcfg, 2, T)).long()
    out = []
    for dev in ("cpu", "cuda"):
        params = to_device(tp, torch.device(dev))
        c = ttfm.init_caches(tcfg, 2, T + 8, device=dev)
        h, c, _ = ttfm.prefill(tcfg, params, toks.to(dev), c)
        lg, _ = ttfm.decode_step(tcfg, params, toks[:, :1].to(dev), T, c)
        out.append((h.cpu(), lg.cpu()))
    for a, b in zip(*out):
        assert float((a - b).abs().max() / b.abs().max()) <= 1e-3
