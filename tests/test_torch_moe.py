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

The serving lanes: dbrx's int8 tree (attention int8, codes and scales
equal to the reference's; router and expert slabs float), deepseek-v2's
int8 lane refused up front (the reference's raises TypeError at its
first forward), fp16 / bf16 trees of both and a float32 tree over a bf16
cache, each through both engines: greedy tokens and prefill logits held
by ``_hold_routes`` (the half limits of ``tests/test_torch_half_lm.py``),
unless the two packages' routes chose other experts at a near-tie
(``route_tie``: 1e-5 for a float32 router, 8 u L p_k for a half one).
"""
import contextlib
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
from repro.quant import ptq as jptq
from repro.quant import qtensor as jqt
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
from repro_torch.quant import qtensor as qt
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


def _load(arch):
    jcfg, tcfg = jget_reduced(arch), get_reduced(arch)
    tree = _perturb_norms(
        _np(jtfm.init_lm_params(jcfg, jax.random.PRNGKey(0))),
        np.random.default_rng(1))
    return (jcfg, tcfg, jax.tree_util.tree_map(jnp.asarray, tree),
            convert.lm_params_from_jax(tree, tcfg, "cpu"))


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    return _load(request.param)


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


# ---------------------------------------------------------------------------
# the int8 and half serving lanes


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    else:
        yield path, tree


def test_dbrx_int8_tree_equals_reference():
    """dbrx-132b's int8 tree: the attention projections (fused ``w_qkv``,
    ``w_o``) carry the reference's codes and scales, layer for layer; the
    router and the (E, D, F) expert slabs are the float tree's own
    tensors, as the reference leaves its 4-D expert stacks float."""
    jcfg, tcfg, jp, tp = _load("dbrx-132b")
    got = quantize_lm_params(tp)
    want = convert.lm_params_from_jax(_np(jptq.quantize_lm_params(jp)),
                                      tcfg, "cpu")
    gl, wl, fl = dict(_leaves(got)), dict(_leaves(want)), dict(_leaves(tp))
    assert gl.keys() == wl.keys() == fl.keys()
    n_quant = 0
    for path, g in gl.items():
        w = wl[path]
        assert type(g) is type(w), path
        if isinstance(g, qt.QuantTensor):
            n_quant += 1
            assert path.rsplit("/", 1)[-1] in ("w_qkv", "w_o"), path
            assert torch.equal(g.q, w.q) and torch.equal(g.scale, w.scale)
        else:
            assert g is fl[path] and torch.equal(g, w), path
    assert n_quant == 2 * tcfg.n_layers
    for b in got["blocks"]:
        assert all(b["ffn"][k] is not None and b["ffn"][k].dtype
                   == torch.float32 for k in ("router", "w_gate", "w_up",
                                              "w_down"))


def test_deepseek_v2_int8_lane_refused_up_front():
    """The reference's int8 walk quantizes MLA's ``w_o`` and the shared
    experts, which its forward multiplies with a plain ``@``: TypeError
    at the first forward.  The port refuses the tree before any forward,
    naming both lines, and so does the launcher."""
    jcfg, tcfg, jp, tp = _load("deepseek-v2-236b")
    jq = jptq.quantize_lm_params(jp)
    toks = jnp.asarray(_tokens(np.random.default_rng(16), tcfg, 1, 8))
    with pytest.raises(TypeError):
        jtfm.prefill(jcfg, jq, toks, jtfm.init_caches(jcfg, 1, 16,
                                                      jnp.float32))
    for line in ("attention.py:457", "moe.py:117-119"):
        with pytest.raises(NotImplementedError, match=line):
            quantize_lm_params(tp)
    with pytest.raises(NotImplementedError, match="TypeError"):
        tlaunch.main(["--arch", "deepseek-v2-236b", "--reduced",
                      "--device", "cpu", "--quant", "int8"])
    # the launcher refuses before any weight is drawn: at full width too
    from repro_torch.configs import get_config
    from repro_torch.quant.ptq import check_lm_int8
    with pytest.raises(NotImplementedError, match="attention.py:457"):
        check_lm_int8(get_config("deepseek-v2-236b"))
    check_lm_int8(get_config("dbrx-132b"))


# the tree / cache types of each lane (reference, port) and its
# prefill-logit limit, of the largest |logit|: the half trees'
# tests/test_torch_half_lm.py limits (the half type's rounding of the
# largest logit); the int8 tree's activations stay float32 and its codes
# are equal (above), so float32's MODEL_TOL; a float32 tree over a bf16
# cache reads the cache's rounding only in decode, so its prefill is
# float32's
LANES = {
    "int8": ((jnp.float32, jnp.float32), (torch.float32, torch.float32),
             MODEL_TOL),
    "fp16": ((jnp.float16, jnp.float32), (torch.float16, torch.float32),
             4e-3),
    "bf16": ((jnp.bfloat16, jnp.float32), (torch.bfloat16, torch.float32),
             3e-2),
    "bf16-cache": ((jnp.float32, jnp.bfloat16),
                   (torch.float32, torch.bfloat16), MODEL_TOL),
}
# the half types' unit roundoff
UNIT = {torch.float16: 2.0 ** -11, torch.bfloat16: 2.0 ** -8,
        jnp.float16: 2.0 ** -11, jnp.bfloat16: 2.0 ** -8}
ROUTE_TIE = 1e-5        # a float32 router's near-tie (chip_smoke.py's)
HALF_ROUTE_ULPS = 8


def route_tie(logits, probs, k, unit):
    """Each token's routing near-tie bound: the gap between its k-th and
    (k+1)-th expert's probability below which two routes may order them
    apart.  A float32 router: ROUTE_TIE.  A half router (``unit`` its
    type's unit roundoff u) computes each logit l as a float32 sum
    rounded once to the type, from a hidden state that each route also
    rounded to the type: two roundings a route, each within u |l|, so
    the routes' logits differ by at most eps = 4 u L (L the token's
    largest |logit|).  Shifting every logit by at most eps moves the log
    of a probability ratio by at most 2 eps, so p_k and p_(k+1) can swap
    only if p_k - p_(k+1) <= p_k (1 - exp(-2 eps)) <= 2 eps p_k = 8 u L
    p_k (HALF_ROUTE_ULPS)."""
    if unit is None:
        return np.full(logits.shape[0], ROUTE_TIE)
    top = -np.sort(-probs, axis=-1)
    return HALF_ROUTE_ULPS * unit * np.abs(logits).max(-1) * top[:, k - 1]


@contextlib.contextmanager
def _record_routes(mod, name, to_np, unit):
    """``mod.<name>`` (the package's ``route``) recording, call by call,
    each token's chosen experts (sorted), the gap between its k-th and
    (k+1)-th expert's probability and its near-tie bound."""
    saved, log = getattr(mod, name), []

    def route(cfg, router_w, x_flat):
        out = saved(cfg, router_w, x_flat)
        k = cfg.moe.top_k
        logits = to_np(x_flat @ router_w).astype(np.float32)
        probs = np.exp(logits - logits.max(-1, keepdims=True))
        probs /= probs.sum(-1, keepdims=True)
        top = -np.sort(-probs, axis=-1)
        log.append((np.sort(to_np(out[0]), axis=-1), top[:, k - 1] - top[:, k],
                    route_tie(logits, probs, k, unit)))
        return out
    setattr(mod, name, route)
    try:
        yield log
    finally:
        setattr(mod, name, saved)


def _forced(reg, tfm_, cfg, params, state, prompt, tokens, to_np):
    """Teacher-forced logits of one request: the prefill's last row, then
    one a decode step on each of ``tokens`` but the last."""
    hidden, state, _ = reg.prefill(cfg, params, {"tokens": prompt}, state)
    out = [to_np(tfm_.logits_from_hidden(cfg, params, hidden[:, -1:]))]
    for step, tok in enumerate(tokens[:-1], start=1):
        lg, state = reg.decode_step(cfg, params, tok,
                                    prompt.shape[1] + step - 1, state)
        out.append(to_np(lg))
    return [o.reshape(-1).astype(np.float32) for o in out]


def _ref_np(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _port_np(a):
    return a.float().numpy()


def _ref_forced(jcfg, jp, jcache, unit, prompt, tokens):
    """The reference teacher-forced eagerly (its layer scans run as
    loops), with its routing log."""
    state = jregistry.init_decode_state(jcfg, 1, T + NEW + 8, jcache)
    with jax.disable_jit(), _record_routes(jmoe, "_route", _ref_np,
                                           unit) as log:
        lg = _forced(jregistry, jtfm, jcfg, jp, state,
                     jnp.asarray(prompt)[None],
                     [jnp.asarray([[t]], jnp.int32) for t in tokens],
                     _ref_np)
    return lg, log


def _port_forced(tcfg, tp, tcache, unit, prompt, tokens):
    state = registry.init_decode_state(tcfg, 1, T + NEW + 8, tcache, "cpu")
    with torch.no_grad(), _record_routes(tmoe, "route", _port_np,
                                         unit) as log:
        lg = _forced(registry, ttfm, tcfg, tp, state,
                     torch.as_tensor(prompt)[None],
                     [torch.tensor([[t]], dtype=torch.int32)
                      for t in tokens], _port_np)
    return lg, log


def _hold_routes(got, want, tol, step=None):
    """The port's and the reference's teacher-forced (logits, routing
    log) of one request.  If every routing call chose the same experts:
    the prefill logits to ``tol`` of their largest, and at ``step`` (the
    first greedy token that differs) the reference's top-2 margin at most
    twice the packages' difference.  Else the first call whose choices
    differ may differ only at tokens whose reference gap is within its
    near-tie bound (a flipped expert moves the logits far more than
    rounding, so they are then not held).  Returns whether the routes
    agreed."""
    (glg, glog), (wlg, wlog) = got, want
    assert len(glog) == len(wlog)
    for (gi, _, _), (wi, gap, tie) in zip(glog, wlog):
        rows = (gi != wi).any(-1)
        if rows.any():
            assert (gap[rows] <= tie[rows]).all(), (gap[rows], tie[rows])
            return False
    rel = np.abs(glg[0] - wlg[0]).max() / np.abs(wlg[0]).max()
    assert rel <= tol, rel
    if step is not None:
        margin = float(np.diff(np.sort(wlg[step])[-2:])[0])
        assert margin <= 2 * float(np.abs(glg[step] - wlg[step]).max()), \
            (step, margin)
    return True


LANE_CASES = [("dbrx-132b", "int8"), ("dbrx-132b", "fp16"),
              ("dbrx-132b", "bf16"), ("deepseek-v2-236b", "fp16"),
              ("deepseek-v2-236b", "bf16"), ("dbrx-132b", "bf16-cache"),
              ("deepseek-v2-236b", "bf16-cache")]


def _lane_trees(jp, tp, lane):
    (jdt, jcache), (tdt, tcache), _ = LANES[lane]
    if lane == "int8":
        return jptq.quantize_lm_params(jp), quantize_lm_params(tp)
    if jdt == jnp.float32:
        return jp, tp
    return jqt.cast_tree(jp, jdt), qt.cast_tree(tp, tdt)


@pytest.mark.parametrize("arch,lane", LANE_CASES)
def test_lane_engine_matches_reference(arch, lane):
    """Three requests padded to the B = 4 bucket through both engines on
    the lane's tree and cache: greedy tokens equal, the first request's
    prefill logits within the lane's limit, each by :func:`_hold_routes`
    (teacher-forced on the reference's tokens) unless the routes chose
    other experts at a near-tie."""
    jcfg, tcfg, jp, tp = _load(arch)
    jp, tp = _lane_trees(jp, tp, lane)
    (jdt, jcache), (tdt, tcache), tol = LANES[lane]
    unit = UNIT.get(tdt)
    kw = dict(max_batch=4, max_len=T + NEW + 8, buckets=(T,))
    jeng = JServeEngine(jcfg, jp, JServeConfig(cache_dtype=jcache, **kw))
    teng = ServeEngine(tcfg, tp, ServeConfig(device="cpu",
                                             cache_dtype=tcache, **kw))
    rng = np.random.default_rng(17)
    prompts = [_tokens(rng, tcfg, 1, T)[0] for _ in range(3)]
    for rid, p in enumerate(prompts):
        jeng.submit(JRequest(rid=rid, prompt=p, max_new_tokens=NEW))
        teng.submit(Request(rid=rid, prompt=p, max_new_tokens=NEW))
    teng.warmup()
    want = {r.rid: r.tokens for r in jeng.run()}
    got = {r.rid: r.tokens for r in teng.run()}
    assert teng.stats.steady_compiles == 0
    assert sorted(got) == sorted(want) == [0, 1, 2]
    for rid, w in want.items():
        g = got[rid]
        assert len(g) == len(w) == NEW
        if rid and g == w:
            continue
        step = next((i for i, (a, b) in enumerate(zip(g, w)) if a != b),
                    None)
        port = _port_forced(tcfg, tp, tcache, unit, prompts[rid], w)
        assert all(np.isfinite(x).all() for x in port[0])
        _hold_routes(port, _ref_forced(jcfg, jp, jcache, UNIT.get(jdt),
                                       prompts[rid], w), tol, step)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float16", "bfloat16"])
def test_half_routing_tables_and_moe_match_reference(arch, dtype):
    """A half MoE FFN on the same half inputs: router logits computed in
    the type and routed in float32, expert choices equal to the
    reference's but at near-ties (:func:`route_tie`), its dispatch tables
    on the reference's routing byte-equal (the gate table float32), and
    ``moe_local`` (the expert ``bmm``s and the shared experts in the
    type, gates cast to it) within the half lane's limit."""
    jcfg, tcfg = jget_reduced(arch), get_reduced(arch)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    p = _moe_params(jcfg, seed=8)
    jp = jqt.cast_tree(jax.tree_util.tree_map(jnp.asarray, p), jdt)
    tp = qt.cast_tree(_tmoe(p), tdt)
    x = np.random.default_rng(9).standard_normal(
        (2, 48, tcfg.d_model)).astype(np.float32)
    jx, tx = jnp.asarray(x).astype(jdt), _t(x).to(tdt)
    xf = (jx.reshape(96, -1), tx.reshape(96, -1))
    with _record_routes(jmoe, "_route", _ref_np, UNIT[tdt]) as jlog:
        ji, jg, ja = jmoe._route(jcfg, jp["router"], xf[0])
    with _record_routes(tmoe, "route", _port_np, UNIT[tdt]) as tlog:
        ti, tg, ta = tmoe.route(tcfg, tp["router"], xf[1])
    assert tg.dtype == ta.dtype == torch.float32
    (_, gap, tie), rows = jlog[0], (tlog[0][0] != jlog[0][0]).any(-1)
    assert (gap[rows] <= tie[rows]).all()
    same = ~rows
    assert np.array_equal(ti.numpy()[same], np.asarray(ji)[same])
    cap = tmoe.expert_capacity(tcfg, 96)
    want = jmoe._dispatch_tables(jcfg, ji, jg, 0, tcfg.moe.n_experts, cap)
    got = tmoe.dispatch_tables(tcfg, _t(ji).long(), _t(jg), cap)
    for g, w in zip(got, want):
        assert g.numpy().tobytes() == np.asarray(w).tobytes()
    assert got[1].dtype == torch.float32
    tout, _ = tmoe.moe_local(tcfg, tp, tx)
    assert tout.dtype == tdt
    if not rows.any():
        jout, _ = jmoe.moe_local(jcfg, jp, jx)
        jout = np.asarray(jout.astype(jnp.float32))
        rel = np.abs(tout.float().numpy() - jout).max() / np.abs(jout).max()
        assert rel <= LANES["fp16" if dtype == "float16" else "bf16"][2]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float16", "bfloat16"])
def test_init_cast_as_drawn_equals_cast_tree(arch, dtype):
    """``init_lm_params(dtype=)`` casts each piece as it is drawn (a
    full-width half tree is built without the whole float32 tree): the
    same tree, byte for byte, as ``cast_tree`` of the float32 draws."""
    tcfg, dt = get_reduced(arch), getattr(torch, dtype)
    want = qt.cast_tree(ttfm.init_lm_params(
        tcfg, torch.Generator().manual_seed(4), "cpu"), dt)
    got = ttfm.init_lm_params(tcfg, torch.Generator().manual_seed(4), "cpu",
                              dtype=dt)
    gl, wl = dict(_leaves(got)), dict(_leaves(want))
    assert gl.keys() == wl.keys()
    assert all(g.dtype == dt and torch.equal(g, wl[k]) for k, g in gl.items())


def test_moe_lanes_through_the_launcher(capsys):
    """``launch.serve --quant`` on reduced dbrx-132b: bf16 and int8 print
    the reference launcher's MiB line (its tree's bytes before and after)
    and serve every request."""
    jcfg = jget_reduced("dbrx-132b")
    jparams = jregistry.init_params(jcfg, jax.random.PRNGKey(0))
    for lane, tree in (("bf16", jqt.cast_tree(jparams, jnp.bfloat16)),
                       ("int8", jptq.quantize_lm_params(jparams))):
        sizes = (f"{jqt.tree_bytes(jparams) / 2**20:.1f} MiB -> "
                 f"{jqt.tree_bytes(tree) / 2**20:.1f} MiB")
        assert tlaunch.main(["--arch", "dbrx-132b", "--reduced", "--device",
                             "cpu", "--quant", lane, "--requests", "3",
                             "--prompt-len", "32", "--max-new", "3"]) == 0
        out = capsys.readouterr().out
        assert f"[serve] quant={lane}: {sizes}" in out, out
        assert "[serve] 3 requests, 9 tokens" in out


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

