"""Port parity for the int8 LM serving lane (float32 activations):
``repro_torch.quant.ptq.quantize_lm_params`` and ``ServeEngine`` on an
int8 tree against ``repro.quant.ptq.quantize_lm_params`` and the
reference engine (its CPU/XLA lane).

Codes and scales are byte-equal: the port quantizes its per-layer tree
(q/k/v fused into ``w_qkv``) and must give the bytes of the reference's
scan-stacked, per-(layer, column) quantized tree converted by
``convert.py``.  mamba2-370m holds none of the target names and comes
back unchanged.  Greedy tokens of the port's int8 engine equal the
reference engine's on the same quantized tree; where one differs, the
reference's top-2 logit margin at that step must be below LOGIT_TOL (a
tie within float32 noise, as in ``test_torch_engine.py``).
"""
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jget_reduced
from repro.models import registry as jregistry
from repro.models import transformer as jtfm
from repro.quant import ptq as jptq
from repro.serve.engine import ServeConfig as JServeConfig
from repro.serve.engine import ServeEngine as JServeEngine
from repro.serve.request import Request as JRequest
from repro_torch import convert
from repro_torch.configs import get_reduced
from repro_torch.quant import ptq as tptq
from repro_torch.quant import qtensor as qt
from repro_torch.serve.engine import ServeConfig, ServeEngine
from repro_torch.serve.request import Request

torch.set_num_threads(2)
T, NEW = 32, 4
LOGIT_TOL = 1e-4
LAYERS = {"qwen3-4b": None, "zamba2-1.2b": 6, "mamba2-370m": 2}
CONVERT = {"dense": convert.lm_params_from_jax,
           "ssm": convert.ssm_params_from_jax,
           "hybrid": convert.hybrid_params_from_jax}


def _cfgs(arch):
    jcfg, tcfg = jget_reduced(arch), get_reduced(arch)
    if LAYERS[arch]:
        jcfg = jcfg.replace(n_layers=LAYERS[arch])
        tcfg = tcfg.replace(n_layers=LAYERS[arch])
    return jcfg, tcfg


@pytest.fixture(scope="module", params=sorted(LAYERS))
def setup(request):
    jcfg, tcfg = _cfgs(request.param)
    jparams = jregistry.init_params(jcfg, jax.random.PRNGKey(0))
    conv = CONVERT[tcfg.family]
    tparams = conv(jax.tree_util.tree_map(np.asarray, jparams), tcfg, "cpu")
    jq = jptq.quantize_lm_params(jparams)
    tq_ref = conv(jax.tree_util.tree_map(np.asarray, jq), tcfg, "cpu")
    return jcfg, tcfg, jparams, tparams, jq, tq_ref


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    else:
        yield path, tree


def test_quantize_lm_params_byte_equal_to_reference(setup):
    jcfg, tcfg, _, tparams, jq, tq_ref = setup
    got = tptq.quantize_lm_params(tparams)
    got_leaves, want_leaves = dict(_leaves(got)), dict(_leaves(tq_ref))
    assert got_leaves.keys() == want_leaves.keys()
    n_quant = 0
    for path, g in got_leaves.items():
        w = want_leaves[path]
        assert type(g) is type(w), path
        if isinstance(g, qt.QuantTensor):
            n_quant += 1
            assert torch.equal(g.q, w.q) and torch.equal(g.scale, w.scale), \
                path
            assert g.out_dtype == w.out_dtype == "float32"
            assert g.q.t().is_contiguous()          # the GEMM's B layout
        else:
            assert torch.equal(g, w), path
    # every target the reference quantized is a QuantTensor here: q/k/v
    # fuse into one, each stacked weight becomes n_layers of them
    want = 0
    for path, leaf in _leaves(jq):
        if isinstance(leaf, jptq.qt.QuantTensor):
            name = path.rsplit("/", 1)[-1]
            layers = leaf.q.shape[0] if leaf.q.ndim == 3 else 1
            want += layers if name not in ("w_k", "w_v") else 0
    assert n_quant == want
    if tcfg.family == "ssm":
        assert n_quant == 0
    else:
        assert n_quant > 0
    assert qt.tree_bytes(got) == qt.tree_bytes(tq_ref)


@pytest.mark.parametrize("out", ["float16", "bfloat16"])
def test_quantize_lm_params_half_outputs_byte_equal_to_reference(setup, out):
    """``out_dtype`` fp16 / bf16, as the reference's ``quantize_lm_params(
    params, out_dtype)``: the same codes and scales as its converted tree,
    every QuantTensor's output type the half one, the other leaves
    untouched."""
    jcfg, tcfg, jparams, tparams, _, _ = setup
    jq = jptq.quantize_lm_params(jparams, out_dtype=getattr(jnp, out))
    want = dict(_leaves(CONVERT[tcfg.family](
        jax.tree_util.tree_map(np.asarray, jq), tcfg, "cpu")))
    got = dict(_leaves(tptq.quantize_lm_params(
        tparams, out_dtype=getattr(torch, out))))
    assert got.keys() == want.keys()
    for path, g in got.items():
        w = want[path]
        assert type(g) is type(w), path
        if isinstance(g, qt.QuantTensor):
            assert torch.equal(g.q, w.q) and torch.equal(g.scale, w.scale)
            assert g.out_dtype == w.out_dtype == out, path
        else:
            assert torch.equal(g, w), path


def test_mamba2_tree_comes_back_unchanged():
    jcfg, tcfg = _cfgs("mamba2-370m")
    jparams = jregistry.init_params(jcfg, jax.random.PRNGKey(1))
    tparams = convert.ssm_params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams), tcfg, "cpu")
    got = tptq.quantize_lm_params(tparams)
    for (pa, a), (pb, b) in zip(_leaves(got), _leaves(tparams)):
        assert pa == pb and a is b
    jq = jptq.quantize_lm_params(jparams)
    assert not any(isinstance(x, jptq.qt.QuantTensor)
                   for _, x in _leaves(jq))


def _ref_margins(jcfg, jparams, prompt, tokens):
    """The reference's top-2 logit margin at every greedy step of one
    request alone, teacher-forced on ``tokens``."""
    state = jregistry.init_decode_state(jcfg, 1, len(prompt) + NEW + 8,
                                        jnp.float32)
    hidden, state, _ = jregistry.prefill(
        jcfg, jparams, {"tokens": jnp.asarray(prompt)[None]}, state)
    logits = [jtfm.logits_from_hidden(jcfg, jparams, hidden[:, -1:])]
    for step, tok in enumerate(tokens[:-1], start=1):
        lg, state = jregistry.decode_step(
            jcfg, jparams, jnp.asarray([[tok]], jnp.int32),
            len(prompt) + step - 1, state)
        logits.append(lg)
    return [float(np.diff(np.sort(np.asarray(lg).reshape(-1))[-2:])[0])
            for lg in logits]


def test_int8_engine_tokens_match_reference(setup):
    """Three requests, padded to the B = 4 bucket, through both engines
    on one int8 tree (the reference's, converted)."""
    jcfg, tcfg, _, _, jq, tq_ref = setup
    kw = dict(max_batch=4, max_len=T + NEW + 8, buckets=(T,))
    jeng = JServeEngine(jcfg, jq, JServeConfig(**kw))
    teng = ServeEngine(tcfg, tq_ref, ServeConfig(device="cpu", **kw))
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, tcfg.vocab_size, (T,)).astype(np.int32)
               for _ in range(3)]
    for rid, p in enumerate(prompts):
        jeng.submit(JRequest(rid=rid, prompt=p, max_new_tokens=NEW))
        teng.submit(Request(rid=rid, prompt=p, max_new_tokens=NEW))
    want = {r.rid: r.tokens for r in jeng.run()}
    got = {r.rid: r.tokens for r in teng.run()}
    assert sorted(got) == sorted(want)
    for rid, w in want.items():
        g = got[rid]
        assert len(g) == len(w) == NEW
        if g != w:
            step = next(i for i, (a, b) in enumerate(zip(g, w)) if a != b)
            margin = _ref_margins(jcfg, jq, prompts[rid], w)[step]
            assert margin < LOGIT_TOL, (rid, step, g, w, margin)


def test_launch_serve_int8_subprocess():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "qwen3-4b", "--quant", "int8", "--reduced", "--device", "cpu",
         "--requests", "2", "--prompt-len", "32", "--max-new", "4"],
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    line = next(ln for ln in out.stdout.splitlines() if "MiB ->" in ln)
    before, after = (float(x.split()[0]) for x in
                     line.split(":", 1)[1].split("->"))
    assert after < before
    assert "[serve] 2 requests, 8 tokens" in out.stdout


@pytest.mark.parametrize("lane", ["fp16", "bf16"])
def test_launch_serve_refuses_half_lanes(lane):
    """The half lanes, once refused, serve: the reference's MiB line for
    the cast tree, then every request's tokens.  A lane the reference
    lacks is still refused by argparse."""
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--quant", lane,
         "--reduced", "--device", "cpu", "--requests", "2",
         "--prompt-len", "32", "--max-new", "4"],
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert f"[serve] quant={lane}: 0.4 MiB -> 0.2 MiB" in out.stdout
    assert "[serve] 2 requests, 8 tokens" in out.stdout
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--quant",
         f"{lane}x", "--reduced", "--device", "cpu"],
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 2 and "invalid choice" in out.stderr
