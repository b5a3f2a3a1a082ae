"""Port parity for the half-precision LM serving lanes: fp16 and bf16
trees (``qtensor.cast_tree``, ``launch/serve.py --quant fp16|bf16``) and
a bf16 cache under a float32 tree (``ServeConfig.cache_dtype``), against
the reference's (``repro.quant.qtensor.cast_tree``,
``repro.serve.engine.ServeConfig.cache_dtype``) on the same seeded
weights, for reduced qwen3-4b, mamba2-370m (2 layers) and zamba2-1.2b
(6 layers).

Tolerances and why:
  * the cast trees are byte-equal: one round to nearest even of the same
    float32 weights in both packages;
  * prefill logits: the two packages run the same half arithmetic but
    sum in other orders (matmul blocking, softmax and norm reductions)
    and round intermediates at other places, so they differ by the half
    type's rounding of the largest logit, not more: fp16 4e-3, bf16 3e-2
    of the largest |logit| (these trees show 1.2e-3 / 9.3e-3 on qwen3
    and mamba2, 3.2e-3 / 2.5e-2 on zamba2, whose shared block runs six
    times on the same residual stream).  A float32 tree over a bf16
    cache reads the cache's rounding only in decode, so its prefill is
    float32's: 1e-4 (these show 8e-7 at most);
  * greedy tokens equal the reference engine's wherever the reference's
    top-2 logit margin, teacher-forced on its own tokens, exceeds twice
    the largest difference between the two packages' logits at that
    step: below that a near-tie may break either way.
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
from repro.quant import qtensor as jqt
from repro.serve.engine import ServeConfig as JServeConfig
from repro.serve.engine import ServeEngine as JServeEngine
from repro.serve.request import Request as JRequest
from repro_torch import convert
from repro_torch.configs import get_reduced
from repro_torch.kernels import dispatch
from repro_torch.models import registry
from repro_torch.models import transformer as tfm
from repro_torch.quant import qtensor as qt
from repro_torch.serve.engine import ServeConfig, ServeEngine
from repro_torch.serve.request import Request

torch.set_num_threads(2)
T, NEW = 32, 4
LAYERS = {"qwen3-4b": None, "zamba2-1.2b": 6, "mamba2-370m": 2}
CONVERT = {"dense": convert.lm_params_from_jax,
           "ssm": convert.ssm_params_from_jax,
           "hybrid": convert.hybrid_params_from_jax}
# lane -> (tree dtype, cache dtype) in each package, and the logit limit
LANES = {
    "fp16": ((jnp.float16, jnp.float32), (torch.float16, torch.float32),
             4e-3),
    "bf16": ((jnp.bfloat16, jnp.float32), (torch.bfloat16, torch.float32),
             3e-2),
    "bf16-cache": ((jnp.float32, jnp.bfloat16),
                   (torch.float32, torch.bfloat16), 1e-4),
}


def _cfgs(arch):
    jcfg, tcfg = jget_reduced(arch), get_reduced(arch)
    if LAYERS[arch]:
        jcfg = jcfg.replace(n_layers=LAYERS[arch])
        tcfg = tcfg.replace(n_layers=LAYERS[arch])
    return jcfg, tcfg


@pytest.fixture(scope="module", params=sorted(LAYERS))
def arch(request):
    jcfg, tcfg = _cfgs(request.param)
    jparams = jregistry.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = CONVERT[tcfg.family](jax.tree_util.tree_map(np.asarray,
                                                          jparams),
                                   tcfg, "cpu")
    return jcfg, tcfg, jparams, tparams


def _lane(arch, lane):
    jcfg, tcfg, jparams, tparams = arch
    (jdt, jcache), (tdt, tcache), tol = LANES[lane]
    jp = jqt.cast_tree(jparams, jdt) if jdt != jnp.float32 else jparams
    tp = qt.cast_tree(tparams, tdt) if tdt != torch.float32 else tparams
    return jcfg, tcfg, jp, tp, jcache, tcache, tol


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    else:
        yield path, tree


@pytest.mark.parametrize("lane", ["fp16", "bf16"])
def test_cast_tree_equals_converted_reference(arch, lane):
    jcfg, tcfg, jp, tp, *_ = _lane(arch, lane)
    want = CONVERT[tcfg.family](jax.tree_util.tree_map(np.asarray, jp),
                                tcfg, "cpu")
    got, ref = dict(_leaves(tp)), dict(_leaves(want))
    assert got.keys() == ref.keys()
    for path, g in got.items():
        assert g.dtype == ref[path].dtype == LANES[lane][1][0], path
        assert torch.equal(g, ref[path]), path
    assert qt.tree_bytes(tp) == jqt.tree_bytes(jp)


def _logits(registry_, tfm_, cfg, params, state, prompt, tokens, to_np):
    """Teacher-forced logits of one request: the prefill's, then one a
    decode step on each of ``tokens`` but the last."""
    hidden, state, _ = registry_.prefill(cfg, params, {"tokens": prompt},
                                         state)
    out = [to_np(tfm_.logits_from_hidden(cfg, params, hidden[:, -1:]))]
    for step, tok in enumerate(tokens[:-1], start=1):
        lg, state = registry_.decode_step(
            cfg, params, tok, prompt.shape[1] + step - 1, state)
        out.append(to_np(lg))
    return [o.reshape(-1).astype(np.float32) for o in out]


def _ref_logits(jcfg, jp, jcache, prompt, tokens):
    state = jregistry.init_decode_state(jcfg, 1, T + NEW + 8, jcache)
    return _logits(jregistry, jtfm, jcfg, jp, state,
                   jnp.asarray(prompt)[None],
                   [jnp.asarray([[t]], jnp.int32) for t in tokens],
                   lambda a: np.asarray(a.astype(jnp.float32)))


def _port_logits(tcfg, tp, tcache, prompt, tokens):
    state = registry.init_decode_state(tcfg, 1, T + NEW + 8, tcache, "cpu")
    with torch.no_grad():
        return _logits(registry, tfm, tcfg, tp, state,
                       torch.as_tensor(prompt)[None],
                       [torch.tensor([[t]], dtype=torch.int32)
                        for t in tokens],
                       lambda a: a.float().numpy())


@pytest.mark.parametrize("lane", sorted(LANES))
def test_half_engine_matches_reference(arch, lane):
    """Three requests, padded to the B = 4 bucket, through both engines;
    prefill logits of the first request teacher-forced in both
    packages."""
    jcfg, tcfg, jp, tp, jcache, tcache, tol = _lane(arch, lane)
    kw = dict(max_batch=4, max_len=T + NEW + 8, buckets=(T,))
    jeng = JServeEngine(jcfg, jp, JServeConfig(cache_dtype=jcache, **kw))
    teng = ServeEngine(tcfg, tp, ServeConfig(device="cpu",
                                             cache_dtype=tcache, **kw))
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, tcfg.vocab_size, (T,)).astype(np.int32)
               for _ in range(3)]
    for rid, p in enumerate(prompts):
        jeng.submit(JRequest(rid=rid, prompt=p, max_new_tokens=NEW))
        teng.submit(Request(rid=rid, prompt=p, max_new_tokens=NEW))
    teng.warmup()       # a decode step on fresh states: mixed types
    dispatch.reset_launch_counts()
    want = {r.rid: r.tokens for r in jeng.run()}
    got = {r.rid: r.tokens for r in teng.run()}
    assert teng.stats.steady_compiles == 0
    assert set(dispatch.launch_counts().values()) == {0}   # CPU: plain
    assert sorted(got) == sorted(want)
    for rid, w in want.items():
        g = got[rid]
        assert len(g) == len(w) == NEW
        if rid and g == w:
            continue
        ref = _ref_logits(jcfg, jp, jcache, prompts[rid], w)
        port = _port_logits(tcfg, tp, tcache, prompts[rid], w)
        assert all(np.isfinite(x).all() for x in port)
        if rid == 0:
            rel = np.abs(port[0] - ref[0]).max() / np.abs(ref[0]).max()
            assert rel <= tol, (lane, rel)
        if g != w:
            step = next(i for i, (a, b) in enumerate(zip(g, w)) if a != b)
            margin = float(np.diff(np.sort(ref[step])[-2:])[0])
            diff = float(np.abs(port[step] - ref[step]).max())
            assert margin <= 2 * diff, (rid, step, g, w, margin, diff)


@pytest.mark.parametrize("lane", ["fp16", "bf16"])
def test_launch_serve_half_subprocess(lane):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "qwen3-4b", "--quant", lane, "--reduced", "--device", "cpu",
         "--requests", "2", "--prompt-len", "32", "--max-new", "4"],
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    line = next(ln for ln in out.stdout.splitlines() if "MiB ->" in ln)
    before, after = (float(x.split()[0]) for x in
                     line.split(":", 1)[1].split("->"))
    assert after < before
    assert "[serve] 2 requests, 8 tokens" in out.stdout


def test_ssd_scan_casts_half_inputs_to_float32():
    """``dispatch.ssd_scan`` runs the scan in float32 on half inputs, as
    the reference's ``ssd_scan/ops.py`` does: y float32, the final state
    in the incoming state's type."""
    g = torch.Generator().manual_seed(0)
    b, L, H, P, G, N = 1, 40, 4, 16, 1, 16
    x = torch.randn(b, L, H, P, generator=g)
    dt = torch.rand(b, L, H, generator=g) * 0.1
    A = -torch.rand(H, generator=g)
    Bm, Cm = (torch.randn(b, L, G, N, generator=g) for _ in range(2))
    s0 = torch.randn(b, H, N, P, generator=g)
    h = [t.to(torch.bfloat16) for t in (x, dt, A, Bm, Cm, s0)]
    y, s = dispatch.ssd_scan(*h[:5], 16, init_state=h[5])
    want_y, want_s = dispatch.ssd_scan(*(t.float() for t in h[:5]), 16,
                                       init_state=h[5].float())
    assert y.dtype == torch.float32 and s.dtype == torch.bfloat16
    assert torch.equal(y, want_y) and torch.equal(s, want_s.bfloat16())
