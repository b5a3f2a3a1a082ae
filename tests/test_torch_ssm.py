"""Port parity for the Mamba-2 lane: the SSD scan's plain version, the
Mamba-2 layers, the pure SSM LM, the Zamba2-style hybrid and
``mixed_forward_ssm``, against the reference on the same parameters
(the reference's inits, converted by ``convert.ssm_params_from_jax`` /
``hybrid_params_from_jax``) and the same numpy-seeded inputs.

The plain scan is held against the reference's Pallas entry point
(``ssd_ops.ssd``, interpret mode on the CPU), its chunked jnp form
(``ssd_chunked``) and its sequential oracle (``ssd_ref``) at the four
shapes of ``tests/test_kernels.py``.  Models carry perturbed norm
scales, ``conv_b``, ``D`` and ``dt_bias`` so that a misplaced term
shows.  The hybrid runs 12 layers, so the shared block runs at layers 5
and 11 (REDUCED zamba2 has 2 layers and never reaches it).

Tolerances (absolute and relative): the scan 1e-4, as the reference's
own kernel tests hold its kernel (float32 through exponentials of
cumulative log decays, in another summation order); single layers
(conv, one decode step) 1e-5; blocks, whole models, logits and states
1e-4 (the same error through a few layers).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import get_reduced as jget_reduced
from repro.core import seq_mixed_res as jsmr
from repro.kernels.ssd_scan import ops as jssd
from repro.kernels.ssd_scan.ref import ssd_ref
from repro.models import hybrid as jhyb
from repro.models import mamba2 as jm2
from repro.models import registry as jregistry
from repro.models import ssm_lm as jssm
from repro_torch import convert
from repro_torch.configs import get_config, get_reduced
from repro_torch.core import seq_mixed_res as tsmr
from repro_torch.kernels.ssd_scan import ops as tssd
from repro_torch.models import hybrid as thyb
from repro_torch.models import mamba2 as tm2
from repro_torch.models import registry
from repro_torch.models import ssm_lm as tssm
from repro_torch.offload.simulator import to_device

torch.set_num_threads(2)
SCAN_TOL = 1e-4
LAYER_TOL = 1e-5
MODEL_TOL = 1e-4
# (b, T, H, G, N, P, chunk) of tests/test_kernels.py::test_ssd_scan
SHAPES = [(2, 128, 8, 1, 32, 16, 32),
          (1, 200, 16, 2, 64, 32, 64),     # ragged T (chunk padding)
          (2, 64, 4, 4, 16, 64, 32),       # one head per group
          (1, 96, 8, 1, 128, 64, 96)]      # full-size state, one chunk
HYBRID_LAYERS = 12


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


def _scan_inputs(seed, b, T, H, G, N, P):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, T, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, T, H)))).astype(np.float32)
    A = -np.exp(0.5 * rng.standard_normal(H)).astype(np.float32)
    Bm = (0.3 * rng.standard_normal((b, T, G, N))).astype(np.float32)
    Cm = (0.3 * rng.standard_normal((b, T, G, N))).astype(np.float32)
    return x, dt, A, Bm, Cm


# ---------------------------------------------------------------------------
# the SSD scan


@pytest.mark.parametrize("shape", SHAPES)
def test_ssd_scan_plain_matches_reference(shape):
    b, T, H, G, N, P, chunk = shape
    args = _scan_inputs(sum(shape), b, T, H, G, N, P)
    y, s = tssd.ssd_scan_plain(*map(_t, args), chunk)
    jargs = [jnp.asarray(a) for a in args]
    wants = [jssd.ssd(*jargs, chunk, return_final_state=True,
                      interpret=True),
             jm2.ssd_chunked(*jargs, min(chunk, T), return_final_state=True),
             ssd_ref(*jargs)]
    for wy, ws in wants:
        _close(y, wy, SCAN_TOL)
        _close(s, ws, SCAN_TOL)


@pytest.mark.parametrize("cut", [64, 50])
def test_ssd_scan_plain_state_handoff(cut):
    """Two halves chained through ``init_state`` give the whole scan (a
    cut inside a chunk too), and the second half agrees with the
    reference's kernel entry point given the same initial state."""
    b, T, H, G, N, P, chunk = 1, 128, 4, 1, 16, 16, 32
    x, dt, A, Bm, Cm = map(_t, _scan_inputs(3, b, T, H, G, N, P))
    y, s = tssd.ssd_scan_plain(x, dt, A, Bm, Cm, chunk)
    y1, s1 = tssd.ssd_scan_plain(x[:, :cut], dt[:, :cut], A, Bm[:, :cut],
                                 Cm[:, :cut], chunk)
    y2, s2 = tssd.ssd_scan_plain(x[:, cut:], dt[:, cut:], A, Bm[:, cut:],
                                 Cm[:, cut:], chunk, init_state=s1)
    _close(torch.cat([y1, y2], 1), y, SCAN_TOL)
    _close(s2, s, SCAN_TOL)
    jy, js = jssd.ssd(*(jnp.asarray(a[:, cut:].numpy())
                        for a in (x, dt)), jnp.asarray(A.numpy()),
                      *(jnp.asarray(a[:, cut:].numpy()) for a in (Bm, Cm)),
                      chunk, init_state=jnp.asarray(s1.numpy()),
                      return_final_state=True, interpret=True)
    _close(y2, jy, SCAN_TOL)
    _close(s2, js, SCAN_TOL)


def test_ssd_scan_cuda_wrapper_refuses_what_the_kernel_does_not_take():
    x, dt, A, Bm, Cm = map(_t, _scan_inputs(4, 1, 8, 4, 1, 16, 16))
    with pytest.raises(ValueError, match="CUDA"):
        tssd.ssd_scan_cuda(x, dt, A, Bm, Cm, 4)         # CPU tensors
    x2, dt2, A2, Bm2, Cm2 = map(_t, _scan_inputs(4, 1, 8, 4, 1, 24, 16))
    with pytest.raises(ValueError, match="N one of"):
        tssd.ssd_scan_cuda(x2, dt2, A2, Bm2, Cm2, 4)    # N = 24
    assert tssd.KERNEL.launches == 0


# ---------------------------------------------------------------------------
# layers


def test_causal_conv1d_and_conv1d_step():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 9, 12)).astype(np.float32)
    w = rng.standard_normal((4, 12)).astype(np.float32)
    b = rng.standard_normal(12).astype(np.float32)
    _close(tm2.causal_conv1d(_t(x), _t(w), _t(b)),
           jm2.causal_conv1d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)),
           LAYER_TOL)
    state = rng.standard_normal((2, 3, 12)).astype(np.float32)
    got = tm2.conv1d_step(_t(x[:, 0]), _t(state), _t(w), _t(b))
    want = jm2.conv1d_step(jnp.asarray(x[:, 0]), jnp.asarray(state),
                           jnp.asarray(w), jnp.asarray(b))
    for g, c in zip(got, want):
        _close(g, c, LAYER_TOL)


def test_ssd_decode_step():
    rng = np.random.default_rng(6)
    b, H, G, N, P = 2, 8, 2, 16, 16
    x = rng.standard_normal((b, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, H)))).astype(np.float32)
    A = -np.exp(rng.standard_normal(H)).astype(np.float32)
    Bt, Ct = (rng.standard_normal((b, G, N)).astype(np.float32)
              for _ in range(2))
    state = rng.standard_normal((b, H, N, P)).astype(np.float32)
    got = tm2.ssd_decode_step(*map(_t, (x, dt, A, Bt, Ct, state)))
    want = jm2.ssd_decode_step(*map(jnp.asarray, (x, dt, A, Bt, Ct, state)))
    for g, c in zip(got, want):
        _close(g, c, LAYER_TOL)


def _perturb(tree, rng):
    """Norm scales, ``conv_b``, ``D`` and ``dt_bias`` moved off their
    init values (ones, zeros, ones, a fixed range), so a misplaced term
    shows."""
    def walk(t, path=()):
        if isinstance(t, dict):
            return {k: walk(v, path + (k,)) for k, v in t.items()}
        if any("norm" in k or k in ("ln", "ln1", "ln2", "conv_b", "D",
                                    "dt_bias") for k in path):
            return (t + 0.1 * rng.standard_normal(t.shape)).astype(t.dtype)
        return t
    return walk(tree)


@pytest.fixture(scope="module")
def layer():
    cfg = jget_reduced("mamba2-370m")
    p = jax.tree_util.tree_map(np.asarray, jm2.init_mamba2(
        cfg, jax.random.PRNGKey(7), jnp.float32))
    p = _perturb(p, np.random.default_rng(8))
    return cfg, p, {k: _t(v) for k, v in p.items()}


@pytest.mark.parametrize("T", [40, 2])
def test_mamba2_forward_and_mamba_prefill(layer, T):
    """The block (against the reference's jnp path and its Pallas path)
    and the serving prefill's block output and end states; T = 2 is
    shorter than the conv's d_conv - 1 = 3 rows (a zero-padded conv
    state)."""
    jcfg, jp, tp = layer
    tcfg = get_reduced("mamba2-370m")
    x = np.random.default_rng(9).standard_normal(
        (2, T, tcfg.d_model)).astype(np.float32)
    got = tm2.mamba2_forward(tcfg, tp, _t(x))
    for use_kernel in (False, True):
        _close(got, jm2.mamba2_forward(jcfg, jp, jnp.asarray(x),
                                       use_kernel=use_kernel), MODEL_TOL)
    out, state = thyb._mamba_prefill(tcfg, tp, _t(x))
    jout, jstate = jhyb._mamba_prefill(jcfg, jp, jnp.asarray(x))
    _close(out, jout, MODEL_TOL)
    _close(out, got, 1e-6)
    for k in ("conv", "ssm"):
        _close(state[k], jstate[k], MODEL_TOL)


def test_mamba2_decode(layer):
    jcfg, jp, tp = layer
    tcfg = get_reduced("mamba2-370m")
    rng = np.random.default_rng(10)
    st = jax.tree_util.tree_map(
        lambda a: (0.5 * rng.standard_normal(a.shape)).astype(np.float32),
        jm2.init_mamba2_state(jcfg, 2, jnp.float32))
    x = rng.standard_normal((2, 1, tcfg.d_model)).astype(np.float32)
    out, new = tm2.mamba2_decode(tcfg, tp, _t(x),
                                 {k: _t(v) for k, v in st.items()})
    jout, jnew = jm2.mamba2_decode(jcfg, jp, jnp.asarray(x), st)
    _close(out, jout, MODEL_TOL)
    for k in ("conv", "ssm"):
        _close(new[k], jnew[k], MODEL_TOL)


# ---------------------------------------------------------------------------
# configs, registry, parameters


def test_configs_copy_the_reference():
    for arch in ("mamba2-370m", "zamba2-1.2b"):
        for get, jget in ((get_config, jget_config),
                          (get_reduced, jget_reduced)):
            assert dataclasses.asdict(get(arch)) == \
                dataclasses.asdict(jget(arch))
    assert jregistry.count_params_analytic(jget_config("mamba2-370m")) == \
        368_288_256
    assert jregistry.count_params_analytic(jget_config("zamba2-1.2b")) == \
        1_104_853_888


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_shapes(v) for v in tree]
    return tuple(tree.shape)


@pytest.mark.parametrize("arch", ["mamba2-370m", "zamba2-1.2b"])
def test_seeded_init_has_the_reference_shapes_and_scales(arch):
    jcfg = jget_reduced(arch).replace(n_layers=6, d_model=128)
    tcfg = get_reduced(arch).replace(n_layers=6, d_model=128)
    tree = jax.tree_util.tree_map(
        np.asarray, jregistry.init_params(jcfg, jax.random.PRNGKey(0)))
    conv = (convert.ssm_params_from_jax if tcfg.family == "ssm"
            else convert.hybrid_params_from_jax)
    ref = conv(tree, tcfg, "cpu")
    got = registry.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    assert _shapes(got) == _shapes(ref)
    s = tcfg.ssm
    for blk in got["mamba_blocks"]:
        m = blk["mamba"]
        _close(m["A_log"], ref["mamba_blocks"][0]["mamba"]["A_log"], 1e-6)
        dt = torch.nn.functional.softplus(m["dt_bias"])
        assert float(dt.min()) >= s.dt_min * 0.999
        assert float(dt.max()) <= s.dt_max * 1.001
        assert torch.equal(m["D"], torch.ones_like(m["D"]))
        assert torch.equal(m["conv_b"], torch.zeros_like(m["conv_b"]))
    conv_w = torch.cat([b["mamba"]["conv_w"].reshape(-1)
                        for b in got["mamba_blocks"]])
    assert abs(float(conv_w.std()) / 0.1 - 1) < 0.05
    std = np.sqrt(1 - 4 * np.exp(-2) / np.sqrt(2 * np.pi)
                  / (2 * 0.9772498680518208 - 1))   # N(0,1) cut at +-2
    w_in = got["mamba_blocks"][0]["mamba"]["w_in"]
    assert abs(float(w_in.std()) / (std / np.sqrt(w_in.shape[0])) - 1) < 0.03
    assert float(w_in.abs().max()) <= 2 / np.sqrt(w_in.shape[0]) + 1e-6


@pytest.mark.parametrize("arch", ["mamba2-370m", "zamba2-1.2b"])
def test_decode_state_layout_matches_reference(arch):
    jcfg = jget_reduced(arch).replace(n_layers=HYBRID_LAYERS)
    tcfg = get_reduced(arch).replace(n_layers=HYBRID_LAYERS)
    want = _shapes(jax.tree_util.tree_map(
        np.asarray, jregistry.init_decode_state(jcfg, 3, 20, jnp.float32)))
    got = registry.init_decode_state(tcfg, 3, 20, device="cpu")
    assert _shapes(got) == want
    assert thyb.n_shared_calls(tcfg) == jhyb.n_shared_calls(jcfg) == 2


# ---------------------------------------------------------------------------
# whole models


def _model(arch, layers):
    jcfg = jget_reduced(arch).replace(n_layers=layers)
    tcfg = get_reduced(arch).replace(n_layers=layers)
    tree = jax.tree_util.tree_map(
        np.asarray, jregistry.init_params(jcfg, jax.random.PRNGKey(0)))
    tree = _perturb(tree, np.random.default_rng(1))
    conv = (convert.ssm_params_from_jax if tcfg.family == "ssm"
            else convert.hybrid_params_from_jax)
    return (jcfg, tcfg, jax.tree_util.tree_map(jnp.asarray, tree),
            conv(tree, tcfg, "cpu"))


@pytest.fixture(scope="module", params=["reduced", "four_layers"])
def ssm_model(request):
    return _model("mamba2-370m", 2 if request.param == "reduced" else 4)


@pytest.fixture(scope="module")
def hybrid_model():
    return _model("zamba2-1.2b", HYBRID_LAYERS)


def _tokens(rng, cfg, B, T):
    return rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)


def _close_tree(got, want, tol):
    if isinstance(got, dict):
        assert got.keys() == want.keys()
        for k in got:
            _close_tree(got[k], want[k], tol)
    else:
        _close(got, want, tol)


def _prefill_and_decode(model, T, steps=3, S=None):
    """Prefill B = 2 prompts of T tokens, then ``steps`` decode steps;
    hidden states, logits and every state / cache against the
    reference's after each call."""
    jcfg, tcfg, jp, tp = model
    rng = np.random.default_rng(T)
    B, S = 2, S or T + steps + 4
    toks = _tokens(rng, tcfg, B, T)
    js = jregistry.init_decode_state(jcfg, B, S, jnp.float32)
    jh, js, _ = jregistry.prefill(jcfg, jp, {"tokens": jnp.asarray(toks)},
                                  js)
    ts = registry.init_decode_state(tcfg, B, S, device="cpu")
    th, ts, _ = registry.prefill(tcfg, tp, {"tokens": _t(toks).long()}, ts)
    _close(th, jh, MODEL_TOL)
    _close_tree(ts, js, MODEL_TOL)
    for step in range(steps):
        tok = _tokens(rng, tcfg, B, 1)
        jl, js = jregistry.decode_step(jcfg, jp, jnp.asarray(tok), T + step,
                                       js)
        tl, ts = registry.decode_step(tcfg, tp, _t(tok).long(), T + step, ts)
        _close(tl, jl, MODEL_TOL)
    _close_tree(ts, js, MODEL_TOL)


@pytest.mark.parametrize("T", [16, 80])
def test_ssm_prefill_and_decode_logits_and_states(ssm_model, T):
    """T = 16 runs one chunk of 16; T = 80 three chunks of 32, the last
    ragged."""
    _prefill_and_decode(ssm_model, T)


def test_ssm_forward_hidden(ssm_model):
    jcfg, tcfg, jp, tp = ssm_model
    toks = _tokens(np.random.default_rng(11), tcfg, 2, 48)
    _close(tssm.forward_hidden(tcfg, tp, _t(toks).long())[0],
           jssm.forward_hidden(jcfg, jp, jnp.asarray(toks))[0], MODEL_TOL)


@pytest.mark.parametrize("beta", [1, 2])
def test_mixed_forward_ssm(ssm_model, beta):
    """The 1-D technique on the SSM backbone: layers [0, Lb) on the pooled
    sequence, then the restore (Lb = 0 at beta 1 on the 2-layer model)."""
    jcfg, tcfg, jp, tp = ssm_model
    T = 64
    toks = _tokens(np.random.default_rng(12 + beta), tcfg, 2, T)
    pack = tsmr.build_seq_pack(np.array([1, 0, 1, 1]), 3,
                               tsmr.seq_partition(tcfg, T))
    got, _ = tsmr.mixed_forward_ssm(
        tcfg, tp, _t(toks).long(),
        {k: torch.from_numpy(v.astype(np.int64)) for k, v in pack.items()},
        beta)
    want, _ = jsmr.mixed_forward_ssm(
        jcfg, jp, jnp.asarray(toks),
        {k: jnp.asarray(v) for k, v in pack.items()}, beta)
    _close(got, want, MODEL_TOL)


def test_hybrid_prefill_and_decode_logits_and_caches(hybrid_model):
    """12 layers: the shared block runs at layers 5 and 11 (KV slots 0
    and 1) in the prefill and in every decode step."""
    _prefill_and_decode(hybrid_model, 40)


def test_hybrid_forward_hidden(hybrid_model):
    jcfg, tcfg, jp, tp = hybrid_model
    toks = _tokens(np.random.default_rng(13), tcfg, 2, 40)
    _close(thyb.forward_hidden(tcfg, tp, _t(toks).long())[0],
           jhyb.forward_hidden(jcfg, jp, jnp.asarray(toks))[0], MODEL_TOL)


# ---------------------------------------------------------------------------
# on the card (skipped where there is none; chip_smoke.py phases 9-12 run
# the same comparisons at full width)


@pytest.mark.cuda
def test_ssd_scan_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (chip_smoke.py phase 9 "
                    "runs this check on the H100)")
    for shape in SHAPES + [(2, 300, 8, 1, 128, 64, 256)]:
        b, T, H, G, N, P, chunk = shape
        x, dt, A, Bm, Cm = (_t(a).cuda() for a in
                            _scan_inputs(sum(shape), b, T, H, G, N, P))
        s0 = torch.randn((b, H, N, P), device="cuda")
        for init in (None, s0):
            y, s = tssd.ssd_scan_cuda(x, dt, A, Bm, Cm, chunk, init)
            yp, sp = tssd.ssd_scan_plain(x, dt, A, Bm, Cm, chunk, init)
            assert float((y - yp).abs().max() / yp.abs().max()) <= SCAN_TOL
            assert float((s - sp).abs().max() / sp.abs().max()) <= SCAN_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["mamba2-370m", "zamba2-1.2b"])
def test_ssm_on_card_matches_cpu(arch):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (chip_smoke.py phase 12 "
                    "runs this check on the H100 at full width)")
    tcfg = get_reduced(arch).replace(n_layers=HYBRID_LAYERS)
    tp = registry.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    tp_gpu = to_device(tp, torch.device("cuda"))
    toks = _t(_tokens(np.random.default_rng(14), tcfg, 2, 80)).long()
    out = []
    for dev, params in (("cpu", tp), ("cuda", tp_gpu)):
        st = registry.init_decode_state(tcfg, 2, 88, device=dev)
        h, st, _ = registry.prefill(tcfg, params, {"tokens": toks.to(dev)},
                                    st)
        lg, _ = registry.decode_step(tcfg, params, toks[:, :1].to(dev), 80,
                                     st)
        out.append((h.cpu(), lg.cpu()))
    for a, b in zip(*out):
        assert float((a - b).abs().max() / b.abs().max()) <= 1e-3
