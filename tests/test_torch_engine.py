"""Port parity for the LM serving engine: ``repro_torch.serve.engine``
against the reference ``repro.serve.engine.ServeEngine`` (its CPU/XLA
lane) on the same parameters (qwen3-4b ``REDUCED`` from the reference's
``init_params``, converted; for the SSM lane mamba2-370m ``REDUCED`` and
zamba2-1.2b ``REDUCED`` at 6 layers, so its shared block runs) and the
same requests.

Wave keys and wave formation must be equal.  Greedy tokens must be equal
on plain, mixed, reuse-session, padded-B (3 -> 4) and EOS waves; where a
token differs, the reference's top-2 logit margin at that step must be
below the logits tolerance (1e-4, as in ``test_torch_lm.py``): a tie
within float32 noise is not a fault, any other mismatch is.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jget_reduced
from repro.core import seq_mixed_res as jsmr
from repro.models import registry as jregistry
from repro.models import transformer as jtfm
from repro.serve.engine import ServeConfig as JServeConfig
from repro.serve.engine import ServeEngine as JServeEngine
from repro.serve.request import Request as JRequest
from repro_torch import convert
from repro_torch.configs import get_reduced
from repro_torch.launch import serve as tlaunch
from repro_torch.offload.simulator import to_device
from repro_torch.serve.engine import ServeConfig, ServeEngine
from repro_torch.serve.request import Request

torch.set_num_threads(2)
ARCH = "qwen3-4b"
T, NEW = 32, 4
LOGIT_TOL = 1e-4


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = jget_reduced(ARCH), get_reduced(ARCH)
    jparams = jregistry.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = convert.lm_params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams), tcfg, "cpu")
    return jcfg, tcfg, jparams, tparams


def _engines(setup, **kw):
    jcfg, tcfg, jparams, tparams = setup
    return (JServeEngine(jcfg, jparams, JServeConfig(**kw)),
            ServeEngine(tcfg, tparams, ServeConfig(device="cpu", **kw)))


def _submit(engines, rid, prompt, **kw):
    engines[0].submit(JRequest(rid=rid, prompt=prompt, **kw))
    engines[1].submit(Request(rid=rid, prompt=prompt, **kw))


def _ref_steps(setup, prompt, tokens, pooled_mask, beta):
    """The reference's greedy token and top-2 logit margin at every step
    of one request run alone, teacher-forced on ``tokens``."""
    jcfg, _, jparams, _ = setup
    Tp = len(prompt)
    state = jregistry.init_decode_state(jcfg, 1, Tp + NEW + 8, jnp.float32)
    toks = jnp.asarray(prompt)[None]
    if pooled_mask is None:
        hidden, state, _ = jregistry.prefill(jcfg, jparams,
                                             {"tokens": toks}, state)
    else:
        part = jsmr.seq_partition(jcfg, Tp)
        pack = jsmr.build_seq_pack(pooled_mask, int(pooled_mask.sum()), part)
        hidden, state, _ = jsmr.mixed_prefill(
            jcfg, jparams, toks, {k: jnp.asarray(v) for k, v in
                                  pack.items()}, beta, state)
    logits = [jtfm.logits_from_hidden(jcfg, jparams, hidden[:, -1:])]
    for step, tok in enumerate(tokens[:-1], start=1):
        lg, state = jregistry.decode_step(
            jcfg, jparams, jnp.asarray([[tok]], jnp.int32), Tp + step - 1,
            state)
        logits.append(lg)
    flat = [np.asarray(lg).reshape(-1) for lg in logits]
    return ([int(np.argmax(f)) for f in flat],
            [float(np.diff(np.sort(f)[-2:])[0]) for f in flat])


def _assert_same_tokens(setup, jresp, tresp, prompts, pooled=None, beta=0):
    assert sorted(jresp) == sorted(tresp)
    for rid, want in jresp.items():
        got = tresp[rid]
        assert len(got) == len(want), rid
        if got == want:
            continue
        step = next(i for i, (a, b) in enumerate(zip(got, want)) if a != b)
        margin = _ref_steps(setup, prompts[rid], want,
                            None if pooled is None else pooled[rid],
                            beta)[1][step]
        assert margin < LOGIT_TOL, (rid, step, got, want, margin)


def _run(engines):
    return [{r.rid: r.tokens for r in e.run()} for e in engines]


def _prompts(rng, cfg, n):
    return [rng.integers(0, cfg.vocab_size, (T,)).astype(np.int32)
            for _ in range(n)]


# ---------------------------------------------------------------------------
# host-side wave formation


def test_wave_keys_and_wave_order_match_reference(setup):
    """Masks, betas, reuse sessions (cold, warm, stale) and a cap: the
    same keys and the same waves in the same order."""
    engines = (JServeEngine(None, None, JServeConfig(
                   max_batch=3, buckets=(16, T), reuse_max_age=2)),
               ServeEngine(None, None, ServeConfig(
                   max_batch=3, buckets=(16, T), reuse_max_age=2,
                   device="cpu")))
    for e in engines:
        e.session(7, 2).note(np.zeros((0,), np.int32), beta=2, frame=0)
        e.session(8, 2).note(np.arange(2), beta=2, frame=0)
        e.session(8, 2).note(np.arange(2), beta=2, frame=1)
    rng = np.random.default_rng(0)
    m01, m10 = np.array([0, 1], np.int32), np.array([1, 0], np.int32)
    specs = [dict(), dict(low_span_mask=m01, beta=2),
             dict(low_span_mask=m10, beta=2), dict(low_span_mask=m01),
             dict(reuse_span_mask=m10, beta=2, client_id=7),
             dict(reuse_span_mask=m10, beta=2, client_id=8),
             dict(reuse_span_mask=m10, beta=3, client_id=7),
             dict(low_span_mask=m01, reuse_span_mask=m01, beta=2,
                  client_id=7),
             dict(low_span_mask=np.ones(2, np.int32), beta=1)] * 2
    for rid, kw in enumerate(specs):
        n = 12 if rid % 5 == 0 else T
        _submit(engines, rid, rng.integers(0, 100, (n,)).astype(np.int32),
                **kw)
    jkeys = [engines[0]._wave_key(r) for r in engines[0].queue]
    assert [engines[1]._wave_key(r) for r in engines[1].queue] == jkeys
    assert len(set(jkeys)) >= 6
    waves = [[], []]
    for e, out in zip(engines, waves):
        while e.queue:
            out.append([r.rid for r in e._form_wave()])
    assert waves[0] == waves[1]
    assert engines[0].batch_bucket(3) == engines[1].batch_bucket(3) == 4


# ---------------------------------------------------------------------------
# greedy tokens through the model


def test_plain_padded_wave_tokens_match_reference(setup):
    """Three requests pad to the B = 4 bucket; a fourth with a shorter
    prompt is right-padded with its last token."""
    engines = _engines(setup, max_batch=4, max_len=T + NEW + 8,
                       buckets=(T,))
    rng = np.random.default_rng(1)
    prompts = _prompts(rng, setup[1], 3)
    for rid, p in enumerate(prompts):
        _submit(engines, rid, p, max_new_tokens=NEW)
    jresp, tresp = _run(engines)
    assert len(engines[1].wave_latencies) == 1
    _assert_same_tokens(setup, jresp, tresp, dict(enumerate(prompts)))
    # the margin oracle reproduces the reference engine's tokens
    assert _ref_steps(setup, prompts[2], jresp[2], None, 0)[0] == jresp[2]


def test_mixed_waves_tokens_match_reference(setup):
    """Mixed-granularity prefill at beta 2 and 4 with two span layouts
    (separate waves), and a request whose n_low buckets away."""
    jcfg, tcfg = setup[0], setup[1]
    engines = _engines(setup, max_batch=4, max_len=T + NEW + 8,
                       buckets=(T,))
    rng = np.random.default_rng(2)
    prompts = dict(enumerate(_prompts(rng, tcfg, 4)))
    masks = {0: np.array([1, 0]), 1: np.array([0, 1]),
             2: np.array([1, 0]), 3: np.array([1, 1])}
    betas = {0: 2, 1: 2, 2: 4, 3: 2}
    for rid in prompts:
        _submit(engines, rid, prompts[rid], max_new_tokens=NEW,
                low_span_mask=masks[rid].astype(np.int32), beta=betas[rid])
    jresp, tresp = _run(engines)
    assert len(engines[1].wave_latencies) == len(engines[0].wave_latencies)
    for beta in (2, 4):
        rids = [r for r in prompts if betas[r] == beta]
        _assert_same_tokens(setup, {r: jresp[r] for r in rids},
                            {r: tresp[r] for r in rids}, prompts,
                            pooled=masks, beta=beta)
    assert _ref_steps(setup, prompts[1], jresp[1], masks[1], 2)[0] == \
        jresp[1]


def test_reuse_session_waves_match_reference(setup):
    """A cold session serves plain and warms; the warm session pools its
    reuse span; both engines' sessions age alike."""
    engines = _engines(setup, max_batch=4, max_len=T + NEW + 8,
                       buckets=(T,))
    rng = np.random.default_rng(3)
    reuse = np.array([1, 0], np.int32)
    prompts = {}
    for rid in range(2):
        prompts[rid] = _prompts(rng, setup[1], 1)[0]
        _submit(engines, rid, prompts[rid], max_new_tokens=NEW,
                reuse_span_mask=reuse, beta=2, client_id=1)
        jresp, tresp = _run(engines)
        pooled = None if rid == 0 else {rid: reuse}
        _assert_same_tokens(setup, jresp, tresp, prompts, pooled=pooled,
                            beta=2)
        js, ts = engines[0].sessions[1], engines[1].sessions[1]
        assert (js.warm, js.beta, js.age.tolist()) == \
            (ts.warm, ts.beta, ts.age.tolist())
    assert engines[1].sessions[1].age[0] == 1


def test_eos_wave_matches_reference(setup):
    """Per-slot EOS: a request stops at its end token, the others run to
    max_new_tokens (the host reads every step)."""
    engines = _engines(setup, max_batch=4, max_len=T + 12 + 8, buckets=(T,))
    rng = np.random.default_rng(4)
    prompts = dict(enumerate(_prompts(rng, setup[1], 2)))
    probe = ServeEngine(setup[1], setup[3], ServeConfig(
        max_batch=4, max_len=T + 12 + 8, buckets=(T,), device="cpu"))
    probe.submit(Request(rid=0, prompt=prompts[0], max_new_tokens=12))
    eos = probe.run()[0].tokens[5]
    for rid, p in prompts.items():
        _submit(engines, rid, p, max_new_tokens=12 - 4 * rid, eos_id=eos)
    jresp, tresp = _run(engines)
    assert tresp[0][-1] == eos and len(tresp[0]) <= 6
    _assert_same_tokens(setup, jresp, tresp, prompts)


def test_warmup_grid_matches_reference_and_steady_state_is_clean(setup):
    """Warmup runs the reference's key grid; a plain and a mixed wave
    afterwards run no new key."""
    tcfg = setup[1]
    engines = _engines(setup, max_batch=3, max_len=T + NEW + 8,
                       buckets=(T,))
    mask = np.array([1, 1], np.int32)
    n_low = engines[1]._wave_key(Request(rid=-1, prompt=np.zeros(T),
                                         low_span_mask=mask, beta=2))[1]
    n = engines[1].warmup(plan_space=[(n_low, 0, 2)])
    assert n == engines[1].stats.compiles > 0 and engines[1].stats.warmed
    assert set(engines[1]._prefill_fns) | set(engines[1]._decode_fns) == {
        ("decode", b) for b in (1, 2, 4)} | {
        ("prefill", T, p, beta, b) for b in (1, 2, 4)
        for p, beta in ((0, 0), (n_low, 2))}
    rng = np.random.default_rng(5)
    for rid in range(3):
        engines[1].submit(Request(
            rid=rid, prompt=rng.integers(0, tcfg.vocab_size, (T,)),
            max_new_tokens=NEW, low_span_mask=mask if rid else None,
            beta=2 if rid else 0))
    assert len(engines[1].run()) == 3
    assert engines[1].stats.steady_compiles == 0, \
        engines[1].stats.steady_compile_keys


@pytest.mark.parametrize("extra", [[], ["--mixed", "--beta", "2"]])
def test_launch_serve_on_cpu(extra, capsys):
    assert tlaunch.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                         "--requests", "3", "--prompt-len", "32",
                         "--max-new", "3", *extra]) == 0
    out = capsys.readouterr().out
    assert "[serve] 3 requests, 9 tokens" in out
    assert f"mixed={'on' if extra else 'off'}" in out


# ---------------------------------------------------------------------------
# the SSM and hybrid families


@pytest.fixture(scope="module", params=["mamba2-370m", "zamba2-1.2b"])
def ssm_setup(request):
    layers = 6 if request.param == "zamba2-1.2b" else 2
    jcfg = jget_reduced(request.param).replace(n_layers=layers)
    tcfg = get_reduced(request.param).replace(n_layers=layers)
    jparams = jregistry.init_params(jcfg, jax.random.PRNGKey(0))
    conv = (convert.ssm_params_from_jax if tcfg.family == "ssm"
            else convert.hybrid_params_from_jax)
    tparams = conv(jax.tree_util.tree_map(np.asarray, jparams), tcfg, "cpu")
    return jcfg, tcfg, jparams, tparams


def test_ssm_plain_padded_wave_tokens_match_reference(ssm_setup):
    """Three requests pad to the B = 4 bucket (slot 0 replicated) after a
    warmup over the same keys; the same greedy tokens as the reference
    engine, and no key first runs after warmup."""
    engines = _engines(ssm_setup, max_batch=4, max_len=T + NEW + 8,
                       buckets=(T,))
    n = engines[1].warmup()
    assert set(engines[1]._prefill_fns) | set(engines[1]._decode_fns) == {
        ("decode", b) for b in (1, 2, 4)} | {
        ("prefill", T, 0, 0, b) for b in (1, 2, 4)}
    assert n == 6
    rng = np.random.default_rng(7)
    prompts = _prompts(rng, ssm_setup[1], 3)
    for rid, p in enumerate(prompts):
        _submit(engines, rid, p, max_new_tokens=NEW)
    jresp, tresp = _run(engines)
    assert len(engines[1].wave_latencies) == 1
    _assert_same_tokens(ssm_setup, jresp, tresp, dict(enumerate(prompts)))
    assert _ref_steps(ssm_setup, prompts[1], jresp[1], None, 0)[0] == \
        jresp[1]
    assert engines[1].stats.steady_compiles == 0, \
        engines[1].stats.steady_compile_keys


def test_ssm_two_waves_tokens_match_reference(ssm_setup):
    """Five requests at max_batch 4: a full wave of 4 and a wave of 1."""
    engines = _engines(ssm_setup, max_batch=4, max_len=T + NEW + 8,
                       buckets=(T,))
    rng = np.random.default_rng(8)
    prompts = _prompts(rng, ssm_setup[1], 5)
    for rid, p in enumerate(prompts):
        _submit(engines, rid, p, max_new_tokens=NEW)
    jresp, tresp = _run(engines)
    assert len(engines[1].wave_latencies) == 2
    _assert_same_tokens(ssm_setup, jresp, tresp, dict(enumerate(prompts)))


def test_ssm_mixed_request_raises(ssm_setup):
    """The reference's mixed prefill runs no mamba layer (its run_blocks
    knows only dense and MoE stacks) and leaves every SSM state at zero:
    the port refuses a pooling request for these families, at submit and
    in warmup; a mask at beta 0, or one that selects no span, still
    serves plain."""
    tcfg, tparams = ssm_setup[1], ssm_setup[3]
    eng = ServeEngine(tcfg, tparams, ServeConfig(
        max_batch=4, max_len=T + NEW + 8, buckets=(T,), device="cpu"))
    prompt = np.zeros(T, np.int32)
    for kw in (dict(low_span_mask=np.array([1, 0])),
               dict(reuse_span_mask=np.array([0, 1]), client_id=3)):
        with pytest.raises(ValueError, match="no mixed-granularity"):
            eng.submit(Request(rid=0, prompt=prompt, beta=2, **kw))
    with pytest.raises(ValueError, match="zero layers"):
        eng.warmup(plan_space=[(1, 0, 2)])
    eng.submit(Request(rid=1, prompt=prompt, max_new_tokens=2,
                       low_span_mask=np.array([1, 0]), beta=0))
    eng.submit(Request(rid=2, prompt=prompt, max_new_tokens=2,
                       low_span_mask=np.array([0, 0]), beta=2))
    assert [r.n_tokens for r in eng.run()] == [2, 2]


def test_ssm_low_span_that_buckets_away_serves_plain(ssm_setup):
    """T = 128 in 8 spans, one of them low, at beta 2: ``bucket_n_low``
    rounds 1 of 8 down to 0, so both engines key the request plain and
    serve it through the plain prefill, with the same greedy tokens."""
    TL = 128
    engines = _engines(ssm_setup, max_batch=2, max_len=TL + NEW + 8,
                       buckets=(TL,))
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, ssm_setup[1].vocab_size, (TL,))
               .astype(np.int32) for _ in range(2)]
    mask = np.zeros(8, np.int32)
    mask[3] = 1
    for rid, p in enumerate(prompts):
        _submit(engines, rid, p, max_new_tokens=NEW, low_span_mask=mask,
                beta=2)
    assert [e._wave_key(e.queue[0]) for e in engines] == [(TL, 0, 0, 0,
                                                           b"")] * 2
    jresp, tresp = _run(engines)
    assert [len(t) for t in tresp.values()] == [NEW, NEW]
    _assert_same_tokens(ssm_setup, jresp, tresp, dict(enumerate(prompts)))


@pytest.mark.parametrize("arch", ["mamba2-370m", "zamba2-1.2b"])
def test_launch_serve_ssm_on_cpu_runs_the_plain_path(arch, capsys):
    assert tlaunch.main(["--arch", arch, "--reduced", "--device", "cpu",
                         "--requests", "3", "--prompt-len", "32",
                         "--max-new", "3", "--mixed"]) == 0
    out = capsys.readouterr().out
    assert "runs the plain path" in out
    assert "[serve] 3 requests, 9 tokens" in out and "mixed=off" in out


@pytest.mark.cuda
def test_engine_on_card_matches_cpu(setup):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (chip_smoke.py serves "
                    "full-width Qwen3-4B on the H100)")
    tcfg, tparams = setup[1], setup[3]
    rng = np.random.default_rng(6)
    prompts = _prompts(rng, tcfg, 3)
    out = []
    for dev in ("cpu", "cuda"):
        params = to_device(tparams, torch.device(dev))
        eng = ServeEngine(tcfg, params, ServeConfig(
            max_batch=4, max_len=T + NEW + 8, buckets=(T,), device=dev))
        for rid, p in enumerate(prompts):
            eng.submit(Request(rid=rid, prompt=p, max_new_tokens=NEW,
                               low_span_mask=np.array([1, 0]), beta=2))
        out.append({r.rid: r.tokens for r in eng.run()})
    assert out[0] == out[1]
