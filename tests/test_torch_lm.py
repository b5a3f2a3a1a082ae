"""Port parity for the dense-LM lane: layers, attention with a KV cache,
prefill + decode, and the mixed-granularity prefill, against the
reference on the same parameters (``init_lm_params`` converted by
``convert.lm_params_from_jax``; norm scales perturbed so they matter)
and the same numpy-seeded inputs.

Configs: qwen3-4b ``REDUCED`` (G = 1) and a narrow GQA variant (3
layers, D = 64, 8 query heads over 2 kv heads, Dh = 32); the ``REDUCED``
configs of the other dense archs at their published head layouts:
deepseek-7b (MHA, G = 1), mistral-nemo-12b (G = 4, q_dim 64 != D = 96,
untied head) and phi4-mini-3.8b (G = 3, q_dim 96 != D = 64, a 0.75
partial rotary: 12 of 16 channels, tied head).  Tolerances:
single layers 1e-5 absolute (float32, another summation order); whole
forwards, logits and caches 1e-4 (the same error, through a few
layers).  Pack plans are integer data and must be byte-equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jget_reduced
from repro.core import partition as jpart
from repro.core import seq_mixed_res as jsmr
from repro.models import attention as jattn
from repro.models import layers as jL
from repro.models import transformer as jtfm
from repro_torch import convert
from repro_torch.configs import get_config, get_reduced
from repro_torch.core import partition as tpart
from repro_torch.core import seq_mixed_res as tsmr
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tL
from repro_torch.models import registry
from repro_torch.offload.simulator import to_device
from repro_torch.models import transformer as ttfm

torch.set_num_threads(2)
LAYER_TOL = 1e-5
MODEL_TOL = 1e-4
ARCH = "qwen3-4b"
NARROW = dict(n_layers=3, n_heads=8, n_kv_heads=2, head_dim=32)
# config name -> (arch, overrides of its REDUCED config)
CONFIGS = {"reduced": (ARCH, {}), "narrow_gqa": (ARCH, NARROW),
           "deepseek-7b": ("deepseek-7b", {}),
           "mistral-nemo-12b": ("mistral-nemo-12b",
                                dict(n_kv_heads=1, d_model=96)),
           "phi4-mini-3.8b": ("phi4-mini-3.8b",
                              dict(n_heads=6, n_kv_heads=2))}


def _cfgs(name):
    arch, kw = CONFIGS[name]
    return jget_reduced(arch).replace(**kw), get_reduced(arch).replace(**kw)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


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


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def model(request):
    jcfg, tcfg = _cfgs(request.param)
    tree = jtfm.init_lm_params(jcfg, jax.random.PRNGKey(0))
    tree = _perturb_norms(jax.tree_util.tree_map(np.asarray, tree),
                          np.random.default_rng(1))
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    return jcfg, tcfg, jparams, convert.lm_params_from_jax(tree, tcfg, "cpu")


# ---------------------------------------------------------------------------
# configs, registry, parameters


def test_configs_copy_the_reference():
    """Every arch of the reference (its ten LMs and ViTDet-L), full and
    reduced, field for field; an unknown name raises KeyError."""
    from repro.configs import ARCH_MODULES as JARCHS
    from repro.configs import get_config as jget_config
    from repro_torch.configs import ARCH_MODULES
    assert sorted(ARCH_MODULES) == sorted(JARCHS)
    assert len(ARCH_MODULES) == 11
    for get, jget in ((get_config, jget_config),
                      (get_reduced, jget_reduced)):
        for arch in JARCHS:
            assert dataclasses.asdict(get(arch)) == \
                dataclasses.asdict(jget(arch))
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("gpt-2")


def test_unported_families_raise():
    """What stays refused: ServeEngine on the encoder-decoder family (it
    passes no frames; the reference's engine raises KeyError: 'frames' at
    its first prefill).  The training forward of both families runs
    (``tests/test_torch_lm_train.py`` holds it to the reference):
    whisper's needs its frames, as the reference's ``batch["frames"]``
    does, and a VLM batch without image embeddings trains the text
    decoder."""
    from repro_torch.serve.engine import ServeConfig, ServeEngine
    for arch in ("whisper-medium", "llava-next-mistral-7b"):
        cfg = get_reduced(arch)
        params = registry.init_params(cfg, torch.Generator().manual_seed(0),
                                      "cpu")
        batch = {"tokens": torch.zeros((1, 16), dtype=torch.long)}
        if cfg.family == "encdec":
            with pytest.raises(KeyError, match="frames"):
                registry.forward_hidden(cfg, params, batch)
            with pytest.raises(NotImplementedError, match="frames"):
                ServeEngine(cfg, params, ServeConfig(device="cpu"))
        else:                                   # a VLM serves its text
            hidden, aux = registry.forward_hidden(cfg, params, batch)
            assert hidden.shape == (1, 16, cfg.d_model) and aux == 0.0
            ServeEngine(cfg, params, ServeConfig(device="cpu"))


def test_seeded_init_has_the_reference_shapes_and_scales():
    jcfg, tcfg = _cfgs("narrow_gqa")
    tcfg = tcfg.replace(d_model=256, d_ff=512, vocab_size=2048)
    jcfg = jcfg.replace(d_model=256, d_ff=512, vocab_size=2048)
    tree = jax.tree_util.tree_map(
        np.asarray, jtfm.init_lm_params(jcfg, jax.random.PRNGKey(0)))
    ref = convert.lm_params_from_jax(tree, tcfg, "cpu")
    got = registry.init_params(tcfg, torch.Generator().manual_seed(0),
                               "cpu")
    shapes = jax.tree_util.tree_map(lambda t: tuple(t.shape), ref)
    assert jax.tree_util.tree_map(lambda t: tuple(t.shape), got) == shapes
    std = np.sqrt(1 - 4 * np.exp(-2) / np.sqrt(2 * np.pi)
                  / (2 * 0.9772498680518208 - 1))   # N(0,1) cut at +-2
    for a, b in ((got["blocks"][0]["ffn"]["w_down"],
                  ref["blocks"][0]["ffn"]["w_down"]),
                 (got["blocks"][1]["attn"]["w_qkv"],
                  ref["blocks"][1]["attn"]["w_qkv"])):
        want = std / np.sqrt(a.shape[0])
        assert abs(float(a.std()) / want - 1) < 0.02
        assert abs(float(b.std()) / want - 1) < 0.02
        assert float(a.abs().max()) <= 2 / np.sqrt(a.shape[0]) + 1e-6
    assert abs(float(got["embed"]["tok"].std()) / 0.02 - 1) < 0.02
    assert torch.equal(got["final_norm"]["w"], torch.ones(256))


def test_bucket_n_low_matches_reference():
    for n_regions in range(1, 17):
        for n_buckets in (1, 2, 3, 4):
            for n_low in range(-1, n_regions + 2):
                assert tpart.bucket_n_low(n_low, n_regions, n_buckets) == \
                    jpart.bucket_n_low(n_low, n_regions, n_buckets)


# ---------------------------------------------------------------------------
# layers


def test_rms_norm():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32) * 3
    w = rng.standard_normal(64).astype(np.float32)
    _close(tL.rms_norm(_t(x), _t(w), 1e-6),
           jL.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6), LAYER_TOL)


@pytest.mark.parametrize("partial", [1.0, 0.75, 0.5])
def test_apply_rope_full_and_partial(partial):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 4, 32)).astype(np.float32)
    pos = rng.integers(0, 160, (2, 7)).astype(np.int32)
    want = jL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6, partial)
    table = tL.rope_table(_t(pos), 32, 1e6, partial)
    _close(tL.apply_rope(_t(x), table), want, LAYER_TOL)
    _close(tL.rope_frequencies(32, 1e6, partial),
           jL.rope_frequencies(32, 1e6, partial), 1e-7)


def test_phi4_partial_rotary_turns_96_of_128_channels():
    """phi4-mini-3.8b's published head: 0.75 of Dh = 128 rotates the
    leading 96 channels in pairs (c, c + 48), as the reference does, and
    passes the last 32 through untouched."""
    cfg = get_config("phi4-mini-3.8b")
    rng = np.random.default_rng(11)
    x = rng.standard_normal((1, 9, 2, cfg.head_dim)).astype(np.float32)
    pos = np.arange(100, 109, dtype=np.int32)[None]
    table = tL.rope_table(_t(pos), cfg.head_dim, cfg.rope_theta,
                          cfg.partial_rotary_factor)
    assert 2 * table[0].shape[-1] == 96
    got = tL.apply_rope(_t(x), table)
    _close(got, jL.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                              cfg.rope_theta, cfg.partial_rotary_factor),
           LAYER_TOL)
    assert torch.equal(got[..., 96:], _t(x)[..., 96:])
    assert bool((got[..., :96] != _t(x)[..., :96]).any())


def test_swiglu_mlp():
    jcfg, tcfg = _cfgs("narrow_gqa")
    p = jax.tree_util.tree_map(
        np.asarray, jL.init_mlp(jcfg, jax.random.PRNGKey(3), jnp.float32))
    x = np.random.default_rng(2).standard_normal((2, 6, 64)).astype(
        np.float32)
    _close(tL.apply_mlp(tcfg, {k: _t(v) for k, v in p.items()}, _t(x)),
           jL.apply_mlp(jcfg, p, jnp.asarray(x)), LAYER_TOL)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_attention_prefill_and_decode_with_qk_norm(name):
    """One attention layer: prefill T tokens into a cache, then decode
    two tokens; outputs and the cache written in place against the
    reference's functional update (qk norms where the config has them,
    phi4-mini's partial rotary)."""
    jcfg, tcfg = _cfgs(name)
    rng = np.random.default_rng(4)
    p = jax.tree_util.tree_map(np.asarray, jattn.init_attention(
        jcfg, jax.random.PRNGKey(5), jnp.float32))
    tp = {"w_qkv": _t(np.concatenate([p["w_q"], p["w_k"], p["w_v"]], 1)),
          "w_o": _t(p["w_o"])}
    for k in ("q_norm", "k_norm"):          # qwen3's; the others have none
        if k in p:
            p[k] = (1 + 0.1 * rng.standard_normal(p[k].shape)
                    ).astype(np.float32)
            tp[k] = _t(p[k])
    B, T, S = 2, 12, 20
    x = rng.standard_normal((B, T, tcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(T), (B, T))
    jcache = jattn.init_kv_cache(jcfg, B, S, jnp.float32)
    jout, jcache = jattn.attention_prefill(jcfg, p, jnp.asarray(x),
                                           jnp.asarray(pos), jcache)
    tcache = tattn.init_kv_cache(tcfg, B, S, device="cpu")
    rope = tL.rope_table(_t(pos), tcfg.head_dim, tcfg.rope_theta,
                         tcfg.partial_rotary_factor)
    tout = tattn.attention_prefill(tcfg, tp, _t(x), rope, tcache)
    _close(tout, jout, LAYER_TOL)
    for step in range(2):
        xd = rng.standard_normal((B, 1, tcfg.d_model)).astype(np.float32)
        jout, jcache = jattn.attention_decode(jcfg, p, jnp.asarray(xd),
                                              T + step, jcache)
        rope = tL.rope_table(torch.full((B, 1), T + step), tcfg.head_dim,
                             tcfg.rope_theta, tcfg.partial_rotary_factor)
        kv_len = torch.full((B,), T + step + 1, dtype=torch.int32)
        tout = tattn.attention_decode(tcfg, tp, _t(xd), T + step, rope,
                                      tcache, kv_len)
        _close(tout, jout, LAYER_TOL)
    for k in ("k", "v"):
        _close(tcache[k], jcache[k], LAYER_TOL)


# ---------------------------------------------------------------------------
# whole model


def _tokens(rng, cfg, B, T):
    return rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)


def _close_caches(tc, jc, tol, T=None):
    for k in ("k", "v"):
        got = tc["dense_blocks"][k].numpy()
        want = np.asarray(jc["dense_blocks"][k])
        if T is not None:
            got, want = got[:, :, :T], want[:, :, :T]
        _close(got, want, tol)


def test_prefill_and_decode_logits_and_caches(model):
    jcfg, tcfg, jp, tp = model
    rng = np.random.default_rng(6)
    B, T, S, steps = 2, 32, 40, 4
    toks = _tokens(rng, tcfg, B, T)
    jc = jtfm.init_caches(jcfg, B, S, jnp.float32)
    jh, jc, _ = jtfm.prefill(jcfg, jp, jnp.asarray(toks), jc)
    tc = ttfm.init_caches(tcfg, B, S, device="cpu")
    th, tc, _ = ttfm.prefill(tcfg, tp, _t(toks).long(), tc)
    _close(th, jh, MODEL_TOL)
    _close(ttfm.logits_from_hidden(tcfg, tp, th[:, -1:]),
           jtfm.logits_from_hidden(jcfg, jp, jh[:, -1:]), MODEL_TOL)
    _close_caches(tc, jc, MODEL_TOL)
    for step in range(steps):
        tok = _tokens(rng, tcfg, B, 1)
        jl, jc = jtfm.decode_step(jcfg, jp, jnp.asarray(tok), T + step, jc)
        tl, tc = ttfm.decode_step(tcfg, tp, _t(tok).long(), T + step, tc)
        _close(tl, jl, MODEL_TOL)
    _close_caches(tc, jc, MODEL_TOL)


@pytest.mark.parametrize("T", [64, 128])
def test_build_seq_pack_byte_equal_every_bucket(T):
    jcfg, tcfg = _cfgs("reduced")
    jp, tp = jsmr.seq_partition(jcfg, T), tsmr.seq_partition(tcfg, T)
    assert (tp.span, tp.n_spans) == (jp.span, jp.n_spans)
    rng = np.random.default_rng(T)
    masks = [np.zeros(tp.n_spans, np.int32), np.ones(tp.n_spans, np.int32)]
    masks += [rng.integers(0, 2, tp.n_spans).astype(np.int32)
              for _ in range(4)]
    for n_low in jpart.bucket_set(tp.n_spans):
        assert tp.n_tokens(n_low) == jp.n_tokens(n_low)
        for m in masks:
            got = tsmr.build_seq_pack(m, n_low, tp)
            want = jsmr.build_seq_pack(m, n_low, jp)
            assert got.keys() == want.keys()
            for k in got:
                assert got[k].dtype == want[k].dtype
                assert got[k].tobytes() == want[k].tobytes(), (n_low, k)


def test_pack_and_restore_primitives():
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 64, 16)).astype(np.float32)
    _, tcfg = _cfgs("reduced")
    pack = tsmr.build_seq_pack(np.array([1, 0, 1, 0]), 2,
                               tsmr.seq_partition(tcfg, 64))
    idx = {k: torch.from_numpy(v.astype(np.int64)) for k, v in pack.items()}
    xm = tsmr.pack_sequence(_t(x), idx["mix_idx"], 2)
    _close(xm, jsmr.pack_sequence(jnp.asarray(x), pack["mix_idx"], 2), 1e-6)
    _close(tsmr.restore_sequence(xm, idx["restore_idx"]),
           jsmr.restore_sequence(jnp.asarray(xm.numpy()),
                                 pack["restore_idx"]), 0)


@pytest.mark.parametrize("beta", [0, 1, 2, 3, 4])
def test_mixed_prefill_hidden_and_restored_caches(model, beta):
    """Every restoration point: hidden states and the restored
    full-resolution caches of every layer, then one decode step on them."""
    jcfg, tcfg, jp, tp = model
    rng = np.random.default_rng(10 + beta)
    B, T, S = 2, 64, 72
    toks = _tokens(rng, tcfg, B, T)
    part = tsmr.seq_partition(tcfg, T)
    pack = tsmr.build_seq_pack(np.array([0, 1, 1, 0]), 2, part)
    tpack = {k: torch.from_numpy(v.astype(np.int64)) for k, v in
             pack.items()}
    jc = jtfm.init_caches(jcfg, B, S, jnp.float32)
    jh, jc, _ = jsmr.mixed_prefill(jcfg, jp, jnp.asarray(toks),
                                   {k: jnp.asarray(v) for k, v in
                                    pack.items()}, beta, jc)
    tc = ttfm.init_caches(tcfg, B, S, device="cpu")
    th, tc, _ = tsmr.mixed_prefill(tcfg, tp, _t(toks).long(), tpack, beta,
                                   tc)
    _close(th, jh, MODEL_TOL)
    _close_caches(tc, jc, MODEL_TOL, T=T)
    tok = _tokens(rng, tcfg, B, 1)
    jl, _ = jtfm.decode_step(jcfg, jp, jnp.asarray(tok), T, jc)
    tl, _ = ttfm.decode_step(tcfg, tp, _t(tok).long(), T, tc)
    _close(tl, jl, MODEL_TOL)


def test_prefill_flops_match_reference():
    jcfg, tcfg = get_config(ARCH), None
    from repro.configs import get_config as jget_config
    jcfg, tcfg = jget_config(ARCH), get_config(ARCH)
    for n_low in (0, 2, 4, 8):
        for beta in range(5):
            assert tsmr.prefill_flops(tcfg, 128, n_low, beta) == \
                jsmr.prefill_flops(jcfg, 128, n_low, beta)


@pytest.mark.cuda
def test_lm_on_card_matches_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (chip_smoke.py runs this "
                    "check on the H100 at full width)")
    _, tcfg = _cfgs("narrow_gqa")
    tp = registry.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    tp_gpu = to_device(tp, torch.device("cuda"))
    rng = np.random.default_rng(12)
    toks = _t(_tokens(rng, tcfg, 2, 64)).long()
    out = []
    for dev, params in (("cpu", tp), ("cuda", tp_gpu)):
        c = ttfm.init_caches(tcfg, 2, 72, device=dev)
        h, c, _ = ttfm.prefill(tcfg, params, toks.to(dev), c)
        lg, _ = ttfm.decode_step(tcfg, params, toks[:, :1].to(dev), 64, c)
        out.append((h.cpu(), lg.cpu()))
    for a, b in zip(*out):
        assert float((a - b).abs().max() / b.abs().max()) <= 1e-3
