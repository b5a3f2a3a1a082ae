"""Port parity for the VLM family (llava-next-mistral-7b ``REDUCED``: a
2-layer Mistral decoder at D = 64 behind the projector from 16 stub image
embeddings of width 32) against the reference on the same parameters
(``init_lm_params`` with its projector, converted by
``convert.lm_params_from_jax``; norm scales and the projector's biases
perturbed so they matter) and the same numpy-seeded inputs: the
projected prefix, ``prefill`` with ``image_embeds`` (hidden states and
caches), decode logits and greedy tokens, ``mixed_prefill`` and
``mixed_forward_hidden`` over one pooled image + text sequence, the
engine's text-only waves and the launcher's lanes.

Tolerances: the projector 1e-5, whole forwards and logits 1e-4 (float32,
another summation order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jget_reduced
from repro.core import seq_mixed_res as jsmr
from repro.models import registry as jreg
from repro.models import transformer as jtfm
from repro.serve.engine import ServeConfig as JServeConfig
from repro.serve.engine import ServeEngine as JServeEngine
from repro.serve.request import Request as JRequest
from repro_torch import convert
from repro_torch.configs import get_reduced
from repro_torch.core import seq_mixed_res as tsmr
from repro_torch.launch import serve as tlaunch
from repro_torch.models import registry
from repro_torch.models import transformer as ttfm
from repro_torch.serve.engine import ServeConfig, ServeEngine
from repro_torch.serve.request import Request

torch.set_num_threads(2)
LAYER_TOL = 1e-5
MODEL_TOL = 1e-4
ARCH = "llava-next-mistral-7b"
B, T_TEXT, STEPS = 2, 48, 8          # 16 image + 48 text = 4 spans of 16


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


def _perturb(tree, rng):
    def walk(t, path=()):
        if isinstance(t, dict):
            return {k: walk(v, path + (k,)) for k, v in t.items()}
        if any("norm" in k or k in ("ln1", "ln2", "b1", "b2")
               for k in path):
            return (t + 0.1 * rng.standard_normal(t.shape)).astype(t.dtype)
        return t
    return walk(tree)


@pytest.fixture(scope="module")
def model():
    jcfg, tcfg = jget_reduced(ARCH), get_reduced(ARCH)
    tree = jtfm.init_lm_params(jcfg, jax.random.PRNGKey(0))
    tree = _perturb(jax.tree_util.tree_map(np.asarray, tree),
                    np.random.default_rng(1))
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    return jcfg, tcfg, jparams, convert.lm_params_from_jax(tree, tcfg, "cpu")


def _inputs(rng, cfg, T=T_TEXT):
    img = rng.standard_normal((B, cfg.vlm.n_image_tokens,
                               cfg.vlm.vision_hidden)).astype(np.float32)
    toks = rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)
    return img, toks


def test_seeded_init_has_the_projector(model):
    _, tcfg, _, tp = model
    got = registry.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    shapes = jax.tree_util.tree_map(lambda t: tuple(t.shape), tp)
    assert jax.tree_util.tree_map(lambda t: tuple(t.shape), got) == shapes
    assert got["projector"]["w1"].shape == (tcfg.vlm.vision_hidden,
                                            tcfg.d_model)
    assert not got["projector"]["b1"].any()


def test_embed_inputs_prepends_the_projected_images(model):
    jcfg, tcfg, jp, tp = model
    img, toks = _inputs(np.random.default_rng(2), tcfg)
    got = ttfm.embed_inputs(tcfg, tp, _t(toks).long(), _t(img))
    assert got.shape == (B, tcfg.vlm.n_image_tokens + T_TEXT, tcfg.d_model)
    _close(got, jtfm.embed_inputs(jcfg, jp, jnp.asarray(toks),
                                  jnp.asarray(img)), LAYER_TOL)
    _close(ttfm.embed_inputs(tcfg, tp, _t(toks).long()),
           jtfm.embed_inputs(jcfg, jp, jnp.asarray(toks)), 0)


def test_prefill_with_images_then_greedy_decode(model):
    """Registry prefill of images + text (hidden states and caches over
    all 64 positions), then STEPS greedy decode steps, each package
    feeding back its own argmax: logits 1e-4 a step, the same tokens."""
    jcfg, tcfg, jp, tp = model
    img, toks = _inputs(np.random.default_rng(3), tcfg)
    T = tcfg.vlm.n_image_tokens + T_TEXT
    jc = jreg.init_decode_state(jcfg, B, T + STEPS + 4, jnp.float32)
    jh, jc, _ = jreg.prefill(jcfg, jp, {"tokens": jnp.asarray(toks),
                                        "image_embeds": jnp.asarray(img)}, jc)
    tc = registry.init_decode_state(tcfg, B, T + STEPS + 4, device="cpu")
    th, tc, _ = registry.prefill(tcfg, tp, {"tokens": _t(toks).long(),
                                            "image_embeds": _t(img)}, tc)
    assert th.shape == (B, T, tcfg.d_model)
    _close(th, jh, MODEL_TOL)
    for k in ("k", "v"):
        _close(tc["dense_blocks"][k], jc["dense_blocks"][k], MODEL_TOL)
    jlog = jtfm.logits_from_hidden(jcfg, jp, jh[:, -1:])
    tlog = ttfm.logits_from_hidden(tcfg, tp, th[:, -1:])
    for step in range(STEPS + 1):
        _close(tlog, jlog, MODEL_TOL)
        jtok, ttok = jnp.argmax(jlog, -1), tlog.argmax(-1)
        assert ttok.numpy().tolist() == np.asarray(jtok).tolist(), step
        if step == STEPS:
            break
        jlog, jc = jreg.decode_step(jcfg, jp, jtok, T + step, jc)
        tlog, tc = registry.decode_step(tcfg, tp, ttok, T + step, tc)


@pytest.mark.parametrize("beta", [0, 2, 4])
def test_mixed_prefill_pools_images_and_text_together(model, beta):
    """One pack over the 64-position image + text sequence: the image
    span and a text span pooled; hidden states, the restored caches of
    every layer and a decode step on them."""
    jcfg, tcfg, jp, tp = model
    img, toks = _inputs(np.random.default_rng(4 + beta), tcfg)
    T = tcfg.vlm.n_image_tokens + T_TEXT
    part = tsmr.seq_partition(tcfg, T)
    pack = tsmr.build_seq_pack(np.array([1, 0, 1, 0]), 2, part)
    tpack = {k: torch.from_numpy(v.astype(np.int64))
             for k, v in pack.items()}
    jpack = {k: jnp.asarray(v) for k, v in pack.items()}
    jc = jreg.init_decode_state(jcfg, B, T + 4, jnp.float32)
    jh, jc, _ = jsmr.mixed_prefill(jcfg, jp, jnp.asarray(toks), jpack, beta,
                                   jc, image_embeds=jnp.asarray(img))
    tc = registry.init_decode_state(tcfg, B, T + 4, device="cpu")
    th, tc, _ = tsmr.mixed_prefill(tcfg, tp, _t(toks).long(), tpack, beta,
                                   tc, image_embeds=_t(img))
    _close(th, jh, MODEL_TOL)
    for k in ("k", "v"):
        _close(tc["dense_blocks"][k][:, :, :T],
               np.asarray(jc["dense_blocks"][k])[:, :, :T], MODEL_TOL)
    tok = toks[:, :1]
    jl, _ = jreg.decode_step(jcfg, jp, jnp.asarray(tok), T, jc)
    tl, _ = registry.decode_step(tcfg, tp, _t(tok).long(), T, tc)
    _close(tl, jl, MODEL_TOL)
    jf, _ = jsmr.mixed_forward_hidden(jcfg, jp, jnp.asarray(toks), jpack,
                                      beta, image_embeds=jnp.asarray(img))
    tf, _ = tsmr.mixed_forward_hidden(tcfg, tp, _t(toks).long(), tpack,
                                      beta, image_embeds=_t(img))
    _close(tf, jf, MODEL_TOL)


def test_engine_serves_the_text_decoder_as_the_reference(model):
    """Neither engine passes image embeddings: a plain and a mixed wave
    of text prompts give the reference engine's greedy tokens."""
    jcfg, tcfg, jp, tp = model
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, tcfg.vocab_size, 32).astype(np.int32)
               for _ in range(3)]
    mask = np.array([1, 0], np.int32)
    engines = (JServeEngine(jcfg, jp, JServeConfig(max_batch=4,
                                                   buckets=(32,))),
               ServeEngine(tcfg, tp, ServeConfig(max_batch=4, buckets=(32,),
                                                 device="cpu")))
    for rid, prompt in enumerate(prompts):
        mixed = rid % 2
        for eng, Req in zip(engines, (JRequest, Request)):
            eng.submit(Req(rid=rid, prompt=prompt, max_new_tokens=4,
                           low_span_mask=mask if mixed else None,
                           beta=2 if mixed else 0))
    want, got = ({r.rid: r.tokens for r in e.run()} for e in engines)
    assert got == want


@pytest.mark.parametrize("arch,quant", [
    ("llava-next-mistral-7b", "fp32"), ("llava-next-mistral-7b", "int8"),
    ("deepseek-7b", "int8"), ("mistral-nemo-12b", "bf16"),
    ("phi4-mini-3.8b", "fp16")])
def test_launch_serve_lanes(arch, quant, capsys):
    """The launcher's lanes on the VLM's text path and the dense configs,
    mixed at beta 2; int8 leaves the projector float, as the reference's
    walk does."""
    assert tlaunch.main(["--arch", arch, "--reduced", "--device", "cpu",
                         "--requests", "3", "--prompt-len", "32",
                         "--max-new", "3", "--mixed", "--quant",
                         quant]) == 0
    out = capsys.readouterr().out
    assert "[serve] 3 requests, 9 tokens" in out and "mixed=on" in out
    if quant != "fp32":
        assert f"[serve] quant={quant}:" in out


def test_int8_tree_keeps_the_projector_float(model):
    from repro_torch.quant.ptq import quantize_lm_params
    from repro_torch.quant.qtensor import QuantTensor
    _, _, _, tp = model
    q = quantize_lm_params(tp)
    assert all(isinstance(v, torch.Tensor) and v.dtype == torch.float32
               for v in q["projector"].values())
    assert isinstance(q["blocks"][0]["attn"]["w_qkv"], QuantTensor)
