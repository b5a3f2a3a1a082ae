"""Port parity for the encoder-decoder family (whisper-medium ``REDUCED``:
2 + 2 layers, D = 64, 4 heads of 16, a 64-frame encoder) against the
reference on the same parameters (``init_whisper_params`` converted by
``convert.whisper_params_from_jax``; norm scales, LayerNorm shifts and
biases perturbed so they matter) and the same numpy-seeded inputs:
the sinusoidal table, cross-attention, ``encode``, ``prefill`` with its
caches, eight greedy ``decode_step``s, ``encode_mixed`` at every
restoration point, the registry and the engine's refusal.

The encoder's frame pooling runs at a window of 4, as the reference's own
``tests/test_seq_mixed_res.py`` does (its window of 10 does not divide
the 64 reduced frames).  Tolerances: a layer 1e-5, whole forwards and
logits 1e-4 (float32, another summation order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jget_reduced
from repro.core import seq_mixed_res as jsmr
from repro.models import attention as jattn
from repro.models import layers as jL
from repro.models import registry as jreg
from repro.models import whisper as jwhs
from repro_torch import convert
from repro_torch.configs import get_reduced
from repro_torch.core import seq_mixed_res as tsmr
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tL
from repro_torch.models import registry
from repro_torch.models import whisper as twhs
from repro_torch.serve.engine import ServeConfig, ServeEngine

torch.set_num_threads(2)
LAYER_TOL = 1e-5
MODEL_TOL = 1e-4
ARCH = "whisper-medium"
WINDOW = 4                  # encoder pooling window at 64 reduced frames
B, T, STEPS, S_MAX = 2, 12, 8, 24


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


def _perturb(tree, rng):
    """Norm scales 1 +- 0.1, LayerNorm shifts and biases +- 0.1, instead
    of ones and zeros, so a misplaced one shows."""
    def walk(t, path=()):
        if isinstance(t, dict):
            return {k: walk(v, path + (k,)) for k, v in t.items()}
        if any("ln" in k or "norm" in k for k in path) or \
                path[-1].startswith("b_"):
            return (t + 0.1 * rng.standard_normal(t.shape)).astype(t.dtype)
        return t
    return walk(tree)


@pytest.fixture(scope="module")
def model():
    jcfg, tcfg = jget_reduced(ARCH), get_reduced(ARCH)
    tree = jwhs.init_whisper_params(jcfg, jax.random.PRNGKey(0))
    tree = _perturb(jax.tree_util.tree_map(np.asarray, tree),
                    np.random.default_rng(1))
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    return jcfg, tcfg, jparams, convert.whisper_params_from_jax(tree, tcfg,
                                                                "cpu")


def _frames(rng, cfg):
    return rng.standard_normal(
        (B, cfg.encdec.encoder_seq_len, cfg.d_model)).astype(np.float32)


def _tokens(rng, cfg, n):
    return rng.integers(0, cfg.vocab_size, (B, n)).astype(np.int32)


# ---------------------------------------------------------------------------
# layers


@pytest.mark.parametrize("n_pos,dim", [(64, 64), (1500, 1024), (7, 10)])
def test_sinusoidal_positions(n_pos, dim):
    """The frequencies' exp may differ by one float32 ulp between the
    packages' math libraries, which moves the angle p * inv by p ulps of
    inv: up to n_pos * 2^-23 at the largest frequency (1.8e-4 at 1500
    frames), the table's limit past LAYER_TOL."""
    _close(tL.sinusoidal_positions(n_pos, dim),
           jL.sinusoidal_positions(n_pos, dim),
           max(LAYER_TOL, n_pos * 2.0 ** -23))


def test_cross_attention_separate_weights_no_bias():
    jcfg, tcfg = jget_reduced(ARCH), get_reduced(ARCH)
    p = jax.tree_util.tree_map(np.asarray, jattn.init_cross_attention(
        jcfg, jax.random.PRNGKey(3), jnp.float32))
    assert sorted(p) == ["w_k", "w_o", "w_q", "w_v"]
    rng = np.random.default_rng(2)
    x = rng.standard_normal((B, 5, tcfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((B, 37, tcfg.d_model)).astype(np.float32)
    _close(tattn.cross_attention(tcfg, {k: _t(v) for k, v in p.items()},
                                 _t(x), _t(enc)),
           jattn.cross_attention(jcfg, p, jnp.asarray(x), jnp.asarray(enc)),
           LAYER_TOL)
    got = tattn.init_cross_attention(tcfg, torch.Generator().manual_seed(0),
                                     "cpu")
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: v.shape for k, v in p.items()}


# ---------------------------------------------------------------------------
# the model


def test_seeded_init_has_the_reference_tree(model):
    jcfg, tcfg, jp, tp = model
    got = registry.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    shapes = jax.tree_util.tree_map(lambda t: tuple(t.shape), tp)
    assert jax.tree_util.tree_map(lambda t: tuple(t.shape), got) == shapes
    assert got["dec_pos"].shape == (tcfg.max_seq_len, tcfg.d_model)
    assert abs(float(got["dec_pos"].std()) / 0.02 - 1) < 0.02
    assert "b_qkv" in got["enc_blocks"][0]["attn"]
    assert got["lm_head"] == {}                     # tied to the table


def test_encode(model):
    jcfg, tcfg, jp, tp = model
    frames = _frames(np.random.default_rng(4), tcfg)
    _close(twhs.encode(tcfg, tp, _t(frames)),
           jwhs.encode(jcfg, jp, jnp.asarray(frames)), MODEL_TOL)


def test_prefill_and_greedy_decode_through_the_registry(model):
    """Registry prefill (frames + a T-token prompt: hidden, enc_out and
    the caches), then STEPS greedy decode steps, each package feeding
    back its own argmax: logits 1e-4 a step, the same tokens."""
    jcfg, tcfg, jp, tp = model
    rng = np.random.default_rng(5)
    frames, toks = _frames(rng, tcfg), _tokens(rng, tcfg, T)
    jst = jreg.init_decode_state(jcfg, B, S_MAX, jnp.float32)
    jh, jst, _ = jreg.prefill(jcfg, jp, {"tokens": jnp.asarray(toks),
                                         "frames": jnp.asarray(frames)}, jst)
    tst = registry.init_decode_state(tcfg, B, S_MAX, device="cpu")
    th, tst, _ = registry.prefill(tcfg, tp, {"tokens": _t(toks).long(),
                                             "frames": _t(frames)}, tst)
    _close(th, jh, MODEL_TOL)
    _close(tst[0], jst[0], MODEL_TOL)
    for k in ("k", "v"):
        assert tst[1][k].shape == jst[1][k].shape
        _close(tst[1][k], jst[1][k], MODEL_TOL)
    jlog = jh[:, -1:] @ jp["embed"]["tok"].T
    tlog = th[:, -1:] @ tp["embed"]["tok"].T
    _close(tlog, jlog, MODEL_TOL)
    jtok, ttok = jnp.argmax(jlog, -1), tlog.argmax(-1)
    for step in range(STEPS):
        assert ttok.numpy().tolist() == np.asarray(jtok).tolist(), step
        jlog, jst = jreg.decode_step(jcfg, jp, jtok, T + step, jst)
        tlog, tst = registry.decode_step(tcfg, tp, ttok, T + step, tst)
        _close(tlog, jlog, MODEL_TOL)
        jtok, ttok = jnp.argmax(jlog, -1), tlog.argmax(-1)
    assert ttok.numpy().tolist() == np.asarray(jtok).tolist()
    for k in ("k", "v"):
        _close(tst[1][k], jst[1][k], MODEL_TOL)


@pytest.mark.parametrize("beta", [0, 1, 2, 4])
def test_encode_mixed_every_restoration_point(model, beta):
    """Encoder frame pooling: 3 of the 8 spans of 8 frames pooled, the
    pre-RP encoder layers over the 52-frame mixed sequence; beta 0 (and
    1, which leaves no layer of 2 before the point) is the plain
    encoder."""
    jcfg, tcfg, jp, tp = model
    part = tsmr.SeqPartition(tcfg.encdec.encoder_seq_len, WINDOW,
                             tcfg.mixed_res.downsample)
    pack = tsmr.build_seq_pack(np.array([1, 0, 0, 1, 1, 0, 0, 0]), 3, part)
    jpack = jsmr.build_seq_pack(np.array([1, 0, 0, 1, 1, 0, 0, 0]), 3,
                                jsmr.SeqPartition(part.seq_len, WINDOW, 2))
    for k in pack:
        assert pack[k].tobytes() == jpack[k].tobytes()
    frames = _frames(np.random.default_rng(6 + beta), tcfg)
    got = tsmr.encode_mixed(tcfg, tp, _t(frames), {
        k: torch.from_numpy(v.astype(np.int64)) for k, v in pack.items()},
        beta)
    want = jsmr.encode_mixed(jcfg, jp, jnp.asarray(frames),
                             {k: jnp.asarray(v) for k, v in jpack.items()},
                             beta)
    _close(got, want, MODEL_TOL)
    plain = twhs.encode(tcfg, tp, _t(frames))
    if tsmr.layers_before_rp(tcfg, beta, 2) == 0:
        _close(got, plain, LAYER_TOL)
    else:
        assert float((got - plain).abs().max()) > 1e-3    # pooling acted


# ---------------------------------------------------------------------------
# what stays refused


def test_engine_and_launcher_refuse_the_encoder_decoder(model):
    """The reference's engine passes no frames and its first prefill
    raises KeyError: 'frames'; the port's refuses at construction, and
    the launcher before drawing any weight."""
    _, tcfg, _, tp = model
    with pytest.raises(NotImplementedError, match="frames"):
        ServeEngine(tcfg, tp, ServeConfig(device="cpu"))
    from repro_torch.launch.serve import main
    with pytest.raises(NotImplementedError, match="frames"):
        main(["--arch", ARCH, "--reduced", "--device", "cpu"])
