"""Port parity: the quantized serving lane (repro_torch.quant,
kernels.int8_matmul) against the reference's (repro.quant), on the same
seeded weights and inputs.

Tolerances and why:
  * weight codes and scales, the fused QKV's codes, compression bytes,
    ratios and the pruned heads are byte-equal: the same float32
    arithmetic on the same bytes;
  * the int8 GEMM (plain version, the reference's dot_general oracle and
    its Pallas kernel in interpret mode) is bit-equal: integer sums plus
    the same three float32 operations in the same order;
  * a quantized forward quantizes every GEMM input per row, so a one-ulp
    difference upstream (softmax and LayerNorm sum in another order in
    the two frameworks) can flip a code where it lands on a rounding tie,
    and the flip moves that GEMM's output by one step of the row scale.
    Over eight blocks the features stay within QUANT_RTOL = 5% of the
    largest feature magnitude, and within QUANT_MEAN_RTOL = 1% of it on
    average; the reference's own Pallas and XLA backends differ by the
    same order on the same tree, for the same reason.  The dequant oracle
    lane has no row quantization, and there the port meets the fp32
    limit (1e-4 absolute).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import vitdet_l as jcfg
from repro.core import partition as jpt
from repro.core import vit_backbone as jvb
from repro.kernels import dispatch as jdispatch
from repro.kernels.int8_matmul import ops as jmm
from repro.kernels.int8_matmul import ref as jmm_ref
from repro.models import config as jmc
from repro.quant import prune as jprune
from repro.quant import ptq as jptq
from repro.quant import qtensor as jqt
from repro_torch import convert
from repro_torch.configs import vitdet_l as tcfg
from repro_torch.core import vit_backbone as tvb
from repro_torch.kernels import dispatch
from repro_torch.kernels.int8_matmul import ops as tmm
from repro_torch.models import config as tmc
from repro_torch.quant import prune as tprune
from repro_torch.quant import ptq as tptq
from repro_torch.quant import qtensor as tqt

torch.set_num_threads(2)
TOL = 1e-4
QUANT_RTOL = 0.05
QUANT_MEAN_RTOL = 0.01


def _t(a):
    return torch.from_numpy(np.array(a))


def _narrow(mc, base):
    return base.replace(
        n_layers=8, d_model=128, n_heads=2, n_kv_heads=2, head_dim=64,
        d_ff=256,
        vit=mc.ViTConfig(img_size=(512, 512), patch_size=16, window_size=8,
                         n_subsets=4, out_channels=32, n_classes=8),
        mixed_res=mc.MixedResConfig(enabled=True, window=8, downsample=2,
                                    n_subsets=4))


CONFIGS = {
    "sim": (jcfg.SIM, tcfg.SIM),
    "narrow": (_narrow(jmc, jcfg.CONFIG), _narrow(tmc, tcfg.CONFIG)),
}


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def sim():
    jp = jvb.init_vitdet_params(jcfg.SIM, jax.random.PRNGKey(0))
    tp = convert.params_from_jax(_np_tree(jp), tcfg.SIM, device="cpu")
    return jp, tp


# ---------------------------------------------------------------------------
# QuantTensor: byte-equal codes and scales


@pytest.mark.parametrize("shape,axis", [((64, 48), -1), ((1024, 960), -1),
                                        ((16, 16, 64), -1),
                                        ((3, 3, 8, 16), 0)])
def test_quantize_weight_byte_equal(shape, axis):
    """(K, N) weights, the position grid, and a conv weight (HWIO in the
    reference, OIHW in the port, scales per output channel)."""
    w = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    w *= 0.05
    want = jqt.quantize_weight(jnp.asarray(w))
    if axis == 0:
        got = tqt.quantize_weight(_t(w.transpose(3, 2, 0, 1)), axis=0)
        codes = got.q.numpy().transpose(2, 3, 1, 0)
    else:
        got = tqt.quantize_weight(_t(w))
        codes = got.q.numpy()
    assert got.q.dtype == torch.int8 and got.scale.dtype == torch.float32
    np.testing.assert_array_equal(codes, np.asarray(want.q))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
    assert got.nbytes == want.nbytes
    deq = got.dequant().numpy()
    if axis == 0:
        deq = deq.transpose(2, 3, 1, 0)
    np.testing.assert_array_equal(deq, np.asarray(want.dequant()))


def test_quantized_codes_are_k_contiguous():
    """The int8 kernel reads (K, N) codes as a row-major (N, K) matrix."""
    q = tqt.quantize_weight(torch.randn(96, 40))
    assert q.q.shape == (96, 40) and q.q.stride() == (1, 96)
    fused = tqt.concat_out([tqt.quantize_weight(torch.randn(96, n))
                            for n in (40, 8, 8)])
    assert fused.q.stride() == (1, 96)


def test_stacked_quantization_matches_reference():
    w = np.random.default_rng(2).standard_normal((3, 16, 8)) \
        .astype(np.float32)
    want = jqt.quantize_weight(jnp.asarray(w), stacked=True)
    got = tqt.quantize_weight(_t(w), stacked=True)
    assert tuple(got.scale.shape) == (3, 1, 8)
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))


def test_concat_out_matches_reference():
    rng = np.random.default_rng(1)
    ws = [rng.standard_normal((32, n)).astype(np.float32)
          for n in (16, 8, 8)]
    want = jqt.concat_out([jqt.quantize_weight(jnp.asarray(w)) for w in ws])
    got = tqt.concat_out([tqt.quantize_weight(_t(w)) for w in ws])
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
    # quantizing the fused float weight per column gives the same codes
    whole = tqt.quantize_weight(_t(np.concatenate(ws, axis=1)))
    assert torch.equal(whole.q, got.q) and torch.equal(whole.scale,
                                                       got.scale)
    with pytest.raises(AssertionError):
        tqt.concat_out([tqt.quantize_weight(_t(ws[0])), _t(ws[1])])


# ---------------------------------------------------------------------------
# the int8 GEMM: bit-equal


@pytest.mark.parametrize("M,K,N", [(8, 32, 16), (128, 128, 128),
                                   (100, 130, 65), (1000, 100, 130),
                                   (37, 960, 288)])
def test_int8_plain_bit_equal_to_pallas_kernel(M, K, N):
    rng = np.random.default_rng(3)
    xq = rng.integers(-127, 128, (M, K), dtype=np.int8)
    wq = rng.integers(-127, 128, (K, N), dtype=np.int8)
    sx = rng.uniform(0.01, 1, M).astype(np.float32)
    sw = rng.uniform(0.01, 1, N).astype(np.float32)
    got = tmm.int8_matmul_plain(_t(xq), _t(wq), _t(sx), _t(sw))
    kern = jmm.int8_matmul(jnp.asarray(xq), jnp.asarray(wq), jnp.asarray(sx),
                           jnp.asarray(sw), interpret=True)
    ref = jmm_ref.int8_matmul_ref(jnp.asarray(xq), jnp.asarray(wq),
                                  jnp.asarray(sx), jnp.asarray(sw))
    np.testing.assert_array_equal(got.numpy(), np.asarray(kern))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("lead", [(40,), (2, 7)])
def test_qt_matmul_native_bit_equal_to_reference(lead):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((*lead, 96)).astype(np.float32)
    w = (rng.standard_normal((96, 72)) * 0.1).astype(np.float32)
    want = jqt.matmul(jnp.asarray(x), jqt.quantize_weight(jnp.asarray(w)),
                      mode="native")
    got = tqt.matmul(_t(x), tqt.quantize_weight(_t(w)), mode="native")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    xq, sx = tqt._quantize_rows(_t(x).reshape(-1, 96))
    jxq, jsx = jqt._quantize_rows(jnp.asarray(x).reshape(-1, 96))
    np.testing.assert_array_equal(xq.numpy(), np.asarray(jxq))
    np.testing.assert_array_equal(sx.numpy(), np.asarray(jsx))


def test_qt_matmul_dequant_lane_and_float_passthrough():
    rng = np.random.default_rng(6)
    x = rng.standard_normal((6, 10, 64)).astype(np.float32)
    w = rng.standard_normal((64, 32)).astype(np.float32)
    q = tqt.quantize_weight(_t(w))
    want = jqt.matmul(jnp.asarray(x), jqt.quantize_weight(jnp.asarray(w)),
                      mode="dequant")
    got = tqt.matmul(_t(x), q, mode="dequant")
    assert float((got - _t(np.asarray(want))).abs().max()) <= 1e-5
    wf = q.dequant()
    assert torch.equal(tqt.matmul(_t(x), wf), torch.matmul(_t(x), wf))


def test_cast_tree_matches_reference():
    """Float leaves cast; QuantTensor leaves keep codes and scales and
    retarget their output dtype; integer leaves pass through."""
    rng = np.random.default_rng(7)
    w = rng.standard_normal((16, 8)).astype(np.float32)
    b = rng.standard_normal(8).astype(np.float32)
    idx = np.arange(4, dtype=np.int32)
    want = jqt.cast_tree({"w": jqt.quantize_weight(jnp.asarray(w)),
                          "b": jnp.asarray(b), "i": jnp.asarray(idx)},
                         jnp.float16)
    got = tqt.cast_tree({"w": tqt.quantize_weight(_t(w)), "b": _t(b),
                         "i": _t(idx)}, torch.float16)
    assert got["w"].out_dtype == want["w"].out_dtype == "float16"
    np.testing.assert_array_equal(got["w"].q.numpy(), np.asarray(want["w"].q))
    assert got["w"].scale.dtype == torch.float32
    np.testing.assert_array_equal(got["b"].numpy(), np.asarray(want["b"]))
    assert got["i"].dtype == torch.int32
    np.testing.assert_array_equal(got["w"].dequant().numpy(),
                                  np.asarray(want["w"].dequant()))


def test_quant_mode_precedence(monkeypatch):
    """env REPRO_QUANT (cached) > per-call arg > set_quant_mode >
    native; quant_scope restores on exit; "dequant" is only ever a
    request, never a fallback."""
    assert dispatch.resolve_quant() == "native"
    assert dispatch.resolve_quant("dequant") == "dequant"
    with dispatch.quant_scope("dequant"):
        assert dispatch.resolve_quant() == "dequant"
        assert dispatch.resolve_quant("native") == "native"
    assert dispatch.resolve_quant() == "native"
    monkeypatch.setenv(dispatch.QUANT_ENV_VAR, "dequant")
    assert dispatch.resolve_quant() == "native", "env is cached"
    dispatch.refresh_from_env()
    try:
        assert dispatch.resolve_quant() == "dequant"
        assert dispatch.resolve_quant("native") == "dequant"
    finally:
        monkeypatch.delenv(dispatch.QUANT_ENV_VAR)
        dispatch.refresh_from_env()
    with pytest.raises(ValueError):
        dispatch.set_quant_mode("bogus")


# ---------------------------------------------------------------------------
# pruning and compression


def test_prune_kept_heads_match_reference(sim):
    jp, tp = sim
    cfg = jcfg.SIM
    np.testing.assert_array_equal(tprune.w_o_head_norms(tcfg.SIM, tp),
                                  jprune.w_o_head_norms(cfg, jp))
    for k in (1, 2):
        jc2, jpp, jkept = jprune.prune_heads(cfg, jp, k)
        tc2, tpp, tkept = tprune.prune_heads(tcfg.SIM, tp, k)
        assert tkept == jkept and tc2.n_heads == jc2.n_heads
        want = convert.params_from_jax(_np_tree(jpp), tc2, device="cpu")
        for gb, wb in zip(tpp["blocks"], want["blocks"]):
            for key in ("w_qkv", "b_qkv", "w_o"):
                assert torch.equal(gb["attn"][key], wb["attn"][key]), key
    with pytest.raises(AssertionError):
        tprune.prune_heads(tcfg.SIM, tp, tcfg.SIM.n_heads)


def test_zero_heads_matches_reference(sim):
    jp, tp = sim
    dropped = [[l % jcfg.SIM.n_heads] for l in range(jcfg.SIM.n_layers)]
    want = convert.params_from_jax(
        _np_tree(jprune.zero_heads(jcfg.SIM, jp, dropped)), tcfg.SIM,
        device="cpu")
    got = tprune.zero_heads(tcfg.SIM, tp, dropped)
    for gb, wb in zip(got["blocks"], want["blocks"]):
        assert torch.equal(gb["attn"]["w_o"], wb["attn"]["w_o"])


def test_score_heads_with_calibration_frames_match_reference(sim):
    jp, tp = sim
    H = jcfg.SIM.vit.img_size[0]
    frames = [np.random.default_rng(i).uniform(0, 1, (H, H, 3))
              .astype(np.float32) for i in range(2)]
    want = jprune.score_heads(jcfg.SIM, jp, frames)
    got = tprune.score_heads(tcfg.SIM, tp, frames)
    np.testing.assert_allclose(got, want, rtol=1e-4)
    _, _, jkept = jprune.prune_heads(jcfg.SIM, jp, 1, want)
    _, _, tkept = tprune.prune_heads(tcfg.SIM, tp, 1, got)
    assert tkept == jkept


@pytest.mark.parametrize("spec", [("int8", "fp32", 0), ("int8", "fp32", 1),
                                  ("fp32", "fp32", 1)])
def test_compress_report_matches_reference(sim, spec):
    jp, tp = sim
    jc2, jq, jrep = jptq.compress(jcfg.SIM, jp, jptq.QuantSpec(*spec))
    tc2, tq, trep = tptq.compress(tcfg.SIM, tp, tptq.QuantSpec(*spec))
    for key in ("spec", "bytes_fp32", "bytes", "ratio", "prune_heads"):
        assert trep[key] == jrep[key], key
    assert trep.get("kept_heads") == jrep.get("kept_heads")
    assert trep.get("dropped_heads") == jrep.get("dropped_heads")
    assert tc2.n_heads == jc2.n_heads
    # the port's own compression equals the converted reference tree
    want = convert.params_from_jax(_np_tree(jq), tc2, device="cpu")
    for key in ("pos_seq", "pos_bank"):
        assert torch.equal(tq[key], want[key])
    for got_blk, want_blk in zip(tq["blocks"], want["blocks"]):
        for key in ("w_qkv", "w_o"):
            g, w = got_blk["attn"][key], want_blk["attn"][key]
            if spec[0] == "int8":
                assert torch.equal(g.q, w.q) and torch.equal(g.scale,
                                                             w.scale)
            else:
                assert torch.equal(g, w)
    if spec[0] == "int8":
        assert trep["ratio"] >= 3.5
        g, w = tq["head"]["tower"]["w"], want["head"]["tower"]["w"]
        assert g.axis == 0 and torch.equal(g.q, w.q)


@pytest.mark.parametrize("spec", [("int8", "fp16", 0), ("fp16", "fp16", 0),
                                  ("bf16", "fp32", 0)])
def test_compress_refuses_half_lanes(sim, spec):
    """The half lanes, once refused, compress as the reference does: the
    same report, and a tree equal to the reference's compressed tree
    converted (half leaves, QuantTensors with half outputs, the position
    layouts derived from the half or dequantized grid)."""
    jp, tp = sim
    jc2, jq, jrep = jptq.compress(jcfg.SIM, jp, jptq.QuantSpec(*spec))
    tc2, tq, trep = tptq.compress(tcfg.SIM, tp, tptq.QuantSpec(*spec))
    for key in ("spec", "bytes_fp32", "bytes", "ratio", "weight_dtype",
                "act_dtype"):
        assert trep[key] == jrep[key], key
    half = tptq.DTYPES[spec[1] if spec[0] == "int8" else spec[0]]
    want = convert.params_from_jax(_np_tree(jq), tc2, device="cpu")
    assert tq["patch_embed"]["b"].dtype == half
    for key in ("pos_seq", "pos_bank"):
        assert tq[key].dtype == half and torch.equal(tq[key], want[key])
    for got_blk, want_blk in zip(tq["blocks"], want["blocks"]):
        for key in ("w_qkv", "w_o"):
            g, w = got_blk["attn"][key], want_blk["attn"][key]
            if spec[0] == "int8":
                assert g.out_dtype == w.out_dtype == str(half)[6:]
                assert torch.equal(g.q, w.q) and torch.equal(g.scale,
                                                             w.scale)
            else:
                assert g.dtype == half and torch.equal(g, w)


# ---------------------------------------------------------------------------
# quantized forward: the reference's compressed tree through both packages


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def qmodel(request):
    jc, tc = CONFIGS[request.param]
    jp = jvb.init_vitdet_params(jc, jax.random.PRNGKey(0))
    jc2, jq, _ = jptq.compress(jc, jp, jptq.QuantSpec("int8", "fp32", 1))
    tc2 = tc.replace(n_heads=jc2.n_heads, n_kv_heads=jc2.n_kv_heads)
    tq = convert.params_from_jax(_np_tree(jq), tc2, device="cpu")
    H, W = jc.vit.img_size
    img = np.random.default_rng(0).uniform(0, 1, (2, H, W, 3)) \
        .astype(np.float32)
    return jc2, tc2, jq, tq, img


def _rel(got: torch.Tensor, want) -> float:
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    return float(np.abs(got.numpy() - want).max() / np.abs(want).max())


def _layout(jc, beta):
    part = jvb.vit_partition(jc)
    nR = part.n_regions
    a = np.zeros(nR, np.int8)
    a[[1, nR - 2]] = jpt.LOW
    b = np.zeros(nR, np.int8)
    b[[0, nR // 2]] = jpt.LOW
    if beta:
        a[2] = jpt.REUSE
        b[nR - 1] = jpt.REUSE
    lb = max(jpt.length_bucket_set(part))
    arrays, _ = jpt.stack_plan_layouts(
        [jpt.plan_layout(s, lb, part) for s in (a, b)])
    return arrays


@pytest.mark.parametrize("beta", [None, 0, 2])
def test_quantized_forward_matches_reference(qmodel, beta):
    """Full resolution (beta None), restore at input (0) and the fused
    padded lane (2), with capture where the lane has one."""
    jc, tc, jq, tq, img = qmodel
    kw_j, kw_t = {}, {}
    if beta is not None:
        arrays = _layout(jc, beta)
        kw_j = {"beta": beta,
                "layout": {k: jnp.asarray(v) for k, v in arrays.items()}}
        kw_t = {"beta": beta,
                "layout": {k: _t(v) for k, v in arrays.items()}}
        if beta:
            part = tvb.vit_partition(tc)
            tiles = np.random.default_rng(1).standard_normal(
                (2, part.n_regions, part.windows_per_full_region,
                 part.tokens_low_region, tc.d_model)).astype(np.float32)
            kw_j.update(reuse_tiles=jnp.asarray(tiles), capture_beta=beta)
            kw_t.update(reuse_tiles=_t(tiles), capture_beta=beta)
    want = jvb.forward_features(jc, jq, jnp.asarray(img), backend="xla",
                                **kw_j)
    got = tvb.forward_features(tc, tq, _t(img), **kw_t)
    if beta:
        (got, got_tiles), (want, want_tiles) = got, want
        assert _rel(got_tiles, want_tiles) <= QUANT_RTOL
    assert _rel(got, want) <= QUANT_RTOL
    assert float(np.abs(got.numpy() - np.asarray(want)).mean()) \
        <= QUANT_MEAN_RTOL * float(np.abs(np.asarray(want)).max())
    if beta:
        # the dequant oracle lane has no row quantization: fp32 parity
        with jdispatch.quant_scope("dequant"), \
                dispatch.quant_scope("dequant"):
            want = jvb.forward_features(jc, jq, jnp.asarray(img),
                                        backend="xla", **kw_j)[0]
            got = tvb.forward_features(tc, tq, _t(img), **kw_t)[0]
        assert float(np.abs(got.numpy() - np.asarray(want)).max()) <= TOL
