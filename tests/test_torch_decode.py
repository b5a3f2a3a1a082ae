"""Port parity: the decode-attention kernel's plain version against the
reference's Pallas decode kernel (interpret mode on the CPU) and its
dense oracle, at the reference's own test shapes; the device routing of
``sdpa``; and, on the card, the CUDA kernel against the plain version.

Tolerance: float32 softmax attention whose summation order differs
between the two frameworks, <= 2e-5 absolute and relative on
unit-normal inputs (the reference's own decode tests use 2e-5).  On the
card the kernel is held to 1e-5 absolute (``chip_smoke.py`` runs the
same check at the full-width shapes).
"""
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention import decode_attention as jdecode
from repro.kernels.decode_attention.ref import decode_attention_ref
from repro_torch.kernels import dispatch
from repro_torch.kernels.decode_attention import ops as tdec
from repro_torch.kernels.decode_attention import ref as tref
from repro_torch.models import attention as tattn

torch.set_num_threads(2)
TOL = 2e-5
CARD_TOL = 1e-5


def _inputs(seed, B, S, H, KV, Dh, kv_len=None):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, 1, H, Dh)).astype(np.float32)
    k = rng.standard_normal((B, S, KV, Dh)).astype(np.float32)
    v = rng.standard_normal((B, S, KV, Dh)).astype(np.float32)
    if kv_len is None:
        kv_len = rng.integers(1, S + 1, (B,))
    return q, k, v, np.asarray(kv_len, np.int32)


def _plain(q, k, v, kv_len):
    return tdec.decode_attention_plain(*(torch.from_numpy(a) for a in
                                         (q, k, v, kv_len))).numpy()


def _both_refs(q, k, v, kv_len, **kw):
    a = [jnp.asarray(x) for x in (q, k, v, kv_len)]
    return np.asarray(jdecode(*a, **kw)), np.asarray(decode_attention_ref(*a))


@pytest.mark.parametrize("shape", [
    (2, 1024, 8, 2, 64),
    (4, 777, 32, 8, 128),     # ragged cache length
    (1, 4096, 4, 4, 64),      # MHA (G = 1)
    (2, 300, 16, 1, 32),      # MQA (G = 16)
])
def test_decode_plain_matches_reference(shape):
    q, k, v, kv_len = _inputs(sum(shape), *shape)
    got = _plain(q, k, v, kv_len)
    pallas, ref = _both_refs(q, k, v, kv_len)
    np.testing.assert_allclose(got, pallas, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("kv_len_val", [1, 511, 512])
def test_decode_plain_kv_len_edges(kv_len_val):
    """A single valid key, one short of a block, the full cache."""
    q, k, v, kv_len = _inputs(11, 2, 512, 8, 4, 64, [kv_len_val] * 2)
    got = _plain(q, k, v, kv_len)
    pallas, ref = _both_refs(q, k, v, kv_len)
    np.testing.assert_allclose(got, pallas, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("G", [1, 2, 3, 4, 6])
def test_decode_plain_gqa_groups(G):
    """GQA groups 1/2/3/4/6 (6: dbrx-132b's 48 heads over 8) against a
    cache of 300, not a multiple of the Pallas kernel's 128-key block."""
    q, k, v, kv_len = _inputs(31 + G, 2, 300, 4 * G, 4, 64)
    got = _plain(q, k, v, kv_len)
    pallas, ref = _both_refs(q, k, v, kv_len, bs=128)
    np.testing.assert_allclose(got, pallas, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL)


def test_decode_plain_empty_row_is_zero_like_the_pallas_kernel():
    """kv_len == 0: the Pallas kernel and the port give zeros (the dense
    oracle gives the mean of V: its finite NEG_INF makes a uniform
    softmax).  No serving input reaches it (kv_len = pos + 1)."""
    q, k, v, kv_len = _inputs(5, 3, 64, 8, 2, 32, [0, 7, 64])
    got = _plain(q, k, v, kv_len)
    pallas, ref = _both_refs(q, k, v, kv_len)
    assert not got[0].any()
    np.testing.assert_allclose(got, pallas, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got[1:], ref[1:], rtol=TOL, atol=TOL)
    np.testing.assert_allclose(ref[0, 0], v[0].mean(0).repeat(4, 0),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape", [
    (8, 8, 4, 152),        # Qwen3-4B serving: 64 groups, ~32-key splits
    (8, 32, 1, 1040),      # zamba2-1.2b shared attention (G = 1)
    (8, 8, 4, 8192),       # the ragged long cache: 8 splits of 1,024
    (1, 1, 1, 1), (1, 1, 1, 0), (8, 8, 4, 33), (1, 1, 16, 300),
    (2, 2, 4, 256), (64, 8, 4, 4096), (4, 8, 8, 100000),
])
def test_split_plan(shape):
    """The cluster plan: splits of a multiple of KEY_ALIGN keys cover
    [0, S) without overlap and with none wholly past S, at most one
    portable cluster of 8 of them; the serving shape puts at least two
    blocks on every SM of the H100's 132; the ragged cache gets the
    8 splits of 1,024; and the plan is a function of the shapes alone
    (no kv_len argument, so a CUDA graph can replay it)."""
    B, KV, G, S = shape
    n, keys = tdec.plan(B, KV, G, S, 132)
    assert 1 <= n <= tdec.MAX_CLUSTER and keys % tdec.KEY_ALIGN == 0
    bounds = [(i * keys, min((i + 1) * keys, S)) for i in range(n)]
    assert bounds[0][0] == 0 and bounds[-1][1] == S
    assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
    assert S == 0 or all(lo < hi for lo, hi in bounds)
    blocks = B * KV * -(-G // tdec.MAX_GROUP) * n
    if shape == (8, 8, 4, 152):
        assert blocks >= 2 * 132 and keys <= 32
    if shape == (8, 8, 4, 8192):
        assert (n, keys) == (8, 1024)
    assert list(inspect.signature(tdec.plan).parameters) == \
        ["B", "KV", "G", "S", "sms"]


@pytest.mark.parametrize("shape,lens", [
    ((2, 256, 8, 2, 64), [0, 1]),            # no key; one key
    ((2, 256, 8, 2, 64), [64, 256]),         # a split boundary; kv_len = S
    ((3, 300, 8, 8, 32), [5, 150, 299]),     # G = 1; splits past kv_len
    ((2, 200, 8, 1, 16), [33, 200]),         # G = 8, Dh = 16
    ((2, 152, 32, 8, 128), [129, 96]),       # serving widths; boundary
    ((1, 1040, 4, 4, 64), [1032]),           # zamba2's G = 1, Dh = 64
    ((2, 40, 16, 1, 32), [0, 40]),           # two groups of 8 heads
    ((2, 200, 6, 6, 64), [77, 200]),         # G = 1, KV not a multiple of 4
    ((2, 152, 48, 8, 128), [129, 152]),      # dbrx-132b's G = 6
    ((2, 200, 12, 4, 64), [33, 200]),        # G = 3
])
def test_split_merge_matches_reference(shape, lens):
    """The kernel's split -> partial (m, l, acc) -> merge path in plain
    torch (``ref.decode_attention_split``: each row's valid keys cut into
    the cluster size the wrapper would launch on 132 SMs) against the reference's Pallas kernel in interpret
    mode, its dense oracle and the port's plain version, to TOL.  A row
    with kv_len 0 is zeros, as the Pallas kernel gives (the dense oracle's
    finite NEG_INF gives the mean of V there, so it is left out)."""
    B, S, H, KV, Dh = shape
    q, k, v, kv_len = _inputs(sum(shape), *shape, lens)
    n, keys = tdec.plan(B, KV, H // KV, S, 132)
    runs = (-(-kv_len // n) + 7) // 8 * 8    # the kernel's run per row
    assert (runs <= keys).all()                # the ring sized by the plan
    got = tref.decode_attention_split(
        *(torch.from_numpy(a) for a in (q, k, v, kv_len)), n).numpy()
    pallas, ref = _both_refs(q, k, v, kv_len)
    live = kv_len > 0
    assert not got[~live].any()
    np.testing.assert_allclose(got, pallas, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got[live], ref[live], rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got, _plain(q, k, v, kv_len), rtol=TOL,
                               atol=TOL)


def test_wrapper_refuses_what_the_kernel_does_not_take():
    q, k, v, kv_len = (torch.from_numpy(a) for a in
                       _inputs(3, 2, 64, 8, 2, 32))
    with pytest.raises(ValueError):                  # two query tokens
        tdec.decode_attention_cuda(q.expand(2, 2, 8, 32), k, v, kv_len)
    with pytest.raises(ValueError):                  # head dim 48
        tdec.decode_attention_cuda(q[..., :24].repeat(1, 1, 1, 2),
                                   k[..., :24].repeat(1, 1, 1, 2),
                                   v[..., :24].repeat(1, 1, 1, 2), kv_len)
    with pytest.raises(ValueError):                  # CPU tensors
        tdec.decode_attention_cuda(q, k, v, kv_len)
    assert dispatch.launch_counts()["decode_attention"] == 0


def test_sdpa_routes_one_token_cache_reads_to_the_decode_kernel(monkeypatch):
    """The reference's kernel-lane routing: a one-token ``kv_len`` read
    goes to decode_attention, the plain (causal) case to flash, and a
    multi-token ``kv_len`` mask (the padded ViT's pre-restoration global
    blocks) to the dense path."""
    calls = []
    for name in ("decode_attention", "flash_attention"):
        real = getattr(dispatch, name)
        monkeypatch.setattr(dispatch, name, lambda *a, _n=name, _r=real,
                            **kw: calls.append(_n) or _r(*a, **kw))
    q, k, v, kv_len = (torch.from_numpy(a) for a in
                       _inputs(9, 2, 40, 8, 2, 32))
    want = tdec.decode_attention_plain(q, k, v, kv_len)
    assert torch.equal(tattn.sdpa(q, k, v, kv_len=kv_len), want)
    assert calls == ["decode_attention"]
    calls.clear()
    qq = torch.randn(2, 40, 8, 32)
    tattn.sdpa(qq, k, v, causal=True)
    assert calls == ["flash_attention"]
    calls.clear()
    out = tattn.sdpa(qq, k, v, kv_len=kv_len)
    assert calls == []
    assert torch.allclose(out[:, :1], tattn._sdpa_dense(qq[:, :1], k, v,
                                                        kv_len=kv_len))
    tattn.sdpa(q, k, v, kv_len=kv_len, scale=0.5)    # explicit scale: dense
    assert calls == []


def test_dense_causal_offset_matches_reference():
    """The masked dense path with causal + q_offset (a chunked query
    block) against the reference's ``_sdpa_dense``."""
    from repro.models.attention import _sdpa_dense as jdense
    rng = np.random.default_rng(2)
    q = rng.standard_normal((2, 5, 8, 16)).astype(np.float32)
    k = rng.standard_normal((2, 12, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, 12, 2, 16)).astype(np.float32)
    kv_len = np.array([9, 12], np.int32)
    got = tattn._sdpa_dense(*(torch.from_numpy(a) for a in (q, k, v)),
                            causal=True, q_offset=4,
                            kv_len=torch.from_numpy(kv_len), scale=0.3)
    want = jdense(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                  causal=True, q_offset=4, kv_len=jnp.asarray(kv_len),
                  scale=0.3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,lens", [
    ((8, 152, 32, 8, 128), [129] * 8),
    ((8, 8192, 32, 8, 128), [8192, 6000, 4097, 2048, 513, 64, 1, 8192]),
    ((2, 300, 16, 1, 32), [0, 300]),
    ((3, 777, 8, 4, 16), [1, 511, 777]),
    ((8, 1040, 32, 32, 64), [1032] * 8),     # zamba2: G = 1, Dh = 64
    ((2, 256, 8, 2, 64), [0, 1]),            # no key; one key
    ((2, 256, 8, 2, 64), [64, 256]),         # a split boundary; kv_len = S
    ((3, 300, 8, 8, 32), [5, 150, 299]),     # splits wholly past kv_len
    ((2, 200, 8, 1, 16), [33, 200]),         # G = 8, Dh = 16
    ((2, 200, 6, 6, 64), [77, 200]),         # G = 1, KV not a multiple of 4
    ((8, 152, 48, 8, 128), [129] * 8),       # dbrx-132b's serving step
    ((3, 152, 48, 8, 128), [0, 1, 152]),     # ... at its kv_len edges
])
def test_decode_kernel_matches_plain_on_card(shape, lens):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (chip_smoke.py runs this "
                    "check on the H100)")
    q, k, v, kv_len = (torch.from_numpy(a).cuda() for a in
                       _inputs(4, *shape, lens))
    got = tdec.decode_attention_cuda(q, k, v, kv_len)
    want = tdec.decode_attention_plain(q, k, v, kv_len)
    assert float((got - want).abs().max()) <= CARD_TOL
