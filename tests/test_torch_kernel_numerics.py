"""The arithmetic of the port's two tensor-core kernels, checked on the
CPU before the card runs them.

``window_attention``'s kernel computes both products in the 3xTF32
scheme: each float32 operand x splits into x_hi, x with its low 13
mantissa bits cleared, and x_lo = x - x_hi, of which the tensor core
reads only the top TF32 bits (again the low 13 cleared); a product keeps
a_lo*b_hi + a_hi*b_lo + a_hi*b_hi in a float32 sum.  The emulation below
does that arithmetic in plain torch and is held to 1e-4 absolute, the
kernel's tolerance on the card, against the plain version and the
reference's dense oracle, on unit-normal inputs.

``int8_matmul``'s TMA loads need K to be a multiple of 16; the wrapper
zero-pads it (``pad_k``), which must leave the result bit-equal.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.window_attention.ref import window_attention_ref
from repro_torch.kernels.int8_matmul import ops as tmm
from repro_torch.kernels.window_attention import ops as twin

torch.set_num_threads(2)

TOL = 1e-4          # window_attention, kernel (here: emulation) vs plain


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """x with the low 13 of its 23 mantissa bits cleared."""
    return (x.view(torch.int32) & ~0x1FFF).view(torch.float32)


def _mm_3xtf32(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a_hi, b_hi = _tf32(a), _tf32(b)
    a_lo, b_lo = _tf32(a - a_hi), _tf32(b - b_hi)
    # products of two TF32 values are exact in float32
    return (torch.einsum(eq, a_lo, b_hi) + torch.einsum(eq, a_hi, b_lo)
            + torch.einsum(eq, a_hi, b_hi))


def window_attention_3xtf32(q, k, v, window, win_valid=None):
    """The window kernel's arithmetic: 3xTF32 products, softmax in float32,
    the rows divided by their sum at the end."""
    B, T, H, Dh = q.shape
    KV = k.shape[2]
    W = T // window
    qw = q.reshape(B, W, window, KV, H // KV, Dh)
    kw = k.reshape(B, W, window, KV, Dh)
    vw = v.reshape(B, W, window, KV, Dh)
    s = _mm_3xtf32("bwikgd,bwjkd->bwkgij", qw, kw) * Dh ** -0.5
    e = torch.exp(s - s.amax(-1, keepdim=True))
    inv = 1.0 / e.sum(-1).permute(0, 1, 4, 2, 3)[..., None]
    o = _mm_3xtf32("bwkgij,bwjkd->bwikgd", e, vw) * inv
    if win_valid is not None:
        keep = torch.arange(W)[None, :] < win_valid[:, None]
        o = o * keep[:, :, None, None, None, None]
    return o.reshape(B, T, H, Dh)


def _inputs(rng, B, W, w2, H, KV, Dh, fused):
    """q, k, v (B, W * w2, ., Dh) from unit normals: dense, or as column
    views of one fused (B, T, (H + 2 KV) * Dh) QKV product."""
    T = W * w2
    if fused:
        qkv = torch.from_numpy(rng.standard_normal(
            (B, T, (H + 2 * KV) * Dh)).astype(np.float32))
        q, k, v = qkv.split((H * Dh, KV * Dh, KV * Dh), dim=-1)
        return (q.reshape(B, T, H, Dh), k.reshape(B, T, KV, Dh),
                v.reshape(B, T, KV, Dh))
    return tuple(torch.from_numpy(rng.standard_normal(
        (B, T, n, Dh)).astype(np.float32)) for n in (H, KV, KV))


@pytest.mark.parametrize("valid", [None, (1, 3)])
@pytest.mark.parametrize("heads", ["gqa_4_2", "fused_15"])
@pytest.mark.parametrize("w2,Dh", [(64, 64), (4, 16)])
def test_window_3xtf32_matches_plain_and_reference(w2, Dh, heads, valid):
    rng = np.random.default_rng(11)
    B, W = 2, 3
    H, KV, fused = (4, 2, False) if heads == "gqa_4_2" else (15, 15, True)
    q, k, v = _inputs(rng, B, W, w2, H, KV, Dh, fused)
    assert not fused or q.stride(1) == 3 * H * Dh
    wv = None if valid is None else torch.tensor(valid, dtype=torch.int32)
    got = window_attention_3xtf32(q, k, v, w2, wv)
    plain = twin.window_attention_plain(q, k, v, w2, wv)
    assert float((got - plain).abs().max()) <= TOL
    ref = torch.from_numpy(np.asarray(window_attention_ref(
        *(jnp.asarray(np.ascontiguousarray(t.numpy())) for t in (q, k, v)),
        w2)))
    if wv is not None:
        ref = ref.reshape(B, W, w2, H, Dh)
        for b in range(B):
            ref[b, valid[b]:] = 0.0
        ref = ref.reshape(B, W * w2, H, Dh)
    assert float((got - ref).abs().max()) <= TOL
    if wv is not None:
        out = got.reshape(B, W, w2, H, Dh)
        for b in range(B):
            assert torch.count_nonzero(out[b, valid[b]:]) == 0


def test_tf32_split_is_what_the_kernel_feeds_the_tensor_cores():
    """hi keeps the top 11 significant bits; hi + lo is x to 2^-21."""
    x = torch.from_numpy(np.random.default_rng(12).standard_normal(
        10000).astype(np.float32))
    hi = _tf32(x)
    assert torch.all((hi.view(torch.int32) & 0x1FFF) == 0)
    err = (x - hi - _tf32(x - hi)).abs() / x.abs()
    assert float(err.max()) <= 2.0 ** -21


# ---------------------------------------------------------------------------
# int8_matmul: the wrapper's K padding is exact


@pytest.mark.parametrize("K", [0, 1, 100, 112, 960])
def test_int8_pad_k_is_exact(K):
    rng = np.random.default_rng(13)
    M, N = 37, 130
    xq = torch.from_numpy(rng.integers(-127, 128, (M, K), dtype=np.int8))
    wq = torch.from_numpy(rng.integers(-127, 128, (N, K), dtype=np.int8)).t()
    sx = torch.from_numpy(rng.uniform(0.01, 1, M).astype(np.float32))
    sw = torch.from_numpy(rng.uniform(0.01, 1, N).astype(np.float32))
    xp, wp = tmm.pad_k(xq, wq)
    Kp = xp.shape[1]
    assert Kp % tmm.K_ALIGN == 0 and Kp == max(16, -(-K // 16) * 16)
    assert wp.shape == (Kp, N) and wp.t().is_contiguous()
    assert xp.is_contiguous() and xp.dtype == wp.dtype == torch.int8
    if Kp == K:
        assert xp is xq and wp is wq
    assert torch.equal(xp[:, :K], xq) and torch.equal(wp[:K], wq)
    assert torch.count_nonzero(xp[:, K:]) == 0
    assert torch.count_nonzero(wp[K:]) == 0
    assert torch.equal(tmm.int8_matmul_plain(xp, wp, sx, sw),
                       tmm.int8_matmul_plain(xq, wq, sx, sw))


@pytest.mark.parametrize("K,N,tile", [(768, 1024, 128), (1024, 2880, 128),
                                      (960, 1024, 128), (1024, 4096, 128),
                                      (4096, 1024, 256)])
def test_int8_tile_width_follows_the_bound(K, N, tile):
    """The five GEMMs of the quantized ViTDet-L: only the MLP down
    projection (K = 4096) is bound by the tensor cores at M >> N, K."""
    assert tmm.tile_n(N, K) == tile
