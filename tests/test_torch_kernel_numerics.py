"""The arithmetic of the port's tensor-core kernels, checked on the CPU
before the card runs them.

``window_attention``'s kernel computes both products in the 3xTF32
scheme: each float32 operand x splits into x_hi, x with its low 13
mantissa bits cleared, and x_lo = x - x_hi, of which the tensor core
reads only the top TF32 bits (again the low 13 cleared); a product keeps
a_lo*b_hi + a_hi*b_lo + a_hi*b_hi in a float32 sum.  The emulation below
does that arithmetic in plain torch and is held to 1e-4 absolute, the
kernel's tolerance on the card, against the plain version and the
reference's dense oracle, on unit-normal inputs.

``flash_attention`` and ``ssd_scan`` compute their products in the
same scheme.  Their emulations below follow the kernels' decomposition:
flash's online softmax in base 2 over 64-key tiles, rescaled per tile,
P split as it leaves the scores, each tile's P V from zero (a model of
the tensor cores' truncating accumulation shows why); the SSD scan's chunk-parallel split into
per-group C.B scores, chunk-local states (the decay weights folded into
B before the split), sequential state passing and per-chunk outputs with
the decay evaluated only at or below the diagonal.  Flash is held to
1e-4 absolute, the SSD scan to 1e-4 of its largest value, against the
port's plain versions and the reference (flash's Pallas kernel in
interpret mode and its oracle; ``ssd_ops.ssd`` in interpret mode and
``ssd_chunked``).

``int8_matmul``'s TMA loads need K to be a multiple of 16; the wrapper
zero-pads it (``pad_k``), which must leave the result bit-equal.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ops as jflash
from repro.kernels.flash_attention.ref import flash_attention_ref
from repro.kernels.ssd_scan import ops as jssd
from repro.kernels.window_attention import ops as jwin
from repro.kernels.window_attention.ref import window_attention_ref
from repro.models import mamba2 as jm2
from repro_torch.kernels import build as tbuild
from repro_torch.kernels.flash_attention import ops as tflash
from repro_torch.kernels.int8_matmul import ops as tmm
from repro_torch.kernels.ssd_scan import ops as tssd
from repro_torch.kernels.window_attention import ops as twin

torch.set_num_threads(2)

TOL = 1e-4          # attention, kernel (here: emulation) vs plain, absolute
SSD_TOL = 1e-4      # SSD scan, of the largest value
LOG2E = 1.4426950408889634


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
# flash_attention: tiled online softmax on 3xTF32 products


def flash_3xtf32(q, k, v, causal=False, tile=64):
    """The flash kernel's arithmetic: per 64-key tile, S = Q K^T in 3xTF32
    scaled by scale * log2(e), masked scores -inf, the running max (a row
    no key has reached subtracts 0), exp2, the tile's probabilities
    added to the rescaled row sum and P V (P split as a 3xTF32 operand)
    to the rescaled output; rows divided by their sum at the end, 0 where
    it is 0."""
    B, T, H, Dh = q.shape
    S, KV = k.shape[1], k.shape[2]
    G = H // KV
    qg = q.reshape(B, T, KV, G, Dh)
    m = torch.full((B, KV, G, T), float("-inf"))
    lsum = torch.zeros((B, KV, G, T))
    o = torch.zeros((B, KV, G, T, Dh))
    rows = torch.arange(T)[:, None]
    for k0 in range(0, S, tile):
        if causal and k0 > T - 1:
            break                       # wholly above the diagonal
        kt, vt = k[:, k0:k0 + tile], v[:, k0:k0 + tile]
        s = _mm_3xtf32("btkgd,bskd->bkgts", qg, kt) * (Dh ** -0.5 * LOG2E)
        if causal:
            seen = rows >= torch.arange(k0, k0 + kt.shape[1])[None, :]
            s = s.masked_fill(~seen, float("-inf"))
        m_new = torch.maximum(m, s.amax(-1))
        m_ref = torch.where(m_new == float("-inf"), 0.0, m_new)
        alpha = torch.exp2(m - m_ref)
        p = torch.exp2(s - m_ref[..., None])
        lsum = lsum * alpha + p.sum(-1)
        o = o * alpha[..., None] + _mm_3xtf32("bkgts,bskd->bkgtd", p, vt)
        m = m_new
    inv = torch.where(lsum > 0, 1.0 / lsum, 0.0)
    out = o * inv[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(B, T, H, Dh)


# (B, T, S, H, KV, Dh): GQA groups 1, 3, 4 and 6 (dbrx-132b's 48 / 8 at
# its mixed prefill's T = 96), T and S off the 64-key tile, S < T, every
# head width the kernel builds, and whisper's decode-step cross-attention
# (one query row against the 1500 encoder frames)
FLASH_SHAPES = [(1, 130, 130, 4, 4, 16), (2, 100, 77, 8, 2, 32),
                (1, 200, 150, 4, 1, 64), (1, 70, 200, 2, 2, 128),
                (1, 64, 64, 4, 1, 64), (1, 70, 130, 6, 2, 32),
                (1, 96, 96, 12, 2, 128), (1, 1, 1500, 4, 4, 64)]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", FLASH_SHAPES)
def test_flash_3xtf32_matches_plain_and_reference(shape, causal):
    B, T, S, H, KV, Dh = shape
    rng = np.random.default_rng(sum(shape) + causal)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((B, T, H, Dh), (B, S, KV, Dh), (B, S, KV, Dh)))
    got = flash_3xtf32(*map(torch.from_numpy, (q, k, v)), causal)
    plain = tflash.flash_attention_plain(*map(torch.from_numpy, (q, k, v)),
                                         causal)
    assert float((got - plain).abs().max()) <= TOL
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    for want in (jflash.flash_attention(jq, jk, jv, causal=causal),
                 flash_attention_ref(jq, jk, jv, causal=causal)):
        assert float(np.abs(got.numpy() - np.asarray(want)).max()) <= TOL


def test_flash_3xtf32_row_no_key_reaches_is_zero():
    """No key at all (S = 0), and a tile that masks a row completely after
    an earlier tile reached it (causal, rows below 64 in the second
    tile): zeros for the first, the plain version for the second."""
    rng = np.random.default_rng(21)
    q = torch.from_numpy(rng.standard_normal((1, 70, 2, 16))
                         .astype(np.float32))
    empty = torch.zeros((1, 0, 2, 16))
    got = flash_3xtf32(q, empty, empty)
    assert torch.count_nonzero(got) == 0
    assert torch.count_nonzero(tflash.flash_attention_plain(q, empty,
                                                            empty)) == 0
    k = torch.from_numpy(rng.standard_normal((1, 70, 2, 16))
                         .astype(np.float32))
    got = flash_3xtf32(q, k, k, causal=True)
    want = tflash.flash_attention_plain(q, k, k, causal=True)
    assert bool(torch.isfinite(got).all())
    assert float((got - want).abs().max()) <= TOL


def _toward_zero(x: torch.Tensor) -> torch.Tensor:
    """float64 -> float32, rounded toward zero."""
    t = x.to(torch.float32)
    over = t.double().abs() > x.abs()
    return torch.where(over, torch.nextafter(t, torch.zeros_like(t)), t)


def _mma_3xtf32(c, a, b, eq):
    """c + a b as a run of mma.sync m16n8k8 forms it: each k-step's 8
    products (of TF32 parts, exact) and c summed, then rounded toward
    zero (the tensor cores' accumulation); the three 3xTF32 products in
    the kernel's order.  a: (..., K) rows, b: (K, N)."""
    a_hi, b_hi = _tf32(a), _tf32(b)
    a_lo, b_lo = _tf32(a - a_hi), _tf32(b - b_hi)
    for x, y in ((a_lo, b_hi), (a_hi, b_lo), (a_hi, b_hi)):
        for k0 in range(0, a.shape[-1], 8):
            c = _toward_zero(c.double() + torch.einsum(
                eq, x[..., k0:k0 + 8].double(), y[k0:k0 + 8].double()))
    return c


def _flash_truncating(q, k, v, tile_local):
    """One head of the flash kernel with truncating accumulation: S per
    64-key tile from zero, and P V either from zero per tile and joined
    to O by one rounded FMA (``tile_local``, the kernel's design) or
    accumulated into the rescaled running O (its former design)."""
    T, Dh = q.shape
    m = torch.full((T,), float("-inf"))
    lsum, o = torch.zeros(T), torch.zeros(T, Dh)
    for k0 in range(0, k.shape[0], 64):
        kt, vt = k[k0:k0 + 64], v[k0:k0 + 64]
        s = _mma_3xtf32(torch.zeros(T, 64), q, kt.T.contiguous(),
                        "td,ds->ts") * (Dh ** -0.5 * LOG2E)
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new[:, None])
        lsum = lsum * alpha + p.sum(-1)
        if tile_local:
            pv = _mma_3xtf32(torch.zeros(T, Dh), p, vt, "ts,sd->td")
            o = (o.double() * alpha[:, None].double() + pv.double()).float()
        else:
            o = _mma_3xtf32(o * alpha[:, None], p, vt, "ts,sd->td")
        m = m_new
    return o / lsum[:, None]


def test_flash_tile_local_pv_keeps_float32_accuracy():
    """Why each key tile's P V accumulates from zero: on near-uniform
    attention over 2048 keys whose values nearly cancel (a ViT global
    block's case), truncating mma sums into the running O drift ~50x
    past the float32 plain version's error against float64; per tile,
    the kernel stays within 4x of it."""
    g = torch.Generator().manual_seed(3)
    q, k = (0.05 * torch.randn((n, 64), generator=g) for n in (16, 2048))
    v = torch.randn((2048, 64), generator=g)

    def err(o):
        ref = tflash.flash_attention_plain(*(x.double()[None, :, None]
                                             for x in (q, k, v)))[0, :, 0]
        return float((o.double() - ref).abs().max() / ref.abs().max())

    plain = err(tflash.flash_attention_plain(
        q[None, :, None], k[None, :, None], v[None, :, None])[0, :, 0])
    assert err(_flash_truncating(q, k, v, tile_local=True)) <= 4 * plain
    assert err(_flash_truncating(q, k, v, tile_local=False)) >= 10 * plain


# ---------------------------------------------------------------------------
# the half kernels (fp16 / bf16 entry points of window and flash
# attention): half tensor cores, P split in two half pieces


HALF_TYPES = {"fp16": (torch.float16, jnp.float16),
              "bf16": (torch.bfloat16, jnp.bfloat16)}


def half_pieces(p: torch.Tensor, dt: torch.dtype, split: bool = True):
    """P as the half kernels feed it to the tensor cores, as float32 values
    of ``dt``: P_hi = P rounded to ``dt`` and P_lo = P - P_hi rounded to
    ``dt`` (csrc/half_mma.cuh: split_half2), or, with ``split`` off, P
    rounded once (what fused attention libraries do)."""
    hi = p.to(dt).float()
    return (hi, (p - hi).to(dt).float()) if split else (hi,)


def _pv_half(pieces, v):
    """P V as the half kernels form it: from zero, each 16 keys' products
    of P_hi and then of P_lo (exact) added to the sum and rounded toward
    zero (the tensor cores' accumulation, as ``_mma_3xtf32`` models it).
    pieces: (..., t, s) float32 values of the half type; v: (..., s, d)."""
    c = torch.zeros((*pieces[0].shape[:-1], v.shape[-1]))
    for k0 in range(0, v.shape[-2], 16):
        for x in pieces:
            c = _toward_zero(c.double() + x[..., k0:k0 + 16].double()
                             @ v[..., k0:k0 + 16, :].double())
    return c


def window_attention_half(q, k, v, window, win_valid=None, split=True):
    """The window kernel's arithmetic at half: S = Q K^T exact products
    with a float32 sum, the row softmax in base 2 (scores times c = scale
    * log2(e), p = 2^(s - max)), P V from the two half pieces of P
    (``_pv_half``), the rows divided by their sum and rounded once to the
    input type."""
    B, T, H, Dh = q.shape
    KV = k.shape[2]
    G, W = H // KV, T // window
    c = float(np.float32(Dh ** -0.5) * np.float32(LOG2E))
    qw = q.float().reshape(B, W, window, KV, G, Dh)
    kw = k.float().reshape(B, W, window, KV, Dh)
    vw = v.float().reshape(B, W, window, KV, Dh)
    s = torch.einsum("bwikgd,bwjkd->bwkgij", qw.double(),
                     kw.double()).float() * c
    e = torch.exp2(s - s.amax(-1, keepdim=True))
    inv = 1.0 / e.sum(-1, keepdim=True)
    o = _pv_half(half_pieces(e, q.dtype, split),
                 vw.permute(0, 1, 3, 2, 4)[:, :, :, None]) * inv
    if win_valid is not None:
        keep = torch.arange(W)[None, :] < win_valid[:, None]
        o = o * keep[:, :, None, None, None, None]
    return o.permute(0, 1, 4, 2, 3, 5).reshape(B, T, H, Dh).to(q.dtype)


def flash_tile(Dh: int) -> int:
    """Keys a tile of the half flash kernel (HalfTile::BN)."""
    return 128 if Dh <= 64 else 64


def flash_half(q, k, v, causal=False, split=True):
    """The flash kernel's arithmetic at half, per key tile of
    ``flash_tile(Dh)`` keys: S = Q K^T exact products with a float32 sum;
    the online softmax in base 2 with ``flash_3xtf32``'s -inf handling,
    its row max that of the masked raw scores times c = scale * log2(e)
    (c > 0) and P = 2^(s c - max) in one rounding (an FMA); the tile's
    P V from zero from the two half pieces of P (``_pv_half``), joined to
    the rescaled O in one rounding (an FMA); rows divided by their sum (0
    where it is 0) and rounded once."""
    B, T, H, Dh = q.shape
    S, KV = k.shape[1], k.shape[2]
    G, tile = H // KV, flash_tile(Dh)
    c = float(np.float32(Dh ** -0.5) * np.float32(LOG2E))
    qg = q.float().reshape(B, T, KV, G, Dh)
    m = torch.full((B, KV, G, T), float("-inf"))
    lsum = torch.zeros((B, KV, G, T))
    o = torch.zeros((B, KV, G, T, Dh))
    rows = torch.arange(T)[:, None]
    for k0 in range(0, S, tile):
        if causal and k0 > T - 1:
            break                       # wholly above the diagonal
        kt = k[:, k0:k0 + tile].float()
        vt = v[:, k0:k0 + tile].float()
        s = torch.einsum("btkgd,bskd->bkgts", qg.double(),
                         kt.double()).float()
        if causal:
            seen = rows >= torch.arange(k0, k0 + kt.shape[1])[None, :]
            s = s.masked_fill(~seen, float("-inf"))
        m_new = torch.maximum(m, s.amax(-1) * c)
        m_ref = torch.where(m_new == float("-inf"), 0.0, m_new)
        alpha = torch.exp2(m - m_ref)
        p = torch.exp2((s.double() * c - m_ref[..., None].double()).float())
        lsum = lsum * alpha + p.sum(-1)
        pv = _pv_half(half_pieces(p, q.dtype, split),
                      vt.permute(0, 2, 1, 3)[:, :, None])
        o = (o.double() * alpha[..., None].double() + pv.double()).float()
        m = m_new
    inv = torch.where(lsum > 0, 1.0 / lsum, 0.0)
    out = o * inv[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(B, T, H, Dh).to(q.dtype)


def _half_inputs(rng, shapes, dt):
    """Unit normals rounded once to the half type ``dt``, as (torch, jax)
    pairs."""
    tdt, jdt = HALF_TYPES[dt]
    arrays = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    return [(torch.from_numpy(a).to(tdt), jnp.asarray(a).astype(jdt))
            for a in arrays]


def _from_jax(x, dt) -> torch.Tensor:
    return torch.from_numpy(np.array(x.astype(jnp.float32))).to(
        HALF_TYPES[dt][0])


def ulp(x: torch.Tensor) -> torch.Tensor:
    """One unit in the last place of the half type at each |x| (the
    smallest subnormal's spacing at 0), as float32."""
    p, tiny = {torch.float16: (11, 2.0 ** -24),
               torch.bfloat16: (8, 2.0 ** -133)}[x.dtype]
    _, e = torch.frexp(x.float().abs())
    return torch.clamp(torch.ldexp(torch.ones_like(e, dtype=torch.float32),
                                   e - p), min=tiny)


def half_agreement(got: torch.Tensor, want: torch.Tensor):
    """(largest excess over one ULP of ``want``, bit-equal share)."""
    assert got.dtype == want.dtype and got.shape == want.shape
    d = (got.float() - want.float()).abs()
    return (float((d - ulp(want)).max()),
            float((got == want).float().mean()))


def assert_half_close(got, want):
    """Within one ULP of the half type beyond the float32 attention limit,
    at least 99% of the elements bit-equal (chip_smoke.half_close)."""
    excess, equal = half_agreement(got, want)
    assert excess <= TOL and equal >= 0.99, (excess, equal)


@pytest.mark.parametrize("dt", sorted(HALF_TYPES))
@pytest.mark.parametrize("heads", ["gqa_4_2", "fused_15"])
@pytest.mark.parametrize("w2,Dh", [(64, 64), (49, 32)])
def test_window_half_matches_plain_and_reference(w2, Dh, heads, dt):
    rng = np.random.default_rng(17)
    B, W = 2, 3
    H, KV = (4, 2) if heads == "gqa_4_2" else (15, 15)
    (q, jq), (k, jk), (v, jv) = _half_inputs(
        rng, ((B, W * w2, H, Dh), (B, W * w2, KV, Dh), (B, W * w2, KV, Dh)),
        dt)
    wv = np.array([W, W - 1], np.int32)
    got = window_attention_half(q, k, v, w2, torch.from_numpy(wv))
    assert_half_close(got, twin.window_attention_plain(
        q, k, v, w2, torch.from_numpy(wv)))
    want = jwin.window_attention(jq, jk, jv, w2, win_valid=jnp.asarray(wv),
                                 interpret=True)
    assert_half_close(got, _from_jax(want, dt))


# (B, T, S, H, KV, Dh): GQA groups 1, 3, 4 and 6, T and S off the key
# tiles (128 keys at Dh 64, 64 at Dh 128), S < T, the LM prefill's head
# width
HALF_FLASH_SHAPES = [(1, 200, 150, 4, 1, 64), (2, 130, 300, 4, 4, 64),
                     (1, 100, 260, 6, 2, 128), (2, 128, 128, 8, 2, 128),
                     (1, 96, 96, 12, 2, 128)]


@pytest.mark.parametrize("dt", sorted(HALF_TYPES))
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", HALF_FLASH_SHAPES)
def test_flash_half_matches_plain_and_reference(shape, causal, dt):
    B, T, S, H, KV, Dh = shape
    rng = np.random.default_rng(sum(shape) + causal)
    (q, jq), (k, jk), (v, jv) = _half_inputs(
        rng, ((B, T, H, Dh), (B, S, KV, Dh), (B, S, KV, Dh)), dt)
    got = flash_half(q, k, v, causal)
    assert_half_close(got, tflash.flash_attention_plain(q, k, v, causal))
    want = jflash.flash_attention(jq, jk, jv, causal=causal, interpret=True)
    assert_half_close(got, _from_jax(want, dt))


@pytest.mark.parametrize("dt", sorted(HALF_TYPES))
@pytest.mark.parametrize("kernel", ["flash", "window"])
def test_half_p_rounded_once_breaks_the_bit_equal_share(kernel, dt):
    """Why P goes to the tensor cores in two half pieces: rounded once to
    the half type (what fused attention libraries do), P moves about a
    third of the outputs off the plain version's rounding, far below the
    99% bit-equal share every half attention is held to; split in two,
    the same inputs keep it."""
    rng = np.random.default_rng(23)
    if kernel == "flash":
        (q, _), (k, _), (v, _) = _half_inputs(
            rng, ((1, 256, 4, 64), (1, 256, 4, 64), (1, 256, 4, 64)), dt)
        want = tflash.flash_attention_plain(q, k, v)
        run = lambda split: flash_half(q, k, v, split=split)  # noqa: E731
    else:
        (q, _), (k, _), (v, _) = _half_inputs(
            rng, ((2, 256, 4, 64), (2, 256, 4, 64), (2, 256, 4, 64)), dt)
        want = twin.window_attention_plain(q, k, v, 64)
        run = lambda split: window_attention_half(  # noqa: E731
            q, k, v, 64, split=split)
    _, once = half_agreement(run(False), want)
    excess, split = half_agreement(run(True), want)
    assert once < 0.9
    assert split >= 0.99 and excess <= TOL


# ---------------------------------------------------------------------------
# ssd_scan: the chunk-parallel split on 3xTF32 products


def ssd_3xtf32(x, dt, A, Bm, Cm, chunk, init_state=None, tile=64):
    """The SSD kernels' arithmetic, chunk by chunk (the last one ragged):
    C.B scores once per group; chunk-local states B^T (w x) with w_j =
    exp(cum_last - cum_j) dt_j folded into B; the states passed on in
    sequence; outputs per 64-row tile starting at row r: exp(cum_r)
    C_i . S_prev plus the scores times v_j = exp(cum_r - cum_j) dt_j
    times x over the columns j < r, all scaled by u_i = exp(cum_i -
    cum_r) (each factor at most 1), then the diagonal tile with
    exp(cum_i - cum_j) dt_j evaluated only where j <= i.  Every product
    in 3xTF32."""
    b, T, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    hpg = H // G
    Q = min(chunk, T)
    s = torch.zeros((b, H, N, P)) if init_state is None else init_state
    chunks = []
    for t0 in range(0, T, Q):
        xc, dtc = x[:, t0:t0 + Q], dt[:, t0:t0 + Q]          # (b, Qc, H, .)
        Bc, Cc = Bm[:, t0:t0 + Q], Cm[:, t0:t0 + Q]          # (b, Qc, G, N)
        cum = torch.cumsum(dtc * A, dim=1)                   # (b, Qc, H)
        scores = _mm_3xtf32("bigd,bjgd->bijg", Cc, Bc)        # per group
        w = torch.exp(cum[:, -1:] - cum) * dtc
        Bh = Bc.repeat_interleave(hpg, 2)                    # (b, Qc, H, N)
        loc = _mm_3xtf32("bjhn,bjhp->bhnp", Bh * w[..., None], xc)
        chunks.append((scores.repeat_interleave(hpg, 3), cum, xc, dtc,
                       Cc.repeat_interleave(hpg, 2), loc))
    out = []
    for sc, cum, xc, dtc, Ch, loc in chunks:                 # sc: (b,i,j,H)
        prev = s
        s = torch.exp(cum[:, -1])[..., None, None] * s + loc
        for r in range(0, xc.shape[1], tile):
            rows = slice(r, r + tile)
            acc = (torch.exp(cum[:, r])[:, None, :, None]
                   * _mm_3xtf32("bihn,bhnp->bihp", Ch[:, rows], prev))
            if r:
                v = torch.exp(cum[:, r:r + 1] - cum[:, :r]) * dtc[:, :r]
                acc = acc + _mm_3xtf32("bijh,bjhp->bihp",
                                       sc[:, rows, :r] * v[:, None],
                                       xc[:, :r])
            acc = acc * torch.exp(cum[:, rows] - cum[:, r:r + 1])[..., None]
            n = acc.shape[1]
            below = torch.tril(torch.ones((n, n), dtype=torch.bool))
            gap = cum[:, rows, None] - cum[:, None, rows]     # (b, i, j, H)
            decay = torch.exp(torch.where(below[None, :, :, None], gap,
                                          float("-inf")))
            m = sc[:, rows, rows] * decay * dtc[:, None, rows]
            out.append(acc + _mm_3xtf32("bijh,bjhp->bihp", m, xc[:, rows]))
    return torch.cat(out, 1), s


# (b, T, H, G, N, P, chunk): the reference's test_ssd_scan shapes (ragged
# T, G > 1, one head a group, one chunk), a ragged last chunk at G = 2 and
# a chunk that is not a multiple of the kernels' 64-row tile, and three
# row tiles a chunk (the tiles left of the diagonal)
SSD_SHAPES = [(2, 128, 8, 1, 32, 16, 32), (1, 200, 16, 2, 64, 32, 64),
              (2, 64, 4, 4, 16, 64, 32), (1, 96, 8, 1, 128, 64, 96),
              (1, 150, 4, 2, 16, 16, 100), (1, 400, 4, 1, 16, 16, 192)]


def _rel(got, want):
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max() / np.abs(want).max())


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("shape", SSD_SHAPES)
def test_ssd_3xtf32_matches_plain_and_reference(shape, with_state):
    b, T, H, G, N, P, chunk = shape
    rng = np.random.default_rng(sum(shape) + with_state)
    x = rng.standard_normal((b, T, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, T, H)))).astype(np.float32)
    A = -np.exp(0.5 * rng.standard_normal(H)).astype(np.float32)
    Bm, Cm = ((0.3 * rng.standard_normal((b, T, G, N))).astype(np.float32)
              for _ in range(2))
    s0 = (rng.standard_normal((b, H, N, P)).astype(np.float32)
          if with_state else None)
    args = [torch.from_numpy(a) for a in (x, dt, A, Bm, Cm)]
    ts0 = None if s0 is None else torch.from_numpy(s0)
    y, s = ssd_3xtf32(*args, chunk, init_state=ts0)
    yp, sp = tssd.ssd_scan_plain(*args, chunk, init_state=ts0)
    assert max(_rel(y, yp), _rel(s, sp)) <= SSD_TOL
    jargs = [jnp.asarray(a) for a in (x, dt, A, Bm, Cm)]
    js0 = None if s0 is None else jnp.asarray(s0)
    for wy, ws in (jssd.ssd(*jargs, chunk, init_state=js0,
                            return_final_state=True, interpret=True),
                   jm2.ssd_chunked(*jargs, min(chunk, T), init_state=js0,
                                   return_final_state=True)):
        assert max(_rel(y, wy), _rel(s, ws)) <= SSD_TOL


@pytest.mark.parametrize("shape", [(8, 1024, 32, 1, 128, 64, 256),
                                   (8, 1024, 64, 1, 64, 64, 256),
                                   (1, 96, 8, 1, 128, 64, 96),
                                   (2, 200, 8, 2, 16, 16, 64)])
def test_ssd_scratch_holds_scores_states_and_prefix_sums(shape):
    """The wrapper's scratch size: the C.B scores per (batch row, chunk,
    group) on tiles of 64 rows, the chunk states and the prefix sums
    (mamba2-370m: ~44 MB, which the H100's 50 MB L2 can hold)."""
    b, T, H, G, N, P, chunk = shape
    nc, Qp = -(-T // chunk), -(-chunk // 64) * 64
    n = tssd.scratch_floats(*shape)
    assert n == b * nc * G * Qp * Qp + b * nc * H * N * P + b * H * nc * Qp
    if shape[:2] == (8, 1024) and N == 128:
        assert 40e6 < 4 * n < 50e6


# ---------------------------------------------------------------------------
# the kernel build key


def test_build_key_covers_every_header(tmp_path, monkeypatch):
    """A library's name hashes its source and every csrc header: an edit
    to a shared header (tf32_mma.cuh) names a new library."""
    for f in list(tbuild.CSRC.glob("*.cu")) + list(tbuild.CSRC.glob(
            "*.cuh")):
        (tmp_path / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(tbuild, "CSRC", tmp_path)
    assert (tmp_path / "tf32_mma.cuh").exists()
    before = {n: tbuild.lib_path(n) for n in tbuild.SOURCES}
    (tmp_path / "tf32_mma.cuh").write_text(
        (tmp_path / "tf32_mma.cuh").read_text() + "\n// edited\n")
    after = {n: tbuild.lib_path(n) for n in tbuild.SOURCES}
    assert all(before[n] != after[n] for n in tbuild.SOURCES)


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
