"""Port parity of the kernels' half-precision lanes: each plain version at
fp16 and bf16 against the reference's Pallas kernel in interpret mode,
at the reference's own test shapes (``tests/test_kernels.py``), and an
emulation of the CUDA kernels' half staging path.

The four Functions with a backward take half operands under autograd
too: their half gradients through ``dispatch`` against ``jax.vjp`` of
the reference's entry points.

Every reference kernel takes fp16 and bf16, computes in float32 (casting
on load) and returns the input's type; the port's plain versions do the
same, and so do the CUDA kernels' ``_f16`` / ``_bf16`` entry points
(``csrc/common.cuh``), which ``chip_smoke.py`` holds against these plain
versions on the card.

Tolerances and why:
  * pack_pos, restore_gather, nn_upsample and the int8 GEMM's epilogue
    are bit-equal: data movement, one half add (rounded once from its
    exact float32 sum in both packages) and the same three float32
    operations rounded once to the output type;
  * avg_pool is bit-equal: the float32 mean of half values, rounded once;
  * attention outputs are within one unit in the last place (ULP) of the
    half type, at 99% or more of the elements bit-equal: both packages
    compute float32 softmax attention from the same half inputs, summing
    in other orders, and round the float32 result once, so where that
    result lies within float32 noise of a rounding boundary the two
    roundings differ by one step.  Near zero, where an output cancels
    and a half ULP is finer than that noise, the bound adds the float32
    parity limit of the port's attention (1e-5 absolute).

The CUDA window and flash kernels keep half rows half in shared memory
and run the half tensor cores: Q K^T is one half product (a product of
two half values is exact in float32), and P, float32 in registers, goes
into P V as two half pieces, P_hi = half(P) and P_lo = half(P - P_hi)
(``test_torch_kernel_numerics.py`` holds that arithmetic to the plain
version and the reference, and shows that P rounded once breaks the 99%
bit-equal share).  ``test_half_staging_*`` emulates the window kernel's
path at half (half rows, exact products, the split, round once) against
the plain version.  A half value is also an exact TF32 value (fp16's 10
and bf16's 7 mantissa bits fit TF32's 10), so the 3xTF32 split gives it
a zero low part.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention import ops as jdec
from repro.kernels.flash_attention import ops as jflash
from repro.kernels.fused_serving import ops as jfused
from repro.kernels.int8_matmul import ops as jmm
from repro.kernels.mixed_res_pool import ops as jpool
from repro.kernels.window_attention import ops as jwin
from repro_torch.kernels import build as tbuild
from repro_torch.kernels import dispatch
from repro_torch.kernels.build import FLOAT_TYPES
from repro_torch.kernels.decode_attention import ops as tdec
from repro_torch.kernels.flash_attention import ops as tflash
from repro_torch.kernels.fused_serving import ops as tfused
from repro_torch.kernels.int8_matmul import ops as tmm
from repro_torch.kernels.mixed_res_pool import ops as tpool
from repro_torch.kernels.window_attention import ops as twin

from test_torch_kernel_numerics import _tf32, window_attention_half

torch.set_num_threads(2)
HALF = {"fp16": (torch.float16, jnp.float16),
        "bf16": (torch.bfloat16, jnp.bfloat16)}
F32_TOL = 1e-5          # float32 attention, port vs reference


def _both(a: np.ndarray, dt: str):
    """float32 numpy -> (torch, jax) arrays of the half type, rounded
    once to nearest even in each package."""
    tdt, jdt = HALF[dt]
    return torch.from_numpy(a).to(tdt), jnp.asarray(a).astype(jdt)


def _to_torch(x, dt: str) -> torch.Tensor:
    return torch.from_numpy(np.array(x.astype(jnp.float32))).to(
        HALF[dt][0])


def ulp(x: torch.Tensor) -> torch.Tensor:
    """One unit in the last place of the half type at each |x| (its
    spacing there, the smallest subnormal's at 0), as float32."""
    p, tiny = {torch.float16: (11, 2.0 ** -24),
               torch.bfloat16: (8, 2.0 ** -133)}[x.dtype]
    _, e = torch.frexp(x.float().abs())
    return torch.clamp(torch.ldexp(torch.ones_like(e, dtype=torch.float32),
                                   e - p), min=tiny)


def _within_one_ulp(got: torch.Tensor, want: torch.Tensor) -> None:
    """Within one ULP of the half type at the reference's value, beyond
    the two packages' float32 attention parity (F32_TOL, as in
    test_torch_kernels.py): near zero a half ULP is finer than float32's
    summation noise.  At least 99% of the elements bit-equal."""
    assert got.dtype == want.dtype and got.shape == want.shape
    d = (got.float() - want.float()).abs()
    assert bool((d <= ulp(want) + F32_TOL).all()), float(
        (d - ulp(want)).max())
    assert float((got == want).float().mean()) >= 0.99


# ---------------------------------------------------------------------------
# data movement and the int8 epilogue: bit-equal


@pytest.mark.parametrize("dt", sorted(HALF))
def test_pack_pos_plain_bit_equal_at_half(dt):
    rng = np.random.default_rng(0)
    B, nbank, w2, C, nw_pad = 2, 20, 64, 32, 12
    bank = rng.standard_normal((B, nbank, w2, C)).astype(np.float32)
    pos = rng.standard_normal((nbank, w2, C)).astype(np.float32)
    src = rng.integers(0, nbank, (B, nw_pad)).astype(np.int32)
    nw = np.array([5, nw_pad], np.int32)
    (tb, jb), (tp, jp) = _both(bank, dt), _both(pos, dt)
    got = tfused.pack_pos_plain(tb, tp, torch.from_numpy(src),
                                torch.from_numpy(nw))
    want = jfused.fused_pack_pos(jb, jp, jnp.asarray(src), jnp.asarray(nw))
    assert got.dtype == HALF[dt][0]
    assert torch.equal(got, _to_torch(want, dt))


@pytest.mark.parametrize("dt", sorted(HALF))
@pytest.mark.parametrize("with_tiles", [False, True])
def test_restore_gather_plain_bit_equal_at_half(dt, with_tiles):
    rng = np.random.default_rng(1)
    window, d = 8, 2
    w2, dd = window * window, d * d
    B, nw_pad, nR, D = 2, 9, 4, 16
    nout = nR * dd
    tw, jw = _both(rng.standard_normal((B, nw_pad, w2, D))
                   .astype(np.float32), dt)
    tt = jt = None
    if with_tiles:
        tt, jt = _both(rng.standard_normal((B, nR, dd, w2, D))
                       .astype(np.float32), dt)
    out_src = rng.integers(0, nw_pad + nout, (B, nout)).astype(np.int32)
    out_map = rng.integers(0, dd + 1, (B, nout)).astype(np.int32)
    got = tfused.restore_gather_plain(tw, torch.from_numpy(out_src),
                                      torch.from_numpy(out_map), window, d,
                                      reuse_tiles=tt)
    want = jfused.fused_restore(jw, jnp.asarray(out_src),
                                jnp.asarray(out_map), window, d,
                                reuse_tiles=jt)
    assert torch.equal(got, _to_torch(want, dt))


# tests/test_kernels.py's avg_pool and nn_upsample shapes (B, H, W, C, d)
POOL_SHAPES = [(2, 32, 32, 64, 2), (1, 48, 48, 100, 4), (2, 16, 24, 128, 2),
               (1, 8, 8, 3, 2)]
UPSAMPLE_SHAPES = [(2, 16, 16, 64, 2), (1, 12, 12, 100, 4), (1, 4, 6, 3, 2)]


@pytest.mark.parametrize("dt", sorted(HALF))
@pytest.mark.parametrize("shape", POOL_SHAPES)
def test_avg_pool_plain_bit_equal_at_half(dt, shape):
    B, H, W, C, d = shape
    tx, jx = _both(np.random.default_rng(2).standard_normal((B, H, W, C))
                   .astype(np.float32), dt)
    got = tpool.avg_pool_plain(tx, d)
    want = jpool.avg_pool_2d(jx, d, interpret=True)
    assert torch.equal(got, _to_torch(want, dt))


@pytest.mark.parametrize("dt", sorted(HALF))
@pytest.mark.parametrize("shape", UPSAMPLE_SHAPES)
def test_nn_upsample_plain_bit_equal_at_half(dt, shape):
    B, H, W, C, d = shape
    tx, jx = _both(np.random.default_rng(8).standard_normal((B, H, W, C))
                   .astype(np.float32), dt)
    got = tpool.nn_upsample_plain(tx, d)
    want = jpool.nn_upsample_2d(jx, d, interpret=True)
    assert torch.equal(got, _to_torch(want, dt))


@pytest.mark.parametrize("dt", sorted(HALF))
@pytest.mark.parametrize("M,K,N", [(64, 96, 48), (1000, 100, 130)])
def test_int8_epilogue_bit_equal_at_half(dt, M, K, N):
    rng = np.random.default_rng(3)
    xq = rng.integers(-127, 128, (M, K)).astype(np.int8)
    wq = rng.integers(-127, 128, (K, N)).astype(np.int8)
    sx = (rng.uniform(0.5, 2, M) / 127).astype(np.float32)
    sw = (rng.uniform(0.5, 2, N) / 127).astype(np.float32)
    tdt, jdt = HALF[dt]
    got = tmm.int8_matmul_plain(*(torch.from_numpy(a)
                                  for a in (xq, wq, sx, sw)), tdt)
    want = jmm.int8_matmul(*(jnp.asarray(a) for a in (xq, wq, sx, sw)),
                           out_dtype=jdt, interpret=True)
    assert got.dtype == tdt
    assert torch.equal(got, _to_torch(want, dt))


# ---------------------------------------------------------------------------
# attention: within one ULP of the half type


def _qkv(rng, B, T, H, KV, Dh, S=None, dt="bf16"):
    S = T if S is None else S
    shapes = ((B, T, H, Dh), (B, S, KV, Dh), (B, S, KV, Dh))
    return [_both(rng.standard_normal(s).astype(np.float32), dt)
            for s in shapes]


# tests/test_kernels.py's window shapes (B, W, w2, H, KV, Dh)
@pytest.mark.parametrize("dt", sorted(HALF))
@pytest.mark.parametrize("shape", [(2, 4, 64, 4, 4, 64), (1, 9, 81, 8, 8, 32),
                                   (2, 3, 49, 4, 2, 64)])
def test_window_attention_plain_within_one_ulp_at_half(dt, shape):
    B, W, w2, H, KV, Dh = shape
    (tq, jq), (tk, jk), (tv, jv) = _qkv(np.random.default_rng(4), B, W * w2,
                                        H, KV, Dh, dt=dt)
    wv = np.array([W, max(W - 1, 1)][:B], np.int32)
    got = twin.window_attention_plain(tq, tk, tv, w2, torch.from_numpy(wv))
    want = jwin.window_attention(jq, jk, jv, w2, win_valid=jnp.asarray(wv),
                                 interpret=True)
    _within_one_ulp(got, _to_torch(want, dt))


# tests/test_kernels.py's flash shapes (B, T, S, H, KV, Dh)
@pytest.mark.parametrize("dt", sorted(HALF))
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", [(2, 256, 256, 4, 2, 64),
                                   (2, 128, 384, 4, 1, 32),
                                   (1, 100, 260, 6, 2, 128)])
def test_flash_attention_plain_within_one_ulp_at_half(dt, causal, shape):
    B, T, S, H, KV, Dh = shape
    (tq, jq), (tk, jk), (tv, jv) = _qkv(np.random.default_rng(5), B, T, H,
                                        KV, Dh, S=S, dt=dt)
    got = tflash.flash_attention_plain(tq, tk, tv, causal)
    want = jflash.flash_attention(jq, jk, jv, causal=causal, interpret=True)
    _within_one_ulp(got, _to_torch(want, dt))


# tests/test_kernels.py's decode shapes (B, S, H, KV, Dh); q and the cache
# each in its own type, as the reference's kernel casts them on load
@pytest.mark.parametrize("q_dt,cache_dt", [("fp16", "fp16"), ("bf16", "bf16"),
                                           ("fp16", "fp32"),
                                           ("fp32", "bf16")])
@pytest.mark.parametrize("shape", [(2, 1024, 8, 2, 64), (4, 777, 32, 8, 128),
                                   (2, 300, 16, 1, 32)])
def test_decode_attention_plain_within_one_ulp_at_half(q_dt, cache_dt,
                                                       shape):
    B, S, H, KV, Dh = shape
    rng = np.random.default_rng(6)
    arrays = [rng.standard_normal(s).astype(np.float32)
              for s in ((B, 1, H, Dh), (B, S, KV, Dh), (B, S, KV, Dh))]

    def cast(a, dt):
        return (torch.from_numpy(a), jnp.asarray(a)) if dt == "fp32" \
            else _both(a, dt)
    (tq, jq), (tk, jk), (tv, jv) = (cast(a, d) for a, d in
                                    zip(arrays, (q_dt, cache_dt, cache_dt)))
    kv_len = rng.integers(1, S + 1, (B,)).astype(np.int32)
    got = tdec.decode_attention_plain(tq, tk, tv, torch.from_numpy(kv_len))
    want = jdec.decode_attention(jq, jk, jv, jnp.asarray(kv_len),
                                 interpret=True)
    assert got.dtype == tq.dtype
    if q_dt == "fp32":
        assert float((got - torch.from_numpy(np.asarray(want))).abs()
                     .max()) <= 1e-5
    else:
        _within_one_ulp(got, _to_torch(want, q_dt))


# ---------------------------------------------------------------------------
# the kernels' half staging path, emulated


@pytest.mark.parametrize("dt", sorted(HALF))
def test_half_values_split_with_zero_low_part(dt):
    """Every half value converts to float32 exactly and is a TF32 value:
    split_tf32 (csrc/tf32_mma.cuh) gives it lo = 0."""
    bits = torch.arange(-32768, 32768, dtype=torch.int32).to(torch.int16)
    x = bits.view(HALF[dt][0]).float()
    x = x[torch.isfinite(x)]
    hi = _tf32(x)
    assert torch.equal(hi, x)
    assert torch.count_nonzero(x - hi) == 0


@pytest.mark.parametrize("dt", sorted(HALF))
@pytest.mark.parametrize("w2,Dh", [(64, 64), (49, 32)])
def test_half_staging_window_within_one_ulp_of_plain(dt, w2, Dh):
    """Half rows, Q K^T from exact half products, float32 softmax, P V
    from the two half pieces of P, round once: the kernel's path at half,
    against the plain version at half."""
    rng = np.random.default_rng(7)
    B, W, H, KV = 2, 3, 4, 2
    (q, _), (k, _), (v, _) = _qkv(rng, B, W * w2, H, KV, Dh, dt=dt)
    got = window_attention_half(q, k, v, w2)
    _within_one_ulp(got, twin.window_attention_plain(q, k, v, w2))


@pytest.mark.parametrize("dt", sorted(HALF))
def test_half_attention_copies_the_views_its_loads_refuse(dt):
    """The half window and flash kernels load rows 16 bytes at a time (TMA,
    ``cp.async``): a column view of a fused QKV product goes in as it is;
    a view whose base or token stride is off 16 bytes is copied, each
    copy counted on the kernel (``build.aligned_rows``)."""
    tdt = HALF[dt][0]
    kernel = tbuild.CudaKernel("flash_attention", "flash_attention", [])
    qkv = torch.randn(2, 8, 3 * 4 * 16).to(tdt)
    q = qkv[..., :64].reshape(2, 8, 4, 16)
    assert tbuild.aligned_rows(kernel, q) is q and kernel.copies == 0
    for view in (torch.randn(2 * 8 * 64 + 1).to(tdt)[1:].view(2, 8, 4, 16),
                 torch.randn(2, 8, 65).to(tdt)[..., :64].reshape(2, 8, 4,
                                                                16)):
        got = tbuild.aligned_rows(kernel, view)
        assert got.data_ptr() % 16 == 0 and got.is_contiguous()
        assert torch.equal(got, view)
    assert kernel.copies == 2
    kernel.reset()
    assert kernel.copies == 0


# ---------------------------------------------------------------------------
# what stays refused


def test_kernels_refuse_other_types():
    """A wrapper takes float32, fp16 and bf16 operands of one type and
    nothing else."""
    for kernel in dispatch.KERNELS.values():
        for dt in (torch.float64, torch.int32):
            with pytest.raises(ValueError):
                kernel.check_dtype("k", torch.zeros(2, dtype=dt))
        with pytest.raises(ValueError):
            kernel.check_dtype("k", torch.zeros(2),
                               torch.zeros(2, dtype=torch.float16))
    assert dispatch.KERNELS["ssd_scan"].dtypes == (torch.float32,)
    assert all(k.dtypes == FLOAT_TYPES for n, k in dispatch.KERNELS.items()
               if n != "ssd_scan")
    x = torch.randn(1, 4, 4, 3, dtype=torch.float16, requires_grad=True)
    with torch.no_grad():
        assert dispatch.avg_pool(x, 2).dtype == torch.float16


def _ref_vjp(fn, primals, g):
    import jax
    out, vjp = jax.vjp(fn, *primals)
    return out, vjp(g)


# the four Functions with a backward, at a shape of each reference test:
# window with a pad window (win_valid), flash causal with GQA, the pools
HALF_GRAD_CASES = ("window", "flash", "avg_pool", "nn_upsample")


@pytest.mark.parametrize("dt", sorted(HALF))
@pytest.mark.parametrize("case", HALF_GRAD_CASES)
def test_half_gradients_through_dispatch_match_reference_vjp(dt, case):
    """fp16 / bf16 operands under autograd through ``dispatch`` (the
    Functions' plain forward and the reference's VJP ported) against
    ``jax.vjp`` of the reference's entry point (Pallas interpret) on the
    same half inputs and cotangent.  Attention: the forward and dq / dk
    / dv within one ULP of the half type at >= 99% bit-equal (both
    compute in float32 and round once to each operand's type); the pools'
    adjoints (in the cotangent's type) and forwards bit-equal."""
    rng = np.random.default_rng(11)
    tdt, jdt = HALF[dt]
    if case in ("window", "flash"):
        if case == "window":
            B, W, w2, H, KV, Dh = 2, 3, 49, 4, 2, 64
            T = S = W * w2
        else:
            B, T, S, H, KV, Dh = 2, 128, 128, 4, 2, 64
        ins = _qkv(rng, B, T, H, KV, Dh, S=S, dt=dt)
        g_t, g_j = _both(rng.standard_normal((B, T, H, Dh))
                         .astype(np.float32), dt)
        if case == "window":
            wv = np.array([W, W - 1], np.int32)

            def tfn(q, k, v):
                return dispatch.window_attention(q, k, v, w2,
                                                 torch.from_numpy(wv))

            def jfn(q, k, v):
                return jwin.window_attention(q, k, v, w2,
                                             win_valid=jnp.asarray(wv),
                                             interpret=True)
        else:
            def tfn(q, k, v):
                return dispatch.flash_attention(q, k, v, causal=True)

            def jfn(q, k, v):
                return jflash.flash_attention(q, k, v, causal=True,
                                              interpret=True)
        close = _within_one_ulp
    else:
        shape = (2, 8, 12, 16) if case == "avg_pool" else (2, 4, 6, 16)
        out_shape = ((2, 4, 6, 16) if case == "avg_pool" else (2, 8, 12, 16))
        ins = [_both(rng.standard_normal(shape).astype(np.float32), dt)]
        g_t, g_j = _both(rng.standard_normal(out_shape)
                         .astype(np.float32), dt)
        tfn = getattr(dispatch, case)
        tfn = (lambda x, f=tfn: f(x, 2))
        jop = jpool.avg_pool_2d if case == "avg_pool" else \
            jpool.nn_upsample_2d
        jfn = (lambda x: jop(x, 2, interpret=True))

        def close(got, want):
            assert got.dtype == want.dtype and torch.equal(got, want)
    xs = [t.clone().requires_grad_(True) for t, _ in ins]
    out = tfn(*xs)
    out.backward(g_t)
    want_out, want_grads = _ref_vjp(jfn, [j for _, j in ins], g_j)
    assert out.dtype == tdt
    close(out.detach(), _to_torch(want_out, dt))
    for x, w in zip(xs, want_grads):
        assert x.grad.dtype == tdt
        close(x.grad, _to_torch(w, dt))


def test_launch_counts_split_by_type(monkeypatch):
    """A launch counts once, under its entry point's type, or, where a
    float32 entry point takes a half tensor (decode's half q over a
    float32 cache), under that tensor's type; an unbuilt type raises
    before it counts."""
    kernel = dispatch.KERNELS["decode_attention"]
    monkeypatch.setattr(kernel, "_launch", lambda args, dtype: None)
    kernel.reset()
    f32, f16, bf16 = (torch.zeros(1, dtype=d) for d in FLOAT_TYPES)
    kernel(f32, f32, 0, dtype=torch.float32)
    kernel(f16, f32, 0, dtype=torch.float32)     # half q, float32 cache
    kernel(f32, bf16, 0, dtype=torch.bfloat16)   # float32 q, bf16 cache
    kernel(bf16, bf16, 0, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        kernel(f32, dtype=torch.float64)
    assert kernel.launches == 4
    assert kernel.by_dtype == {"f32": 1, "f16": 1, "bf16": 2}
    assert dispatch.launch_counts("bf16")["decode_attention"] == 2
    kernel.reset()
    assert dispatch.launch_counts()["decode_attention"] == 0
