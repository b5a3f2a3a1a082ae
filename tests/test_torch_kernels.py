"""Port parity: the plain versions of the ported kernels against the
reference's Pallas entry points (interpret mode on the CPU) and oracles,
plus the device routing of ``repro_torch.kernels.dispatch``.

Tolerances: the fused pack/restore are data movement plus one add, and
the nearest-neighbour upsample is data movement alone, so they must be
bit-equal; average pooling sums four floats (<= 1e-6); attention is
float32 softmax attention whose summation order differs between the two
frameworks (<= 1e-5 absolute on unit-normal inputs).  The int8 GEMM's
parity tests live in ``test_torch_quant.py`` (bit-equal).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ops as jflash
from repro.kernels.fused_serving import ops as jfused
from repro.kernels.fused_serving.ref import (fused_pack_pos_ref,
                                             fused_restore_ref)
from repro.kernels.mixed_res_pool import ops as jpool
from repro.kernels.window_attention import ops as jwin
from repro_torch.kernels import dispatch
from repro_torch.kernels.decode_attention import ops as tdec
from repro_torch.kernels.flash_attention import ops as tflash
from repro_torch.kernels.fused_serving import ops as tfused
from repro_torch.kernels.int8_matmul import ops as tmm
from repro_torch.kernels.mixed_res_pool import ops as tpool
from repro_torch.kernels.ssd_scan import ops as tssd
from repro_torch.kernels.window_attention import ops as twin

torch.set_num_threads(2)


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# fused serving: bit-exact


@pytest.mark.parametrize("per_sample", [False, True])
def test_pack_pos_plain_bit_equal(per_sample):
    rng = np.random.default_rng(0)
    B, nbank, w2, C, nw_pad = 2, 20, 64, 32, 12
    bank = rng.standard_normal((B, nbank, w2, C)).astype(np.float32)
    pos = rng.standard_normal((nbank, w2, C)).astype(np.float32)
    src = rng.integers(0, nbank, (B, nw_pad) if per_sample else (nw_pad,))
    src = src.astype(np.int32)
    nw = np.array([5, nw_pad], np.int32)
    got = tfused.pack_pos_plain(_t(bank), _t(pos), _t(src), _t(nw))
    want = jfused.fused_pack_pos(jnp.asarray(bank), jnp.asarray(pos),
                                 jnp.asarray(src), jnp.asarray(nw))
    assert torch.equal(got, _t(np.asarray(want)))
    src2 = src if per_sample else np.broadcast_to(src, (B, nw_pad))
    ref = fused_pack_pos_ref(jnp.asarray(bank), jnp.asarray(pos),
                             jnp.asarray(src2), jnp.asarray(nw))
    assert torch.equal(got, _t(np.asarray(ref).reshape(B, -1, C)))
    assert torch.count_nonzero(got.reshape(B, nw_pad, w2, C)[0, 5:]) == 0


@pytest.mark.parametrize("with_tiles", [False, True])
def test_restore_gather_plain_bit_equal(with_tiles):
    rng = np.random.default_rng(1)
    window, d = 8, 2
    w2, dd = window * window, d * d
    B, nw_pad, nR, D = 2, 9, 4, 16
    nout = nR * dd
    win = rng.standard_normal((B, nw_pad, w2, D)).astype(np.float32)
    tiles = (rng.standard_normal((B, nR, dd, w2, D)).astype(np.float32)
             if with_tiles else None)
    out_src = rng.integers(0, nw_pad + nout, (B, nout)).astype(np.int32)
    out_map = rng.integers(0, dd + 1, (B, nout)).astype(np.int32)
    got = tfused.restore_gather_plain(
        _t(win), _t(out_src), _t(out_map), window, d,
        reuse_tiles=None if tiles is None else _t(tiles))
    want = jfused.fused_restore(
        jnp.asarray(win), jnp.asarray(out_src), jnp.asarray(out_map), window,
        d, reuse_tiles=None if tiles is None else jnp.asarray(tiles))
    assert torch.equal(got, _t(np.asarray(want)))
    bank = np.concatenate(
        [win, tiles.reshape(B, nout, w2, D) if with_tiles
         else np.zeros((B, nout, w2, D), np.float32)], axis=1)
    ref = fused_restore_ref(jnp.asarray(bank),
                            jnp.asarray(jfused.upsample_token_maps(window, d)),
                            jnp.asarray(out_src), jnp.asarray(out_map))
    assert torch.equal(got, _t(np.asarray(ref).reshape(B, -1, D)))


@pytest.mark.parametrize("window,d", [(2, 2), (8, 2), (4, 3)])
def test_upsample_token_maps_match_reference(window, d):
    np.testing.assert_array_equal(tfused.upsample_token_maps(window, d),
                                  jfused.upsample_token_maps(window, d))


# ---------------------------------------------------------------------------
# average pool: <= 1e-6


@pytest.mark.parametrize("shape,d", [((2, 64, 64, 3), 2), ((1, 32, 48, 8), 2),
                                     ((1, 24, 24, 5), 3),
                                     ((2, 10, 10, 3), 2),
                                     ((2, 16, 12, 3), 4)])
def test_avg_pool_plain_matches_reference(shape, d):
    x = np.random.default_rng(2).uniform(0, 1, shape).astype(np.float32)
    got = tpool.avg_pool_plain(_t(x), d)
    want = np.asarray(jpool.avg_pool_2d(jnp.asarray(x), d, interpret=True))
    assert got.shape == want.shape
    assert float((got - _t(want)).abs().max()) <= 1e-6


@pytest.mark.parametrize("shape,d", [((32, 8, 8, 64), 2), ((3, 4, 6, 5), 2),
                                     ((2, 3, 3, 130), 3)])
def test_nn_upsample_plain_bit_equal(shape, d):
    x = np.random.default_rng(8).standard_normal(shape).astype(np.float32)
    got = tpool.nn_upsample_plain(_t(x), d)
    want = np.asarray(jpool.nn_upsample_2d(jnp.asarray(x), d, interpret=True))
    assert torch.equal(got, _t(want))


# ---------------------------------------------------------------------------
# attention: <= 1e-5


def _qkv(rng, B, T, H, KV, Dh, S=None):
    S = T if S is None else S
    q = rng.standard_normal((B, T, H, Dh)).astype(np.float32)
    k = rng.standard_normal((B, S, KV, Dh)).astype(np.float32)
    v = rng.standard_normal((B, S, KV, Dh)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("group", [1, 2, 4])
@pytest.mark.parametrize("valid", [None, (0, 0), (1, 2), (3, 3)])
@pytest.mark.parametrize("w2,Dh", [(64, 64), (4, 16)])
def test_window_attention_plain_matches_reference(group, valid, w2, Dh):
    rng = np.random.default_rng(3)
    B, W, H = 2, 3, 4
    q, k, v = _qkv(rng, B, W * w2, H, H // group, Dh)
    wv = None if valid is None else np.asarray(valid, np.int32)
    got = twin.window_attention_plain(_t(q), _t(k), _t(v), w2,
                                      None if wv is None else _t(wv))
    want = jwin.window_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), w2,
        win_valid=None if wv is None else jnp.asarray(wv), interpret=True)
    assert float((got - _t(np.asarray(want))).abs().max()) <= 1e-5
    if wv is not None:
        out = got.reshape(B, W, w2, H, Dh)
        for b in range(B):
            assert torch.count_nonzero(out[b, wv[b]:]) == 0


@pytest.mark.parametrize("group", [1, 2, 4])
@pytest.mark.parametrize("T,S,causal", [(200, 200, False), (200, 200, True),
                                        (64, 136, False)])
def test_flash_attention_plain_matches_reference(group, T, S, causal):
    rng = np.random.default_rng(4)
    H = 4
    q, k, v = _qkv(rng, 2, T, H, H // group, 64, S=S)
    got = tflash.flash_attention_plain(_t(q), _t(k), _t(v), causal)
    want = jflash.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal=causal,
                                  interpret=True)
    assert float((got - _t(np.asarray(want))).abs().max()) <= 1e-5


def test_flash_attention_plain_chunks_long_queries():
    """T > Q_CHUNK runs in query chunks; the result equals one dense pass."""
    rng = np.random.default_rng(5)
    q, k, v = (_t(a) for a in _qkv(rng, 1, tflash.Q_CHUNK + 40, 2, 2, 16))
    got = tflash.flash_attention_plain(q, k, v, causal=True)
    s = torch.einsum("bthd,bshd->bhts", q, k) * 16 ** -0.5
    T = q.shape[1]
    s = s.masked_fill(torch.ones(T, T).triu(1).bool(), float("-inf"))
    want = torch.einsum("bhts,bshd->bthd", torch.softmax(s, -1), v)
    assert float((got - want).abs().max()) <= 1e-5


# ---------------------------------------------------------------------------
# dispatch: a CPU tensor takes the plain version and launches nothing


def _dispatch_cases():
    rng = np.random.default_rng(6)
    q, k, v = (_t(a) for a in _qkv(rng, 1, 128, 2, 2, 16))
    wv = torch.tensor([1], dtype=torch.int32)
    bank = _t(rng.standard_normal((1, 6, 4, 8)).astype(np.float32))
    pos = _t(rng.standard_normal((6, 4, 8)).astype(np.float32))
    src = torch.tensor([3, 0, 5], dtype=torch.int32)
    nw = torch.tensor([2], dtype=torch.int32)
    win = _t(rng.standard_normal((1, 3, 4, 8)).astype(np.float32))
    osrc = torch.tensor([0, 1, 2, 2], dtype=torch.int32)
    omap = torch.tensor([0, 0, 1, 4], dtype=torch.int32)
    img = _t(rng.uniform(0, 1, (1, 8, 8, 3)).astype(np.float32))
    xq = _t(rng.integers(-127, 128, (5, 24), dtype=np.int8))
    wq = _t(rng.integers(-127, 128, (24, 7), dtype=np.int8))
    sx, sw = torch.ones(5), torch.full((7,), 0.5)
    kv_len = torch.tensor([100], dtype=torch.int32)
    q1 = q[:, :1]
    ssd = (q, torch.nn.functional.softplus(q[..., 0]), -torch.ones(2),
           k[:, :, :1], v[:, :, :1], 32)
    return {
        "ssd_scan": (      # (y, final state) flattened into one tensor
            lambda: torch.cat([t.reshape(-1)
                               for t in dispatch.ssd_scan(*ssd)]),
            lambda: torch.cat([t.reshape(-1)
                               for t in tssd.ssd_scan_plain(*ssd)]),
            lambda: tssd.ssd_scan_cuda(*ssd)),
        "decode_attention": (
            lambda: dispatch.decode_attention(q1, k, v, kv_len),
            lambda: tdec.decode_attention_plain(q1, k, v, kv_len),
            lambda: tdec.decode_attention_cuda(q1, k, v, kv_len)),
        "window_attention": (
            lambda: dispatch.window_attention(q, k, v, 64, wv),
            lambda: twin.window_attention_plain(q, k, v, 64, wv),
            lambda: twin.window_attention_cuda(q, k, v, 64, wv)),
        "flash_attention": (
            lambda: dispatch.flash_attention(q, k, v),
            lambda: tflash.flash_attention_plain(q, k, v),
            lambda: tflash.flash_attention_cuda(q, k, v)),
        "avg_pool": (
            lambda: dispatch.avg_pool(img, 2),
            lambda: tpool.avg_pool_plain(img, 2),
            lambda: tpool.avg_pool_cuda(img, 2)),
        "nn_upsample": (
            lambda: dispatch.nn_upsample(img, 2),
            lambda: tpool.nn_upsample_plain(img, 2),
            lambda: tpool.nn_upsample_cuda(img, 2)),
        "int8_matmul": (
            lambda: dispatch.int8_matmul(xq, wq, sx, sw),
            lambda: tmm.int8_matmul_plain(xq, wq, sx, sw),
            lambda: tmm.int8_matmul_cuda(xq, wq, sx, sw)),
        "pack_pos": (
            lambda: dispatch.pack_pos(bank, pos, src, nw),
            lambda: tfused.pack_pos_plain(bank, pos, src, nw),
            lambda: tfused.pack_pos_cuda(bank, pos, src, nw)),
        "restore_gather": (
            lambda: dispatch.restore_gather(win, osrc, omap, 2, 2),
            lambda: tfused.restore_gather_plain(win, osrc, omap, 2, 2),
            lambda: tfused.restore_gather_cuda(win, osrc, omap, 2, 2)),
    }


@pytest.mark.parametrize("name", sorted(dispatch.KERNELS))
def test_dispatch_cpu_takes_plain_version_and_launches_nothing(name):
    routed, plain, cuda = _dispatch_cases()[name]
    dispatch.reset_launch_counts()
    assert torch.equal(routed(), plain())
    assert dispatch.launch_counts() == dict.fromkeys(dispatch.KERNELS, 0)
    with pytest.raises(ValueError):      # the kernel wrapper takes no CPU
        cuda()
    assert dispatch.launch_counts()[name] == 0


# ---------------------------------------------------------------------------
# on the card (skipped where there is none; chip_smoke.py runs the same
# comparison at the full-width shapes)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(dispatch.KERNELS))
def test_kernel_matches_plain_on_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (chip_smoke.py runs this "
                    "check on the H100)")
    rng = np.random.default_rng(7)
    dev = "cuda"
    if name == "window_attention":
        q, k, v = (_t(a).to(dev) for a in _qkv(rng, 2, 256, 4, 2, 64))
        wv = torch.tensor([1, 4], dtype=torch.int32, device=dev)
        # the int8 lane's 15 heads: column views of a 2880-wide fused QKV
        qkv = _t(rng.standard_normal((2, 128, 2880)).astype(np.float32))
        q15, k15, v15 = (t.reshape(2, 128, 15, 64).to(dev)
                         for t in qkv.split(960, dim=-1))
        small = [_t(a).to(dev) for a in _qkv(rng, 2, 12, 4, 4, 16)]
        for args, w2, valid in (((q, k, v), 64, wv), ((q, k, v), 64, None),
                                ((q15, k15, v15), 64, None),
                                (small, 4, wv)):
            got = twin.window_attention_cuda(*args, w2, valid)
            want = twin.window_attention_plain(*args, w2, valid)
            assert float((got - want).abs().max()) <= 1e-4
    elif name == "flash_attention":
        q, k, v = (_t(a).to(dev) for a in _qkv(rng, 2, 256, 4, 2, 64))
        got = tflash.flash_attention_cuda(q, k, v, causal=True)
        want = tflash.flash_attention_plain(q, k, v, causal=True)
        assert float((got - want).abs().max()) <= 1e-4
        # every head width the kernel builds, T and S off its 64-row
        # tiles, S < T, causal and not
        for Dh in tflash.HEAD_DIMS:
            q = _t(rng.standard_normal((2, 130, 4, Dh)).astype(
                np.float32)).to(dev)
            k, v = (_t(rng.standard_normal((2, 77, 1, Dh)).astype(
                np.float32)).to(dev) for _ in range(2))
            for causal in (False, True):
                got = tflash.flash_attention_cuda(q, k, v, causal=causal)
                want = tflash.flash_attention_plain(q, k, v, causal=causal)
                assert float((got - want).abs().max()) <= 1e-4
    elif name == "decode_attention":
        q, k, v = (_t(a).to(dev) for a in _qkv(rng, 2, 256, 4, 2, 64))
        kv_len = torch.tensor([1, 200], dtype=torch.int32, device=dev)
        got = tdec.decode_attention_cuda(q[:, :1], k, v, kv_len)
        want = tdec.decode_attention_plain(q[:, :1], k, v, kv_len)
        assert float((got - want).abs().max()) <= 1e-5
    elif name == "ssd_scan":
        x = _t(rng.standard_normal((2, 300, 8, 64)).astype(np.float32))
        dt = torch.nn.functional.softplus(_t(rng.standard_normal(
            (2, 300, 8)).astype(np.float32)))
        bc = _t(0.3 * rng.standard_normal((2, 300, 2, 2, 128)).astype(
            np.float32))
        args = [a.to(dev) for a in (x, dt, -torch.arange(1.0, 9.0),
                                    bc[:, :, 0], bc[:, :, 1])]
        for got, want in zip(tssd.ssd_scan_cuda(*args, 256),
                             tssd.ssd_scan_plain(*args, 256)):
            assert float((got - want).abs().max() / want.abs().max()) \
                <= 1e-4
    elif name == "avg_pool":
        x = _t(rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)).to(dev)
        got, want = tpool.avg_pool_cuda(x, 2), tpool.avg_pool_plain(x, 2)
        assert float((got - want).abs().max()) <= 1e-6
    elif name == "nn_upsample":
        for shape, d in (((32, 8, 8, 1024), 2), ((3, 5, 7, 6), 3)):
            x = _t(rng.standard_normal(shape).astype(np.float32)).to(dev)
            assert torch.equal(tpool.nn_upsample_cuda(x, d),
                               tpool.nn_upsample_plain(x, d))
    elif name == "int8_matmul":
        # ragged M at the pruned widths, the unaligned K = 100 (zero-padded
        # to 112), a 128 x 256-tile shape (K = 4096) and a tiny one
        for M, K, N in ((256, 1024, 2880), (1000, 960, 2880),
                        (1000, 100, 130), (300, 4096, 1024), (37, 64, 8)):
            xq = _t(rng.integers(-127, 128, (M, K), dtype=np.int8)).to(dev)
            wq = _t(rng.integers(-127, 128, (N, K), dtype=np.int8)).to(dev).t()
            sx = _t(rng.uniform(0.01, 1, M).astype(np.float32)).to(dev)
            sw = _t(rng.uniform(0.01, 1, N).astype(np.float32)).to(dev)
            assert torch.equal(tmm.int8_matmul_cuda(xq, wq, sx, sw),
                               tmm.int8_matmul_plain(xq, wq, sx, sw))
    elif name == "pack_pos":
        bank = _t(rng.standard_normal((2, 20, 64, 32)).astype(np.float32))
        pos = _t(rng.standard_normal((20, 64, 32)).astype(np.float32))
        src = _t(rng.integers(0, 20, (2, 12)).astype(np.int32))
        nw = torch.tensor([5, 12], dtype=torch.int32)
        args = [a.to(dev) for a in (bank, pos, src, nw)]
        assert torch.equal(tfused.pack_pos_cuda(*args),
                           tfused.pack_pos_plain(*args))
    else:
        win = _t(rng.standard_normal((2, 9, 64, 16)).astype(np.float32))
        tiles = _t(rng.standard_normal((2, 4, 4, 64, 16)).astype(np.float32))
        osrc = _t(rng.integers(0, 25, (2, 16)).astype(np.int32))
        omap = _t(rng.integers(0, 5, (2, 16)).astype(np.int32))
        args = [a.to(dev) for a in (win, osrc, omap)]
        assert torch.equal(
            tfused.restore_gather_cuda(*args, 8, 2, tiles.to(dev)),
            tfused.restore_gather_plain(*args, 8, 2, tiles.to(dev)))


# the pooling kernel's own paths: 16-byte copies of whole rows, the 4-byte
# path where W * C, Wo * C or the base is not 16-byte aligned, rows cut
# into chunks, and wide channels that opt in to more shared memory
@pytest.mark.cuda
@pytest.mark.parametrize("shape,d,offset", [
    ((2, 1024, 1024, 3), 2, 0),    # the serving frame: 0 error
    ((2, 1024, 1024, 3), 4, 0),
    ((2, 10, 10, 3), 2, 0),        # W * C = 30, not a multiple of 4
    ((2, 16, 12, 3), 4, 0),        # Wo * C = 9
    ((2, 64, 64, 3), 2, 1),        # a base 4 bytes off 16
    ((1, 4, 4096, 3), 2, 0),       # three chunks, the last one short
    ((1, 16, 16, 1024), 2, 0),     # 80 KB of shared memory
])
def test_avg_pool_kernel_paths_on_card(shape, d, offset):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (chip_smoke.py runs this "
                    "check on the H100)")
    n = int(np.prod(shape))
    flat = _t(np.random.default_rng(11).uniform(0, 1, n + offset).astype(
        np.float32)).cuda()
    x = flat[offset:].view(shape)
    assert (x.data_ptr() % 16 == 0) == (offset == 0)
    got, want = tpool.avg_pool_cuda(x, d), tpool.avg_pool_plain(x, d)
    assert float((got - want).abs().max()) <= 1e-6
    if shape == (2, 1024, 1024, 3) and d == 2:
        assert torch.equal(got, want)
