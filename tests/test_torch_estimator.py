"""Port parity of the offload estimators and their optimizer: the
``MLPEstimator`` (a torch module here) and ``optim.adam`` against the
reference's JAX versions, and the numpy estimators and delay models,
which the port copies.

Tolerances: the MLP forward on carried parameters within 1e-5 (float32,
another matmul order); one AdamW update on the same gradients within
1e-6, clip included; a whole ``fit`` from carried initial parameters
with the same sampling seed within 1e-4 relative on its predictions.
The numpy estimators and delay models are equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.vitdet_l import CONFIG as JCONFIG
from repro.core import vit_backbone as jvb
from repro.offload import estimator as jest
from repro.optim import adam as jadam
from repro_torch import convert
from repro_torch.configs.vitdet_l import CONFIG
from repro_torch.core import partition as pt
from repro_torch.core import vit_backbone as vb
from repro_torch.offload import estimator as est
from repro_torch.optim import adam

torch.set_num_threads(2)
FWD_TOL = 1e-5
ADAM_TOL = 1e-6
FIT_RTOL = 1e-4


def _data(seed=0, n=300):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, est.N_FEATURES)).astype(np.float32)
    X[:, 0] = rng.integers(0, 3, n)
    X[:, 4] = rng.choice([0.7, 0.85, 1.0], n)
    y = (3.0 * X[:, 1] - 2.0 * X[:, 4] + np.sin(X[:, 2])
         + 0.1 * rng.normal(size=n)).astype(np.float32)
    return X, y


def _carried(jmlp):
    tm = est.MLPEstimator(device="cpu")
    tm.load_params(convert.mlp_params_from_jax(
        jax.tree_util.tree_map(np.asarray, jmlp.params), device="cpu"))
    return tm


def test_mlp_init_shapes_and_seed():
    a, b = est.MLPEstimator(seed=3, device="cpu"), est.MLPEstimator(
        seed=3, device="cpu")
    assert [tuple(w.shape) for w in a.w] == [(8, 128), (128, 64), (64, 1)]
    for wa, wb in zip(a.w, b.w):
        torch.testing.assert_close(wa, wb, rtol=0, atol=0)
    c = est.MLPEstimator(seed=4, device="cpu")
    assert not torch.equal(a.w[0], c.w[0])
    # normal / sqrt(fan_in), as the reference draws it
    assert abs(float(a.w[1].detach().std()) * np.sqrt(128) - 1.0) < 0.05
    assert all(float(b_.detach().abs().max()) == 0.0 for b_ in a.b)


@pytest.mark.parametrize("seed", [0, 1])
def test_mlp_forward_carried_params(seed):
    jm = jest.MLPEstimator(seed=seed)
    tm = _carried(jm)
    X, _ = _data(seed + 5, 64)
    want = np.asarray(jest._mlp_fwd(jm.params, jnp.asarray(X)))
    got = tm(torch.as_tensor(X)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=FWD_TOL)
    np.testing.assert_allclose(tm.predict(X), jm.predict(X), rtol=0,
                               atol=FWD_TOL)


@pytest.mark.parametrize("grad_scale,weight_decay,clip", [
    (1.0, 0.0, 1.0),          # the norm is above 1: clipped
    (0.01, 0.0, 1.0),         # below: untouched
    (5.0, 0.1, None),         # no clip, decoupled weight decay
])
def test_adam_update_matches(grad_scale, weight_decay, clip):
    rng = np.random.default_rng(7)
    shapes = {"w0": (8, 16), "b0": (16,), "w1": (16, 1)}
    params = {k: rng.normal(size=s).astype(np.float32)
              for k, s in shapes.items()}
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.as_tensor(v) for k, v in params.items()}
    js, ts = jadam.init_adam(jp), adam.init_adam(tp)
    for step in range(3):
        grads = {k: (grad_scale * rng.normal(size=s)).astype(np.float32)
                 for k, s in shapes.items()}
        kw = dict(lr=1e-2 * (step + 1), weight_decay=weight_decay,
                  grad_clip=clip)
        jp, js, jinfo = jadam.adam_update(
            {k: jnp.asarray(v) for k, v in grads.items()}, js, jp, **kw)
        tp, ts, tinfo = adam.adam_update(
            {k: torch.as_tensor(v) for k, v in grads.items()}, ts, tp, **kw)
        np.testing.assert_allclose(float(tinfo["grad_norm"]),
                                   float(jinfo["grad_norm"]), rtol=ADAM_TOL)
        assert ts.step == int(js.step)
        for k in shapes:
            for t_, j_ in ((tp[k], jp[k]), (ts.m[k], js.m[k]),
                           (ts.v[k], js.v[k])):
                np.testing.assert_allclose(t_.numpy(), np.asarray(j_),
                                           rtol=0, atol=ADAM_TOL)


def test_adam_update_skips_non_finite_gradients():
    tp = {"w": torch.ones(4)}
    ts = adam.init_adam(tp)
    new, ts2, info = adam.adam_update({"w": torch.tensor(
        [1.0, float("nan"), 0.0, 0.0])}, ts, tp, lr=0.1)
    assert not bool(torch.isfinite(info["grad_norm"]))
    torch.testing.assert_close(new["w"], tp["w"])
    assert float(ts2.m["w"].abs().max()) == 0.0
    assert float(ts2.v["w"].abs().max()) == 0.0
    want = {"w": jnp.ones(4)}
    jnew, _, _ = jadam.adam_update({"w": jnp.asarray(
        [1.0, np.nan, 0.0, 0.0])}, jadam.init_adam(want), want, lr=0.1)
    np.testing.assert_array_equal(new["w"].numpy(), np.asarray(jnew["w"]))


@pytest.mark.parametrize("steps,batch", [(150, 64), (300, 256)])
def test_fit_from_carried_params(steps, batch):
    X, y = _data(1)
    jm = jest.MLPEstimator(seed=2)
    tm = _carried(jm)
    jm.fit(X, y, steps=steps, batch=batch, seed=4)
    tm.fit(X, y, steps=steps, batch=batch, seed=4)
    for a in ("x_mean", "x_std"):
        np.testing.assert_array_equal(getattr(tm, a), getattr(jm, a))
    assert (tm.y_mean, tm.y_std) == (jm.y_mean, jm.y_std)
    Xt, _ = _data(9, 50)
    want = jm.predict(Xt)
    got = tm.predict(Xt)
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= FIT_RTOL, err


def test_linear_and_mean_estimators_equal():
    X, y = _data(2)
    ja, ta = jest.LinearEstimator(), est.LinearEstimator()
    ja.fit(X, y)
    ta.fit(X, y)
    np.testing.assert_array_equal(ta.w, ja.w)
    np.testing.assert_array_equal(ta.predict(X[:20]), ja.predict(X[:20]))
    jm, tm = jest.OfflineMean(), est.OfflineMean()
    jm.fit(X, y)
    tm.fit(X, y)
    assert tm.mean == jm.mean
    np.testing.assert_array_equal(tm.predict(X[:5]), jm.predict(X[:5]))
    assert est.regression_metrics(y, ta.predict(X)) == \
        jest.regression_metrics(y, ja.predict(X))
    np.testing.assert_array_equal(
        est.feature_vector(1, 4, 0.3, 0.02, 85, 0.1, 0.2, 2),
        jest.feature_vector(1, 4, 0.3, 0.02, 85, 0.1, 0.2, 2))


@pytest.mark.parametrize("form", ["exact", "reuse", "padded"])
def test_inference_delay_model_equal(form):
    part = vb.vit_partition(CONFIG)
    edges = pt.length_bucket_set(part)
    fns = {
        "exact": (lambda n, b: jvb.backbone_flops(JCONFIG, n, b),
                  lambda n, b: vb.backbone_flops(CONFIG, n, b)),
        "reuse": (lambda n, b, r: jvb.backbone_flops(JCONFIG, n, b, r),
                  lambda n, b, r: vb.backbone_flops(CONFIG, n, b, r)),
        "padded": (lambda n, b, r: jvb.backbone_flops(
            JCONFIG, n, b, r, length_edges=edges),
                   lambda n, b, r: vb.backbone_flops(
            CONFIG, n, b, r, length_edges=edges))}[form]
    ja = jest.InferenceDelayModel.fit_from_flops(
        fns[0], part.n_regions, betas=(0, 1, 2, 3, 4),
        full_res_delay_s=0.0731)
    ta = est.InferenceDelayModel.fit_from_flops(
        fns[1], part.n_regions, betas=(0, 1, 2, 3, 4),
        full_res_delay_s=0.0731)
    assert ta.coefs == ja.coefs
    for beta in range(5):
        for n in range(part.n_regions + 1):
            assert ta(beta, n, 2) == ja(beta, n, 2)


def test_throughput_estimator_equal():
    rng = np.random.default_rng(4)
    ja, ta = jest.ThroughputEstimator(), est.ThroughputEstimator()
    assert (ta.throughput, ta.rtt) == (ja.throughput, ja.rtt)
    t = 0.0
    for i in range(30):
        t += float(rng.uniform(0.1, 20.0))
        tput = float(rng.choice([1e3, rng.uniform(1e6, 5e7)]))
        rtt = float(rng.uniform(0.02, 0.2))
        ja.observe(tput, rtt, t=t if i % 3 else None)
        ta.observe(tput, rtt, t=t if i % 3 else None)
        assert (ta.throughput, ta.rtt) == (ja.throughput, ja.rtt)
        assert (ta.obs_tput, ta.obs_rtt, ta.obs_t) == \
            (ja.obs_tput, ja.obs_rtt, ja.obs_t)
