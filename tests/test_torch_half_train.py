"""Port parity of training at half parameters: ``registry.init_params(
dtype=)`` leaf dtypes, and train steps on fp16 / bf16 trees, each against
the JAX package.

The reference trains at any parameter dtype: ``init_params(cfg, key,
dtype)`` casts every float leaf but a mamba block's ``A_log``,
``dt_bias`` and ``D``; its step differentiates in the parameters' types,
at ``accum_steps`` > 1 sums the microbatch gradients in float32 and
divides there; AdamW keeps float32 moments and rounds each update once
to the parameter's type.  The models are reduced configs of each family
(dense qwen3-4b, the dbrx-132b MoE, llava over stub image embeddings
here; mamba2-370m, a 6-layer zamba2-1.2b and whisper-medium over stub
frames in ``test_torch_half_train_recurrent.py``),
the reference's half tree (norm scales, biases, ``D`` and ``dt_bias``
moved off their init values) converted to the port's.

Tolerances and why: both packages compute each forward and backward in
the half type with float32 statistics, in other orders, so the losses
agree to ``LOSS_RTOL`` (1e-2 relative) and each gradient leaf to
``GRAD_TOL`` (3e-2 of the leaf's largest: a few half ULPs of a sum of
rounded terms), or, for a leaf whose gradient sums many cancelling
half terms (the SSM's ``A_log``, a norm scale six layers down), within
``NOISE_FACTOR`` (4) times the reference's own distance from its float32
gradient (the same step on the float32-cast tree): that distance is the
largest of a few elements (``A_log`` has one a head), a noisy measure
of the half noise.  The port's AdamW applied to its own gradients
equals the reference's update of the same gradients to one ULP of a
half parameter's type everywhere (float32 leaves to ``ADAM_RTOL`` of
their largest, the float32 AdamW test's bound: the global norms sum
the leaves in other orders) and bit for bit at >= 99.9%
(``SAME_GRAD_SHARE``).  End to end, the parameters after two
steps take the reference's types and part from its parameters by no more
than both packages' largest AdamW moves, 2 lr (1 + weight_decay |p|) a
step: AdamW's step m / sqrt(v) drops the gradient's scale, so an entry
whose gradient is small against its leaf's largest carries its half
noise into a step of full size lr, many ULPs of a parameter near 0.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import registry as jreg
from repro.optim import adam as jadam
from repro.train import trainer as jtr
from repro_torch.configs import get_reduced
from repro_torch.models import registry
from repro_torch.optim import adam
from repro_torch.train import checkpoint as tckpt
from repro_torch.train import trainer as ttr

from test_torch_lm_train import CONVERT, _batch, _perturb, _t

torch.set_num_threads(2)
LOSS_RTOL = 1e-2
GRAD_TOL = 3e-2          # of each leaf's largest
SAME_GRAD_SHARE = 0.999  # AdamW on the same gradients, as test_torch_lm_train
NOISE_FACTOR = 4.0
ADAM_RTOL = 1e-6
HALF = {"bf16": (torch.bfloat16, jnp.bfloat16),
        "fp16": (torch.float16, jnp.float16)}
LAYERS = {"qwen3-4b": 2, "dbrx-132b": 2, "mamba2-370m": 2,
          "zamba2-1.2b": 6, "whisper-medium": 2,
          "llava-next-mistral-7b": 2, "deepseek-v2-236b": 2}
# the train-step cases of this file; the SSM, hybrid and encoder-decoder
# families' are in test_torch_half_train_recurrent.py (the same check,
# split so that two test workers share the compile time)
FAMILY_ARCHS = ("qwen3-4b", "dbrx-132b", "llava-next-mistral-7b")


def _half_model(arch, jdt):
    n = LAYERS[arch]
    jcfg = jconfigs.get_reduced(arch).replace(n_layers=n)
    tcfg = get_reduced(arch).replace(n_layers=n)
    tree = _perturb(jax.tree_util.tree_map(
        np.asarray, jreg.init_params(jcfg, jax.random.PRNGKey(0), jdt)),
        np.random.default_rng(1))
    return jcfg, tcfg, tree


def _leaf_dtypes(tree):
    """path -> dtype name of a reference tree's float leaves."""
    out = {}
    for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                       for p in path)
        out[key] = np.dtype(x.dtype).name
    return out


# ---------------------------------------------------------------------------
# init_params(dtype=): leaf dtypes


@pytest.mark.parametrize("dt", sorted(HALF))
@pytest.mark.parametrize("arch", ["qwen3-4b", "dbrx-132b", "mamba2-370m",
                                  "zamba2-1.2b", "whisper-medium",
                                  "llava-next-mistral-7b",
                                  "deepseek-v2-236b", "vitdet-l"])
def test_init_params_leaf_dtypes_match_reference(arch, dt):
    """Every family's ``init_params(dtype=)`` (the reference's reduced
    configs, ViTDet at SIM scale) against the reference's tree, leaf for
    leaf by name (the port's fused ``w_qkv`` / ``b_qkv`` stand for the
    reference's q / k / v leaves); the values' draws differ (torch's
    generator), the types must not.  ``init_train_state`` keeps float32
    moments."""
    tdt, jdt = HALF[dt]
    if arch == "vitdet-l":
        from repro.configs import vitdet_l as jv
        from repro_torch.configs import vitdet_l as tv
        jcfg, tcfg = jv.SIM, tv.SIM
    else:
        jcfg = jconfigs.get_reduced(arch).replace(n_layers=LAYERS[arch])
        tcfg = get_reduced(arch).replace(n_layers=LAYERS[arch])
    want = _leaf_dtypes(jax.eval_shape(
        lambda: jreg.init_params(jcfg, jax.random.PRNGKey(0), jdt)))
    params = registry.init_params(tcfg, torch.Generator().manual_seed(0),
                                  "cpu", tdt)
    got = tckpt.flatten(params)
    kinds = {}
    for k, v in want.items():
        kinds.setdefault(k.rsplit("/", 1)[-1], set()).add(v)
    checked = 0
    for path, x in got.items():
        leaf = path.rsplit("/", 1)[-1]
        if leaf in ("pos_seq", "pos_bank"):        # derived, not drawn
            assert x.dtype == tdt
            continue
        ref = {"w_qkv": "w_q", "b_qkv": "b_q"}.get(leaf, leaf)
        assert kinds[ref] == {str(x.dtype).replace("torch.", "")}, path
        checked += 1
    assert checked >= len(want) // 2
    f32 = {k for k, v in got.items() if v.dtype == torch.float32}
    assert f32 == {k for k in got if k.rsplit("/", 1)[-1] in
                   ("A_log", "dt_bias", "D")}
    if tcfg.family != "vit":
        _, opt = ttr.init_train_state(tcfg, torch.Generator().manual_seed(0),
                                      "cpu", tdt)
        assert all(m.dtype == torch.float32 for m in opt.m.values())


def test_shape_tree_dtypes_match_reference_params_shape():
    """``train.trainer.shape_tree(cfg, dtype)`` on the meta device (the
    dry-run's ``params_shape``) at bf16 for the SSM and hybrid configs at
    full width: the three mamba leaves float32, the rest bf16, as the
    reference's ``launch.specs.params_shape``."""
    from repro.launch import specs as jsp
    from repro_torch.configs import get_config
    from repro_torch.launch import specs as tsp
    for arch in ("mamba2-370m", "zamba2-1.2b"):
        want = _leaf_dtypes(jsp.params_shape(jconfigs.get_config(arch)))
        got = tckpt.flatten(tsp.params_shape(get_config(arch)))
        kinds = {}
        for k, v in want.items():
            kinds.setdefault(k.rsplit("/", 1)[-1], set()).add(v)
        for path, x in got.items():
            leaf = path.rsplit("/", 1)[-1]
            ref = {"w_qkv": "w_q", "b_qkv": "b_q"}.get(leaf, leaf)
            assert kinds[ref] == {str(x.dtype).replace("torch.", "")}, \
                (arch, path)


# ---------------------------------------------------------------------------
# train steps at half


def _record_grads(monkeypatch):
    """Both packages' AdamW, wrapped to hand back the gradients it was
    given (the reference's through its jitted step's metrics)."""
    got = []
    port, ref = adam.adam_update, jadam.adam_update

    def port_rec(grads, state, params, **kw):
        got.append({k: g.detach().clone() for k, g in grads.items()})
        return port(grads, state, params, **kw)

    def ref_rec(grads, state, params, **kw):
        p, s, m = ref(grads, state, params, **kw)
        return p, s, {**m, "grads": grads}

    monkeypatch.setattr(adam, "adam_update", port_rec)
    monkeypatch.setattr(jadam, "adam_update", ref_rec)
    return got


def ulp(x: torch.Tensor) -> torch.Tensor:
    """One unit in the last place of x's type at each |x|, as float32."""
    p = {torch.float16: 11, torch.bfloat16: 8, torch.float32: 24}[x.dtype]
    tiny = {torch.float16: 2.0 ** -24, torch.bfloat16: 2.0 ** -133,
            torch.float32: 2.0 ** -149}[x.dtype]
    _, e = torch.frexp(x.float().abs())
    return torch.clamp(torch.ldexp(torch.ones_like(e, dtype=torch.float32),
                                   e - p), min=tiny)


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("dt", sorted(HALF))
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_half_train_steps_match_reference(monkeypatch, arch, dt, accum):
    check_half_train_steps(monkeypatch, arch, dt, accum)


def check_half_train_steps(monkeypatch, arch, dt, accum):
    """Two steps of ``make_train_step`` (lr 0 at the first, peak 1e-3 at
    the second) on the reference's half tree against its jitted step: the
    losses, the first step's gradients (each leaf's type as the
    reference's: the parameter's at A = 1, float32 at A = 2), and the
    parameters (each leaf's type the reference's) after both steps."""
    tdt, jdt = HALF[dt]
    jcfg, tcfg, tree = _half_model(arch, jdt)
    grads = _record_grads(monkeypatch)
    kw = dict(accum_steps=accum, remat=True, peak_lr=1e-3, warmup_steps=1,
              total_steps=6, weight_decay=0.1, grad_clip=1.0)
    # float32 stub frames / image embeddings, as both launchers feed
    # them: the reference promotes where they meet half weights
    batches = [_batch(tcfg, 4, 16, seed=20 + s, mask=False)
               for s in range(2)]
    for b in batches:
        b["labels"] = np.roll(b["tokens"], -1, axis=1)
    jstep = jax.jit(jtr.make_train_step(jcfg, None, jtr.TrainConfig(**kw)))
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    jo = jadam.init_adam(jp)
    want, jgrads = [], None
    for b in batches:
        jp, jo, m = jstep(jp, jo, {k: jnp.asarray(v) for k, v in b.items()})
        want.append(float(m["loss"]))
        if jgrads is None:
            jgrads = m["grads"]

    params = CONVERT[tcfg.family](tree, tcfg, "cpu")
    opt = adam.init_adam(tckpt.flatten(params))
    step = ttr.make_train_step(tcfg, ttr.TrainConfig(**kw))
    got, lrs = [], []
    for b in batches:
        params, opt, m = step(params, opt, {k: _t(v) for k, v in b.items()})
        got.append(float(m["loss"]))
        lrs.append(float(m["lr"]))
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)

    conv = (lambda t: tckpt.flatten(CONVERT[tcfg.family](
        jax.tree_util.tree_map(np.asarray, t), tcfg, "cpu")))

    def grads32():
        # the reference's float32 gradient: the same step on the
        # float32-cast tree
        tree32 = jax.tree_util.tree_map(
            lambda x: jnp.asarray(x, jnp.float32), tree)
        step32 = jax.jit(jtr.make_train_step(jcfg, None,
                                             jtr.TrainConfig(**kw)))
        b0 = {k: jnp.asarray(v) for k, v in batches[0].items()}
        return conv(step32(tree32, jadam.init_adam(tree32), b0)[2]["grads"])

    check_grads(grads[0], conv(jgrads), grads32)
    flat = tckpt.flatten(params)
    check_adam_on_own_grads(
        tckpt.flatten(CONVERT[tcfg.family](tree, tcfg, "cpu")), grads, lrs,
        flat, kw["weight_decay"], kw["grad_clip"])

    # end to end: each leaf's type the reference's, and no element parts by
    # more than both packages' largest AdamW moves
    ref_p = conv(jp)
    for k, w in ref_p.items():
        p = flat[k]
        assert p.dtype == w.dtype, k
        d = (p.float() - w.float()).abs()
        move = 2 * sum(lrs) * (1 + kw["weight_decay"] * w.float().abs())
        assert bool((d <= ulp(w) + move).all()), k


def check_grads(got, want, grads32):
    """Each gradient leaf of ``got`` (the port's, flat) in the type of
    ``want`` (the reference's, converted) and within GRAD_TOL of its
    largest element; a leaf past that within NOISE_FACTOR times the
    reference's own distance from its float32 gradient (``grads32()``,
    called only then)."""
    assert set(got) == set(want)
    far = []
    for k, w in want.items():
        g = got[k]
        assert g.dtype == w.dtype, (k, g.dtype, w.dtype)
        err = float((g.float() - w.float()).abs().max())
        if err > GRAD_TOL * max(float(w.float().abs().max()), 1e-12):
            far.append(k)
    if far:
        g32 = grads32()
        for k in far:
            ref_d = float((want[k].float() - g32[k]).abs().max())
            got_d = float((got[k].float() - g32[k]).abs().max())
            assert got_d <= NOISE_FACTOR * ref_d, (k, got_d, ref_d)


def check_adam_on_own_grads(start, grads, lrs, final, weight_decay,
                            grad_clip):
    """The reference's AdamW applied to the port's own gradients
    (``grads``, one flat dict a step, at the learning rates ``lrs``) from
    the flat parameters ``start`` equals the port's parameters after
    those steps (``final``): a half leaf within one ULP of its type, a
    float32 leaf within ADAM_RTOL of its largest (the two global norms
    sum the leaves in other orders, as test_torch_lm_train's AdamW
    check), and >= SAME_GRAD_SHARE of all elements bit-equal."""
    jflat = {k: jnp.asarray(_np(v)) for k, v in start.items()}
    jst = jadam.init_adam(jflat)
    for g, lr in zip(grads, lrs):
        jflat, jst, _ = jadam.adam_update(
            {k: jnp.asarray(_np(v)) for k, v in g.items()}, jst, jflat,
            lr=lr, weight_decay=weight_decay, grad_clip=grad_clip)
    n_eq = n = 0
    for k, w in jflat.items():
        w = _t(_np32(w)).to(final[k].dtype)
        d = (final[k].float() - w.float()).abs()
        tol = (ulp(w) if w.dtype != torch.float32
               else ADAM_RTOL * float(w.abs().max()))
        assert bool((d <= tol).all()), (k, float((d - tol).max()))
        n_eq += int((final[k] == w).sum())
        n += w.numel()
    assert n_eq >= SAME_GRAD_SHARE * n, n_eq / n


def _np(t: torch.Tensor) -> np.ndarray:
    """A port tensor -> numpy in its type (bf16 as ``ml_dtypes``)."""
    if t.dtype == torch.bfloat16:
        return t.float().numpy().astype(jnp.bfloat16)
    return t.numpy()


def _np32(a) -> np.ndarray:
    return np.asarray(a).astype(np.float32)
