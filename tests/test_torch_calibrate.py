"""Port parity for the calibration gate: ``repro_torch.quant.calibrate``
against ``repro.quant.calibrate`` on SIM, the same weights in both
packages (converted with ``convert.params_from_jax``), the clips of seed
23 (``parkS`` / ``driveN``, 3 frames), score threshold 0 and top-k 8.

Candidates are the int8-weight / float32-activation rungs with and
without one pruned head.  The candidates' order, byte counts and ratios,
pass / fail and the shipped spec must equal the reference's in both
quant lanes.  The F1 deltas must be equal in the "dequant" lane (int8
weights, float GEMMs), where the two packages' detections agree to
float32 rounding.  In the "native" lane each delta may differ by one
detection of the top-k 8 (NATIVE_DELTA_TOL): both packages quantize each
GEMM's input rows on the fly, and a one-ulp difference upstream flips an
int8 code where it lands on a rounding tie (``test_torch_quant.py``),
which on seeded weights, where the pruned candidate keeps one or no box
of the eight, moves a frame's F1 by 1/8.  The default ladder
(``DEFAULT_CANDIDATES``, three of its four rungs at half precision) runs
against the reference's in both lanes: equal throughout in the dequant
lane, within one detection a delta in the native lane.  There the
shipped spec differs at seed 23 (the port ships fp16+fp16, the
reference int8+fp16), and the last tests show why: the reference run
eagerly ships fp16+fp16 too, the port's scores differ from the jit
reference's by as much as the eager reference's do (a median of about
three fp16 ULPs of the k-th score, where the k-th and (k+1)-th scores
lie 0.2-5.5 ULPs apart), and at seeds 1 and 5 both packages ship the
same spec.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs.vitdet_l import SIM as JSIM
from repro.core import vit_backbone as jvb
from repro.kernels import dispatch as jdispatch
from repro.offload.simulator import ServerModel as JServerModel
from repro.quant import calibrate as jcal
from repro.quant import ptq as jptq
from repro.quant.ptq import QuantSpec as JQuantSpec
from repro_torch import convert
from repro_torch.configs.vitdet_l import SIM
from repro_torch.kernels import dispatch as tdispatch
from repro_torch.offload import simulator as tsim
from repro_torch.quant import calibrate as tcal
from repro_torch.quant import ptq as tptq
from repro_torch.quant.ptq import QuantSpec

torch.set_num_threads(2)
SPECS = (("int8", "fp32", 0), ("int8", "fp32", 1))
SCENARIOS = ("parkS", "driveN")
N_FRAMES = 3
SEED = 23
TOP_K = 8
NATIVE_DELTA_TOL = 1.0 / TOP_K
NOISE_RATIO = 1.5


@pytest.fixture(scope="module")
def params():
    jparams = jvb.init_vitdet_params(JSIM, jax.random.PRNGKey(SEED))
    tparams = convert.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams), SIM, device="cpu")
    return jparams, tparams


@pytest.mark.parametrize("lane", ["dequant", "native"])
def test_calibrate_matches_reference(params, lane):
    jparams, tparams = params
    kw = dict(top_k=TOP_K, score_thresh=0.0)
    with jdispatch.quant_scope(lane), tdispatch.quant_scope(lane):
        want = jcal.calibrate(JSIM, jparams,
                              candidates=[JQuantSpec(*s) for s in SPECS],
                              scenarios=SCENARIOS, n_frames=N_FRAMES,
                              seed=SEED, server_kw=dict(backend="xla", **kw))
        got = tcal.calibrate(SIM, tparams,
                             candidates=[QuantSpec(*s) for s in SPECS],
                             scenarios=SCENARIOS, n_frames=N_FRAMES,
                             seed=SEED, server_kw=dict(device="cpu", **kw))
    assert got.bytes_fp32 == want.bytes_fp32
    assert got.bound == want.bound == tcal.F1_BOUND
    assert got.scenarios == want.scenarios == SCENARIOS
    assert len(got.points) == len(want.points) >= 1
    for g, w in zip(got.points, want.points):
        assert g.spec.name == w.spec.name
        assert g.bytes == w.bytes
        assert g.ratio == pytest.approx(w.ratio, rel=1e-12)
        assert g.deltas.keys() == w.deltas.keys()
        for s in SCENARIOS:
            if lane == "dequant":
                assert g.deltas[s] == w.deltas[s], (g.spec.name, s)
            else:
                assert abs(g.deltas[s] - w.deltas[s]) <= NATIVE_DELTA_TOL
        assert g.passed == w.passed
    assert (got.shipped is None) == (want.shipped is None)
    if want.shipped is not None:
        assert got.shipped.name == want.shipped.name


def test_scenario_workload_matches_reference():
    for s in SCENARIOS:
        tf, tm = tcal._scenario_workload(SIM, s, N_FRAMES, SEED)
        jf, jm = jcal._scenario_workload(JSIM, s, N_FRAMES, SEED)
        np.testing.assert_array_equal(np.asarray(tf), np.asarray(jf))
        for a, b in zip(tm, jm):
            np.testing.assert_array_equal(a, b)


def _default_ladders(params, lane):
    jparams, tparams = params
    kw = dict(top_k=TOP_K, score_thresh=0.0)
    with jdispatch.quant_scope(lane), tdispatch.quant_scope(lane):
        want = jcal.calibrate(JSIM, jparams, scenarios=SCENARIOS,
                              n_frames=N_FRAMES, seed=SEED,
                              server_kw=dict(backend="xla", **kw))
        got = tcal.calibrate(SIM, tparams, scenarios=SCENARIOS,
                             n_frames=N_FRAMES, seed=SEED,
                             server_kw=dict(device="cpu", **kw))
    return got, want


def test_default_ladder_raises_before_any_server(params):
    """The full default ladder (``DEFAULT_CANDIDATES``: int8+fp16-p1,
    int8+fp16, int8, fp16+fp16), which the port once refused before
    building a server, now runs against the reference's.  In the dequant
    lane (no row quantization) the rungs it reaches, their bytes, deltas
    and pass / fail and the shipped spec equal the reference's."""
    got, want = _default_ladders(params, "dequant")
    assert [p.spec.name for p in got.points] == \
        [p.spec.name for p in want.points]
    assert got.points[0].spec.name == "int8+fp16-p1"
    for g, w in zip(got.points, want.points):
        assert g.bytes == w.bytes
        assert g.ratio == pytest.approx(w.ratio, rel=1e-12)
        assert g.deltas == w.deltas, g.spec.name
        assert g.passed == w.passed
    assert want.shipped is not None
    assert got.shipped.name == want.shipped.name


@pytest.fixture(scope="module")
def native_ladders(params):
    """The default ladder in the native lane: the port's, the reference's
    (jit-compiled, as its ``ServerModel`` runs by default) and the
    reference's run eagerly (``jit=False``: the same operations without
    XLA's fusion, so its half intermediates round at other places)."""
    got, want = _default_ladders(params, "native")
    with jdispatch.quant_scope("native"):
        eager = jcal.calibrate(
            JSIM, params[0], scenarios=SCENARIOS, n_frames=N_FRAMES,
            seed=SEED, server_kw=dict(backend="xla", jit=False, top_k=TOP_K,
                                      score_thresh=0.0))
    return got, want, eager


def test_default_ladder_native_lane_within_one_detection(native_ladders):
    """The same ladder in the native lane: the reference's points come
    first in the port's list with their bytes, and each delta within one
    detection of the eight (NATIVE_DELTA_TOL).  Where a delta moves by
    that one detection across the 0.005 bound, the port walks on to the
    next rung (on these seeded weights int8+fp16 on driveN: the port's
    0.125 against 0.0, one near-tied box), so every pass / fail must
    follow its own deltas."""
    got, want, _ = native_ladders
    names = [p.spec.name for p in got.points]
    assert names[:len(want.points)] == [p.spec.name for p in want.points] \
        or [p.spec.name for p in want.points][:len(names)] == names
    for g, w in zip(got.points, want.points):
        assert g.bytes == w.bytes
        for s in SCENARIOS:
            assert abs(g.deltas[s] - w.deltas[s]) <= NATIVE_DELTA_TOL, \
                (g.spec.name, s, g.deltas[s], w.deltas[s])
    for g in got.points:
        assert g.passed == all(d <= tcal.F1_BOUND
                               for d in g.deltas.values())
    assert got.shipped == next((p.spec for p in got.points if p.passed),
                               None)


def test_native_lane_shipped_spec_moves_with_rounding_alone(native_ladders):
    """Why the native lane ships another spec than the reference at this
    seed: the reference's own choice turns on rounding.  Jit-compiled it
    ships int8+fp16; run eagerly it ships fp16+fp16, as the port does,
    with the port's ladder and each of its deltas within one detection of
    the eager reference's."""
    got, want, eager = native_ladders
    assert want.shipped.name == "int8+fp16"
    assert eager.shipped.name == got.shipped.name == "fp16+fp16"
    assert [p.spec.name for p in got.points] == \
        [p.spec.name for p in eager.points]
    for g, e in zip(got.points, eager.points):
        assert g.bytes == e.bytes
        for s in SCENARIOS:
            assert abs(g.deltas[s] - e.deltas[s]) <= NATIVE_DELTA_TOL


@pytest.mark.parametrize("seed", [1, 5])
def test_default_ladder_native_lane_ships_reference_spec(seed):
    """At other seeds (weights and clips) the native lane ships the
    reference's spec: int8+fp16 at seed 1, fp16+fp16 at seed 5, each
    delta within one detection of the reference's."""
    jparams = jvb.init_vitdet_params(JSIM, jax.random.PRNGKey(seed))
    tparams = convert.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams), SIM, device="cpu")
    kw = dict(top_k=TOP_K, score_thresh=0.0)
    with jdispatch.quant_scope("native"), tdispatch.quant_scope("native"):
        want = jcal.calibrate(JSIM, jparams, scenarios=SCENARIOS,
                              n_frames=N_FRAMES, seed=seed,
                              server_kw=dict(backend="xla", **kw))
        got = tcal.calibrate(SIM, tparams, scenarios=SCENARIOS,
                             n_frames=N_FRAMES, seed=seed,
                             server_kw=dict(device="cpu", **kw))
    assert got.shipped.name == want.shipped.name
    assert [p.spec.name for p in got.points] == \
        [p.spec.name for p in want.points]
    for g, w in zip(got.points, want.points):
        for s in SCENARIOS:
            assert abs(g.deltas[s] - w.deltas[s]) <= NATIVE_DELTA_TOL


def _by_anchor(dets, ref):
    """Scores of ``dets`` at the anchors of ``ref`` (boxes within 1 px);
    NaN where ``dets`` has no such box."""
    boxes = np.array([d["box"] for d in dets])
    out = []
    for r in ref:
        dist = np.abs(boxes - np.array(r["box"])).max(axis=1)
        j = int(dist.argmin())
        out.append(dets[j]["score"] if dist[j] < 1.0 else np.nan)
    return np.array(out)


def test_native_half_lane_score_noise_is_the_references_own(params):
    """The cause of the one-detection differences at int8+fp16 in the
    native lane: on seeded weights the scores around the k-th place lie a
    few fp16 ULPs (of the k-th score) apart, and the port's score for a
    box differs from the jit-compiled reference's by about as much as the
    reference's own eager score does (row quantization of half
    activations turns a one-ULP difference into a changed int8 code).
    On driveN the median difference, port against reference, is at most
    NOISE_RATIO times the reference's eager against jit; the k-th and
    (k+1)-th scores and their gap are printed."""
    jparams, tparams = params
    spec = ("int8", "fp16", 0)
    kw = dict(top_k=4 * TOP_K, score_thresh=0.0)
    frames, masks = jcal._scenario_workload(JSIM, "driveN", N_FRAMES, SEED)
    with jdispatch.quant_scope("native"), tdispatch.quant_scope("native"):
        jc, jq, _ = jptq.compress(JSIM, jparams, JQuantSpec(*spec))
        tc, tq, _ = tptq.compress(SIM, tparams, QuantSpec(*spec))
        servers = {"jit": JServerModel(jc, jq, backend="xla", **kw),
                   "eager": JServerModel(jc, jq, backend="xla", jit=False,
                                         **kw),
                   "port": tsim.ServerModel(tc, tq, device="cpu", **kw)}
        noise = {"eager": [], "port": []}
        for i, f in enumerate(frames):
            dets = {k: s.infer(f) for k, s in servers.items()}
            ref = dets["jit"][:2 * TOP_K]
            ulp = float(np.spacing(np.float16(ref[TOP_K - 1]["score"])))
            for k in noise:
                d = np.abs(_by_anchor(dets[k], ref)
                           - np.array([r["score"] for r in ref])) / ulp
                noise[k] += d[np.isfinite(d)].tolist()
            for k in ("jit", "port"):
                s_k, s_k1 = (dets[k][TOP_K - 1]["score"],
                             dets[k][TOP_K]["score"])
                print(f"driveN frame {i} {k}: k-th {s_k:.9g}, (k+1)-th "
                      f"{s_k1:.9g}, gap {(s_k - s_k1) / ulp:.2f} fp16 ULPs")
    med = {k: float(np.median(v)) for k, v in noise.items()}
    print(f"median |score difference| against the jit reference, fp16 "
          f"ULPs of the k-th score: {med} over {len(noise['port'])} boxes")
    assert len(noise["port"]) >= TOP_K * N_FRAMES
    assert med["port"] <= NOISE_RATIO * med["eager"]
