"""Port parity of the edge scheduling plane: ``repro.serve.scheduler``
against ``repro_torch.serve.scheduler`` on the fake-server and fake-client
scenarios of ``tests/test_scheduler.py`` (modelled timelines only, no
model).

Each scenario runs once through each package's scheduler, with fakes
built over that package's ``RegionPlan``, ``Partition``, ``FeatureCache``
and faults.  The waves each scheduler dispatched (members, compute start,
key), ``free_at``, every ``EdgeStats`` field and every job's Eq. (2)
fields must be equal, and the port's run must show what the reference's
own test asserts.  Scenarios: ``form_wave`` and its hooks, the unknown
scheduler name, barrier queueing as admission wait, continuous overlap,
uncontended equality, pad-slot admission and the rule that a late job
never grows the B bucket, ``edge_restart_tick`` and the lost queue, the
speculative lane (hide, patch, discard, abandon, stale epoch, its gates
and its window) and a failure of the deferred dispatch.
"""
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest

from repro.configs.vitdet_l import SIM as JSIM
from repro.core import partition as jpt
from repro.offload import faults as jfa
from repro.serve import request as jreq
from repro.serve import scheduler as jsch
from repro_torch.configs.vitdet_l import SIM
from repro_torch.core import partition as tpt
from repro_torch.offload import faults as tfa
from repro_torch.serve import request as treq
from repro_torch.serve import scheduler as tsch

PKGS = {"ref": SimpleNamespace(sch=jsch, req=jreq, pt=jpt, fa=jfa, cfg=JSIM),
        "port": SimpleNamespace(sch=tsch, req=treq, pt=tpt, fa=tfa, cfg=SIM)}
JOB_KEYS = ("arrival", "frame", "_client", "t_dec", "t_inf", "beta", "e2e",
            "done_at", "parts", "lost", "rejected", "stale_epoch",
            "abandoned", "speculation", "t_inf_exec", "promoted_lb",
            "_bound_at")


# ---------------------------------------------------------------------------
# fakes over one package (as tests/test_scheduler.py defines them)


def fakes(pkg):
    class FakeStats:
        stale_epoch_rejects = 0

    class FakeServer:
        b_buckets = (1, 2, 4, 8)
        epoch = 0

        def __init__(self):
            self.stats = FakeStats()
            self.restarts = []

        def plan_length_bucket(self, plan):
            return 48

        def batch_bucket(self, b):
            return next(e for e in self.b_buckets if e >= b)

        def infer_wave(self, frames, plans, beta, **kw):
            return [[] for _ in plans]

        def stage_frames(self, frames):
            return np.asarray(frames)

        def restart(self, preserve_executables=False):
            self.epoch += 1
            self.restarts.append(preserve_executables)
            return self.epoch

    class FakeClient:
        feature_cache = None

        def __init__(self):
            self.finished = []

        def _finish_offload(self, job, dets, queue_delay=0.0, t_dec=None,
                            t_inf=None):
            t_dec = job["t_dec"] if t_dec is None else t_dec
            t_inf = job["t_inf"] if t_inf is None else t_inf
            job["e2e"] = queue_delay + t_dec + t_inf
            job["done_at"] = job["arrival"] + job["e2e"]
            job["parts"] = {"queue": queue_delay, "dec": t_dec,
                            "inf": t_inf}
            job["dets"] = dets
            self.finished.append(job)

    spart = pkg.pt.Partition(grid_h=8, grid_w=8, window=2, downsample=2)

    class SpecServer(FakeServer):
        part = spart
        cfg = pkg.cfg

        def plan_length_bucket(self, plan):
            return spart.n_windows(plan.n_low, plan.n_reuse)

        def infer_speculative(self, pred, plan, beta, cache, frame_idx):
            clone = cache.speculative_clone()
            return [{"box": (0.0, 0.0, 1.0, 1.0), "score": 1.0,
                     "label": 0}], clone

    class SpecClient(FakeClient):
        analyzer = SimpleNamespace(patch_px=1)

        def __init__(self):
            super().__init__()
            self.feature_cache = pkg.req.FeatureCache(
                n_regions=4, max_age=4, beta=2, warm=True, epoch=0)

    class BoomServer(FakeServer):
        def __init__(self, boom_on=2):
            super().__init__()
            self.calls = 0
            self.boom_on = boom_on

        def infer_wave(self, frames, plans, beta, **kw):
            self.calls += 1
            if self.calls == self.boom_on:
                raise RuntimeError("device OOM mid-dispatch")
            return [[] for _ in plans]

    return SimpleNamespace(Server=FakeServer, Client=FakeClient,
                           SpecServer=SpecServer, SpecClient=SpecClient,
                           BoomServer=BoomServer)


class Host:
    """The dispatch hook ``MultiClientSimulation`` gives a scheduler:
    records each wave (members, compute start, key) and executes it."""

    def __init__(self):
        self.sched = None
        self.waves = []

    def _run_wave(self, wave, t_start, key):
        self.waves.append(([(ci, j["frame"]) for ci, j in wave], t_start,
                           tuple(key)))
        return self.sched.execute_wave(wave, t_start, key)


def make(pkg, cls_name, server, clients, faults=None, **ec_kw):
    host = Host()
    sched = getattr(pkg.sch, cls_name)(server, clients,
                                       pkg.sch.EdgeConfig(**ec_kw),
                                       faults=faults, host=host)
    host.sched = sched
    return sched


def fake_job(pkg, arrival, frame=0, ci=0, t_dec=0.1, t_inf=0.5):
    plan = pkg.pt.RegionPlan(np.array([1] * 4 + [0] * 12, np.int8))
    return {"arrival": arrival, "frame": frame, "_client": ci,
            "t_dec": t_dec, "t_inf": t_inf, "beta": 2, "plan": plan,
            "rtt": 0.0, "decoded": np.zeros((2, 2, 3), np.float32),
            "submit": arrival, "t_enc": 0.0, "t_up": 0.0}


def spec_job(pkg, decoded, t_up=1.0, **kw):
    """A REUSE-heavy job: header at submit + t_enc = 0.05, payload at
    arrival = 0.05 + t_up."""
    L, R = pkg.pt.LOW, pkg.pt.REUSE
    plan = pkg.pt.RegionPlan(np.array([L, L, R, R], np.int8))
    job = {"frame": 0, "_client": 0, "submit": 0.0, "t_enc": 0.05,
           "t_up": t_up, "arrival": 0.05 + t_up, "t_dec": 0.1,
           "t_inf": 0.5, "beta": 2, "plan": plan, "rtt": 0.0,
           "decoded": decoded, "spec_frac": 0.75, "spec_conf": 1.0}
    job.update(kw)
    return job


def observe(sched, jobs, clients=()):
    """Everything the scheduler decided, as plain data."""
    stats = dataclasses.asdict(sched.stats)
    out = {"waves": sched.host.waves if sched.host else None,
           "free_at": sched.free_at, "stats": stats,
           "pending": [(ci, j["frame"]) for ci, j in sched.pending],
           "jobs": [{k: j.get(k) for k in JOB_KEYS} for j in jobs],
           "finished": [[(j["_client"], j["frame"]) for j in c.finished]
                        for c in clients]}
    for c in clients:
        fc = c.feature_cache
        if fc is not None:
            out.setdefault("caches", []).append(
                (fc.age.tolist(), fc.beta, fc.frame, fc.warm, fc.epoch,
                 fc.pred_age, fc.pred_epoch, fc.pred_frame_idx))
    return out


# ---------------------------------------------------------------------------
# scenarios: each runs on one package and asserts what the reference's own
# test asserts; the returned observation is compared across packages


def s_form_wave(pkg):
    items = [("a", 1), ("b", 1), ("c", 2), ("d", 1), ("e", 1)]
    wave, rest, hk = pkg.sch.form_wave(items, key_fn=lambda it: it[1],
                                       cap=3)
    assert hk == 1 and [n for n, _ in wave] == ["a", "b", "d"]
    assert [n for n, _ in rest] == ["c", "e"]
    one = pkg.sch.form_wave(items, key_fn=lambda it: it[1], cap=1)
    assert len(one[0]) == 1 and len(one[1]) == 4
    return {"wave": wave, "rest": rest, "hk": hk, "one": one}


def s_form_wave_hooks(pkg):
    items = [("a", 1), ("b", 2), ("c", 1)]
    promoted = []
    wave, rest, hk = pkg.sch.form_wave(
        items, key_fn=lambda it: it[1], cap=8,
        admit=lambda it: it[0] != "c",
        promote=lambda it, k, hk, w: promoted.append(it[0]) or True)
    assert [n for n, _ in wave] == ["a", "b"] and promoted == ["b"]
    assert [n for n, _ in rest] == ["c"]
    # a refusing promote hook keeps the other bucket out
    refused = pkg.sch.form_wave(items, key_fn=lambda it: it[1], cap=8,
                                promote=lambda it, k, hk, w: False)
    assert [n for n, _ in refused[0]] == ["a", "c"]
    return {"wave": wave, "rest": rest, "promoted": promoted,
            "refused": refused}


def s_unknown_scheduler(pkg):
    f = fakes(pkg)
    with pytest.raises(ValueError, match="unknown EdgeConfig.scheduler") \
            as e:
        pkg.sch.make_scheduler(f.Server(), [f.Client()],
                               pkg.sch.EdgeConfig(scheduler="warp"))
    assert sorted(pkg.sch.SCHEDULERS) == ["barrier", "continuous"]
    return {"msg": str(e.value)}


def s_barrier_admission_wait(pkg):
    f = fakes(pkg)
    clients = [f.Client(), f.Client()]
    sched = make(pkg, "BarrierScheduler", f.Server(), clients)
    jobs = [fake_job(pkg, 0.0, ci=0), fake_job(pkg, 0.2, ci=1)]
    for ci, j in enumerate(jobs):
        sched.enqueue(ci, j)
    sched.drain(float("inf"))
    assert sched.stats.wave_sizes == [1, 1]
    assert sched.free_at == pytest.approx(1.2)
    np.testing.assert_allclose(sched.stats.queue_delays, [0.0, 0.4])
    np.testing.assert_allclose(sched.stats.queue_admit,
                               sched.stats.queue_delays)
    assert all(s == 0.0 for s in sched.stats.queue_slot)
    assert sched.stats.device_idle_frac == pytest.approx(1 - 1.0 / 1.1)
    return observe(sched, jobs, clients)


def s_continuous_overlap(pkg):
    f = fakes(pkg)
    clients = [f.Client(), f.Client()]
    sched = make(pkg, "ContinuousScheduler", f.Server(), clients)
    jobs = [fake_job(pkg, 0.0, ci=0), fake_job(pkg, 0.2, ci=1)]
    for ci, j in enumerate(jobs):
        sched.enqueue(ci, j)
    sched.drain(float("inf"))
    assert sched.stats.wave_sizes == [1, 1]
    assert sched.free_at == pytest.approx(1.1)
    np.testing.assert_allclose(sched.stats.queue_delays, [0.0, 0.3])
    assert sched.stats.decode_hidden_s == pytest.approx(0.1)
    assert sched.stats.device_idle_frac == pytest.approx(0.0)
    b = clients[1].finished[0]
    assert b["e2e"] == pytest.approx(0.3 + 0.1 + 0.5)
    assert b["parts"]["queue_admit"] + b["parts"]["queue_slot"] \
        == pytest.approx(b["parts"]["queue"])
    return observe(sched, jobs, clients)


def s_uncontended(pkg):
    out = {}
    f = fakes(pkg)
    for cls in ("BarrierScheduler", "ContinuousScheduler"):
        clients = [f.Client(), f.Client()]
        sched = make(pkg, cls, f.Server(), clients)
        jobs = [fake_job(pkg, 0.0, ci=0), fake_job(pkg, 5.0, ci=1)]
        for ci, j in enumerate(jobs):
            sched.enqueue(ci, j)
        sched.drain(float("inf"))
        assert sched.free_at == pytest.approx(5.6)
        assert all(q == 0.0 for q in sched.stats.queue_delays)
        out[cls] = observe(sched, jobs, clients)
    return out


def s_pad_slot_admission(pkg):
    f = fakes(pkg)
    clients = [f.Client() for _ in range(4)]
    sched = make(pkg, "ContinuousScheduler", f.Server(), clients)
    jobs = [fake_job(pkg, 0.0, ci=ci, t_dec=0.05) for ci in range(3)]
    jobs.append(fake_job(pkg, 0.03, ci=3, t_dec=0.05))  # staged at 0.08
    for ci, j in enumerate(jobs):
        sched.enqueue(ci, j)
    sched.drain(float("inf"))
    assert sched.stats.wave_sizes == [4]
    assert jobs[3]["parts"]["queue"] == pytest.approx(0.0)
    assert sched.free_at == pytest.approx(0.08 + 0.5 * (1 + 0.35 * 3))
    assert sched.stats.queue_delays[0] == pytest.approx(0.03)
    return observe(sched, jobs, clients)


def s_late_job_never_grows_bucket(pkg):
    f = fakes(pkg)
    clients = [f.Client() for _ in range(3)]
    sched = make(pkg, "ContinuousScheduler", f.Server(), clients)
    jobs = [fake_job(pkg, 0.0, ci=ci, t_dec=0.05) for ci in range(2)]
    jobs.append(fake_job(pkg, 0.03, ci=2, t_dec=0.05))
    for ci, j in enumerate(jobs):
        sched.enqueue(ci, j)
    sched.drain(float("inf"))
    assert sched.stats.wave_sizes == [2, 1]
    return observe(sched, jobs, clients)


def s_restart_tick(pkg):
    f = fakes(pkg)
    server = f.Server()
    inj = pkg.fa.FaultInjector(pkg.fa.FaultSpec(
        edge_restarts=((0.5, 0.2), (1.5, 0.1))))
    e1 = pkg.sch.edge_restart_tick(server, inj, -1.0, 1.0)
    assert e1 == [(0.5, 0.2)] and server.epoch == 1
    e2 = pkg.sch.edge_restart_tick(server, inj, 1.0, 2.0,
                                   preserve_executables=True)
    assert e2 == [(1.5, 0.1)] and server.epoch == 2
    assert server.restarts == [False, True]
    assert pkg.sch.edge_restart_tick(server, None, -1.0, 99.0) == []
    return {"e1": e1, "e2": e2, "restarts": server.restarts}


def s_restart_loses_queue(pkg):
    f = fakes(pkg)
    inj = pkg.fa.FaultInjector(pkg.fa.FaultSpec(edge_restarts=((0.5, 0.4),)))
    clients = [f.Client(), f.Client()]
    sched = make(pkg, "BarrierScheduler", f.Server(), clients, faults=inj)
    jobs = [fake_job(pkg, 0.3, ci=0), fake_job(pkg, 0.4, ci=1)]
    for ci, j in enumerate(jobs):
        sched.enqueue(ci, j)
    sched.fault_tick(0.2, 0.6)
    assert sched.pending == [] and sched.stats.lost_jobs == 2
    assert jobs[0]["lost"] and jobs[1]["lost"]
    assert sched.free_at == pytest.approx(0.9)
    assert sched.stats.restarts == 1 and sched.server.epoch == 1
    # a job arriving while the replica is down is lost at admission
    late = fake_job(pkg, 0.7, ci=0)
    sched.enqueue(0, late)
    assert late["lost"] and sched.stats.lost_jobs == 3
    return observe(sched, jobs + [late], clients)


def spec_sched(pkg, **ec_kw):
    f = fakes(pkg)
    clients = [f.SpecClient()]
    ec_kw.setdefault("speculate", True)
    sched = make(pkg, "ContinuousScheduler", f.SpecServer(), clients,
                 **ec_kw)
    pred = np.full((8, 8, 3), 0.25, np.float32)
    clients[0].feature_cache.note_pred(pred, -1, 0)
    return sched, clients, pred


def s_spec_hides_uplink(pkg):
    sched, clients, pred = spec_sched(pkg)
    job = spec_job(pkg, pred.copy())
    sched.enqueue(0, job)
    sched.drain(0.5)
    assert sched.stats.spec_launched == 1
    assert sched.pending == [] and len(sched._spec) == 1
    assert sched.free_at == pytest.approx(0.55)
    sched.drain(2.0)
    assert sched.stats.spec_patched == 1 and sched.stats.spec_discarded == 0
    assert job["speculation"] == "patched"
    done = clients[0].finished[0]
    assert done["parts"]["inf"] == 0.0
    assert done["e2e"] == pytest.approx(0.1)
    assert done["done_at"] == pytest.approx(1.15)
    assert sched.stats.spec_hidden_s == pytest.approx(0.5)
    assert sched.stats.spec_hidden_percentile(50) == pytest.approx(0.5)
    cache = clients[0].feature_cache
    np.testing.assert_array_equal(cache.age, [1, 1, 1, 1])
    assert cache.pred_age == 0
    return observe(sched, [job], clients)


def s_spec_patches(pkg):
    sched, clients, pred = spec_sched(pkg)
    decoded = pred.copy()
    decoded[:4, :4] += 0.5              # region 0 diverges (1 of 2 sent)
    job = spec_job(pkg, decoded)
    sched.enqueue(0, job)
    sched.drain(0.5)
    sched.drain(2.0)
    assert sched.stats.spec_patched == 1 and job["speculation"] == "patched"
    assert 0.0 < clients[0].finished[0]["parts"]["inf"] < 0.5
    np.testing.assert_array_equal(clients[0].feature_cache.age,
                                  [0, 1, 1, 1])
    return observe(sched, [job], clients)


def s_spec_discards(pkg):
    sched, clients, pred = spec_sched(pkg)
    decoded = pred.copy()
    decoded[:4, :] += 0.5               # regions 0 and 1: 2 of 2 diverged
    job = spec_job(pkg, decoded)
    sched.enqueue(0, job)
    sched.drain(0.5)
    sched.drain(2.0)
    assert sched.stats.spec_discarded == 1 and sched.stats.spec_patched == 0
    assert job["speculation"] == "discarded"
    assert clients[0].finished[0]["parts"]["inf"] == pytest.approx(0.5)
    np.testing.assert_array_equal(clients[0].feature_cache.age,
                                  [0, 0, 0, 0])
    assert clients[0].feature_cache.pred_frame is decoded
    return observe(sched, [job], clients)


def s_spec_abandoned(pkg):
    sched, clients, pred = spec_sched(pkg)
    job = spec_job(pkg, pred.copy())
    sched.enqueue(0, job)
    sched.drain(0.5)
    assert sched.stats.spec_launched == 1
    job["abandoned"] = True
    sched.drain(float("inf"))
    assert sched.stats.spec_discarded == 1 and sched._spec == []
    assert clients[0].finished == [] and "speculation" not in job
    return observe(sched, [job], clients)


def s_spec_stale_epoch(pkg):
    sched, clients, pred = spec_sched(pkg)
    job = spec_job(pkg, pred.copy())
    sched.enqueue(0, job)
    sched.drain(0.5)
    sched.server.restart()
    sched.drain(0.6)
    assert len(sched._spec) == 1        # the NACK waits for the payload
    sched.drain(2.0)
    assert job["stale_epoch"] and job["dets"] == []
    assert job["done_at"] == pytest.approx(job["arrival"])
    assert sched.stats.stale_nacks == 1 and sched.stats.spec_discarded == 1
    assert sched.server.stats.stale_epoch_rejects == 1
    assert clients[0].finished == []
    return observe(sched, [job], clients)


SPEC_GATES = [dict(job_kw={"spec_conf": 0.2}), dict(pred_age=4),
              dict(ec_kw={"speculate": False}),
              dict(job_kw={"spec_frac": 0.1}), dict(pred_epoch=7)]


def s_spec_gates(pkg):
    out = []
    for case in SPEC_GATES:
        sched, clients, pred = spec_sched(pkg, **case.get("ec_kw", {}))
        cache = clients[0].feature_cache
        if "pred_age" in case:
            cache.pred_age = case["pred_age"]
        if "pred_epoch" in case:
            cache.pred_epoch = case["pred_epoch"]
        job = spec_job(pkg, pred.copy(), **case.get("job_kw", {}))
        sched.enqueue(0, job)
        sched.drain(float("inf"))
        assert sched.stats.spec_launched == 0, case
        assert len(clients[0].finished) == 1, case
        assert "speculation" not in job
        out.append(observe(sched, [job], clients))
    return out


def s_spec_window(pkg):
    sched, clients, pred = spec_sched(pkg)
    sched.free_at = 2.0                 # busy past the payload's arrival
    job = spec_job(pkg, pred.copy())
    sched.enqueue(0, job)
    sched.drain(float("inf"))
    assert sched.stats.spec_launched == 0
    assert len(clients[0].finished) == 1
    return observe(sched, [job], clients)


def s_deferred_failure(pkg):
    f = fakes(pkg)
    clients = [f.Client(), f.Client()]
    sched = make(pkg, "ContinuousScheduler", f.BoomServer(), clients,
                 stage_ahead=True)
    j0, j1 = fake_job(pkg, 0.0, ci=0), fake_job(pkg, 0.2, ci=1)
    sched.enqueue(0, j0)
    sched.enqueue(1, j1)
    with pytest.raises(RuntimeError, match="mid-dispatch"):
        sched.drain(0.7)                # wave A deferred, wave B raises
    assert sched._exec_q == []
    assert len(clients[0].finished) == 1
    assert j1["lost"] and j1["done_at"] == float("inf")
    assert sched.stats.lost_jobs == 1
    j2 = fake_job(pkg, 1.0, ci=0)
    sched.enqueue(0, j2)
    sched.drain(float("inf"))
    assert len(clients[0].finished) == 2
    return observe(sched, [j0, j1, j2], clients)


SCENARIOS = [s_form_wave, s_form_wave_hooks, s_unknown_scheduler,
             s_barrier_admission_wait, s_continuous_overlap, s_uncontended,
             s_pad_slot_admission, s_late_job_never_grows_bucket,
             s_restart_tick, s_restart_loses_queue, s_spec_hides_uplink,
             s_spec_patches, s_spec_discards, s_spec_abandoned,
             s_spec_stale_epoch, s_spec_gates, s_spec_window,
             s_deferred_failure]


def _plain(x):
    """Observations with RegionPlans and arrays as comparable data."""
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_plain(v) for v in x)
    if isinstance(x, np.ndarray):
        return x.tolist()
    return x


@pytest.mark.parametrize("scenario", SCENARIOS,
                         ids=[s.__name__[2:] for s in SCENARIOS])
def test_scheduler_matches_reference(scenario):
    want = _plain(scenario(PKGS["ref"]))
    got = _plain(scenario(PKGS["port"]))
    assert got == want


def test_form_wave_default_hooks_keep_the_engine_pass():
    """``ServeEngine._form_wave`` calls ``form_wave`` without hooks; the
    hooked signature must group exactly as the hook-free pass did."""
    items = [(i, k) for i, k in enumerate((3, 1, 3, 3, 2, 3))]
    for cap in (1, 2, 3, 8):
        assert tsch.form_wave(items, lambda it: it[1], cap) == \
            jsch.form_wave(items, lambda it: it[1], cap)
