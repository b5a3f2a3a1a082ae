"""Port parity: repro_torch.core.partition and the configs against the
reference.  The plan layouts are host-side numpy, so every array and the
fingerprint key must be byte-equal."""
import dataclasses

import numpy as np
import pytest

from repro.configs import vitdet_l as jcfg
from repro.core import partition as jpt
from repro.core import vit_backbone as jvb
from repro_torch.configs import vitdet_l as tcfg
from repro_torch.core import partition as tpt
from repro_torch.core import vit_backbone as tvb

LAYOUT_FIELDS = ("nw", "n_low", "n_reuse", "win_src", "win_dst", "low_src",
                 "low_ids", "reuse_ids", "out_src", "out_map", "key")


@pytest.mark.parametrize("name", ["CONFIG", "SIM", "REDUCED"])
def test_configs_match_reference(name):
    assert (dataclasses.asdict(getattr(tcfg, name))
            == dataclasses.asdict(getattr(jcfg, name)))


def _plans(n_regions: int, rng) -> list:
    plans = [np.zeros(n_regions, np.int8),
             np.full(n_regions, jpt.LOW, np.int8)]
    one_full = np.full(n_regions, jpt.REUSE, np.int8)
    one_full[0] = jpt.FULL
    plans.append(one_full)
    one_low = np.full(n_regions, jpt.REUSE, np.int8)
    one_low[-1] = jpt.LOW
    plans.append(one_low)
    plans += [rng.integers(0, 3, n_regions).astype(np.int8)
              for _ in range(60)]
    return plans


@pytest.mark.parametrize("name", ["CONFIG", "SIM"])
def test_plan_layouts_byte_equal(name):
    jpart = jvb.vit_partition(getattr(jcfg, name))
    tpart = tvb.vit_partition(getattr(tcfg, name))
    assert dataclasses.astuple(jpart) == dataclasses.astuple(tpart)
    edges = jpt.length_bucket_set(jpart)
    assert tpt.length_bucket_set(tpart) == edges
    rng = np.random.default_rng(0)
    n_checked = 0
    for states in _plans(jpart.n_regions, rng):
        plan = tpt.RegionPlan(states)
        nw = tpt.plan_n_windows(plan, tpart)
        assert nw == jpt.plan_n_windows(jpt.RegionPlan(states), jpart)
        if nw == 0:
            continue
        assert tpt.length_bucket(nw, edges) == jpt.length_bucket(nw, edges)
        for lb in edges:
            if lb < nw:
                with pytest.raises(ValueError):
                    tpt.plan_layout(states, lb, tpart)
                continue
            jl = jpt.plan_layout(states, lb, jpart)
            tl = tpt.plan_layout(states, lb, tpart)
            for f in LAYOUT_FIELDS:
                a, b = getattr(jl, f), getattr(tl, f)
                if isinstance(a, np.ndarray):
                    assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f
                else:
                    assert a == b, f
            n_checked += 1
    assert n_checked > 50


def test_stack_and_buckets_match_reference():
    part = tvb.vit_partition(tcfg.SIM)
    rng = np.random.default_rng(1)
    states = [s for s in _plans(part.n_regions, rng)
              if tpt.plan_n_windows(tpt.RegionPlan(s), part) > 0][:5]
    lays_t = [tpt.plan_layout(s, 64, part) for s in states]
    lays_j = [jpt.plan_layout(s, 64, jvb.vit_partition(jcfg.SIM))
              for s in states]
    at, kt = tpt.stack_plan_layouts(lays_t)
    aj, kj = jpt.stack_plan_layouts(lays_j)
    assert kt == kj and at.keys() == aj.keys()
    for k in at:
        assert at[k].tobytes() == aj[k].tobytes(), k
    for b in range(1, 9):
        assert tpt.batch_bucket(b) == jpt.batch_bucket(b)
    for n in (4, 16, 64):
        assert tpt.bucket_set(n) == jpt.bucket_set(n)
