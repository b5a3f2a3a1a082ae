"""The traffic generator: the same seed gives the same offloads, plans
keep to their mix, and REUSE only where a session may reuse."""
from __future__ import annotations

from pathlib import Path

import numpy as np
import pytest

from edgebench import traffic_gen as tg

MIXES = Path(__file__).resolve().parent / "traffic"
SEED = 2 ** 31 + 12345           # past 32 signed bits, as large seeds are


def stream(mix, seed, n=60):
    clients = tg.make_clients(mix, 16, 4, seed)
    return clients, [[c.next_offload() for _ in range(n)] for c in clients]


@pytest.mark.parametrize("name", ["phones-mixed", "cams-full"])
def test_same_seed_same_offloads(name):
    mix = tg.load_mix(MIXES / f"{name}.json")
    ca, a = stream(mix, SEED)
    cb, b = stream(mix, SEED)
    _, c = stream(mix, SEED + 1)
    for x, y in zip(a, b):
        for o, p in zip(x, y):
            assert (o.frame, o.nbytes, o.n_windows) == \
                (p.frame, p.nbytes, p.n_windows)
            assert (o.states == p.states).all()
    assert [c.start_s for c in ca] == [c.start_s for c in cb]
    if mix["uplink"]:
        assert ca[3].uplink_s(10 ** 6, 17.5) == cb[3].uplink_s(10 ** 6, 17.5)
    assert any((o.states != p.states).any() or o.frame != p.frame
               for x, y in zip(a, c) for o, p in zip(x, y))


def test_mixed_plans_keep_to_the_mix():
    mix = tg.load_mix(MIXES / "phones-mixed.json")
    _, offs = stream(mix, SEED, n=200)
    counts = np.zeros(len(mix["windows"]))
    for per_client in offs:
        assert per_client[0].full_res          # the bootstrap
        age = np.zeros(16, int)
        for k, o in enumerate(per_client):
            reuse = o.states == tg.REUSE
            # a region is reused at most max_age offloads in a row
            assert (age[reuse] < mix["max_age"]).all()
            age = np.where(reuse, age + 1, 0)
            assert o.n_windows == tg.plan_windows(o.states, 4) >= 1
            if k:
                hit = [lo <= o.n_windows <= hi
                       for lo, hi, _ in mix["windows"]]
                assert sum(hit) == 1
                counts += hit
    share = counts / counts.sum()
    want = np.array([w[2] for w in mix["windows"]], float)
    assert np.allclose(share, want / want.sum(), atol=0.01)
    assert any((o.states == tg.REUSE).any() for c in offs for o in c)
    assert any((o.states == tg.LOW).any() for c in offs for o in c)


def test_payload_bytes():
    mix = tg.load_mix(MIXES / "phones-mixed.json")
    rb = mix["region_bytes"]
    s = np.array([tg.FULL] * 10 + [tg.LOW] * 4 + [tg.REUSE] * 2, np.int8)
    assert tg.payload_bytes(mix, s) == (rb["header"] + 10 * rb["full"]
                                        + 4 * rb["low"] + rb["reuse_header"])
    assert tg.payload_bytes(tg.load_mix(MIXES / "cams-full.json"), s) == 0


def test_uplink_follows_the_4g_statistics():
    mix = tg.load_mix(MIXES / "phones-mixed.json")
    clients = tg.make_clients(mix, 16, 4, SEED)
    # every seed's fleet has the same uplinks, in a seeded order
    other = tg.make_clients(mix, 16, 4, SEED + 1)
    order = [np.median(c.uplink.tput_bps) for c in clients]
    assert [np.median(c.uplink.tput_bps) for c in other] != order
    assert sorted([np.median(c.uplink.tput_bps) for c in other]) == \
        sorted(order)
    for c in clients:
        tr = c.uplink
        assert len(tr.tput_bps) == 300
        # the mean is one of 8 slices of 10.4-36.4 Mbps; fades only
        # pull it down
        assert 2.0 < np.median(tr.tput_bps) / 1e6 < 60.0
        assert (0.015 <= tr.rtt_s).all() and (tr.rtt_s <= 0.5).all()
        d = c.uplink_s(100_000, 3.2)
        i = 3
        assert d == pytest.approx(tr.rtt_s[i] + 8e5 / tr.tput_bps[i])
    assert clients[0].uplink_s(1, 301.0) == clients[0].uplink_s(1, 1.0)


def test_checked_clients_are_seeded():
    mix = tg.load_mix(MIXES / "phones-mixed.json")
    a = tg.checked_clients(mix, SEED)
    assert a == tg.checked_clients(mix, SEED)
    assert len(a) == mix["check"]["clients"] == len(set(a))
    assert any(tg.checked_clients(mix, SEED + k) != a for k in range(1, 5))


def test_bad_mix_is_refused(tmp_path):
    p = tmp_path / "bad.json"
    p.write_text('{"plans": "mixed", "windows": [[1, 24, 0.5]]}')
    with pytest.raises(ValueError):
        tg.load_mix(p)
    p.write_text('{"plans": "sometimes"}')
    with pytest.raises(ValueError):
        tg.load_mix(p)
