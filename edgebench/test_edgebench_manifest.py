"""The manifest (``BENCHMARK.json``) against the benchmark's contract,
and every file a cell is made of found by name."""
from __future__ import annotations

import json
import re
import shutil
from pathlib import Path

import pytest

from edgebench import harness
from edgebench import traffic_gen as tg

ROOT = Path(__file__).resolve().parents[1]
MANIFEST = ROOT / "BENCHMARK.json"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def man():
    return json.loads(MANIFEST.read_text())


def test_keys_and_sizes(man):
    assert set(man) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert MANIFEST.stat().st_size <= 64 * 1024
    assert 1 <= len(man["paths"]) <= 16
    for p in man["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (ROOT / p).is_dir()
    assert 1 <= len(man["command"]) <= 32
    assert man["command"][1].startswith(man["paths"][0] + "/")
    assert 1 <= man["run_seconds"] <= 51
    # a full check of 24 cells fits its 43200 s
    assert (2 + 14 * 24) * (man["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43200


def test_names_units_and_lines(man):
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in man[group]:
            assert NAME.match(e["name"]), e["name"]
            names.append((group, e["name"]))
            for key in ("why", "layer", "source"):
                if key in e:
                    assert 1 <= len(e[key]) <= 200
                    assert "\n" not in e[key] and "\t" not in e[key]
    assert len(names) == len(set(names))
    for m in man["end_to_end"] + man["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for w in man["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4)


def test_metrics_by_the_contract(man):
    e2e = {m["name"]: m for m in man["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in man["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    cells = {w["name"] for w in man["workloads"]}
    layers = {}
    for m in man["per_layer"]:
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= cells
        base = m["name"].split(".")[0]
        if base.endswith("_roofline") or "mfu" in base:
            assert m["unit"] == "%"
        layers.setdefault(m["layer"], set()).add(m["name"])
    for cell in cells:
        reported = [m for m in man["per_layer"] if cell in m["workloads"]]
        assert reported, cell
        assert len(e2e) >= 2


def test_every_cell_found_by_name(man):
    for w in man["workloads"]:
        cell = harness.load_cell(MANIFEST, w["name"])
        assert cell.config["name"] == w["config"]
        assert cell.mix["name"] == w["traffic"]
        assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
        for m in cell.per_layer:
            assert callable(harness.reader(cell.bench_dir, m["name"]))
    for c in man["configs"]:
        assert (ROOT / c["file"]).is_file()
        assert c["file"].startswith(man["paths"][0] + "/")
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"]
        assert "box_gap_rel" in cfg["limits"]
        assert set(cfg["limits"]) & {"score_gap", "score_gap_rel"}


def test_a_new_mix_is_a_file_alone(tmp_path, man):
    """A later change adds a cell with a traffic file and a manifest
    entry; no file the benchmark has changes."""
    before = {p: p.read_bytes() for p in (ROOT / "edgebench").rglob("*")
              if p.is_file() and "__pycache__" not in p.parts}
    bench = tmp_path / "edgebench"
    shutil.copytree(ROOT / "edgebench", bench,
                    ignore=shutil.ignore_patterns("__pycache__"))
    mix = json.loads((bench / "traffic" / "cams-full.json").read_text())
    mix.update(name="cams-few", clients=4, batch_buckets=[4])
    (bench / "traffic" / "cams-few.json").write_text(json.dumps(mix))
    man = dict(man, workloads=man["workloads"] + [
        {"name": "vitdet-l.fp32.cams-few", "config": "vitdet-l.fp32",
         "traffic": "cams-few", "chips": 1, "why": "a throwaway"}])
    for m in man["per_layer"] + man["end_to_end"]:
        if m["name"].endswith(".full32"):
            m["workloads"] = m["workloads"] + ["vitdet-l.fp32.cams-few"]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))
    cell = harness.load_cell(tmp_path / "BENCHMARK.json",
                             "vitdet-l.fp32.cams-few")
    assert cell.mix["clients"] == 4 and cell.config["precision"] == "fp32"
    assert {m["name"] for m in cell.per_layer} == {
        m["name"] for m in man["per_layer"] if m["name"].endswith(".full32")}
    assert {m["name"] for m in cell.end_to_end} == {
        "offloads_per_s.full32", "offload_p50_ms.full32",
        "offload_p95_ms.full32", "setup_s"}
    clients = tg.make_clients(cell.mix, 16, 4, 7)
    assert len(clients) == 4
    after = {p: p.read_bytes() for p in (ROOT / "edgebench").rglob("*")
             if p.is_file() and "__pycache__" not in p.parts}
    assert after == before


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        harness.load_cell(MANIFEST, "no-such-cell")
