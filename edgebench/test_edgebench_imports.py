"""Nothing the benchmark loads is JAX or the JAX package, compared by
whole top-level module names (the port's name begins with the JAX
package's), and nothing here reads the JAX package's old benchmarks."""
from __future__ import annotations

import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

PROBE = """
import json, sys
sys.path.insert(0, {root!r})
from edgebench import harness
harness.prepare_environment({root!r})
cell = harness.load_cell(harness.BENCH_DIR.parent / "BENCHMARK.json",
                         "vitdet-l.fp16.phones-mixed")
prog = harness.load_program()
harness.model_config(prog, cell.config)
for name in json.load(open({root!r} + "/BENCHMARK.json"))["workloads"]:
    for m in harness.load_cell(harness.BENCH_DIR.parent / "BENCHMARK.json",
                               name["name"]).per_layer:
        harness.reader(cell.bench_dir, m["name"])
import edgebench.control, edgebench.run
print(json.dumps({{"bad": harness.forbidden_modules(),
                  "tops": sorted({{m.split(".")[0] for m in sys.modules}})}}))
"""


def test_nothing_loaded_is_jax_or_the_jax_package():
    p = subprocess.run([sys.executable, "-c", PROBE.format(root=str(ROOT))],
                       capture_output=True, text=True, timeout=300,
                       env={"PATH": "/usr/bin:/bin"})
    assert p.returncode == 0, p.stderr
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["bad"] == []
    assert "repro_torch" in out["tops"]
    assert not {"jax", "jaxlib", "flax", "repro"} & set(out["tops"])


def test_forbidden_names_are_whole_words():
    from edgebench import harness
    assert harness.forbidden_modules(
        ["repro_torch", "repro_torch.core", "jaxish.sub", "numpy"]) == []
    assert harness.forbidden_modules(
        ["repro_torch", "repro.core", "jax", "flax.linen"]) == [
            "flax", "jax", "repro"]


def test_sources_name_no_jax_and_no_old_benchmarks():
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|repro|"
                     r"benchmarks)\b", re.M)
    for path in (ROOT / "edgebench").rglob("*.py"):
        text = path.read_text()
        assert not pat.search(text), path
        assert "benchmarks" + "/" not in text, path
