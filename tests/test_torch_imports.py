"""The port imports neither ``jax`` nor the reference package ``repro``:
every ``repro_torch`` module imports in a fresh interpreter where
``import jax`` fails, and ``chip_smoke.py`` names neither."""
import ast
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

_PROBE = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None          # any "import jax" now raises
import repro_torch
names = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m, mod in sys.modules.items() if mod is not None
             and (m == "repro" or m.startswith(("repro.", "jax"))))
assert not bad, bad
print(" ".join(names))
"""

# modules every slice must keep importable without the reference
REQUIRED = ("repro_torch.quant.qtensor", "repro_torch.quant.ptq",
            "repro_torch.quant.prune", "repro_torch.kernels.int8_matmul.ops",
            "repro_torch.kernels.mixed_res_pool.ops",
            "repro_torch.offload.simulator",
            "repro_torch.configs.qwen3_4b",
            "repro_torch.kernels.decode_attention.ops",
            "repro_torch.models.transformer", "repro_torch.models.registry",
            "repro_torch.core.seq_mixed_res", "repro_torch.serve.scheduler",
            "repro_torch.serve.engine", "repro_torch.launch.serve",
            "repro_torch.configs.mamba2_370m",
            "repro_torch.configs.zamba2_1p2b",
            "repro_torch.kernels.ssd_scan.ops", "repro_torch.models.mamba2",
            "repro_torch.models.hybrid", "repro_torch.models.ssm_lm",
            "repro_torch.data.network_traces",
            "repro_torch.data.synthetic_video",
            "repro_torch.offload.detection", "repro_torch.offload.motion",
            "repro_torch.offload.tracker", "repro_torch.offload.codec",
            "repro_torch.optim.adam", "repro_torch.offload.estimator",
            "repro_torch.offload.optimizer", "repro_torch.offload.faults",
            "repro_torch.offload.baselines", "repro_torch.launch.offload")


def test_every_port_module_imports_without_jax():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", _PROBE], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    names = out.stdout.split()
    assert len(names) >= 25
    assert set(REQUIRED) <= set(names), sorted(set(REQUIRED) - set(names))


def test_chip_smoke_imports_no_reference():
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    mods = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            mods.add(node.module)
    roots = {m.split(".")[0] for m in mods}
    assert "jax" not in roots and "repro" not in roots, sorted(roots)
