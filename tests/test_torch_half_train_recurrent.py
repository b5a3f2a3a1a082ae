"""Port parity of training at half parameters for the SSM, hybrid and
encoder-decoder families: ``test_torch_half_train.py``'s train-step
check (its docstring gives the tolerances) on reduced mamba2-370m, a
6-layer zamba2-1.2b (its shared attention block at layer 5) and
whisper-medium over float32 stub frames, at bf16 and fp16 parameters
and accumulation 1 and 2, against the JAX package's jitted step.
"""
import pytest

from test_torch_half_train import HALF, check_half_train_steps

ARCHS = ("mamba2-370m", "zamba2-1.2b", "whisper-medium")


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("dt", sorted(HALF))
@pytest.mark.parametrize("arch", ARCHS)
def test_half_train_steps_match_reference(monkeypatch, arch, dt, accum):
    check_half_train_steps(monkeypatch, arch, dt, accum)
