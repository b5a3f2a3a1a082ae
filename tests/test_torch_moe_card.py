"""The MoE family's serving lanes and train steps on the card against
the CPU (skipped where there is no card; ``chip_smoke.py`` phase 25 runs
the lanes at full width and the narrow train steps on the H100):

    PYTHONPATH=src python3 -m pytest -q -m cuda tests/test_torch_moe_card.py

dbrx-132b and deepseek-v2-236b ``REDUCED``, seed 0: each lane's tree
(int8: dbrx only; fp16 / bf16; a float32 tree over a bf16 cache),
prefill and decode steps teacher-forced on fixed tokens, with both
devices' routes recorded.  While the routes choose the same experts the
logits hold to the lane's limit (the half types' as
``tests/test_torch_half_lm.py`` holds the packages, at least the LM card
tests' 1e-3; int8 5%: on the card a rounding tie can flip an
activation's int8 code); where they part, the first call that does may
part only at routing near-ties (``route_tie``).  A train step with the
MoE aux term: the loss to 1e-4 relative.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_reduced
from repro_torch.models import moe, registry
from repro_torch.models import transformer as tfm
from repro_torch.offload.simulator import to_device
from repro_torch.quant import qtensor as qt
from repro_torch.quant.ptq import quantize_lm_params

T, NEW = 32, 4
# lane -> (tree dtype, cache dtype, logit limit of the largest |logit|)
LANES = {"int8": (torch.float32, torch.float32, 5e-2),
         "fp16": (torch.float16, torch.float32, 4e-3),
         "bf16": (torch.bfloat16, torch.float32, 3e-2),
         "bf16-cache": (torch.float32, torch.bfloat16, 1e-3)}
LANE_CASES = [("dbrx-132b", "int8"), ("dbrx-132b", "fp16"),
              ("dbrx-132b", "bf16"), ("deepseek-v2-236b", "fp16"),
              ("deepseek-v2-236b", "bf16"), ("dbrx-132b", "bf16-cache"),
              ("deepseek-v2-236b", "bf16-cache")]
UNIT = {torch.float16: 2.0 ** -11, torch.bfloat16: 2.0 ** -8}
ROUTE_TIE = 1e-5


def _card() -> None:
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (chip_smoke.py phase 25 "
                    "runs the MoE lanes and train steps on the H100)")


def route_tie(logits, top, k, unit):
    """A token's routing near-tie bound: ROUTE_TIE for a float32 router;
    for a half one (unit roundoff u), two roundings a route of each logit
    l bound the routes' difference by eps = 4 u L (L the token's largest
    |logit|), which can swap the k-th and (k+1)-th experts only if their
    gap is <= 2 eps p_k = 8 u L p_k."""
    if unit is None:
        return torch.full_like(top[:, 0], ROUTE_TIE)
    return 8 * unit * logits.abs().amax(-1) * top[:, k - 1]


def _forced(cfg, params, dev, cache_dt, prompt, toks):
    """Teacher-forced logits (the prefill's last row, then a decode step
    on each token but the last) and the routing log: each call's chosen
    experts (sorted), k / k+1 probability gaps and near-tie bounds."""
    saved, log = moe.route, []

    def route(cfg_, router_w, x_flat):
        out = saved(cfg_, router_w, x_flat)
        k = cfg_.moe.top_k
        logits = (x_flat @ router_w).float()
        top = torch.softmax(logits, -1).topk(k + 1, -1).values
        log.append((out[0].sort(-1).values.cpu(),
                    (top[:, k - 1] - top[:, k]).cpu(),
                    route_tie(logits, top, k,
                              UNIT.get(router_w.dtype)).cpu()))
        return out
    moe.route = route
    try:
        state = registry.init_decode_state(cfg, 1, T + NEW + 8, cache_dt,
                                           dev)
        with torch.no_grad():
            h, state, _ = registry.prefill(
                cfg, params, {"tokens": prompt.to(dev)}, state)
            out = [tfm.logits_from_hidden(cfg, params, h[:, -1:])]
            for i, t in enumerate(toks[:-1]):
                lg, state = registry.decode_step(
                    cfg, params, t.to(dev), T + i, state)
                out.append(lg)
    finally:
        moe.route = saved
    return [o.float().cpu().reshape(-1) for o in out], log


@pytest.mark.cuda
@pytest.mark.parametrize("arch,lane", LANE_CASES)
def test_moe_lanes_on_card_match_cpu(arch, lane):
    _card()
    cfg = get_reduced(arch)
    tree_dt, cache_dt, tol = LANES[lane]
    params = registry.init_params(cfg, torch.Generator().manual_seed(0),
                                  "cpu")
    if lane == "int8":
        params = quantize_lm_params(params)
    elif tree_dt != torch.float32:
        params = qt.cast_tree(params, tree_dt)
    rng = np.random.default_rng(18)
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, T)))
    toks = [torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, 1)))
            for _ in range(NEW)]
    (glg, glog), (wlg, wlog) = (
        _forced(cfg, to_device(params, torch.device(d)), d, cache_dt,
                prompt, toks) for d in ("cuda", "cpu"))
    assert len(glog) == len(wlog)
    for (gi, _, _), (wi, gap, tie) in zip(glog, wlog):
        rows = (gi != wi).any(-1)
        if rows.any():                  # routes parted: at a near-tie only
            assert bool((gap[rows] <= tie[rows]).all()), (gap[rows],
                                                          tie[rows])
            return
    for g, w in zip(glg, wlg):
        assert float((g - w).abs().max() / w.abs().max()) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["dbrx-132b", "deepseek-v2-236b"])
def test_moe_train_step_on_card_matches_cpu(arch):
    """One ``make_train_step`` step of the reduced config with the aux
    term, card against CPU: the loss to 1e-4 relative."""
    _card()
    from repro_torch.train import trainer as tr
    cfg = get_reduced(arch)
    toks = torch.as_tensor(np.random.default_rng(20).integers(
        0, cfg.vocab_size, (2, T)))
    losses = []
    for dev in ("cpu", "cuda"):
        params, opt = tr.init_train_state(
            cfg, torch.Generator().manual_seed(0), dev)
        step = tr.make_train_step(cfg, tr.TrainConfig(peak_lr=1e-3,
                                                      warmup_steps=1))
        _, _, m = step(params, opt, {"tokens": toks.to(dev)})
        losses.append(float(m["loss"]))
        assert float(m["aux"]) > 0
    assert abs(losses[1] - losses[0]) <= 1e-4 * abs(losses[0])
