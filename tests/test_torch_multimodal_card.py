"""The encoder-decoder and VLM families on the card against the CPU
(skipped where there is no card; ``chip_smoke.py`` phases 24 and 25 run the
published configs at full width):

    PYTHONPATH=src python3 -m pytest -q -m cuda tests/test_torch_multimodal_card.py

whisper-medium and llava-next-mistral-7b ``REDUCED`` (2 layers, D = 64),
seed 0: whisper's ``prefill`` on 1500 stub frames (the flash kernel not
causal at S off its 64-key tile, causal over the prompt, and at the
cross-attention's T_q < S) and four decode steps (the flash kernel at
T_q = 1, the decode kernel); llava's ``prefill`` with its image
embeddings, ``mixed_prefill`` at beta 2 over images and text, and four
decode steps.  Logits within 1e-3 of the largest, as the LM card tests
hold them (the 3xTF32 kernels against the CPU's float32 plain versions).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_reduced
from repro_torch.core import seq_mixed_res as smr
from repro_torch.models import registry
from repro_torch.models import transformer as tfm
from repro_torch.offload.simulator import to_device

RTOL = 1e-3
B, T, STEPS = 2, 32, 4


def _card() -> None:
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (chip_smoke.py phase 24 "
                    "runs the full-width models on the H100)")


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.cpu() - b).abs().max() / b.abs().max())


def _run(cfg, params, dev, batch, pack=None):
    """Prefill (mixed at beta 2 with ``pack``) and STEPS decode steps on
    fixed tokens: every step's logits, on the CPU."""
    batch = {k: v.to(dev) for k, v in batch.items()}
    n = batch["tokens"].shape[1] + (cfg.vlm.n_image_tokens if cfg.vlm
                                    else 0)
    state = registry.init_decode_state(cfg, B, n + STEPS + 4, device=dev)
    with torch.no_grad():
        if pack is None:
            h, state, _ = registry.prefill(cfg, params, batch, state)
        else:
            h, state, _ = smr.mixed_prefill(
                cfg, params, batch["tokens"],
                {k: v.to(dev) for k, v in pack.items()}, 2, state,
                image_embeds=batch["image_embeds"])
        out = [(h[:, -1:] @ params["embed"]["tok"].T if cfg.encdec
                else tfm.logits_from_hidden(cfg, params, h[:, -1:]))]
        for i in range(STEPS):
            lg, state = registry.decode_step(
                cfg, params, batch["tokens"][:, i:i + 1], n + i, state)
            out.append(lg)
    return [o.cpu() for o in out]


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["whisper-medium", "llava-next-mistral-7b"])
def test_multimodal_on_card_matches_cpu(arch):
    _card()
    cfg = get_reduced(arch)
    if cfg.encdec:
        cfg = cfg.replace(encdec=dataclasses.replace(cfg.encdec,
                                                     encoder_seq_len=1500))
    p_cpu = registry.init_params(cfg, torch.Generator().manual_seed(0),
                                 "cpu")
    p_gpu = to_device(p_cpu, torch.device("cuda"))
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                                    (B, T)))}
    packs = [None]
    if cfg.encdec:
        batch["frames"] = torch.as_tensor(rng.standard_normal(
            (B, 1500, cfg.d_model)).astype(np.float32))
    else:
        batch["image_embeds"] = torch.as_tensor(rng.standard_normal(
            (B, cfg.vlm.n_image_tokens, cfg.vlm.vision_hidden)
        ).astype(np.float32))
        part = smr.seq_partition(cfg, cfg.vlm.n_image_tokens + T)
        mask = np.zeros(part.n_spans, np.int32)
        mask[::2] = 1
        packs.append({k: torch.as_tensor(v.astype(np.int64)) for k, v in
                      smr.build_seq_pack(mask, int(mask.sum()),
                                         part).items()})
    for pack in packs:
        got = _run(cfg, p_gpu, "cuda", batch, pack)
        want = _run(cfg, p_cpu, "cpu", batch, pack)
        for step, (g, w) in enumerate(zip(got, want)):
            assert _rel(g, w) <= RTOL, (arch, pack is not None, step)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["whisper-medium", "llava-next-mistral-7b"])
def test_multimodal_train_step_on_card_matches_cpu(arch):
    """One ``make_train_step`` step (remat on: the flash Function's
    forward runs twice) of the reduced config on ``synthetic_batches``'
    frames or image embeddings, card against CPU: the loss to 1e-4
    relative."""
    _card()
    from repro_torch.launch import train as lt
    from repro_torch.train import trainer as tr
    cfg = get_reduced(arch)
    batch = next(lt.synthetic_batches(cfg, B, T, seed=0))
    losses = []
    for dev in ("cpu", "cuda"):
        params, opt = tr.init_train_state(
            cfg, torch.Generator().manual_seed(0), dev)
        step = tr.make_train_step(cfg, tr.TrainConfig(peak_lr=1e-3,
                                                      warmup_steps=1))
        _, _, m = step(params, opt, {k: torch.as_tensor(v, device=dev)
                                     for k, v in batch.items()})
        losses.append(float(m["loss"]))
    assert abs(losses[1] - losses[0]) <= 1e-4 * abs(losses[0])
