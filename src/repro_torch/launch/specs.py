"""Per-cell step functions and their arguments' shapes; port of
``repro.launch.specs``.

``build_cell(arch, shape, mesh)`` returns what the dry-run needs for
every (architecture x input-shape) cell: the step callable, rank 0's
local argument pieces as meta tensors (shapes and dtypes, no storage:
the reference's ``ShapeDtypeStruct``s, cut by
``distributed.sharding.shard_tree``), the in/out ``Spec`` trees, and
``donate_argnums`` kept as data.  ``materialize`` turns the pieces into
tensors of the caller's mode (fake ones under ``FakeTensorMode``).

How the port runs each cell on a mesh:

  * train: ``train.trainer.make_train_step(cfg, tc, mesh)``, FSDP over
    ``data`` and expert-parallel MoE over ``model``, gathering each
    block's weights as it runs.  A train cell's parameters and float
    inputs are ``PARAM_DTYPE`` (bf16), as the reference's, a mamba
    block's ``A_log``, ``dt_bias`` and ``D`` float32; its AdamW moments
    are float32 in both.  The step takes the global batch on every
    rank, as the port's launcher feeds it, and each rank cuts its rows.
  * prefill / decode: the port's serving code has no tensor-parallel
    attention.  A rank serves its batch rows whole: each block's
    weights are gathered where the code reads them
    (``sharding.Gathered``); decode gathers the cache over the axes
    that do not split its batch at entry; prefill fills a fresh
    full-head state for its rows.  The state goes back as the rank's
    piece under the reference's decode-state specs, so the stored
    layout is the reference's.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs import SHAPES, ShapeSpec, get_config
from repro_torch.distributed import sharding as shd
from repro_torch.models import registry
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adam
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import trainer as tr

PARAM_DTYPE = torch.bfloat16
CACHE_DTYPE = torch.bfloat16


def sds(shape, dtype) -> torch.Tensor:
    """A shape and a dtype without storage (a meta tensor)."""
    return torch.empty(tuple(int(s) for s in shape), dtype=dtype,
                       device="meta")


def materialize(tree, device="cpu", real: bool = False):
    """Tensors of each meta leaf's shape and dtype on ``device`` (under a
    ``FakeTensorMode``, fake ones); ``real`` fills them with zeros."""
    make = torch.zeros if real else torch.empty

    def leaf(_, x):
        if isinstance(x, torch.Tensor):
            return make(tuple(x.shape), dtype=x.dtype, device=device)
        return x
    return shd._map(leaf, tree)


# ---------------------------------------------------------------------------
# input shapes


def input_specs(cfg: ModelConfig, shape: ShapeSpec,
                dtype: torch.dtype = PARAM_DTYPE) -> Dict[str, Any]:
    """Model inputs for a training/prefill step (meta tensors); float
    inputs in ``dtype``, the parameters'."""
    B, T = shape.global_batch, shape.seq_len
    batch = {"tokens": sds((B, T), torch.int32)}
    if shape.kind == "train":
        batch["labels"] = sds((B, T), torch.int32)
    if cfg.family == "encdec":
        batch["frames"] = sds((B, cfg.encdec.encoder_seq_len, cfg.d_model),
                              dtype)
    if cfg.family == "vlm":
        batch["image_embeds"] = sds(
            (B, cfg.vlm.n_image_tokens, cfg.vlm.vision_hidden), dtype)
    return batch


def params_shape(cfg: ModelConfig, dtype: torch.dtype = PARAM_DTYPE) -> Any:
    """The parameter tree on the meta device at ``dtype``, leaf dtypes
    as the reference's ``params_shape`` (a mamba block's ``A_log``,
    ``dt_bias`` and ``D`` float32)."""
    return tr.shape_tree(cfg, dtype)


def decode_state_shape(cfg: ModelConfig, batch: int, max_len: int) -> Any:
    state = registry.init_decode_state(cfg, batch, max_len, CACHE_DTYPE,
                                       "meta")
    if cfg.family == "encdec":      # whisper decode state = (enc_out, caches)
        enc = sds((batch, cfg.encdec.encoder_seq_len, cfg.d_model),
                  PARAM_DTYPE)
        state = (enc, state)
    return state


# ---------------------------------------------------------------------------
# cell construction


# how each kind of cell runs on the mesh (a record's ``layout``)
LAYOUTS = {
    "train": "the port's train step: FSDP over data (each block's "
             "weights gathered as it runs), expert-parallel MoE over "
             "model, each rank's rows of the global batch; parameters "
             "at the cell's dtype, float32 moments",
    "prefill": "a dry-run layout, not a path the port runs on a mesh: "
               "each rank serves its batch rows with every head, "
               "gathering each block's weights as it reads them, and "
               "stores its piece of a fresh full-head cache under the "
               "reference's decode-state specs; the reference's GSPMD "
               "layout splits the heads over model instead",
    "decode": "a dry-run layout, not a path the port runs on a mesh: "
              "each rank all-gathers its rows' whole KV cache over the "
              "axes that do not split the batch every step, and each "
              "block's weights as it reads them; the reference's GSPMD "
              "layout does not gather the cache, so the collective term "
              "is this layout's, not the model's",
}


@dataclass
class Cell:
    arch: str
    shape: ShapeSpec
    fn: Callable
    args: Tuple[Any, ...]             # rank 0's local pieces (meta)
    in_shardings: Tuple[Any, ...]
    out_shardings: Any
    donate_argnums: Tuple[int, ...] = ()
    dtype: torch.dtype = PARAM_DTYPE  # the parameters' (GEMMs') type
    layout: str = ""                  # LAYOUTS[shape.kind]


def _accum_for(cfg: ModelConfig, shape: ShapeSpec, mesh,
               scale: int = 1) -> int:
    """Microbatch count keeping per-device live tokens ~<= 8k (the
    reference's rule)."""
    dp = shd.dp_size(mesh)
    local_tokens = shape.global_batch * shape.seq_len / max(dp, 1)
    accum = max(1, int(local_tokens // 8192)) * scale
    # accumulate only in powers of two dividing the local batch
    while shape.global_batch % (accum * dp) and accum > 1:
        accum //= 2
    return accum


OPT_VARIANTS = {
    "base": {},
    "sp": {"train": {"sp": True}},
    "accum2x": {"accum_scale": 2},
    "accum4x": {"accum_scale": 4},
    "sp_accum2x": {"train": {"sp": True}, "accum_scale": 2},
    # pure-accounting variant (graph unchanged; the dry-run applies the
    # byte correction): "flash" — the card's attention kernels keep the
    # (B,H,T,S) logits on chip.  Compose tokens with '+': "flash+sp".
    "flash": {},
}


def _opt_variant(opt: str) -> dict:
    var: dict = {"train": {}}
    for tok in opt.split("+"):
        v = OPT_VARIANTS.get(tok, {})
        var["train"].update(v.get("train", {}))
        if "accum_scale" in v:
            var["accum_scale"] = v["accum_scale"]
    return var


def accum_for_cell(arch: str, shape_name: str, mesh,
                   opt: str = "base") -> int:
    """The grad-accum trip count the real cell uses (costing needs it)."""
    shape = SHAPES[shape_name]
    if shape.kind != "train":
        return 1
    scale = _opt_variant(opt).get("accum_scale", 1)
    return _accum_for(get_config(arch), shape, mesh, scale)


def build_cell(arch: str, shape_name: str, mesh,
               train_overrides: Optional[dict] = None,
               opt: str = "base") -> Cell:
    return build_cell_from(get_config(arch), SHAPES[shape_name], mesh,
                           train_overrides, opt, arch_name=arch)


def _strip_data_axis(spec: shd.Spec) -> shd.Spec:
    """Replicate over the data axis (TP-only layout for serving)."""
    def fix(e):
        if e == "data":
            return None
        if isinstance(e, (tuple, list)):
            kept = tuple(x for x in e if x != "data")
            return kept if kept else None
        return e
    return shd.Spec(*[fix(e) for e in spec])


def _piece(mesh, x: torch.Tensor, spec: shd.Spec, keep) -> torch.Tensor:
    """This rank's piece under ``spec`` of ``x``, a tensor already cut
    over the ``keep`` axes only."""
    sl = []
    for d, size in enumerate(x.shape):
        e = spec[d] if d < len(spec) else None
        axes = shd._axes(e)
        if all(a in keep for a in axes):
            sl.append(slice(None))
            continue
        idx, n = shd._dim_index(mesh, e)
        sl.append(slice(idx * (size // n), (idx + 1) * (size // n)))
    return x[tuple(sl)].contiguous()


def _pieces(mesh, tree, specs, keep):
    return shd._map(lambda _, x, s: _piece(mesh, x, s, keep), tree, specs)


def _gathered(mesh, tree, specs, keep):
    return shd._map(lambda _, x, s: shd.gather_leaf(x, mesh, s, keep),
                    tree, specs)


def build_cell_from(cfg: ModelConfig, shape: ShapeSpec, mesh,
                    train_overrides: Optional[dict] = None,
                    opt: str = "base", accum: Optional[int] = None,
                    arch_name: Optional[str] = None,
                    dtype: torch.dtype = PARAM_DTYPE) -> Cell:
    """Cell from explicit config/shape (costing probes pass overridden
    configs and forced accum counts); parameters and float inputs in
    ``dtype`` (``PARAM_DTYPE``, the reference's, by default; a float32
    train cell prices the port's float32 step)."""
    arch = arch_name or cfg.name
    var = _opt_variant(opt)
    train_overrides = {**var.get("train", {}), **(train_overrides or {})}
    accum_scale = var.get("accum_scale", 1)
    is_train = shape.kind == "train"
    p_shape = params_shape(cfg, dtype)
    pspecs = shd.param_specs(cfg, p_shape, mesh)
    if "tponly" in opt.split("+") and not is_train:
        # serving-layout variant: replicate params over data — inference
        # has no optimizer state, so FSDP buys nothing and its per-layer
        # all-gathers dominate the collective term
        pspecs = shd._map(lambda _, s: _strip_data_axis(s), pspecs)
    p_local = shd.shard_tree(mesh, p_shape, pspecs)
    dp = shd.dp_axes(mesh)

    if is_train:
        accum = accum if accum is not None else \
            _accum_for(cfg, shape, mesh, accum_scale)
        tc = tr.TrainConfig(accum_steps=accum, **train_overrides)
        step = tr.make_train_step(cfg, tc, mesh)
        batch = input_specs(cfg, shape, dtype)
        flat = ckpt.flatten(p_local)
        opt_local = adam.AdamState(
            step=0, m={k: sds(v.shape, torch.float32)
                       for k, v in flat.items()},
            v={k: sds(v.shape, torch.float32) for k, v in flat.items()})
        _, opt_specs, _ = tr.train_shardings(cfg, mesh, p_shape)
        # every rank holds the global batch (the step cuts its rows)
        b_specs = {k: shd.Spec() for k in batch}
        return Cell(
            arch=arch, shape=shape, fn=step,
            args=(p_local, opt_local, batch),
            in_shardings=(pspecs, opt_specs, b_specs),
            out_shardings=(pspecs, opt_specs, shd.Spec()),
            donate_argnums=(0, 1), dtype=dtype, layout=LAYOUTS["train"],
        )

    if shape.kind == "prefill":
        batch = input_specs(cfg, shape, dtype)
        n_img = cfg.vlm.n_image_tokens if cfg.family == "vlm" else 0
        max_len = shape.seq_len + n_img
        state = decode_state_shape(cfg, shape.global_batch, max_len)
        if cfg.family == "encdec":
            state = state[1]          # prefill builds enc_out itself

        mixed_pack = None
        if "mixed" in opt.split("+") and cfg.mixed_res is not None and \
                cfg.family in ("dense", "moe", "vlm"):
            # the paper's technique: pool HALF the prompt spans (oldest
            # context) for the first beta=2 of 4 subsets
            import numpy as np

            from repro_torch.core import seq_mixed_res as smr
            T_total = shape.seq_len + n_img
            part1d = smr.seq_partition(cfg, T_total)
            span_mask = np.zeros((part1d.n_spans,), np.int32)
            n_low = part1d.n_spans // 2
            span_mask[:n_low] = 1
            plan = smr.build_seq_pack(span_mask, n_low, part1d)
            mixed_pack = {k: v for k, v in plan.items()
                          if k != "low_spans"}

        s_specs = shd.fix_specs(
            mesh, shd.decode_state_specs(cfg, mesh, state,
                                         shard_batch=True), state)
        b_specs = shd.batch_specs(cfg, mesh, batch)
        b_loc = shape.global_batch // shd.dp_size(mesh)
        out_s_specs = s_specs
        if cfg.family == "encdec":
            out_s_specs = (shd.Spec(dp, None, None), s_specs)

        def prefill_step(params, batch, state):
            view = shd.Gathered(params, pspecs, mesh)
            tokens = batch["tokens"]
            # a fresh full-head state for this rank's rows (prefill
            # overwrites it whole); ``state``, donated, goes unread
            fresh = registry.init_decode_state(cfg, b_loc, max_len,
                                               CACHE_DTYPE, tokens.device)
            if mixed_pack is not None:
                from repro_torch.core import seq_mixed_res as smr
                pack = {k: torch.as_tensor(v, device=tokens.device)
                        for k, v in mixed_pack.items()}
                hidden, new_state, _ = smr.mixed_prefill(
                    cfg, view, tokens, pack, 2, fresh,
                    image_embeds=batch.get("image_embeds"))
            else:
                hidden, new_state, _ = registry.prefill(cfg, view, batch,
                                                        fresh)
            logits = _last_logits(cfg, view, hidden)
            return logits, _pieces(mesh, new_state, out_s_specs, dp)

        return Cell(
            arch=arch, shape=shape, fn=prefill_step,
            args=(p_local, shd.shard_tree(mesh, batch, b_specs),
                  shd.shard_tree(mesh, state, s_specs)),
            in_shardings=(pspecs, b_specs, s_specs),
            out_shardings=(shd.Spec(dp, None, None), out_s_specs),
            donate_argnums=(2,), dtype=dtype, layout=LAYOUTS["prefill"],
        )

    # decode
    shard_batch = shape.global_batch >= shd.dp_size(mesh)
    max_len = shape.seq_len
    state = decode_state_shape(cfg, shape.global_batch, max_len)
    token = sds((shape.global_batch, 1), torch.int32)
    pos = shape.seq_len - 1
    s_specs = shd.fix_specs(
        mesh, shd.decode_state_specs(cfg, mesh, state,
                                     shard_batch=shard_batch), state)
    bspec = dp if shard_batch else None
    keep = dp if shard_batch else ()
    t_spec = shd.Spec(bspec, None)

    def decode_fn(params, token, state):
        view = shd.Gathered(params, pspecs, mesh)
        full = _gathered(mesh, state, s_specs, keep)
        logits, new_state = registry.decode_step(cfg, view, token, pos,
                                                 full)
        return logits, _pieces(mesh, new_state, s_specs, keep)

    return Cell(
        arch=arch, shape=shape, fn=decode_fn,
        args=(p_local, shd.shard_leaf(mesh, token, t_spec),
              shd.shard_tree(mesh, state, s_specs)),
        in_shardings=(pspecs, t_spec, s_specs),
        out_shardings=(shd.Spec(bspec, None, None), s_specs),
        donate_argnums=(2,), dtype=dtype, layout=LAYOUTS["decode"],
    )


def _last_logits(cfg: ModelConfig, params, hidden):
    from repro_torch.models import transformer as tfm
    return tfm.logits_from_hidden(cfg, params, hidden[:, -1:, :])
