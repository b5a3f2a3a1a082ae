"""Mixture-of-Experts FFN (DBRX, DeepSeek-V2 style): the single-device
half of ``repro.models.moe``.

Top-k routing in float32, static-capacity dispatch tables (an expert
takes at most ``capacity`` tokens, in the order of the flattened (token,
k) assignments; the rest are dropped), the experts as batched SwiGLU
matmuls over (E, C, D) slabs, and DeepSeek-V2's always-on shared
experts.  On a half tree, as in the reference, the router logits are
computed in the tree's type and routed in float32, the expert ``bmm``s
and the shared experts run in the type, and the float32 gate table is
cast to it.

Two entry points share the inner math (``_moe_inner``), as in the
reference: ``moe_local`` (every expert resident) and ``moe_sharded``
(expert parallel over a mesh's ``model`` axis: each model rank runs its
E / ep experts on its data rows, replicated over ``model``, and one
all-reduce over ``model`` combines the partial outputs).

Two departures in mechanism, none in result:
  * ``torch.topk`` does not promise an order for equal values; a stable
    descending sort keeps the lower expert first, as ``jax.lax.top_k``.
  * the reference combines the experts' outputs with a scatter-add over
    the slots' token ids; repeated-index scatters have no fixed order on
    the card, so here each token gathers its own kept (expert, slot)
    rows and sums them in ascending expert order, the order of the
    reference's scatter.  Padding slots (token 0, gate 0) are never
    gathered, so they add nothing.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig


def init_moe(cfg: ModelConfig, generator: torch.Generator,
             device="cuda", dtype: Optional[torch.dtype] = None) -> Dict:
    """Seeded MoE weights with the reference's shapes and scales: the
    router at std 0.02, each (E, D, F) / (E, F, D) expert slab at 1 /
    sqrt(E) (the reference's ``dense_init`` takes the leading axis as
    the fan-in), the shared experts' SwiGLU at width
    ``d_ff_expert * n_shared_experts``; every leaf cast to ``dtype``
    (the router too, as the reference's; routing runs in float32)."""
    m = cfg.moe
    E, D, F_ = m.n_experts, cfg.d_model, m.d_ff_expert
    p = {"router": L.slab_init((D, E), generator, device, scale=0.02),
         "w_gate": L.slab_init((E, D, F_), generator, device),
         "w_up": L.slab_init((E, D, F_), generator, device),
         "w_down": L.slab_init((E, F_, D), generator, device)}
    if m.n_shared_experts > 0:
        p["shared"] = L.init_mlp(cfg, generator, device,
                                 d_ff=F_ * m.n_shared_experts)
    return L.as_dtype(p, dtype)


def expert_capacity(cfg: ModelConfig, n_tokens: int) -> int:
    m = cfg.moe
    cap = int(math.ceil(m.top_k * n_tokens / m.n_experts * m.capacity_factor))
    return max(8, -(-cap // 8) * 8)      # round up to a multiple of 8


# ---------------------------------------------------------------------------
# routing and dispatch


def route(cfg: ModelConfig, router_w: torch.Tensor, x_flat: torch.Tensor
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top-k routing.  Returns (top_idx (N, k) int64, top_gate (N, k)
    float32, renormalised to sum 1, aux): the load-balance term E *
    sum_e(fraction of assignments to e * mean probability of e)."""
    m = cfg.moe
    probs = torch.softmax((x_flat @ router_w).float(), dim=-1)     # (N, E)
    top_gate, top_idx = torch.sort(probs, dim=-1, descending=True,
                                   stable=True)
    top_gate, top_idx = top_gate[:, :m.top_k], top_idx[:, :m.top_k]
    top_gate = top_gate / top_gate.sum(dim=-1, keepdim=True)
    counts = torch.bincount(top_idx.reshape(-1),
                            minlength=m.n_experts).float()
    frac = counts / (x_flat.shape[0] * m.top_k)
    aux = m.n_experts * torch.sum(frac * probs.mean(dim=0))
    return top_idx, top_gate, aux


def _slots(top_idx: torch.Tensor, e0: int, n_local: int, capacity: int
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per flattened assignment (N * k, token-major) for the experts
    [e0, e0 + n_local): its local expert (``top_idx - e0``), its slot
    there (the count of earlier assignments to that expert) and whether
    it is kept (a local expert and slot < capacity)."""
    local_e = top_idx.reshape(-1) - e0
    is_local = (local_e >= 0) & (local_e < n_local)
    onehot = (local_e[:, None] == torch.arange(
        n_local, device=top_idx.device)[None, :]) & is_local[:, None]
    pos = torch.cumsum(onehot.int(), dim=0) - 1
    slot = torch.where(onehot, pos, 0).sum(dim=1)
    return local_e, slot, is_local & (slot < capacity)


def _tables(cfg: ModelConfig, slots, top_gate: torch.Tensor, n_local: int,
            capacity: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`dispatch_tables` from :func:`_slots`' result.  Each kept
    (expert, slot) is written once, so the tables do not depend on the
    order of the writes."""
    local_e, slot, keep = slots
    dev = top_gate.device
    tok_of = torch.arange(local_e.shape[0], device=dev) // cfg.moe.top_k
    idx_table = torch.zeros((n_local, capacity), dtype=torch.int32,
                            device=dev)
    gate_table = torch.zeros((n_local, capacity), dtype=torch.float32,
                             device=dev)
    idx_table[local_e[keep], slot[keep]] = tok_of[keep].int()
    gate_table[local_e[keep], slot[keep]] = top_gate.reshape(-1)[keep]
    return idx_table, gate_table


def dispatch_tables(cfg: ModelConfig, top_idx: torch.Tensor,
                    top_gate: torch.Tensor, capacity: int, e0: int = 0,
                    n_local: Optional[int] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Static-capacity dispatch tables for the experts [e0, e0 +
    n_local) (all by default): idx_table (n_local, capacity) int32 token
    ids and gate_table float32 gates, 0 (token 0, gate 0) in padding
    slots (the reference's ``_dispatch_tables``)."""
    n_local = cfg.moe.n_experts if n_local is None else n_local
    slots = _slots(top_idx, e0, n_local, capacity)
    return _tables(cfg, slots, top_gate, n_local, capacity)


# ---------------------------------------------------------------------------
# experts and combine


def expert_ffn(p: Dict, xs: torch.Tensor) -> torch.Tensor:
    """xs: (E, C, D); each expert's SwiGLU as batched matmuls."""
    h = F.silu(torch.bmm(xs, p["w_gate"])) * torch.bmm(xs, p["w_up"])
    return torch.bmm(h, p["w_down"])


def _moe_inner(cfg: ModelConfig, p, x_flat: torch.Tensor, e0: int,
               n_local: int, capacity: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The partial MoE output (N, D) of the experts [e0, e0 + n_local)
    held in ``p``'s slabs, plus ``p``'s shared experts, and the routing's
    aux."""
    N, D = x_flat.shape
    k = cfg.moe.top_k
    top_idx, top_gate, aux = route(cfg, p["router"], x_flat)
    slots = _slots(top_idx, e0, n_local, capacity)
    idx_table, gate_table = _tables(cfg, slots, top_gate, n_local, capacity)
    ys = expert_ffn(p, x_flat[idx_table.long()])          # (E_loc, C, D)
    ys = ys * gate_table[..., None].to(ys.dtype)
    # combine: each assignment's (expert, slot) row, or a zero row when
    # it was dropped or is not local; a token's k rows summed in
    # ascending expert order
    local_e, slot, keep = slots
    rows = torch.where(keep, local_e * capacity + slot, n_local * capacity)
    rows = rows.reshape(N, k).gather(1, torch.argsort(top_idx, dim=1))
    flat = F.pad(ys.reshape(n_local * capacity, D), (0, 0, 0, 1))
    out = torch.zeros_like(x_flat)
    for j in range(k):
        out = out + flat[rows[:, j]]
    if "shared" in p:
        out = out + L.apply_mlp(cfg, p["shared"], x_flat)
    return out, aux


def moe_local(cfg: ModelConfig, p: Dict, x: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-device MoE, every expert resident: x (B, S, D) -> (out,
    aux), shared experts added; capacity from the B * S tokens of this
    call."""
    B, S, D = x.shape
    out, aux = _moe_inner(cfg, p, x.reshape(B * S, D), 0, cfg.moe.n_experts,
                          expert_capacity(cfg, B * S))
    return out.reshape(B, S, D), aux


def moe_sharded(cfg: ModelConfig, p, x: torch.Tensor, mesh,
                data_axes: Tuple[str, ...] = ("data",),
                model_axis: str = "model"
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expert-parallel MoE on ``mesh`` (the reference's shard_map body).

    ``x`` (b, S, D) is this rank's rows (its data shard, replicated over
    ``model``).  ``p`` is either the full tree (each rank slices its
    experts) or a ``distributed.sharding.Gathered`` view of the stored
    pieces, which gathers the slabs over data only and keeps them split
    over ``model`` (``moe_param_specs``).  Model rank r runs the experts
    [r * E / ep, (r + 1) * E / ep) and its slice of the shared experts'
    hidden width; one autograd-aware all-reduce over ``model`` sums the
    partial outputs.  As in the reference:
      * the capacity comes from the LOCAL token count b * S, so with
        ``data`` > 1 tokens drop per data shard, not as ``moe_local``
        over the global batch drops them;
      * ``aux`` is all-reduced over ``model`` and divided by ep, which
        gives each data shard its own routing's aux (the reference's
        ``out_specs P()`` with ``check_vma=False`` keeps every device's
        value: the host reads data shard 0's, and its gradient is that
        of the mean over the data shards, which ``registry.lm_loss``
        reproduces on a mesh).
    At ep = 1 it is ``moe_local``'s arithmetic, op for op."""
    from repro_torch.distributed import sharding as shd
    m = cfg.moe
    ep = shd.mesh_shape(mesh)[model_axis]
    if m.n_experts % ep:
        raise ValueError(f"{m.n_experts} experts do not split over "
                         f"{ep} model ranks")
    n_local = m.n_experts // ep
    e0 = mesh.get_local_rank(model_axis) * n_local
    specs = moe_param_specs(cfg, data_axes, model_axis)
    if isinstance(p, shd.Gathered):
        local = {k: p.reshard(k, s) for k, s in specs.items()
                 if k != "shared"}
        if "shared" in specs:
            local["shared"] = {k: p["shared"].reshard(k, s)
                               for k, s in specs["shared"].items()}
    else:
        def piece(t, s):
            return shd.shard_leaf(mesh, t, s)
        local = {k: piece(p[k], s) for k, s in specs.items()
                 if k != "shared"}
        if "shared" in specs:
            local["shared"] = {k: piece(p["shared"][k], s)
                               for k, s in specs["shared"].items()}
    b, S, D = x.shape
    out, aux = _moe_inner(cfg, local, x.reshape(b * S, D), e0, n_local,
                          expert_capacity(cfg, b * S))
    group = mesh.get_group(model_axis)
    out = shd.all_reduce_sum(out, group)
    aux = shd.all_reduce_sum(aux, group) / ep
    return out.reshape(b, S, D), aux


def moe_param_specs(cfg: ModelConfig, data_axes=("data",),
                    model_axis: str = "model") -> Dict:
    """Specs of ``init_moe``'s tree inside the expert-parallel layer:
    expert slabs over ``model`` on the expert axis, the shared experts'
    hidden width over ``model``, the router whole."""
    from repro_torch.distributed.sharding import Spec
    specs = {"router": Spec(None, None),
             "w_gate": Spec(model_axis, None, None),
             "w_up": Spec(model_axis, None, None),
             "w_down": Spec(model_axis, None, None)}
    if cfg.moe.n_shared_experts > 0:
        specs["shared"] = {"w_gate": Spec(None, model_axis),
                           "w_up": Spec(None, model_axis),
                           "w_down": Spec(model_axis, None)}
    return specs
