"""Mixture-of-Experts FFN (DBRX, DeepSeek-V2 style): the single-device
half of ``repro.models.moe``.

Top-k routing in float32, static-capacity dispatch tables (an expert
takes at most ``capacity`` tokens, in the order of the flattened (token,
k) assignments; the rest are dropped), the experts as batched SwiGLU
matmuls over (E, C, D) slabs, and DeepSeek-V2's always-on shared
experts.  On a half tree, as in the reference, the router logits are
computed in the tree's type and routed in float32, the expert ``bmm``s
and the shared experts run in the type, and the float32 gate table is
cast to it.  The expert-parallel ``moe_sharded`` needs a mesh and waits for
the mesh code (``ROADMAP.md``, Queue 1).

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
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig


def init_moe(cfg: ModelConfig, generator: torch.Generator,
             device="cuda") -> Dict:
    """Seeded MoE weights with the reference's shapes and scales: the
    router at std 0.02, each (E, D, F) / (E, F, D) expert slab at 1 /
    sqrt(E) (the reference's ``dense_init`` takes the leading axis as
    the fan-in), the shared experts' SwiGLU at width
    ``d_ff_expert * n_shared_experts``."""
    m = cfg.moe
    E, D, F_ = m.n_experts, cfg.d_model, m.d_ff_expert
    p = {"router": L.slab_init((D, E), generator, device, scale=0.02),
         "w_gate": L.slab_init((E, D, F_), generator, device),
         "w_up": L.slab_init((E, D, F_), generator, device),
         "w_down": L.slab_init((E, F_, D), generator, device)}
    if m.n_shared_experts > 0:
        p["shared"] = L.init_mlp(cfg, generator, device,
                                 d_ff=F_ * m.n_shared_experts)
    return p


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


def _slots(top_idx: torch.Tensor, n_experts: int, capacity: int
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per flattened assignment (N * k, token-major): its expert, its slot
    there (the count of earlier assignments to that expert) and whether
    it is kept (slot < capacity)."""
    flat_e = top_idx.reshape(-1)
    onehot = flat_e[:, None] == torch.arange(n_experts,
                                             device=top_idx.device)[None, :]
    pos = torch.cumsum(onehot.int(), dim=0) - 1
    slot = torch.where(onehot, pos, 0).sum(dim=1)
    return flat_e, slot, slot < capacity


def _tables(cfg: ModelConfig, slots, top_gate: torch.Tensor,
            capacity: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`dispatch_tables` from :func:`_slots`' result.  Each kept
    (expert, slot) is written once, so the tables do not depend on the
    order of the writes."""
    flat_e, slot, keep = slots
    dev = top_gate.device
    E = cfg.moe.n_experts
    tok_of = torch.arange(flat_e.shape[0], device=dev) // cfg.moe.top_k
    idx_table = torch.zeros((E, capacity), dtype=torch.int32, device=dev)
    gate_table = torch.zeros((E, capacity), dtype=torch.float32, device=dev)
    idx_table[flat_e[keep], slot[keep]] = tok_of[keep].int()
    gate_table[flat_e[keep], slot[keep]] = top_gate.reshape(-1)[keep]
    return idx_table, gate_table


def dispatch_tables(cfg: ModelConfig, top_idx: torch.Tensor,
                    top_gate: torch.Tensor, capacity: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Static-capacity dispatch tables: idx_table (E, capacity) int32
    token ids and gate_table float32 gates, 0 (token 0, gate 0) in
    padding slots (the reference's ``_dispatch_tables`` over all
    experts)."""
    slots = _slots(top_idx, cfg.moe.n_experts, capacity)
    return _tables(cfg, slots, top_gate, capacity)


# ---------------------------------------------------------------------------
# experts and combine


def expert_ffn(p: Dict, xs: torch.Tensor) -> torch.Tensor:
    """xs: (E, C, D); each expert's SwiGLU as batched matmuls."""
    h = F.silu(torch.bmm(xs, p["w_gate"])) * torch.bmm(xs, p["w_up"])
    return torch.bmm(h, p["w_down"])


def moe_local(cfg: ModelConfig, p: Dict, x: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-device MoE, every expert resident: x (B, S, D) -> (out,
    aux), shared experts added; capacity from the B * S tokens of this
    call."""
    B, S, D = x.shape
    N, E, k = B * S, cfg.moe.n_experts, cfg.moe.top_k
    cap = expert_capacity(cfg, N)
    x_flat = x.reshape(N, D)
    top_idx, top_gate, aux = route(cfg, p["router"], x_flat)
    slots = _slots(top_idx, E, cap)
    idx_table, gate_table = _tables(cfg, slots, top_gate, cap)
    ys = expert_ffn(p, x_flat[idx_table.long()])                # (E, C, D)
    ys = ys * gate_table[..., None].to(ys.dtype)
    # combine: each assignment's (expert, slot) row, or a zero row when
    # it was dropped; a token's k rows summed in ascending expert order
    flat_e, slot, keep = slots
    rows = torch.where(keep, flat_e * cap + slot, E * cap)
    rows = rows.reshape(N, k).gather(1, torch.argsort(top_idx, dim=1))
    flat = F.pad(ys.reshape(E * cap, D), (0, 0, 0, 1))
    out = torch.zeros_like(x_flat)
    for j in range(k):
        out = out + flat[rows[:, j]]
    if "shared" in p:
        out = out + L.apply_mlp(cfg, p["shared"], x_flat)
    return out.reshape(B, S, D), aux
