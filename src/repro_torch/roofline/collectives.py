"""Collective traffic from the dry-run's records; port of
``repro.roofline.collectives``.

The reference parses all-gather / all-reduce / reduce-scatter /
all-to-all / collective-permute ops out of post-SPMD HLO text.  The port
has no HLO: ``launch.costing``'s counter records every ``c10d`` op it
sees as (op, group size, operand bytes, result bytes, intra-node), and
this module turns the records into per-device link traffic with the
reference's ring-algorithm factors:

  all-reduce       2 * S * (g-1)/g      (reduce-scatter + all-gather)
  all-gather       R * (g-1)/g          (R = full result size)
  reduce-scatter   S * (g-1)/g          (S = full operand size)
  all-to-all       S * (g-1)/g
  collective-permute  S                 (point-to-point)

A group is intra-node when all of its ranks lie on one host of
``roofline.model.GPUS_PER_NODE`` cards (ranks ``n * 8 .. n * 8 + 7``);
its bytes then also count in ``intra_node_bytes``.
"""
from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass
from typing import Dict, Iterable, Sequence

from repro_torch.roofline.model import GPUS_PER_NODE

OPS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
       "collective-permute")


@dataclass(frozen=True)
class Record:
    """One collective as the counter saw it (bytes of this rank's
    operand and result tensors)."""
    op: str
    group_size: int
    operand_bytes: int
    result_bytes: int
    intra_node: bool


def moved_bytes(op: str, group_size: int, operand_bytes: float,
                result_bytes: float) -> float:
    """Per-device link bytes of one collective (the ring factors)."""
    frac = (group_size - 1) / group_size
    if op == "all-reduce":
        return 2.0 * operand_bytes * frac
    if op == "all-gather":
        return result_bytes * frac
    if op in ("reduce-scatter", "all-to-all"):
        return operand_bytes * frac
    if op == "collective-permute":
        return float(operand_bytes)
    raise ValueError(f"unknown collective {op!r}; have {OPS}")


def intra_node(ranks: Sequence[int], per_node: int = GPUS_PER_NODE) -> bool:
    """True when every rank of a group lies on one node."""
    return len({r // per_node for r in ranks}) <= 1


def collective_bytes(records: Iterable[Record]) -> Dict:
    """Per-device collective traffic summed over the records."""
    per_op = defaultdict(float)
    counts = defaultdict(int)
    total = intra = 0.0
    for r in records:
        moved = moved_bytes(r.op, r.group_size, r.operand_bytes,
                            r.result_bytes)
        per_op[r.op] += moved
        counts[r.op] += 1
        total += moved
        if r.intra_node:
            intra += moved
    return {
        "bytes_per_device": total,
        "by_op_bytes": dict(per_op),
        "op_counts": dict(counts),
        "intra_node_bytes": intra,
    }
