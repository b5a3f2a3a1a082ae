"""Elastic scaling arithmetic; port of the mesh-free half of
``repro.train.elastic``.

On a failure (``train.straggler.HeartbeatMonitor``) the reference drops
the failed hosts, picks the largest (data, model) grid that fits the
survivors (``plan_mesh``: the model axis, the tensor-parallel degree, is
kept where it can be, since changing it costs a full relayout of the
sharded parameters), restores the last checkpoint onto that mesh and
scales gradient accumulation to keep the global batch
(``ElasticState.scaled_accum``).

``rebuild_mesh``, the resharded ``elastic_restart`` and the ``mesh``
field of ``ElasticState`` need the port's mesh code and wait for it
(``ROADMAP.md``, Queue 1, the mesh item); one card has world size 1.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple


def plan_mesh(n_devices: int, model_par: int) -> Tuple[int, int]:
    """Largest (data, model) grid with the model axis kept if possible."""
    while model_par > 1 and n_devices % model_par:
        model_par //= 2
    return n_devices // model_par, model_par


@dataclass
class ElasticState:
    global_batch: int
    accum_steps: int

    def scaled_accum(self, old_dp: int, new_dp: int) -> int:
        """Keep the global batch constant across a size change."""
        return max(1, int(round(self.accum_steps * old_dp / new_dp)))
