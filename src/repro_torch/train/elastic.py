"""Elastic scaling: rebuild the mesh from the surviving ranks and reshard
training state from the last checkpoint; port of ``repro.train.elastic``.

The flow on failure (driven by ``train.straggler.HeartbeatMonitor``):
  1. drop the failed hosts; the survivors form a new world
     (``torch.distributed.init_process_group`` again, or ``torchrun``'s
     restart);
  2. ``plan_mesh``: the largest (data, model) grid that fits, keeping the
     model axis (the tensor-parallel degree) where it can, since changing
     it costs a full relayout of the sharded parameters;
  3. restore the last checkpoint onto the NEW mesh's shardings
     (``checkpoint.restore`` gives each rank its piece of every full
     saved leaf);
  4. scale gradient accumulation to keep the global batch
     (``ElasticState.scaled_accum``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.launch.mesh import default_device_type
from repro_torch.train import checkpoint as ckpt_lib


def plan_mesh(n_devices: int, model_par: int) -> Tuple[int, int]:
    """Largest (data, model) grid with the model axis kept if possible."""
    while model_par > 1 and n_devices % model_par:
        model_par //= 2
    return n_devices // model_par, model_par


def rebuild_mesh(world_ranks: Sequence[int], model_par: int,
                 device_type: Optional[str] = None) -> DeviceMesh:
    """A ("data", "model") mesh over the first data * model of
    ``world_ranks`` (``plan_mesh``).  Over the whole initialised world it
    is ``init_device_mesh``; over a part of it, a ``DeviceMesh`` of those
    ranks, which every rank of the world must build together (it creates
    process groups)."""
    data, model = plan_mesh(len(world_ranks), model_par)
    usable = list(world_ranks)[: data * model]
    device_type = default_device_type(device_type)
    if usable == list(range(dist.get_world_size())):
        return init_device_mesh(device_type, (data, model),
                                mesh_dim_names=("data", "model"))
    return DeviceMesh(device_type, torch.tensor(usable).reshape(data, model),
                      mesh_dim_names=("data", "model"))


@dataclass
class ElasticState:
    global_batch: int
    accum_steps: int
    mesh: Any = None        # last in the port, so (batch, accum) reads on

    def scaled_accum(self, old_dp: int, new_dp: int) -> int:
        """Keep the global batch constant across a size change."""
        return max(1, int(round(self.accum_steps * old_dp / new_dp)))


def elastic_restart(cfg, directory: str, world_ranks: Sequence[int],
                    model_par: int, make_state_like: Callable[[], Any],
                    make_shardings: Callable[[DeviceMesh], Any],
                    step: Optional[int] = None,
                    device_type: Optional[str] = None):
    """The full restart path: a new mesh, then the checkpoint restored
    onto it.  ``make_state_like()`` gives the state's structure (leaves'
    devices; their shapes are not read), ``make_shardings(mesh)`` the
    matching ``NamedSharding`` tree.  Returns (mesh, state)."""
    mesh = rebuild_mesh(world_ranks, model_par, device_type)
    state = ckpt_lib.restore(make_state_like(), directory, step=step,
                             shardings=make_shardings(mesh))
    return mesh, state
