"""Device meshes over the initialised world; port of ``repro.launch.mesh``.

Functions, not module-level constants: importing this module touches no
device and no process-group state (the reference's rule, so that tests
and tools that never start a process group can import it).

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with the
reference's axis names, ``("data", "model")`` or, across pods,
``("pod", "data", "model")``; its process groups come from
``mesh.get_group(axis)``.  The caller starts the process group
(``torch.distributed.init_process_group``, or ``torchrun``): NCCL on the
card, gloo on the CPU.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

PRODUCTION_SHAPES = {False: ((16, 16), ("data", "model")),
                     True: ((2, 16, 16), ("pod", "data", "model"))}


def default_device_type(device_type: Optional[str] = None) -> str:
    """``device_type`` as given, else "cuda": the mesh runs on the card
    unless the caller asks for the CPU, and a missing card raises rather
    than falling back."""
    if device_type is None:
        device_type = "cuda"
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("a cuda mesh needs a card; pass device_type="
                           "'cpu' for a gloo mesh on the CPU")
    return device_type


def make_mesh(shape: Sequence[int], axes: Tuple[str, ...],
              device_type: Optional[str] = None) -> DeviceMesh:
    """A mesh of ``shape`` named ``axes`` over the whole initialised
    world; raises when the world's size is not the shape's product."""
    if not dist.is_initialized():
        raise RuntimeError("init_process_group first (torchrun or "
                           "tcp://localhost:<port>)")
    n = 1
    for s in shape:
        n *= s
    if dist.get_world_size() != n:
        raise ValueError(f"a {tuple(shape)} mesh {axes} needs {n} ranks; "
                         f"the world has {dist.get_world_size()}")
    return init_device_mesh(default_device_type(device_type), tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: Optional[str] = None) -> DeviceMesh:
    """The reference's (16, 16) ``("data", "model")`` mesh, or (2, 16, 16)
    ``("pod", "data", "model")`` across pods: 256 or 512 ranks."""
    shape, axes = PRODUCTION_SHAPES[multi_pod]
    return make_mesh(shape, axes, device_type)


def make_local_mesh(data: int = 1, model: int = 1,
                    device_type: Optional[str] = None) -> DeviceMesh:
    """A small (data, model) mesh over the world (tests, one card)."""
    return make_mesh((data, model), ("data", "model"), device_type)
