"""Production and debug meshes — counterpart of ``repro.launch.mesh``.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with the
reference's axis names, over the ranks of the default process group:

  single pod: (16, 16) = 256 ranks, axes (data, model)
  multi-pod:  (2, 16, 16) = 512 ranks, axes (pod, data, model)

On the card the group is gloo, its ranks sharing one H100 (NCCL refuses two
ranks on one device); on the CPU, gloo ranks; for the dry-run, the
``"fake"`` backend at 256 or 512 ranks in one process.  The functions here
never initialize a process group: the caller does (``dryrun`` initializes
its fake group itself), so importing this module touches nothing.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..device import resolve_device

__all__ = ["PRODUCTION_SHAPES", "make_debug_mesh", "make_production_mesh"]

PRODUCTION_SHAPES = {
    "single": ((16, 16), ("data", "model")),
    "multi": ((2, 16, 16), ("pod", "data", "model")),
}


def _device_type(device) -> str:
    return resolve_device(device).type


def _mesh(shape: Sequence[int], axes: Sequence[str], device):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    dev = _device_type(device)
    if not dist.is_initialized():
        raise RuntimeError("a mesh needs an initialized default process group")
    n = int(np.prod(shape))
    world = dist.get_world_size()
    if world < n:
        raise ValueError(f"mesh {tuple(shape)} needs {n} ranks; the group has {world}")
    if n == world:
        return init_device_mesh(dev, tuple(shape), mesh_dim_names=tuple(axes))
    from torch.distributed.device_mesh import DeviceMesh

    ranks = torch.arange(n).reshape(tuple(shape))
    return DeviceMesh(dev, ranks, mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """The (16, 16) ("data", "model") mesh, or (2, 16, 16) ("pod", "data",
    "model") with ``multi_pod``, over the default group's first ranks, on
    ``device``'s type (default: the card)."""
    shape, axes = PRODUCTION_SHAPES["multi" if multi_pod else "single"]
    return _mesh(shape, axes, device)


def make_debug_mesh(shape=(2, 2, 2), axes=("pod", "data", "model"), device=None):
    """A small mesh over the first ranks of the initialized default group
    (tests, examples, the card's mesh phase); raises when the group is
    smaller than the mesh."""
    return _mesh(shape, axes, device)
