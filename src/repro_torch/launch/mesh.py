"""Mesh factories.  Port of ``repro/launch/mesh.py``.

A mesh is a ``torch.distributed`` ``DeviceMesh`` over the ranks of a process
group the caller has initialised (``torch.distributed.init_process_group``:
``launch.train`` does it, with NCCL for ``cuda`` and gloo for ``cpu``), with
the reference's axis names and order: ``("pod", "data", "model")`` when
there is more than one pod, else ``("data", "model")``.  The mesh's size is
the group's world size: a factory raises when no group is initialised or
when the world is another size, and never builds a smaller mesh.
"""
from __future__ import annotations

import math
from typing import Tuple

__all__ = ["make_production_mesh", "make_local_mesh"]


def _mesh(shape: Tuple[int, ...], names: Tuple[str, ...], device_type: str):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    size = math.prod(shape)
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            f"a {dict(zip(names, shape))} mesh needs an initialised process "
            f"group of {size} ranks (torch.distributed.init_process_group); "
            f"none is initialised")
    world = dist.get_world_size()
    if world != size:
        raise RuntimeError(
            f"a {dict(zip(names, shape))} mesh needs {size} ranks; the "
            f"process group has {world}")
    return init_device_mesh(device_type, shape, mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """16 x 16 single-pod (256 ranks) or 2 x 16 x 16 multi-pod (512)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, device_type)


def make_local_mesh(data: int = 1, model: int = 1, pod: int = 1,
                    device_type: str = "cuda"):
    """A ``pod x data x model`` mesh over the initialised group's ranks
    (``pod`` left out when 1); the group's world size must be its size."""
    if pod > 1:
        return _mesh((pod, data, model), ("pod", "data", "model"),
                     device_type)
    return _mesh((data, model), ("data", "model"), device_type)
