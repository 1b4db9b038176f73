"""Meshes over the caller's process group (port of ``repro.launch.mesh``).

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with named dims,
built over the process group the caller initialised
(``torch.distributed.init_process_group``): the port names no backend,
the group it is given carries the collectives. Functions, so importing
this module touches no device or group.

>>> mesh = make_local_mesh(2, 2, device="cpu")   # 4 ranks: data x model

The dry-run (``launch/dryrun.py``) builds the production meshes over a
fake process group of 256 or 512 ranks with ``device="cpu"`` (the mesh's
device type; its tensors are meta).
"""
from __future__ import annotations

from typing import Optional, Union

import torch
import torch.distributed as dist

from .._device import resolve_device
from ..dist.layout import mesh_group

__all__ = ["make_local_mesh", "make_production_mesh", "mesh_group"]


def _mesh(shape, names, device):
    from torch.distributed.device_mesh import init_device_mesh
    kind = resolve_device(device).type
    if not dist.is_initialized():
        raise RuntimeError("initialise the process group first "
                           "(torch.distributed.init_process_group)")
    want = 1
    for n in shape:
        want *= n
    if dist.get_world_size() != want:
        raise ValueError(f"a {shape} mesh needs {want} ranks, the process "
                         f"group has {dist.get_world_size()}")
    return init_device_mesh(kind, tuple(shape), mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False,
                         device: Optional[Union[str, torch.device]] = None):
    """The production mesh: (16, 16) over ("data", "model"), or (2, 16,
    16) over ("pod", "data", "model"); raises unless the process group has
    exactly that many ranks. ``device=None`` means the card (raises
    without CUDA)."""
    if multi_pod:
        return _mesh((2, 16, 16), ("pod", "data", "model"), device)
    return _mesh((16, 16), ("data", "model"), device)


def make_local_mesh(data: int = 1, model: int = 1, *,
                    device: Optional[Union[str, torch.device]] = None):
    """A (data, model) mesh over the whole process group, which must have
    ``data * model`` ranks. ``device=None`` means the card (raises without
    CUDA); the tests pass ``device="cpu"``."""
    return _mesh((data, model), ("data", "model"), device)
