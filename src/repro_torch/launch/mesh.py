"""Mesh construction, counterpart of ``repro/launch/mesh.py``.

Functions (not module-level constants), so importing this module touches
no process group.  Single pod: (data=16, model=16) = 256 ranks.  Multi
pod: (pod=2, data=16, model=16) = 512; the pod axis composes with data
parallelism, so only the gradient reduction crosses the (slower) pod
interconnect.  Each is a ``torch.distributed.device_mesh.DeviceMesh``
over the ranks of the initialized process group, one rank per card;
``device="cpu"`` (gloo) only when the caller asks for it.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.common.device import resolve_device

__all__ = ["make_production_mesh", "make_host_mesh", "make_mesh"]


def make_mesh(shape: tuple, axis_names: tuple, *, ranks=None,
              device=None) -> DeviceMesh:
    """A mesh of ``shape`` over ``ranks`` (increasing; default: every
    rank of the world), on ``device``'s type (default: the CUDA card).
    Every rank of the world calls it, members or not."""
    dev = resolve_device(device)
    if not dist.is_initialized():
        raise RuntimeError("a mesh needs an initialized process group "
                           "(torch.distributed.init_process_group)")
    n = 1
    for s in shape:
        n *= s
    if ranks is None:
        if dist.get_world_size() != n:
            raise ValueError(f"mesh {shape} needs {n} ranks; the world "
                             f"has {dist.get_world_size()}")
        ranks = range(n)
    ranks = torch.as_tensor(list(ranks), dtype=torch.int64)
    if ranks.numel() != n or bool((ranks[1:] <= ranks[:-1]).any()):
        raise ValueError(f"mesh {shape} needs {n} increasing ranks (an "
                         f"axis's index is the rank's place in its group), "
                         f"got {ranks.tolist()}")
    return DeviceMesh(dev.type, ranks.reshape(shape),
                      mesh_dim_names=tuple(axis_names))


def make_production_mesh(*, multi_pod: bool = False, device=None):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device=device)


def make_host_mesh(model: int = 2, device=None):
    """A (world / model, model) mesh over the ranks that exist."""
    if not dist.is_initialized():
        raise RuntimeError("a mesh needs an initialized process group "
                           "(torch.distributed.init_process_group)")
    n = dist.get_world_size()
    model = min(model, n)
    return make_mesh((n // model, model), ("data", "model"), device=device)
