"""Device meshes, counterpart of ``repro/launch/mesh.py``: named
``DeviceMesh``es over the ranks of the default process group, one rank a
device. Functions, not module constants, so importing this module touches
no process group. The device type is explicit: ``"cuda"`` unless the
caller asks for ``"cpu"`` (gloo ranks on the host, as the tests run them).
"""
from __future__ import annotations

import math
import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro_torch.parallel.sharding import data_axes_of


def init_distributed(device_type: str = "cuda") -> bool:
    """Start the default process group unless one is running: under
    ``torchrun`` (``RANK`` and ``WORLD_SIZE`` set) from its environment,
    each rank on the card ``LOCAL_RANK``; otherwise a one-rank group on an
    in-process store. NCCL on the card, gloo on the CPU. Returns True if
    this call started it (the caller then destroys it)."""
    if dist.is_initialized():
        return False
    backend = "nccl" if device_type == "cuda" else "gloo"
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        if device_type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group(backend, init_method="env://")
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    return True


def make_mesh(shape, axes, device_type: str = "cuda"):
    """A mesh of ``shape`` named ``axes`` over every rank of the default
    process group (started by the caller); raises if the world size is not
    the mesh's size."""
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    world = dist.get_world_size() if dist.is_initialized() else 0
    if world != math.prod(shape):
        raise ValueError(f"mesh {dict(zip(axes, shape))} needs "
                         f"{math.prod(shape)} ranks; the process group has "
                         f"{world}")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """Single pod: (data=16, model=16) = 256 ranks. Multi-pod: (pod=2,
    data=16, model=16) = 512; the ``pod`` axis carries only the gradient
    reduction (the lowest-frequency collective on the slowest links)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type)


def make_host_mesh(device_type: str = "cuda"):
    """The one-rank (data=1, model=1) mesh (axes present, extent 1)."""
    return make_mesh((1, 1), ("data", "model"), device_type)


def data_rank(mesh) -> tuple:
    """(this rank's index over the mesh's data axes, their extent): the
    ``host_id`` and ``num_hosts`` of ``data/pipeline.DataConfig``, so
    each rank loads its rows of the global batch (ranks that differ only
    along the model axis load the same rows)."""
    coord, names = mesh.get_coordinate(), mesh.mesh_dim_names
    idx, n = 0, 1
    for a in data_axes_of(mesh):
        i = names.index(a)
        idx, n = idx * mesh.size(i) + coord[i], n * mesh.size(i)
    return idx, n
