"""Logical-axis sharding rules, counterpart of ``repro/parallel/sharding.py``:
parameter logical axis names (recorded at init by ``nn/params.set_axes``)
→ mesh axes, MaxText-style, with JAX's rule table and guards, so that a
leaf gets the same spec in both packages on every mesh.

The default table realises FSDP × TP (DESIGN §5):

* FSDP ("zero-3") over the composed ``("pod", "data")`` axes on the
  d_model / ``"embed"`` dim of every weight: sharded at rest, gathered at
  use (``nn/params.gathered``);
* TP over ``model`` on heads / ffn / vocab / expert-ffn / tno-channel dims.

A spec is a per-dim tuple like JAX's ``PartitionSpec`` (None, a mesh axis
name or a tuple of names); :func:`placements_for` turns it into DTensor
placements on a named ``DeviceMesh`` (a dim over several axes is sharded
over them in mesh order, as JAX's ``P(("pod", "data"))``). The mesh
functions read only the mesh's axis names and extents
(:func:`mesh_shape`), as JAX's read ``mesh.shape``, so a stand-in object
whose ``.shape`` maps axis → extent serves for tables at sizes no host
has.
"""
from __future__ import annotations

import dataclasses
import math
from collections.abc import Mapping
from typing import Optional, Sequence, Tuple, Union

import torch
from torch import nn
from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                      distribute_tensor)

from repro_torch.nn.params import DATA_AXES

AxisVal = Union[str, Tuple[str, ...], None]

# Default logical-name -> mesh-axis rules. "fsdp" is substituted with the
# composed data axes of the active mesh (("data",) or ("pod", "data")).
DEFAULT_RULES: Mapping = {
    # weight matrices
    "embed": "fsdp",          # d_model dim: FSDP-sharded at rest
    "embed_tp": "model",      # embedding table d_model dim: TP (gather by id)
    "heads": "model",         # q heads / fused h*hd projections
    "kv_proj": "model",       # k/v projections (None per arch at kv < TP)
    "mlp": "model",
    "ffn": "model",
    "vocab": "model",
    "expert": None,           # router logits dim (tiny)
    "ssm_inner": "model",     # mamba inner projections
    "ssm_heads": None,
    "tno_channel": "model",   # per-channel Toeplitz mixers: TP across channels
    "rpe_hidden": None,       # RPE MLP hidden (tiny)
    "layers": None,           # scanned-layer leading dim
    None: None,
}


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """Rule table bound to a mesh's axis names."""

    data_axes: Tuple[str, ...] = ("data",)   # FSDP axes (composed)
    model_axis: str = "model"
    overrides: Tuple[Tuple[str, AxisVal], ...] = ()

    def resolve(self, logical: Optional[str]) -> AxisVal:
        table = dict(DEFAULT_RULES)
        table.update(dict(self.overrides))
        v = table.get(logical, None)
        if v == "fsdp":
            return self.data_axes if len(self.data_axes) > 1 else self.data_axes[0]
        if v == "model":
            return self.model_axis
        return v


def mesh_shape(mesh) -> dict:
    """axis name → extent of a ``DeviceMesh`` (or of a stand-in whose
    ``.shape`` is already that mapping)."""
    if isinstance(mesh.shape, Mapping):
        return dict(mesh.shape)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _names(axis: AxisVal) -> tuple:
    if axis is None:
        return ()
    return (axis,) if isinstance(axis, str) else tuple(axis)


def _axes_divisible(mesh, axis: AxisVal, dim: int) -> bool:
    shape = mesh_shape(mesh)
    return dim % math.prod(shape[a] for a in _names(axis)) == 0


def spec_for(mesh, rules: ShardingRules, axes: Sequence[Optional[str]],
             shape: Sequence[int]) -> tuple:
    """The spec of one parameter; drops any axis whose mesh extent does not
    divide the dim (replication on that dim) or that an earlier dim already
    uses."""
    used = set()
    spec = []
    for name, dim in zip(axes, shape):
        ax = rules.resolve(name)
        if ax is not None:
            names = _names(ax)
            if any(a in used for a in names) or not _axes_divisible(mesh, ax, dim):
                ax = None
            else:
                used.update(names)
        spec.append(ax)
    return tuple(spec)


def placements_for(mesh, spec: Sequence[AxisVal]) -> tuple:
    """DTensor placements (one per mesh axis) of a per-dim spec."""
    dim_of = {a: i for i, ax in enumerate(spec) for a in _names(ax)}
    return tuple(Shard(dim_of[a]) if a in dim_of else Replicate()
                 for a in mesh.mesh_dim_names)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh, JAX's ``NamedSharding``: :meth:`place` puts a full
    tensor onto the mesh with it."""

    mesh: object
    spec: tuple

    @property
    def placements(self) -> tuple:
        return placements_for(self.mesh, self.spec)

    def place(self, t: torch.Tensor) -> DTensor:
        """``t`` (the same full value on every rank) as a DTensor on the
        mesh's device type, each rank keeping its shard."""
        return distribute_tensor(t.detach().to(self.mesh.device_type),
                                 self.mesh, self.placements)


def tree_shardings(mesh, rules: ShardingRules, axes: dict,
                   shapes: dict) -> dict:
    """name → :class:`NamedSharding` for twin tables name → axes and name
    → tensor (or anything with ``.shape``)."""
    return {k: NamedSharding(mesh, spec_for(mesh, rules, axes[k],
                                            shapes[k].shape))
            for k in axes}


def data_axes_of(mesh) -> tuple:
    return tuple(a for a in DATA_AXES if a in mesh_shape(mesh))


def rules_for_arch(cfg, mesh) -> ShardingRules:
    """Arch-family rule overrides (DESIGN §5 table)."""
    shape = mesh_shape(mesh)
    ov = []
    model = shape.get("model", 1)
    # kv projections: TP only if kv_heads >= model extent would keep head
    # granularity; otherwise replicate kv and shard only q (standard GQA
    # practice at kv < TP)
    if cfg.n_kv_heads and cfg.n_kv_heads < model:
        ov.append(("kv_proj", None))
    return ShardingRules(data_axes=data_axes_of(mesh), overrides=tuple(ov))


# ----------------------------------------------------- DTensor state helpers
@torch.no_grad()
def shard_module(module: nn.Module, shardings: dict) -> nn.Module:
    """Replace every parameter of ``module`` named in ``shardings`` by a
    DTensor parameter holding its shard (in place); returns the module."""
    for name, sh in shardings.items():
        owner, _, leaf = name.rpartition(".")
        mod = module.get_submodule(owner)
        p = mod._parameters[leaf]
        mod._parameters[leaf] = nn.Parameter(sh.place(p),
                                             requires_grad=p.requires_grad)
    return module


def full(t):
    """The full value of a DTensor (an all-gather every rank must join), or
    ``t`` itself."""
    return t.full_tensor() if isinstance(t, DTensor) else t


def local(t):
    """A DTensor's local shard (sharing its storage), or ``t`` itself."""
    return t.to_local() if isinstance(t, DTensor) else t


def shard_as(t: torch.Tensor, like: DTensor) -> DTensor:
    """``t`` (a full value, in its own dtype) with ``like``'s mesh and
    placements."""
    return distribute_tensor(t.detach().to(like.device_mesh.device_type),
                             like.device_mesh, like.placements)


def place_like(t: torch.Tensor, like) -> torch.Tensor:
    """``t`` (a full value) in ``like``'s dtype, on its device and, for a
    DTensor ``like``, with its mesh and placements."""
    if isinstance(like, DTensor):
        return shard_as(t.to(like.dtype), like)
    return t.to(device=like.device, dtype=like.dtype)
