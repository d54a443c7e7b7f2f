"""Mesh / activation-sharding context threaded through the model's apply
functions, counterpart of ``repro/models/context.py``.

Models never name mesh axes: they ask for *logical* activation shardings
with ``shard(ctx, x, "batch", "seq", "embed")``, and the context maps the
names onto mesh axes and redistributes the DTensor ``x`` to them (no-op
without a mesh: the one-card code path). As under GSPMD, a dim the mesh
does not divide is sharded unevenly rather than refused.

Code that DTensor cannot run (the kernels' wrappers, ``torch.fft``, the
autograd Functions) runs on the local shards: :func:`to_local` hands such
code a DTensor's local tensor with the gradient placement that makes the
backward right, and :func:`from_local` wraps the result.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard


@dataclasses.dataclass(frozen=True)
class Ctx:
    mesh: Optional[object] = None   # a named DeviceMesh
    data_axes: Tuple[str, ...] = ("data",)
    model_axis: str = "model"
    decode: bool = False
    seq_shard_resid: bool = False   # sequence-parallel residual stream
    # KV-cache sequence sharding axes (flash decoding). For batch-1 long-
    # context decode the idle data axes fold in here, e.g. ("data","model")
    # = 256-way sequence sharding of a 512k cache (DESIGN §5).
    seq_kv_axes: Tuple[str, ...] = ("model",)

    def rules(self):
        m = (self.model_axis,)
        return {
            "batch": self.data_axes or None,
            "seq": m if self.seq_shard_resid else None,
            "seq_any": None,
            "seq_kv": self.seq_kv_axes,
            "embed": None,
            "heads": m,
            "kv_heads": None,
            "head_dim": None,
            "ffn": m,
            "vocab": m,
            "expert": None,
            "state": None,
            "tno_channel": m,
            None: None,
        }

    def placements(self, *axes) -> tuple:
        """DTensor placements (one per mesh axis) of the logical names
        ``axes`` (one per tensor dim)."""
        rules = self.rules()
        dim_of = {}
        for i, a in enumerate(axes):
            r = rules[a]
            for name in ((r,) if isinstance(r, str) else (r or ())):
                dim_of[name] = i
        return tuple(Shard(dim_of[n]) if n in dim_of else Replicate()
                     for n in self.mesh.mesh_dim_names)


def shard(ctx: Optional[Ctx], x, *axes):
    """Redistribute the DTensor ``x`` to the logical sharding ``axes`` (a
    collective where the placements change); ``x`` itself without a
    mesh."""
    if ctx is None or ctx.mesh is None:
        return x
    if len(axes) != x.ndim:
        raise ValueError(f"logical axes {axes} for a {x.ndim}-d tensor")
    pl = ctx.placements(*axes)
    return x if same_layout(x, pl) else x.redistribute(ctx.mesh, pl)


def same_layout(t: DTensor, placements) -> bool:
    """Whether ``t`` already has ``placements`` on every mesh axis of
    extent > 1 (on an axis of extent 1 every placement holds the whole
    tensor: redistributing there would move nothing, yet add an autograd
    node that reorders the gradient's sums)."""
    mesh = t.device_mesh
    return all(p == q or mesh.size(i) == 1
               for i, (p, q) in enumerate(zip(t.placements, placements)))


def relayout(t: DTensor, placements) -> DTensor:
    """``t`` redistributed to ``placements`` on the mesh axes of extent >
    1; on an axis of extent 1 its placement is left as it is (the local
    value is the whole value there, a partial sum over one rank
    included)."""
    if same_layout(t, placements):
        return t
    mesh = t.device_mesh
    return t.redistribute(mesh, [q if mesh.size(i) > 1 else p for i, (p, q)
                                 in enumerate(zip(t.placements, placements))])


def to_local(t: DTensor, out_placements) -> torch.Tensor:
    """``t``'s local tensor for code whose output has ``out_placements``.
    Its gradient keeps ``t``'s shards; along a mesh axis where ``t`` is
    replicated but the output is sharded, each rank's code sees only its
    part of the work, so the gradient is partial there (summed by the
    reduction that follows), and replicated where the output is too."""
    grad = [p if p.is_shard() else (Partial() if o.is_shard()
                                    else Replicate())
            for p, o in zip(t.placements, out_placements)]
    return t.to_local(grad_placements=grad)


def from_local(local: torch.Tensor, like: DTensor):
    """``local`` (this rank's shard, in any layout) as a DTensor on
    ``like``'s mesh with ``like``'s placements (shards of equal size, as
    the divisibility guards and the pipeline's host batches give)."""
    return DTensor.from_local(local, like.device_mesh, like.placements,
                              run_check=False)
