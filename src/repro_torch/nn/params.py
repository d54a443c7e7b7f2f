"""Logical sharding axes of the parameters, counterpart of
``repro/nn/params.py`` (``Box``/``boxed``/``unbox``).

JAX boxes each leaf with its logical axis names at init; here each module
records the axes of its own parameters (:func:`set_axes`, kept on the
module so that ``load_state_dict(assign=True)``, ``Module.to`` and DTensor
parameters all keep them), and :func:`param_axes` gives the model's
name → axes table, JAX's ``unbox(...)[1]`` under the port's names (the
scanned ``"layers"`` axis dropped: every layer is its own module).
``parallel/sharding.py`` maps the logical names onto mesh axes.

:func:`gathered` is FSDP's gather at use: a parameter sharded over the
data axes at rest is all-gathered over them before it is read (its
autograd is the reduce-scatter of the gradient); a plain tensor passes
through. :func:`local_params` runs plain code on a module's local shards.
"""
from __future__ import annotations

import contextlib

from torch import nn
from torch.distributed.tensor import DTensor, Replicate

#: the mesh axes that carry data parallelism (JAX's ``data_axes_of``)
DATA_AXES = ("pod", "data")


def set_axes(module: nn.Module, **axes) -> None:
    """Record the logical axes (a tuple of names or None, one per dim) of
    ``module``'s parameters, by attribute name."""
    table = module.__dict__.setdefault("_param_axes", {})
    table.update({k: tuple(v) for k, v in axes.items()})


def param_axes(model: nn.Module) -> dict:
    """name → logical axes of every parameter of ``model``. Raises if a
    parameter has none recorded or its axes do not match its rank."""
    out = {}
    for mname, mod in model.named_modules():
        table = mod.__dict__.get("_param_axes", {})
        for pname, p in mod.named_parameters(recurse=False):
            name = f"{mname}.{pname}" if mname else pname
            if pname not in table:
                raise KeyError(f"parameter {name} has no logical axes")
            if len(table[pname]) != p.dim():
                raise ValueError(f"{name}: axes {table[pname]} for shape "
                                 f"{tuple(p.shape)}")
            out[name] = table[pname]
    return out


def tree_size_bytes(params) -> int:
    """Bytes of every tensor in ``params`` (a dict name → tensor or a
    module), at their logical (global) shapes."""
    if isinstance(params, nn.Module):
        params = dict(params.named_parameters())
    return sum(p.numel() * p.element_size() for p in params.values())


def tree_param_count(params) -> int:
    if isinstance(params, nn.Module):
        params = dict(params.named_parameters())
    return sum(p.numel() for p in params.values())


def gathered(t):
    """``t`` with its data-axis shards all-gathered (the FSDP gather at
    use), keeping its model-axis placement; a plain tensor unchanged."""
    if not isinstance(t, DTensor):
        return t
    mesh = t.device_mesh
    pl = [Replicate() if n in DATA_AXES and mesh.size(i) > 1 else p
          for i, (n, p) in enumerate(zip(mesh.mesh_dim_names, t.placements))]
    return t if pl == list(t.placements) else t.redistribute(mesh, pl)


@contextlib.contextmanager
def local_params(module: nn.Module, tensors: dict):
    """Put ``tensors`` (parameter name under ``module`` → plain tensor) in
    place of those parameters for the body of the ``with``, and put the
    parameters back after it: plain code (an op, a kernel wrapper) then
    reads the local tensors through the module's attributes."""
    saved = []
    try:
        for name, t in tensors.items():
            owner, _, leaf = name.rpartition(".")
            mod = module.get_submodule(owner)
            saved.append((mod, leaf, mod._parameters[leaf]))
            mod._parameters[leaf] = t
        yield module
    finally:
        for mod, leaf, p in reversed(saved):
            mod._parameters[leaf] = p
