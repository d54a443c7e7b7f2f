"""Parameter bridge: the JAX package's parameter tree → the port's model.

The input is the unboxed JAX tree
(``repro.nn.params.unbox(init_model(...))[0]``) with every leaf converted to a numpy array by the caller, so this module
needs neither JAX nor the JAX package. Weights keep their (d_in, d_out)
layout (the port computes ``x @ w`` as JAX does). The scanned stack
``blocks/sub<k>`` (leading axis ``n_scan_blocks``) is split into
``layers.<block * period + k>`` and ``tail<i>`` becomes
``layers.<n_scan_blocks * period + i>``. Reading checkpoint directories
(``checkpoint/manifest.py``) comes with a later slice.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.config import ArchConfig
from repro_torch.models.transformer import Model


def _flatten(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flatten(v, f"{prefix}{k}.")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten(v, f"{prefix}{i}.")
    else:
        yield prefix[:-1], np.asarray(tree)


def _port_leaves(tree, cfg: ArchConfig) -> dict[str, np.ndarray]:
    """JAX leaves under the port's parameter names (``Model.state_dict``)."""
    out = {}
    for name, arr in _flatten(tree):
        head, _, rest = name.partition(".")
        if head == "blocks":
            sub, _, rest = rest.partition(".")
            k = int(sub.removeprefix("sub"))
            if arr.shape[0] != cfg.n_scan_blocks:
                raise ValueError(f"JAX leaf {name}: leading axis "
                                 f"{arr.shape[0]} != n_scan_blocks "
                                 f"{cfg.n_scan_blocks}")
            for blk in range(cfg.n_scan_blocks):
                out[f"layers.{blk * cfg.period + k}.{rest}"] = arr[blk]
        elif head.startswith("tail"):
            i = int(head.removeprefix("tail"))
            out[f"layers.{cfg.n_scan_blocks * cfg.period + i}.{rest}"] = arr
        else:
            out[name] = arr
    return out


def params_from_jax(tree, cfg: ArchConfig, device="cuda") -> Model:
    """Build the port's model holding exactly the JAX parameters. Raises if
    a JAX leaf has no port parameter, a port parameter gets no JAX leaf,
    or a shape differs."""
    leaves = _port_leaves(tree, cfg)
    model = Model(cfg, device="meta")
    want = dict(model.state_dict())
    extra = sorted(set(leaves) - set(want))
    missing = sorted(set(want) - set(leaves))
    if extra or missing:
        raise ValueError(f"JAX tree does not match the port's parameters: "
                         f"unconsumed JAX leaves {extra}, unset port "
                         f"parameters {missing}")
    for name, arr in leaves.items():
        if tuple(arr.shape) != tuple(want[name].shape):
            raise ValueError(f"{name}: JAX shape {arr.shape} != port shape "
                             f"{tuple(want[name].shape)}")
    dtype = getattr(torch, cfg.param_dtype)
    state = {k: torch.tensor(v, dtype=dtype, device=device)
             for k, v in leaves.items()}
    model.load_state_dict(state, assign=True)
    return model
