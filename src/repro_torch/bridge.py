"""Bridge between the JAX package's parameter / training-state trees and
the port's model and optimizer state, both ways.

A JAX tree here is the unboxed JAX layout (``repro.nn.params.unbox(
init_model(...))[0]``, and ``{"params", "opt": OptState}`` for training
state) with numpy or torch leaves: the caller converts JAX arrays to numpy,
so this module needs neither JAX nor the JAX package. Weights keep their
(d_in, d_out) layout (the port computes ``x @ w`` as JAX does). The
scanned stack ``blocks/sub<k>`` (leading axis ``n_scan_blocks``) is split
into ``layers.<block * period + k>`` and ``tail<i>`` becomes
``layers.<n_scan_blocks * period + i>``; the way back stacks them again.

``checkpoint/manifest.py`` stores trees in this layout, so checkpoints
pass between the two packages: :func:`train_state_to_jax` before a save,
:func:`load_train_state` after a restore.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.config import ArchConfig
from repro_torch.models.transformer import Model
from repro_torch.optim.adamw import OptState


def _flatten(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flatten(v, f"{prefix}{k}.")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten(v, f"{prefix}{i}.")
    elif tree is not None:
        yield prefix[:-1], tree


def _port_leaves(tree, cfg: ArchConfig) -> dict:
    """JAX leaves under the port's parameter names (``Model.state_dict``).
    A 0-d leaf of the scanned stack (the error-feedback placeholder of an
    uncompressed optimizer) stands for every layer of the stack."""
    out = {}
    for name, arr in _flatten(tree):
        head, _, rest = name.partition(".")
        if head == "blocks":
            sub, _, rest = rest.partition(".")
            k = int(sub.removeprefix("sub"))
            if arr.ndim and arr.shape[0] != cfg.n_scan_blocks:
                raise ValueError(f"JAX leaf {name}: leading axis "
                                 f"{arr.shape[0]} != n_scan_blocks "
                                 f"{cfg.n_scan_blocks}")
            for blk in range(cfg.n_scan_blocks):
                out[f"layers.{blk * cfg.period + k}.{rest}"] = (
                    arr[blk] if arr.ndim else arr)
        elif head.startswith("tail"):
            i = int(head.removeprefix("tail"))
            out[f"layers.{cfg.n_scan_blocks * cfg.period + i}.{rest}"] = arr
        else:
            out[name] = arr
    return out


def _check_names(got: dict, want: dict, what: str) -> None:
    extra = sorted(set(got) - set(want))
    missing = sorted(set(want) - set(got))
    if extra or missing:
        raise ValueError(f"{what} does not match the port's parameters: "
                         f"unconsumed JAX leaves {extra}, unset port "
                         f"parameters {missing}")


def _as_torch(v) -> torch.Tensor:
    """A tensor view of a tensor or numpy leaf (bf16 from ``ml_dtypes``
    included)."""
    if isinstance(v, torch.Tensor):
        return v
    a = np.asarray(v)
    if not a.flags.writeable:         # torch warns on read-only memory
        a = a.copy()
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _tensor(v, device, dtype=None) -> torch.Tensor:
    """A fresh tensor (never sharing the caller's numpy or tensor memory),
    in ``dtype`` or the leaf's own."""
    t = _as_torch(v)
    return t.to(device=device, dtype=dtype or t.dtype, copy=True)


def _leaves_by_name(tree, cfg: ArchConfig, want: dict, what: str) -> dict:
    leaves = _port_leaves(tree, cfg)
    _check_names(leaves, want, what)
    return leaves


def params_from_jax(tree, cfg: ArchConfig, device="cuda") -> Model:
    """Build the port's model holding exactly the JAX parameters. Raises if
    a JAX leaf has no port parameter, a port parameter gets no JAX leaf,
    or a shape differs."""
    model = Model(cfg, device="meta")
    want = dict(model.state_dict())
    leaves = _leaves_by_name(tree, cfg, want, "JAX tree")
    for name, arr in leaves.items():
        if tuple(arr.shape) != tuple(want[name].shape):
            raise ValueError(f"{name}: JAX shape {tuple(arr.shape)} != port "
                             f"shape {tuple(want[name].shape)}")
    dtype = getattr(torch, cfg.param_dtype)
    state = {k: _tensor(v, device, dtype) for k, v in leaves.items()}
    model.load_state_dict(state, assign=True)
    return model


# ---------------------------------------------------------- the way back
def _jax_tree(flat: dict, cfg: ArchConfig) -> dict:
    """Port-named tensors (one per parameter) → the nested JAX layout:
    layers stacked into ``blocks/sub<k>`` (0-d leaves kept 0-d, see
    :func:`_port_leaves`), the rest as they are; a numeric path segment is
    a list index (the RPE MLP's ``layers``)."""
    per = cfg.period
    n_scan = cfg.n_scan_blocks * per
    paths = {}
    for name, t in flat.items():
        head, _, rest = name.partition(".")
        if head != "layers":
            paths[name] = t
            continue
        i_s, _, rest = rest.partition(".")
        i = int(i_s)
        if i >= n_scan:
            paths[f"tail{i - n_scan}.{rest}"] = t
        elif i < per:                  # first block: gather the stack
            stack = [flat[f"layers.{blk * per + i}.{rest}"]
                     for blk in range(cfg.n_scan_blocks)]
            paths[f"blocks.sub{i}.{rest}"] = (torch.stack(stack)
                                              if t.dim() else t)
    root: dict = {}
    for path, t in paths.items():
        node, keys = root, path.split(".")
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = t
    return _lists(root)


def _lists(node):
    """Dicts whose keys are all digits become lists, in index order."""
    if not isinstance(node, dict):
        return node
    kids = {k: _lists(v) for k, v in node.items()}
    if kids and all(k.isdigit() for k in kids):
        return [kids[k] for k in sorted(kids, key=int)]
    return kids


def params_to_jax(model: Model) -> dict:
    """The model's parameters in the JAX layout (detached tensors on the
    model's device; the scanned stack is a new stacked tensor)."""
    return _jax_tree({k: p.detach() for k, p in model.named_parameters()},
                     model.cfg)


def opt_to_jax(opt: OptState, cfg: ArchConfig) -> OptState:
    """The optimizer state with each moment tree in the JAX layout."""
    return OptState(opt.step, *(_jax_tree(t, cfg)
                                for t in (opt.mu, opt.nu, opt.err)))


def opt_from_jax(tree: OptState, cfg: ArchConfig, device) -> OptState:
    """A JAX-layout ``OptState`` (numpy or tensor leaves) → the port's, on
    ``device``. Raises on a missing or unconsumed leaf."""
    names = dict(Model(cfg, device="meta").named_parameters())
    trees = []
    for what, sub in zip(("mu", "nu", "err"), tree[1:]):
        leaves = _leaves_by_name(sub, cfg, names, f"JAX optimizer {what}")
        trees.append({k: _tensor(leaves[k], device) for k in names})
    return OptState(_tensor(tree[0], device, torch.int32), *trees)


def train_state_to_jax(model: Model, opt: OptState) -> dict:
    """``{"params", "opt"}`` in the JAX layout: the tree that
    ``repro.checkpoint.manifest`` saves for the JAX trainer."""
    return {"params": params_to_jax(model), "opt": opt_to_jax(opt, model.cfg)}


@torch.no_grad()
def load_train_state(model: Model, tree: dict) -> OptState:
    """Copy ``tree["params"]`` (JAX layout) into the model's parameters in
    place and return ``tree["opt"]`` as the port's OptState on the model's
    device. Raises on a missing, unconsumed or mis-shaped leaf."""
    cfg = model.cfg
    params = dict(model.named_parameters())
    leaves = _leaves_by_name(tree["params"], cfg, params, "JAX params")
    for k, p in params.items():
        if tuple(leaves[k].shape) != tuple(p.shape):
            raise ValueError(f"{k}: JAX shape {tuple(leaves[k].shape)} != "
                             f"port shape {tuple(p.shape)}")
        p.copy_(_as_torch(leaves[k]))
    return opt_from_jax(tree["opt"], cfg, params["embed"].device)
