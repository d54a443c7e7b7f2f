"""Bridge between the JAX package's parameter / training-state trees and
the port's model and optimizer state, both ways.

A JAX tree here is the unboxed JAX layout (``repro.nn.params.unbox(
init_model(...))[0]``, and ``{"params", "opt": OptState}`` for training
state) with numpy or torch leaves: the caller converts JAX arrays to numpy,
so this module needs neither JAX nor the JAX package. Weights keep their
(d_in, d_out) layout (the port computes ``x @ w`` as JAX does). The
scanned stack ``blocks/sub<k>`` (leading axis ``n_scan_blocks``) is split
into ``layers.<block * period + k>`` and ``tail<i>`` becomes
``layers.<n_scan_blocks * period + i>``; an encdec model's encoder stack
``enc_blocks`` (leading axis ``enc_layers``) becomes ``enc_layers.<i>``.
The way back stacks them again.
Every leaf keeps its own dtype both ways: a bf16 model's fp32 leaves
(norm scales, Mamba's ``a_log``, ``dt_bias``, ``d_skip``,
``norm_scale``) stay fp32, as the port's ``Model`` makes them.

``checkpoint/manifest.py`` stores trees in this layout, so checkpoints
pass between the two packages: :func:`train_state_to_jax` before a save,
:func:`load_train_state` after a restore. :func:`cache_from_jax` carries a
JAX serving cache (attention KV, FD stream, hist-replay and Mamba leaves,
mixed layer by layer in a hybrid such as jamba, each in its own dtype)
the same way into the port's list of per-layer caches, and
:func:`decode_state_from_jax` a JAX ``DecodeState`` (the serving engine's
slots) into the port's; the engine's snapshots store
:func:`decode_state_to_jax`'s layout, so a snapshot written by either
package's scheduler resumes in the port.

Sharded models (DTensor parameters, ``launch/steps.StepBuilder``):
:func:`params_from_jax` with a ``mesh`` places the carried weights on it
by the arch's sharding rules, :func:`load_train_state` puts weights and
moments with the model's placements, and the way back gathers full
tensors (every rank joins).
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from repro_torch.models.config import ArchConfig
from repro_torch.models.transformer import Model
from repro_torch.nn.layers import cast_params
from repro_torch.nn.params import param_axes
from repro_torch.optim.adamw import OptState
from repro_torch.parallel.sharding import (full, place_like, rules_for_arch,
                                           shard_as, shard_module,
                                           tree_shardings)
from repro_torch.serving_engine import state as st


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
        elif head == "enc_blocks":
            if arr.ndim and arr.shape[0] != cfg.enc_layers:
                raise ValueError(f"JAX leaf {name}: leading axis "
                                 f"{arr.shape[0]} != enc_layers "
                                 f"{cfg.enc_layers}")
            for i in range(cfg.enc_layers):
                out[f"enc_layers.{i}.{rest}"] = arr[i] if arr.ndim else arr
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


def _check_leaf(name: str, arr, want: torch.Tensor) -> None:
    """Raise unless a JAX leaf has the port parameter's shape and dtype."""
    if tuple(arr.shape) != tuple(want.shape):
        raise ValueError(f"{name}: JAX shape {tuple(arr.shape)} != port "
                         f"shape {tuple(want.shape)}")
    dtype = _as_torch(arr).dtype
    if dtype != want.dtype:
        raise ValueError(f"{name}: JAX dtype {dtype} != port dtype "
                         f"{want.dtype}")


def params_from_jax(tree, cfg: ArchConfig, device="cuda",
                    dtype: torch.dtype | None = None, *, mesh=None,
                    rules=None) -> Model:
    """Build the port's model holding exactly the JAX parameters, each in
    its leaf's own dtype. ``dtype``: the dtype JAX's ``cast_params`` gave
    the tree's floating leaves, which the port's model then takes through
    ``nn.layers.cast_params`` before the leaves are checked against it.
    ``mesh``: place each parameter on it (DTensor shards) by ``rules``
    (default ``rules_for_arch``), as ``StepBuilder.param_shardings``.
    Raises if a JAX leaf has no port parameter, a port parameter gets no
    JAX leaf, or a shape or dtype differs."""
    model = Model(cfg, device="meta")
    if dtype is not None:
        cast_params(model, dtype)
    want = dict(model.state_dict())
    leaves = _leaves_by_name(tree, cfg, want, "JAX tree")
    for name, arr in leaves.items():
        _check_leaf(name, arr, want[name])
    state = {k: _tensor(v, device) for k, v in leaves.items()}
    model.load_state_dict(state, assign=True)
    if mesh is not None:
        shard_module(model, tree_shardings(
            mesh, rules or rules_for_arch(cfg, mesh), param_axes(model),
            dict(model.named_parameters())))
    return model


#: the cache leaves the port's serving has: attention KV
#: (models/attention.decode_cache_init), FD overlap-save stream
#: (kernels/fd_stream.py; its leaf ``tail`` is not the layer prefix
#: ``tail<i>``), hist replay (models/serving.py) and Mamba
#: (models/mamba.mamba_cache_init)
_CACHE_LEAVES = frozenset({"k", "v", "ring", "tail", "uspec_re",
                           "uspec_im", "khead", "khs_re", "khs_im",
                           "kseg_re", "kseg_im", "cap", "hist", "kcoef",
                           "conv", "state"})


def cache_from_jax(tree, cfg: ArchConfig, device="cuda",
                   shared: list | None = None) -> list:
    """A JAX serving cache (``repro.models.serving.init_cache`` layout:
    scanned ``blocks/sub<k>`` leaves with a leading layer axis, and
    ``tail<i>`` layers; numpy or tensor leaves) → the port's list of
    per-layer cache dicts on ``device``, each leaf a fresh tensor in its
    own dtype. ``shared`` (a port cache of the same cfg, params and
    max_len) lends its shared leaves (``state.SHARED_LEAVES``: the kernel
    constants, the hist replay's taps and the capacity marker) themselves
    in place of copies of the JAX ones, each checked for the JAX leaf's
    shape. Raises on a leaf the port's caches do not have or a layer left
    without one."""
    layers = [{} for _ in range(cfg.n_layers)]
    for name, arr in _port_leaves(tree, cfg).items():
        head, i_s, leaf = name.split(".")
        if head != "layers" or leaf not in _CACHE_LEAVES:
            raise ValueError(f"JAX cache leaf {name!r} has no port "
                             "counterpart")
        i = int(i_s)
        if shared is not None and leaf in st.SHARED_LEAVES:
            t = shared[i][leaf]
            if tuple(t.shape) != tuple(arr.shape):
                raise ValueError(f"JAX cache leaf {name}: shape "
                                 f"{tuple(arr.shape)} != the shared "
                                 f"leaf's {tuple(t.shape)}")
            layers[i][leaf] = t
        else:
            layers[i][leaf] = _tensor(arr, device)
    empty = [i for i, lc in enumerate(layers) if not lc]
    if empty:
        raise ValueError(f"JAX cache has no leaves for layers {empty}")
    return layers


class JaxDecodeState(NamedTuple):
    """A ``DecodeState`` in the JAX package's layout: ``cache`` a JAX
    serving-cache tree, the rest (S,) or (S, 2) arrays. Its fields are in
    the order JAX flattens its ``DecodeState``, so a checkpoint manifest
    of either holds the same leaves in the same order."""
    cache: Any
    cur_len: Any
    tokens: Any
    active: Any
    rng: Any


def decode_state_from_jax(state, cfg: ArchConfig, device="cuda", *,
                          template: list | None = None) -> st.DecodeState:
    """A JAX ``DecodeState`` (``repro.serving_engine.state``, or a
    :class:`JaxDecodeState`; numpy or tensor leaves) → the port's on
    ``device``: the cache through :func:`cache_from_jax`, ``cur_len``
    (int64) and ``active`` (bool) on the host, ``tokens`` (int64) on the
    device. ``template`` (the Engine's batch-1 cache) lends its kernel
    constants, as every state of one Engine shares them, so none is
    realised or copied again. The sampling lanes start at zero: JAX's
    uint32 PRNG keys have no counterpart in the port's counter-hash
    sampler (a greedy engine never reads them, and the scheduler re-derives
    a restored request's lane from its seed and token count)."""
    cur_len = _as_torch(state.cur_len).to(torch.int64, copy=True)
    active = _as_torch(state.active).to(torch.bool, copy=True)
    if cur_len.dim() != 1 or active.shape != cur_len.shape:
        raise ValueError(f"DecodeState cur_len {tuple(cur_len.shape)} and "
                         f"active {tuple(active.shape)} are not (S,)")
    cache = cache_from_jax(state.cache, cfg, device, shared=template)
    if st.batch_size(cache) != cur_len.shape[0]:
        raise ValueError(f"DecodeState cache has {st.batch_size(cache)} "
                         f"rows for {cur_len.shape[0]} slots")
    return st.DecodeState(
        cache=cache, cur_len=cur_len,
        tokens=_tensor(state.tokens, device, torch.int64),
        active=active,
        rng=torch.zeros(cur_len.shape[0], 2, dtype=torch.int64,
                        device=device))


def decode_state_to_jax(state: st.DecodeState,
                        cfg: ArchConfig) -> JaxDecodeState:
    """The port's ``DecodeState`` in the JAX layout (tensors on the state's
    devices; the layers' leaves stacked into new tensors). ``rng`` holds
    the port's (key, draws) lanes, which JAX's sampler cannot use."""
    flat = {f"layers.{i}.{k}": v for i, lc in enumerate(state.cache)
            for k, v in lc.items()}
    return JaxDecodeState(_jax_tree(flat, cfg), state.cur_len, state.tokens,
                          state.active, state.rng)


# ---------------------------------------------------------- the way back
def _jax_tree(flat: dict, cfg: ArchConfig) -> dict:
    """Port-named tensors (one per parameter) → the nested JAX layout:
    layers stacked into ``blocks/sub<k>`` and the encoder's into
    ``enc_blocks`` (0-d leaves kept 0-d, see :func:`_port_leaves`), the
    rest as they are; a numeric path segment is a list index (the RPE
    MLP's ``layers``)."""
    per = cfg.period
    n_scan = cfg.n_scan_blocks * per
    paths = {}
    for name, t in flat.items():
        head, _, rest = name.partition(".")
        if head == "enc_layers":
            i_s, _, rest = rest.partition(".")
            if i_s == "0":             # the first layer gathers the stack
                stack = [flat[f"enc_layers.{i}.{rest}"]
                         for i in range(cfg.enc_layers)]
                paths[f"enc_blocks.{rest}"] = (torch.stack(stack)
                                               if t.dim() else t)
            continue
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
    model's device, a DTensor's full value; the scanned stack is a new
    stacked tensor)."""
    return _jax_tree({k: full(p.detach())
                      for k, p in model.named_parameters()}, model.cfg)


def opt_to_jax(opt: OptState, cfg: ArchConfig) -> OptState:
    """The optimizer state with each moment tree in the JAX layout (a
    DTensor moment's full value)."""
    return OptState(opt.step, *(_jax_tree({k: full(v) for k, v in t.items()},
                                          cfg)
                                for t in (opt.mu, opt.nu, opt.err)))


def opt_from_jax(tree: OptState, cfg: ArchConfig, device,
                 like: dict | None = None) -> OptState:
    """A JAX-layout ``OptState`` (numpy or tensor leaves) → the port's, on
    ``device``; with ``like`` (the model's parameters by name), each
    moment of a parameter's shape is placed as that parameter is (a
    DTensor's mesh and placements). Raises on a missing or unconsumed
    leaf."""
    names = dict(Model(cfg, device="meta").named_parameters())
    trees = []
    for what, sub in zip(("mu", "nu", "err"), tree[1:]):
        leaves = _leaves_by_name(sub, cfg, names, f"JAX optimizer {what}")
        t = {k: _tensor(leaves[k], device) for k in names}
        if like is not None:
            t = {k: (shard_as(v, like[k]) if isinstance(like[k], DTensor)
                     and v.shape == like[k].shape else v)
                 for k, v in t.items()}
        trees.append(t)
    return OptState(_tensor(tree[0], device, torch.int32), *trees)


def train_state_to_jax(model: Model, opt: OptState) -> dict:
    """``{"params", "opt"}`` in the JAX layout: the tree that
    ``repro.checkpoint.manifest`` saves for the JAX trainer."""
    return {"params": params_to_jax(model), "opt": opt_to_jax(opt, model.cfg)}


@torch.no_grad()
def load_train_state(model: Model, tree: dict) -> OptState:
    """Copy ``tree["params"]`` (JAX layout) into the model's parameters in
    place and return ``tree["opt"]`` as the port's OptState on the model's
    device. Raises on a missing, unconsumed, mis-shaped or mis-typed
    leaf."""
    cfg = model.cfg
    params = dict(model.named_parameters())
    leaves = _leaves_by_name(tree["params"], cfg, params, "JAX params")
    for k, p in params.items():
        _check_leaf(k, leaves[k], p)
        p.copy_(place_like(_as_torch(leaves[k]), p)
                if isinstance(p, DTensor) else _as_torch(leaves[k]))
    return opt_from_jax(tree["opt"], cfg, params["embed"].device, like=params)
