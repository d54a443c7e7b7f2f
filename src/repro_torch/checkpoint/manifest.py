"""Manifest checkpoints, counterpart of ``repro/checkpoint/manifest.py``
with the same on-disk layout, so a checkpoint written by either package
loads in the other::

    ckpt_dir/
      step_000123/
        manifest.json        # structure string, n_leaves, shapes, dtypes
        data/leaf_<i>.npy    # one file per leaf
      step_000123.COMMITTED  # atomic commit marker (written last)
      LATEST                 # text file: last committed step

Leaves are numbered in the order ``jax.tree.flatten`` gives them: dict
keys sorted, tuples, lists and NamedTuples in order, ``None`` holding no
leaf. A tree here is made of those containers with ``torch.Tensor`` or
numpy leaves; ``bridge.train_state_to_jax`` puts the port's model and
optimizer state in the JAX package's layout first. bf16 (which numpy
cannot hold) is stored as raw bytes (``"stored": "raw_u8"``) with its
logical dtype, as the JAX package stores it.

Atomicity as in the JAX package: every leaf file, the manifest and the
directories are fsync'd before the step directory is renamed into place
and the COMMITTED marker and LATEST are written; restore reads only
committed steps. ``AsyncCheckpointer`` copies the state to host memory
synchronously and writes it in a background thread.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Callable, Optional

import numpy as np
import torch

_NP_NATIVE = {"float64", "float32", "float16", "int64", "int32", "int16",
              "int8", "uint64", "uint32", "uint16", "uint8", "bool",
              "complex64", "complex128"}


# ------------------------------------------------------------ tree helpers
def tree_leaves(tree) -> list:
    """Leaves in ``jax.tree.flatten`` order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    if tree is None:
        return []
    return [tree]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and of same-structured ``rest``),
    keeping the structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, v, *(r[i] for r in rest))
               for i, v in enumerate(tree)]
        if hasattr(tree, "_fields"):                 # NamedTuple
            return type(tree)(*out)
        return type(tree)(out)
    if tree is None:
        return None
    return fn(tree, *rest)


def _treedef_str(tree) -> str:
    """The structure as ``str(jax.tree.structure(tree))`` prints it."""
    def s(t):
        if isinstance(t, dict):
            return "{" + ", ".join(f"{k!r}: {s(t[k])}"
                                   for k in sorted(t)) + "}"
        if hasattr(t, "_fields"):
            return (f"CustomNode(namedtuple[{type(t).__name__}], ["
                    + ", ".join(s(v) for v in t) + "])")
        if isinstance(t, list):
            return "[" + ", ".join(s(v) for v in t) + "]"
        if isinstance(t, tuple):
            return "(" + ", ".join(s(v) for v in t) + ("," if len(t) == 1
                                                       else "") + ")"
        return "None" if t is None else "*"
    return f"PyTreeDef({s(tree)})"


def to_host(tree):
    """A copy of ``tree`` in host memory: tensors become CPU tensors that
    share no storage with the originals (so a background write never sees
    a later in-place update), numpy leaves are copied."""
    return tree_map(lambda x: (x.detach().to("cpu", copy=True)
                               if isinstance(x, torch.Tensor)
                               else np.array(x)), tree)


def _as_stored(leaf):
    """(array to np.save, logical dtype string, stored tag)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        dtype = str(t.dtype).removeprefix("torch.")
        if dtype not in _NP_NATIVE:
            return t.reshape(-1).view(torch.uint8).numpy(), dtype, "raw_u8"
        return t.numpy(), dtype, dtype
    arr = np.asarray(leaf)
    return arr, str(arr.dtype), str(arr.dtype)


# ------------------------------------------------------------------- save
def _fsync_file(f):
    f.flush()
    os.fsync(f.fileno())


def _fsync_dir(path: str):
    """fsync a directory so renames/creates inside it are durable before
    the commit marker goes down."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def save(ckpt_dir: str, step: int, tree: Any, *, extra: Optional[dict] = None):
    """Synchronous atomic save of a tree of tensors / arrays."""
    leaves = tree_leaves(tree)
    step_dir = os.path.join(ckpt_dir, f"step_{step:09d}")
    tmp_dir = step_dir + ".tmp"
    if os.path.exists(tmp_dir):
        shutil.rmtree(tmp_dir)
    os.makedirs(os.path.join(tmp_dir, "data"), exist_ok=True)

    manifest = {
        "step": step,
        "treedef": _treedef_str(tree),
        "n_leaves": len(leaves),
        "leaves": [],
        "extra": extra or {},
    }
    for i, leaf in enumerate(leaves):
        to_store, dtype, stored = _as_stored(leaf)
        fname = f"leaf_{i:06d}.npy"
        # every data file is fsync'd before the COMMITTED marker exists
        with open(os.path.join(tmp_dir, "data", fname), "wb") as f:
            np.save(f, to_store)
            _fsync_file(f)
        shape = (list(leaf.shape) if isinstance(leaf, torch.Tensor)
                 else list(np.shape(leaf)))
        manifest["leaves"].append(
            {"file": fname, "shape": shape, "dtype": dtype, "stored": stored})
    with open(os.path.join(tmp_dir, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        _fsync_file(f)
    _fsync_dir(os.path.join(tmp_dir, "data"))
    _fsync_dir(tmp_dir)

    if os.path.exists(step_dir):
        shutil.rmtree(step_dir)
    os.rename(tmp_dir, step_dir)                       # atomic on POSIX
    _fsync_dir(ckpt_dir)
    marker = step_dir + ".COMMITTED"
    with open(marker, "w") as f:
        f.write(str(step))
        _fsync_file(f)
    latest_tmp = os.path.join(ckpt_dir, "LATEST.tmp")
    with open(latest_tmp, "w") as f:
        f.write(str(step))
        _fsync_file(f)
    os.rename(latest_tmp, os.path.join(ckpt_dir, "LATEST"))
    _fsync_dir(ckpt_dir)
    return step_dir


def _committed_steps(ckpt_dir: str) -> list:
    return sorted(int(p.split("_")[1].split(".")[0])
                  for p in os.listdir(ckpt_dir) if p.endswith(".COMMITTED"))


def latest_step(ckpt_dir: str) -> Optional[int]:
    path = os.path.join(ckpt_dir, "LATEST")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        step = int(f.read().strip())
    if os.path.exists(os.path.join(ckpt_dir, f"step_{step:09d}.COMMITTED")):
        return step
    # LATEST points at an uncommitted step (crash window): scan backwards
    steps = _committed_steps(ckpt_dir)
    return steps[-1] if steps else None


# ---------------------------------------------------------------- restore
def _load_leaf(step_dir: str, meta: dict) -> torch.Tensor:
    arr = np.load(os.path.join(step_dir, "data", meta["file"]))
    t = torch.from_numpy(arr)
    if meta.get("stored") == "raw_u8":
        t = (t.reshape(-1).view(getattr(torch, meta["dtype"]))
             .reshape(meta["shape"]))
    return t


def restore(ckpt_dir: str, tree_like: Any, *, step: Optional[int] = None):
    """Restore into the structure of ``tree_like`` (tensors): each leaf
    takes its ``like``'s dtype and device. Raises ``ValueError`` if the
    leaf count or a shape differs. Returns (tree, extra)."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint in {ckpt_dir}")
    step_dir = os.path.join(ckpt_dir, f"step_{step:09d}")
    with open(os.path.join(step_dir, "manifest.json")) as f:
        manifest = json.load(f)
    leaves_like = tree_leaves(tree_like)
    if manifest["n_leaves"] != len(leaves_like):
        raise ValueError(
            f"checkpoint has {manifest['n_leaves']} leaves, "
            f"model expects {len(leaves_like)}")
    out = []
    for meta, like in zip(manifest["leaves"], leaves_like):
        t = _load_leaf(step_dir, meta)
        if tuple(t.shape) != tuple(like.shape):
            raise ValueError(f"leaf {meta['file']}: shape mismatch "
                             f"{tuple(t.shape)} vs {tuple(like.shape)}")
        out.append(t.to(device=like.device, dtype=like.dtype))
    it = iter(out)
    return _fill(tree_like, it), manifest["extra"]


def _fill(like, it):
    """``like``'s structure with the next leaves of ``it``, consumed in
    :func:`tree_leaves` order (sorted dict keys)."""
    if isinstance(like, dict):
        filled = {k: _fill(like[k], it) for k in sorted(like)}
        return {k: filled[k] for k in like}
    if isinstance(like, (list, tuple)):
        out = [_fill(v, it) for v in like]
        return type(like)(*out) if hasattr(like, "_fields") else type(like)(out)
    return None if like is None else next(it)


# ------------------------------------------------------------------ async
class AsyncCheckpointer:
    """Double-buffered async saver: snapshot now, write in background."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        os.makedirs(ckpt_dir, exist_ok=True)

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def save_async(self, step: int, tree: Any, *, extra: Optional[dict] = None):
        self.wait()                                    # block on previous save
        host_tree = to_host(tree)

        def _work():
            try:
                save(self.ckpt_dir, step, host_tree, extra=extra)
                self._gc()
            except BaseException as e:   # surfaced on next wait()
                self._error = e

        self._thread = threading.Thread(target=_work, daemon=True)
        self._thread.start()

    def _gc(self):
        for s in _committed_steps(self.ckpt_dir)[: -self.keep]:
            base = os.path.join(self.ckpt_dir, f"step_{s:09d}")
            shutil.rmtree(base, ignore_errors=True)
            try:
                os.remove(base + ".COMMITTED")
            except FileNotFoundError:
                pass
