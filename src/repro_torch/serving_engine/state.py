"""Slot-based decode state for the continuous-batching engine, counterpart
of ``repro/serving_engine/state.py``.

A ``DecodeState`` is S *slots*, rows of one batched model cache, each
serving at most one request at its own position:

* ``cache``   — the port's model cache (``models/serving.init_cache``: one
  dict per layer) batched over S slots on dim 0 of every per-slot leaf;
* ``cur_len`` — (S,) int64 **on the host**: slot s's next write position.
  The FD stream step decides block boundaries from it without a device
  sync; ``decode_step`` moves it to the card once a step;
* ``tokens``  — (S,) int64 on the device: last emitted token per slot;
* ``active``  — (S,) bool on the host: slot liveness. Inactive slots are
  frozen (position, token and lane do not advance); their cache rows are
  scratch until the next insert overwrites them;
* ``rng``     — (S, 2) int64 on the device: per-slot sampling lanes (the
  key of the request's seed, the count of its draws so far; see
  ``models/sampling.py``). Only advancing steps draw, so a request's
  sampled stream depends only on (params, prompt, seed, temperature,
  top_k), never on its neighbours, its slot or when it was admitted.

The cache's leaves are classified by name, as in JAX: per-slot leaves
(:data:`PER_SLOT_LEAVES`, batch on dim 0) and leaves shared by every slot
(:data:`SHARED_LEAVES`: the kernel constants and the capacity marker, the
same for any request under the same params and max_len, realised once and
held read-only by every state and template). An unclassified leaf raises:
treating a new per-slot leaf as shared would leak a recycled slot's
previous occupant. Every update is functional: it returns new tensors and
writes in place only into tensors it has just made, leaf by leaf in each
leaf's own dtype (a hybrid's cache holds bf16 KV and conv rows beside
fp32 SSD state).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models import serving

#: per-slot leaves (batch on dim 0): attention KV k/v (b, max_len, kvh,
#: hd); FD stream ring/tail (b, C, d) and block spectra (b, NB, F, d); the
#: hist-replay history (b, max_len, d); Mamba conv window (b, w-1,
#: conv_dim) and SSD state (b, h, p, s)
PER_SLOT_LEAVES = frozenset(
    {"k", "v", "ring", "tail", "uspec_re", "uspec_im", "hist", "conv",
     "state"})

#: parameter-derived leaves shared by every slot: the FD stream's kernel
#: constants, the hist replay's causal taps ``kcoef`` and the capacity
#: marker
SHARED_LEAVES = frozenset(
    {"khead", "khs_re", "khs_im", "kseg_re", "kseg_im", "kcoef", "cap"})


@dataclasses.dataclass(frozen=True)
class DecodeState:
    cache: list            # model cache, batched over S slots
    cur_len: torch.Tensor  # (S,) int64, host — next write position per slot
    tokens: torch.Tensor   # (S,) int64, device — last emitted token
    active: torch.Tensor   # (S,) bool, host — slot liveness
    rng: torch.Tensor      # (S, 2) int64, device — (key, draws) lanes

    @property
    def slots(self) -> int:
        return self.cur_len.shape[0]


def _per_slot(leaf: str) -> bool:
    """True for a per-slot leaf, False for a shared one; an unclassified
    name raises (see the module docstring)."""
    if leaf in PER_SLOT_LEAVES:
        return True
    if leaf in SHARED_LEAVES:
        return False
    raise NotImplementedError(
        f"cache leaf {leaf!r} is not classified as per-slot "
        "(PER_SLOT_LEAVES) or shared (SHARED_LEAVES); add it before "
        "serving this cache through the engine")


def _map(fn, *caches) -> list:
    """Layer by layer, leaf by leaf: fn(name, leaf of each cache)."""
    return [{k: fn(k, *(lc[k] for lc in layers)) for k in layers[0]}
            for layers in zip(*caches)]


def batch_size(cache: list) -> int:
    """The number of rows of a cache (dim 0 of its per-slot leaves)."""
    return next(leaf.shape[0] for lc in cache for name, leaf in lc.items()
                if _per_slot(name))


def empty_cache(template: list, batch: int) -> list:
    """A zeroed cache of ``batch`` rows shaped like ``template``, holding
    the template's shared leaves themselves (not copies)."""
    def f(name, leaf):
        if not _per_slot(name):
            return leaf
        return torch.zeros((batch,) + leaf.shape[1:], dtype=leaf.dtype,
                           device=leaf.device)
    return _map(f, template)


def init_decode_state(cfg, params, slots: int, max_len: int, dtype=None,
                      template: list | None = None) -> DecodeState:
    """Fresh all-free state of S slot rows on the parameters' device.
    ``template`` (a cache of the same cfg, params and max_len) lends its
    shared leaves, so the kernel constants are not realised again;
    without it they are realised here."""
    if template is None:
        template = serving.init_cache(cfg, 1, max_len, params=params,
                                      dtype=dtype)
    device = params.embed.device
    return DecodeState(
        cache=empty_cache(template, slots),
        cur_len=torch.zeros(slots, dtype=torch.long),
        tokens=torch.zeros(slots, dtype=torch.long, device=device),
        active=torch.zeros(slots, dtype=torch.bool),
        rng=torch.zeros(slots, 2, dtype=torch.long, device=device),
    )


def select_rows(take: torch.Tensor, new_cache: list,
                old_cache: list) -> list:
    """Per-row merge: row b of the result is ``new_cache``'s where
    ``take[b]`` (a (b,) bool tensor on the cache's device) else
    ``old_cache``'s, one ``torch.where`` per per-slot leaf. Shared leaves
    take the new side (the same on both)."""
    def f(name, new, old):
        if not _per_slot(name):
            return new
        return torch.where(take.view((-1,) + (1,) * (new.dim() - 1)), new,
                           old)
    return _map(f, new_cache, old_cache)


def take_row(packed_cache: list, row: int) -> list:
    """Batch row ``row`` (kept, size 1) of a packed prefill cache: the
    batch-1 prefix cache :func:`insert_prefix_cache` takes. Per-slot
    leaves are views of the packed cache; shared leaves pass whole."""
    return _map(lambda name, leaf: leaf[row:row + 1] if _per_slot(name)
                else leaf, packed_cache)


def insert_prefix_cache(batched_cache: list, prefix_cache: list,
                        slot: int) -> list:
    """A copy of the batched cache with row ``slot`` of every per-slot
    leaf replaced by the batch-1 prefix cache's row; shared leaves keep
    the batched side's tensor."""
    def f(name, dst, src):
        if not _per_slot(name):
            return dst
        if src.shape[0] != 1 or src.shape[1:] != dst.shape[1:]:
            raise ValueError(f"prefix leaf {name!r} {tuple(src.shape)} does "
                             f"not fit a row of {tuple(dst.shape)}")
        out = dst.clone()
        out[slot] = src[0]
        return out
    return _map(f, batched_cache, prefix_cache)


def _set(t: torch.Tensor, slot: int, value) -> torch.Tensor:
    out = t.clone()
    out[slot] = value
    return out


def insert(state: DecodeState, prefix_cache: list, slot: int, cur_len: int,
           token, key: torch.Tensor | None = None) -> DecodeState:
    """Admit a prefilled request into ``slot``: slice its cache row in,
    set the slot's position to the prefix length, seed the first decode
    input with ``token`` (an int or a 0-d device tensor: no sync), mark
    the slot live. ``key`` ((2,) int64 lane) seeds the slot's sampling
    lane; None keeps the previous occupant's (a greedy engine never
    reads it)."""
    return DecodeState(
        cache=insert_prefix_cache(state.cache, prefix_cache, slot),
        cur_len=_set(state.cur_len, slot, int(cur_len)),
        tokens=_set(state.tokens, slot, token),
        active=_set(state.active, slot, True),
        rng=state.rng if key is None else _set(state.rng, slot, key),
    )


def release(state: DecodeState, slot: int) -> DecodeState:
    """Evict a finished request: the slot is frozen and its cache row is
    scratch until the next insert recycles it."""
    return dataclasses.replace(state, active=_set(state.active, slot, False))


def poison(state: DecodeState, slot: int) -> DecodeState:
    """Fault-injection hook: ``slot``'s per-slot floating-point cache rows
    become NaN, so the next decode step gives that row alone non-finite
    logits (rows are independent, the property ``insert`` rests on) and
    the engine's non-finite guard must quarantine it. Shared leaves are
    untouched."""
    def f(name, leaf):
        if not _per_slot(name) or not leaf.is_floating_point():
            return leaf
        return _set(leaf, slot, float("nan"))
    return dataclasses.replace(state, cache=_map(f, state.cache))
