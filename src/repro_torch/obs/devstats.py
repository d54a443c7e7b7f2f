"""Memory gauges for the serving loop, counterpart of the memory half of
``repro/obs/devstats.py`` (its kernel regions and trace attribution are
not ported).

:func:`sample_memory` publishes live device bytes, DecodeState cache
bytes, and the FD ring/spectra slice of the cache as gauges; the
scheduler samples it every ``REPRO_MEM_SAMPLE_EVERY`` steps (0 = off, the
default). Live device bytes are ``torch.cuda.memory_allocated`` of the
state's card; on the CPU that gauge is left unset, as the JAX package
leaves it when ``jax.live_arrays`` gives nothing.
"""
from __future__ import annotations

import os
from typing import Dict, Optional

from repro_torch.obs import metrics as obs_metrics

_ENV_MEM_EVERY = "REPRO_MEM_SAMPLE_EVERY"

#: DecodeState cache leaves that belong to the FD streaming decode path
#: (overlap-save ring + block/tail spectra) — see serving_engine/state.py
FD_STREAM_LEAVES = ("ring", "tail", "uspec_re", "uspec_im")


def mem_sample_every() -> int:
    v = os.environ.get(_ENV_MEM_EVERY)
    if v is None or v == "":
        return 0
    try:
        return max(int(v), 0)
    except ValueError:
        raise ValueError(f"{_ENV_MEM_EVERY}={v!r} is not an int") from None


def _cache_bytes(cache, names: Optional[tuple] = None) -> int:
    """Sum ``nbytes`` over the cache's tensors (a list of per-layer leaf
    dicts); with ``names``, only leaves of those names."""
    return sum(leaf.nbytes for lc in cache for name, leaf in lc.items()
               if names is None or name in names)


def sample_memory(metrics=None, state=None, *,
                  reuse: Optional[dict] = None) -> Dict[str, float]:
    """Publish the memory gauges: live device bytes on the state's card
    (``torch.cuda.memory_allocated``; unset on the CPU), DecodeState cache
    bytes, and the FD ring/spectra slice of the cache. Returns the
    sampled values.

    ``reuse`` (a caller-held dict) caches the cache byte sums: the
    DecodeState cache is fixed-shape for the lifetime of a drain, so the
    walk happens once and later samples republish the cached sizes; only
    the live total is re-measured each time."""
    reg = metrics if metrics is not None else obs_metrics.default_registry()
    out: Dict[str, float] = {}
    cache = getattr(state, "cache", None) if state is not None else None
    device = None
    if cache:
        device = next(iter(cache[0].values())).device
    live = 0
    if device is not None and device.type == "cuda":
        import torch
        live = int(torch.cuda.memory_allocated(device))
    if live:
        reg.gauge("repro_live_device_bytes",
                  "bytes allocated on the serving card").set(live)
        out["repro_live_device_bytes"] = float(live)
    if cache is not None:
        if reuse is not None and "cache_bytes" in reuse:
            cb, fd = reuse["cache_bytes"], reuse["fd_bytes"]
        else:
            cb = _cache_bytes(cache)
            fd = _cache_bytes(cache, FD_STREAM_LEAVES)
            if reuse is not None:
                reuse["cache_bytes"], reuse["fd_bytes"] = cb, fd
        reg.gauge("repro_decode_cache_bytes",
                  "DecodeState cache bytes across slots").set(cb)
        out["repro_decode_cache_bytes"] = float(cb)
        if fd:
            reg.gauge("repro_fd_stream_bytes",
                      "fd overlap-save ring + spectra bytes").set(fd)
            out["repro_fd_stream_bytes"] = float(fd)
    return out


__all__ = ["FD_STREAM_LEAVES", "sample_memory", "mem_sample_every"]
