"""Compile/retrace watchdog for the memoised entry points, counterpart of
``repro/obs/compilewatch.py``.

Every serving and training entry point is shape-memoised by construction:
the engine's prefill runs ≤ 2 shapes per (batch, bucket), the trainer one
train_step shape. In the JAX package a call outside those families is a
fresh jit trace, seconds of XLA time on the hot path. The port runs
eagerly, so its "trace" is the first call at a new argument signature:
the shape, dtype and device of each tensor argument and the value of every
other argument (the engine's ``_trace`` applies the same rule). That first
call is where the port pays its own one-off costs: the kernel libraries'
lazy load, cuFFT plans, cuBLAS handles and allocator growth.

:class:`CompileWatch` wraps an entry point so every such first call is:

* counted into ``repro_compiles_total{fn}``,
* timed into the ``repro_compile_seconds{fn}`` histogram (on the card the
  timing ends in a ``torch.cuda.synchronize``, so it holds the first
  call's device work, not only its enqueue),
* checked against the ceiling declared by :meth:`expect`, warning through
  the obs logger the moment a function exceeds its shape-family budget.

:meth:`CompileWatch._mark` records a first call that was not timed: the
engine's ``_trace`` feeds it, so ``repro_compiles_total{fn="engine.*"}``
equals ``trace_counts``.
"""
from __future__ import annotations

import dataclasses
import functools
import threading
import time
from typing import Callable, Dict, Optional

from repro_torch.obs import log as obs_log
from repro_torch.obs import metrics as obs_metrics

#: compile latencies span ~50ms (tiny CPU smoke graphs) to minutes
#: (a first call that builds kernels) — wider than the serving-latency
#: default
COMPILE_BUCKETS = (0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
                   60.0, 120.0, 300.0)


def _signature(v, cuda: list):
    """Hashable signature of one argument: tensors by (shape, dtype,
    device), containers element by element, other values as themselves
    (by identity where unhashable). CUDA devices seen are appended to
    ``cuda``."""
    import torch
    if isinstance(v, torch.Tensor):
        if v.device.type == "cuda":
            cuda.append(v.device)
        return ("tensor", tuple(v.shape), str(v.dtype), str(v.device))
    if isinstance(v, dict):
        return ("dict", tuple((k, _signature(x, cuda))
                              for k, x in sorted(v.items(), key=lambda kv:
                                                 str(kv[0]))))
    if isinstance(v, (list, tuple)):
        return (type(v).__name__, tuple(_signature(x, cuda) for x in v))
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        return (type(v).__name__,
                tuple(_signature(getattr(v, f.name), cuda)
                      for f in dataclasses.fields(v)))
    try:
        hash(v)
    except TypeError:
        return ("id", type(v).__name__, id(v))
    return v


class CompileWatch:
    """Watches a family of entry points for first calls at new argument
    signatures (the port's compiles).

    ``wrap(name, fn)`` returns a callable with ``fn``'s signature;
    ``expect(name, n)`` declares the shape-family ceiling (the warning
    threshold — counting is unconditional). ``counts()`` is the host-side
    mirror for tests.
    """

    def __init__(self, metrics=None, *, prefix: str = "",
                 logger=None):
        reg = metrics if metrics is not None \
            else obs_metrics.default_registry()
        self.prefix = prefix
        self._m_compiles = reg.counter(
            "repro_compiles_total",
            "fresh jit traces (compiles) per wrapped entry point",
            ("fn",))
        self._m_seconds = reg.histogram(
            "repro_compile_seconds",
            "wall seconds of calls that triggered a fresh trace "
            "(trace + compile + first run)",
            ("fn",), buckets=COMPILE_BUCKETS)
        self._log = logger or obs_log.get_logger("obs")
        self._lock = threading.Lock()
        self._counts: Dict[str, int] = {}
        self._expected: Dict[str, int] = {}
        self._seen: Dict[str, set] = {}

    # ------------------------------------------------------------ config
    def expect(self, name: str, max_traces: int) -> None:
        """Declare the retrace budget: warn when ``name`` exceeds it."""
        self._expected[name] = int(max_traces)

    def counts(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._counts)

    def count(self, name: str) -> int:
        with self._lock:
            return self._counts.get(name, 0)

    # ---------------------------------------------------------- recording
    def _record(self, name: str, seconds: Optional[float]) -> None:
        with self._lock:
            self._counts[name] = n = self._counts.get(name, 0) + 1
        label = self.prefix + name
        self._m_compiles.labels(fn=label).inc()
        if seconds is not None:
            self._m_seconds.labels(fn=label).observe(seconds)
        exp = self._expected.get(name)
        if exp is not None and n > exp:
            self._log.warning(
                f"compile watchdog: {label} retraced ({n} traces > "
                f"expected {exp}) — a shape outside the memoised family "
                "reached this entry point")

    def _mark(self, name: str) -> None:
        """Record a first call at a new signature that was not timed (the
        engine's ``_trace`` calls this): counted, no latency."""
        self._record(name, None)

    # ------------------------------------------------------------- wrap
    def wrap(self, name: str, fn: Callable) -> Callable:
        """``fn`` with compile accounting: a call whose argument signature
        this name has not seen is timed (ending in a synchronise of the
        card its tensors are on) and recorded."""

        @functools.wraps(fn)
        def call(*args, **kwargs):
            cuda: list = []
            sig = _signature((args, kwargs), cuda)
            with self._lock:
                seen = self._seen.setdefault(name, set())
                fresh = sig not in seen
                seen.add(sig)
            if not fresh:
                return fn(*args, **kwargs)
            t0 = time.perf_counter()
            try:
                out = fn(*args, **kwargs)
                if cuda:
                    import torch
                    torch.cuda.synchronize(cuda[0])
                return out
            finally:
                self._record(name, time.perf_counter() - t0)

        call.watch_name = name
        return call


__all__ = ["CompileWatch", "COMPILE_BUCKETS"]
