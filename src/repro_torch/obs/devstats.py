"""Device-time attribution + memory gauges, counterpart of
``repro/obs/devstats.py``.

Three concerns, all cheap when off like the rest of the obs tier:

* **Kernel regions** — :func:`kernel_region` wraps every entry of
  ``kernels/ops.py`` and the backward of each autograd Function behind
  them in a ``torch.profiler.record_function`` named
  ``repro_kernel.<kernel>`` while ``REPRO_PROFILE_DIR`` is set, and is a
  ``nullcontext`` otherwise. The port runs eagerly, so a region costs
  something on every call (JAX's named scope cost only at trace time):
  hence off unless a profile is being taken.
* **Attribution** — on a profiled run, :func:`aggregate_chrome` sums each
  region's seconds out of a Chrome trace (the profiler's, or our own
  exporter's). On the card a region's time is device time: the
  ``gpu_user_annotation`` events the profiler writes on the stream for
  each ``record_function`` range, or, where those are absent, each kernel
  event attributed to the region its launch was made in (the launch's
  ``correlation`` id). A card trace whose regions have no device events
  raises; it is never read as host ranges. Where no profile is taken,
  :func:`attribute_engine` takes the *measured* engine seconds (the
  scheduler's ``repro_decode_step_seconds`` / ``repro_prefill_seconds``
  histogram sums) and splits them across kernel families by the analytic
  FLOP shares of :func:`repro_torch.obs.cost.decode_step_cost`. Either
  path records into ``repro_kernel_seconds_total{kernel}`` and a
  per-kernel ``repro_kernel_roofline_frac`` gauge.
* **Memory gauges** — :func:`sample_memory` publishes live device bytes,
  DecodeState cache bytes, and the FD ring/spectra slice of the cache as
  gauges; the scheduler samples it every ``REPRO_MEM_SAMPLE_EVERY`` steps
  (0 = off, the default). Live device bytes are
  ``torch.cuda.memory_allocated`` of the state's card; on the CPU that
  gauge is left unset, as the JAX package leaves it when
  ``jax.live_arrays`` gives nothing.
"""
from __future__ import annotations

import bisect
import gzip
import json
import os
from pathlib import Path
from typing import Dict, Iterable, List, Optional

from repro_torch.obs import cost as obs_cost
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import profiling as obs_prof

#: record_function prefix for kernel regions — the aggregator keys off it
KERNEL_SCOPE_PREFIX = "repro_kernel."

_ENV_MEM_EVERY = "REPRO_MEM_SAMPLE_EVERY"

#: DecodeState cache leaves that belong to the FD streaming decode path
#: (overlap-save ring + block/tail spectra) — see serving_engine/state.py
FD_STREAM_LEAVES = ("ring", "tail", "uspec_re", "uspec_im")

#: Chrome-trace categories of the card's own events (kernels, copies,
#: fills, and the profiler's device-side ranges of record_function), and
#: of the host calls that launch them
_DEVICE_WORK = ("kernel", "gpu_memcpy", "gpu_memset")
_DEVICE_ANNOTATION = "gpu_user_annotation"
_LAUNCH = ("cuda_runtime", "cuda_driver")


def mem_sample_every() -> int:
    v = os.environ.get(_ENV_MEM_EVERY)
    if v is None or v == "":
        return 0
    try:
        return max(int(v), 0)
    except ValueError:
        raise ValueError(f"{_ENV_MEM_EVERY}={v!r} is not an int") from None


# ------------------------------------------------------------ regions
def kernel_region(kernel: str):
    """Mark a kernel dispatch site: a ``record_function`` named
    ``repro_kernel.<kernel>`` while ``REPRO_PROFILE_DIR`` is set (the
    profiler then places it on the host timeline and, for the kernels
    launched inside, on the card's), a ``nullcontext`` otherwise. Errors
    raised inside pass through."""
    return obs_prof.annotation(KERNEL_SCOPE_PREFIX + kernel)


# ------------------------------------------------ trace aggregation
def _cat(ev: dict) -> str:
    return str(ev.get("cat", "")).lower()


def _host_totals(events: Iterable[dict], prefix: str) -> Dict[str, float]:
    """JAX's aggregation: complete events (``X`` with ``dur`` µs) and
    ``B``/``E`` pairs stacked per (pid, tid, name), for names starting
    with ``prefix`` (stripped); the card's events are left out."""
    totals: Dict[str, float] = {}
    open_b: Dict[tuple, List[float]] = {}
    for ev in events:
        name = ev.get("name", "")
        if not isinstance(name, str) or not name.startswith(prefix):
            continue
        if _cat(ev) == _DEVICE_ANNOTATION:
            continue
        kernel = name[len(prefix):]
        ph = ev.get("ph")
        if ph == "X":
            totals[kernel] = totals.get(kernel, 0.0) \
                + float(ev.get("dur", 0.0)) * 1e-6
        elif ph == "B":
            key = (ev.get("pid"), ev.get("tid"), kernel)
            open_b.setdefault(key, []).append(float(ev["ts"]))
        elif ph == "E":
            key = (ev.get("pid"), ev.get("tid"), kernel)
            stack = open_b.get(key)
            if stack:
                totals[kernel] = totals.get(kernel, 0.0) \
                    + (float(ev["ts"]) - stack.pop()) * 1e-6
    return totals


def region_kernels(events: Iterable[dict],
                   prefix: str = KERNEL_SCOPE_PREFIX) -> Dict[str, dict]:
    """The card's work of each region, by the ``correlation`` id that ties
    each kernel (copy, fill) event to the host call that launched it: a
    launch made inside a region's host range (on the same thread; the
    innermost range where regions nest) is that region's. Returns
    ``{region: {device event name: [count, seconds]}}``."""
    ranges: Dict[tuple, list] = {}
    launches: Dict[object, tuple] = {}
    work = []
    for ev in events:
        cat = _cat(ev)
        if cat in _DEVICE_WORK:
            work.append(ev)
            continue
        args = ev.get("args") or {}
        if cat in _LAUNCH and "correlation" in args:
            launches[args["correlation"]] = (ev.get("pid"), ev.get("tid"),
                                            float(ev["ts"]))
            continue
        name = ev.get("name", "")
        if (ev.get("ph") == "X" and cat != _DEVICE_ANNOTATION
                and isinstance(name, str) and name.startswith(prefix)):
            t0 = float(ev["ts"])
            ranges.setdefault((ev.get("pid"), ev.get("tid")), []).append(
                (t0, t0 + float(ev.get("dur", 0.0)), name[len(prefix):]))
    for rs in ranges.values():
        rs.sort()
    starts = {key: [r[0] for r in rs] for key, rs in ranges.items()}
    out: Dict[str, dict] = {}
    for ev in work:
        launch = launches.get((ev.get("args") or {}).get("correlation"))
        if launch is None:
            continue
        key, ts = launch[:2], launch[2]
        rs = ranges.get(key)
        if not rs:
            continue
        region = None
        for i in range(bisect.bisect_right(starts[key], ts) - 1, -1, -1):
            if rs[i][0] <= ts <= rs[i][1]:
                region = rs[i][2]
                break
        if region is None:
            continue
        acc = out.setdefault(region, {}).setdefault(ev.get("name", ""),
                                                   [0, 0.0])
        acc[0] += 1
        acc[1] += float(ev.get("dur", 0.0)) * 1e-6
    return out


def aggregate_chrome(events: Iterable[dict],
                     prefix: str = KERNEL_SCOPE_PREFIX) -> Dict[str, float]:
    """Sum per-region seconds from Chrome ``trace_event`` records (the
    profiler's ``*.trace.json``, or our own exporter's output). Returns
    ``{kernel: seconds}`` for region names starting with ``prefix``
    (stripped).

    A trace without the card's events (a CPU profile, a synthetic or
    exported host trace) is read as JAX reads one: complete events (``X``
    with ``dur`` µs) and ``B``/``E`` pairs. A trace with them gives device
    time: the ``gpu_user_annotation`` ranges of the regions where the
    profiler wrote them, else the kernel events attributed to each region
    through their launches' correlation ids (:func:`region_kernels`).
    There, a region seen on the host with no device time raises."""
    events = list(events)
    cats = {_cat(ev) for ev in events}
    if not cats & {*_DEVICE_WORK, _DEVICE_ANNOTATION}:
        return _host_totals(events, prefix)
    totals: Dict[str, float] = {}
    for ev in events:
        name = ev.get("name", "")
        if (_cat(ev) == _DEVICE_ANNOTATION and ev.get("ph") == "X"
                and isinstance(name, str) and name.startswith(prefix)):
            kernel = name[len(prefix):]
            totals[kernel] = totals.get(kernel, 0.0) \
                + float(ev.get("dur", 0.0)) * 1e-6
    if not totals:
        totals = {region: sum(s for _, s in by_name.values())
                  for region, by_name in region_kernels(events,
                                                        prefix).items()}
    missing = sorted(set(_host_totals(events, prefix)) - set(totals))
    if missing:
        raise ValueError(
            f"the trace holds the card's events but none for the kernel "
            f"regions {missing}: a host range is not device time")
    return totals


def load_profile_traces(profile_dir: str) -> List[dict]:
    """Collect ``traceEvents`` from every ``*.trace.json[.gz]`` under a
    profiler session directory (``obs/profiling.session`` exports one file
    per session)."""
    events: List[dict] = []
    root = Path(profile_dir)
    for p in sorted(root.rglob("*.trace.json")) + \
            sorted(root.rglob("*.trace.json.gz")):
        try:
            if p.suffix == ".gz":
                with gzip.open(p, "rt") as f:
                    doc = json.load(f)
            else:
                with open(p) as f:
                    doc = json.load(f)
        except (OSError, ValueError):
            continue
        events.extend(doc.get("traceEvents", []))
    return events


def record_kernel_seconds(seconds_by_kernel: Dict[str, float],
                          metrics=None) -> None:
    """Accumulate attributed seconds into
    ``repro_kernel_seconds_total{kernel}``."""
    reg = metrics if metrics is not None else obs_metrics.default_registry()
    m = reg.counter("repro_kernel_seconds_total",
                    "attributed device/engine seconds per kernel family",
                    ("kernel",))
    for kernel, s in seconds_by_kernel.items():
        if s > 0:
            m.labels(kernel=kernel).inc(s)


# ------------------------------------------------------ attribution
def _hist_sum(reg, name: str) -> float:
    m = reg.get(name) if hasattr(reg, "get") else None
    if m is None or getattr(m, "kind", None) != "histogram":
        return 0.0
    with m._lock:
        return sum(ch.sum for ch in m._children.values())


def attribute_engine(engine, metrics, *, drain_s: Optional[float] = None,
                     profile_dir: Optional[str] = None) -> dict:
    """Split measured engine seconds across kernel families and record
    them.

    Ground truth seconds come from the scheduler's own histograms —
    ``repro_decode_step_seconds`` + ``repro_prefill_seconds`` sums, which
    time the engine calls to their host results. When a profiler trace is
    given (``profile_dir``) and holds kernel regions, their seconds are
    used directly (the "profile" path); otherwise the decode seconds are
    projected onto families by the analytic FLOP shares of one decode step
    (:func:`repro_torch.obs.cost.decode_step_cost` for the engine's arch;
    the "analytic" path). Records ``repro_kernel_seconds_total{kernel}`` +
    ``repro_kernel_roofline_frac{kernel}`` and returns::

        {"device_s", "coverage", "path", "rows": [
            {"kernel", "seconds", "frac", "roofline_frac"}, ...]}

    ``coverage`` is device_s / drain_s (None when drain_s not given).
    """
    step_s = _hist_sum(metrics, "repro_decode_step_seconds")
    prefill_s = _hist_sum(metrics, "repro_prefill_seconds")
    device_s = step_s + prefill_s

    by_kernel: Dict[str, float] = {}
    if profile_dir:
        by_kernel = aggregate_chrome(load_profile_traces(profile_dir))
    path = "profile" if by_kernel else "analytic"
    if not by_kernel and device_s > 0:
        cfg = engine.cfg
        costs = obs_cost.decode_step_cost(cfg, engine.slots, engine.max_len)
        flops_total = sum(c.flops for c in costs.values()) or 1.0
        by_kernel = {k: step_s * (c.flops / flops_total)
                     for k, c in costs.items()}
        if prefill_s > 0:
            # prefill is one fused forward over the prompt — same family
            # mix at n=bucket length; reuse the step shares
            for k, c in costs.items():
                by_kernel[k] = by_kernel.get(k, 0.0) \
                    + prefill_s * (c.flops / flops_total)
    record_kernel_seconds(by_kernel, metrics)

    pk = obs_cost.peaks(dtype=engine.params.embed.dtype)
    costs = obs_cost.decode_step_cost(engine.cfg, engine.slots,
                                      engine.max_len)
    # steps executed ≈ decode-step histogram count
    m = metrics.get("repro_decode_step_seconds") if hasattr(
        metrics, "get") else None
    n_steps = 0
    if m is not None and getattr(m, "kind", None) == "histogram":
        with m._lock:
            n_steps = sum(ch.count for ch in m._children.values())
    frac_gauge = metrics.gauge(
        "repro_kernel_roofline_frac",
        "achieved fraction of the roofline bound per kernel family",
        ("kernel",))
    total_s = sum(by_kernel.values()) or 1.0
    rows = []
    for kernel, s in sorted(by_kernel.items(), key=lambda kv: -kv[1]):
        rf = None
        c = costs.get(kernel)
        if c is not None and n_steps > 0 and s > 0:
            rf = obs_cost.achieved_fraction(c.scale(n_steps), s, pk)
            frac_gauge.labels(kernel=kernel).set(rf)
        rows.append({"kernel": kernel, "seconds": s,
                     "frac": s / total_s, "roofline_frac": rf})
    return {"device_s": device_s,
            "coverage": (device_s / drain_s) if drain_s else None,
            "path": path, "rows": rows}


# --------------------------------------------------------- memory gauges
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


__all__ = ["kernel_region", "KERNEL_SCOPE_PREFIX", "FD_STREAM_LEAVES",
           "aggregate_chrome", "region_kernels", "load_profile_traces",
           "record_kernel_seconds", "attribute_engine", "sample_memory",
           "mem_sample_every"]
