"""Host-side metrics registry: counters, gauges, fixed-bucket histograms,
a copy of ``repro/obs/metrics.py`` (which needs no JAX, but the port
imports nothing of the JAX package). Metric names, label sets, the
Prometheus text and the JSON dump are the same as the JAX package's, so a
dashboard reads both alike.

The serving/training observability substrate. Three
instrument kinds, all **host-side floats under one registry lock** — an
``inc``/``observe`` on the decode hot path is a dict lookup and a float
add, never a device sync, never an allocation after the first call for a
given label set:

* :class:`Counter` — monotone ``inc(n)``; per-label-set children.
* :class:`Gauge` — ``set``/``inc``/``dec``; last-write-wins.
* :class:`Histogram` — fixed cumulative buckets chosen at registration
  (Prometheus ``le`` semantics: ``observe(x)`` increments every bucket
  with ``x <= le``, plus ``sum`` and ``count``).

Exports:

* :meth:`Registry.render_prometheus` — the text exposition format
  (``# HELP`` / ``# TYPE`` / samples) that ``promtool``/Prometheus
  scrape; histograms emit ``_bucket{le=...}``/``_sum``/``_count``.
* :meth:`Registry.to_dict` / :meth:`Registry.dump_json` — a JSON mirror
  for reports and test assertions.

**Off-by-default-cheap**: the process-wide default registry
(:func:`default_registry`) is a real :class:`Registry` only when
``REPRO_METRICS`` is truthy; otherwise it is :data:`NULL_REGISTRY`,
whose instruments are shared no-op singletons — an un-instrumented run
pays one attribute load and a no-op call per site. Launchers/tests that
want metrics regardless of the env construct an explicit
:class:`Registry` and pass it down (``Scheduler(metrics=...)``,
``Engine(metrics=...)``, ``Trainer`` via its registry argument).

Registration is idempotent: asking for an existing name returns the
existing collector (kind and labelnames must match — a silent kind
collision would corrupt the exposition).
"""
from __future__ import annotations

import atexit
import json
import os
import threading
from typing import Dict, Iterable, Optional, Sequence, Tuple

_ENV_METRICS = "REPRO_METRICS"
_ENV_METRICS_FILE = "REPRO_METRICS_FILE"

#: default histogram buckets (seconds) — serving latencies span ~100µs
#: (one CPU smoke decode step) to ~10s (a cold packed prefill compile)
DEFAULT_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                   0.25, 0.5, 1.0, 2.5, 5.0, 10.0)


def metrics_enabled() -> bool:
    v = os.environ.get(_ENV_METRICS)
    if v is None or v == "":
        return False
    return v.strip().lower() not in ("0", "false", "off", "no")


def _check_name(name: str):
    if not name or not all(c.isalnum() or c == "_" for c in name):
        raise ValueError(f"metric name {name!r}: want [a-zA-Z0-9_]+ "
                         "(Prometheus exposition identifier)")


def _escape(v: str) -> str:
    return str(v).replace("\\", "\\\\").replace('"', '\\"').replace(
        "\n", "\\n")


def _fmt(x: float) -> str:
    """Prometheus sample value: integers render without the trailing .0
    (``17`` not ``17.0``) — promtool accepts both, humans prefer one."""
    f = float(x)
    return str(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


class _Child:
    """One label-set's value cell. All mutation under the parent lock."""

    __slots__ = ("_metric", "_labels", "value", "bucket_counts", "sum",
                 "count")

    def __init__(self, metric: "_Metric", labels: Tuple[str, ...]):
        self._metric = metric
        self._labels = labels
        self.value = 0.0
        if metric.kind == "histogram":
            self.bucket_counts = [0] * len(metric.buckets)
            self.sum = 0.0
            self.count = 0

    # ---- counter / gauge
    def inc(self, n: float = 1.0):
        if self._metric.kind == "counter" and n < 0:
            raise ValueError(f"counter {self._metric.name}: inc({n}) < 0")
        with self._metric._lock:
            self.value += n

    def dec(self, n: float = 1.0):
        if self._metric.kind != "gauge":
            raise TypeError(f"{self._metric.kind} {self._metric.name} "
                            "has no dec()")
        with self._metric._lock:
            self.value -= n

    def set(self, v: float):
        if self._metric.kind != "gauge":
            raise TypeError(f"{self._metric.kind} {self._metric.name} "
                            "has no set()")
        with self._metric._lock:
            self.value = float(v)

    # ---- histogram
    def observe(self, x: float):
        if self._metric.kind != "histogram":
            raise TypeError(f"{self._metric.kind} {self._metric.name} "
                            "has no observe()")
        x = float(x)
        with self._metric._lock:
            for i, le in enumerate(self._metric.buckets):
                if x <= le:
                    self.bucket_counts[i] += 1
            self.sum += x
            self.count += 1

    def get(self) -> float:
        with self._metric._lock:
            return self.count if self._metric.kind == "histogram" \
                else self.value


class _Metric:
    """One named collector (counter | gauge | histogram) with labeled
    children. ``labels(**kw)`` memoises the child per label-value tuple
    so the hot path after the first call is a dict hit."""

    def __init__(self, name: str, help: str, kind: str,
                 labelnames: Sequence[str] = (),
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        _check_name(name)
        for ln in labelnames:
            _check_name(ln)
        self.name = name
        self.help = help
        self.kind = kind
        self.labelnames = tuple(labelnames)
        if kind == "histogram":
            bs = tuple(sorted(float(b) for b in buckets))
            if len(set(bs)) != len(bs) or not bs:
                raise ValueError(f"histogram {name}: buckets must be "
                                 f"non-empty and strictly increasing: {bs}")
            self.buckets = bs
        else:
            self.buckets = ()
        self._lock = threading.Lock()
        self._children: Dict[Tuple[str, ...], _Child] = {}
        if not self.labelnames:          # unlabeled: one eager child
            self._children[()] = _Child(self, ())

    def labels(self, **kw) -> _Child:
        if set(kw) != set(self.labelnames):
            raise ValueError(
                f"{self.name}: labels {sorted(kw)} != declared "
                f"{sorted(self.labelnames)}")
        key = tuple(str(kw[ln]) for ln in self.labelnames)
        child = self._children.get(key)
        if child is None:
            with self._lock:
                child = self._children.setdefault(key, _Child(self, key))
        return child

    # unlabeled convenience: metric.inc() == metric.labels().inc()
    def _solo(self) -> _Child:
        if self.labelnames:
            raise ValueError(f"{self.name} has labels {self.labelnames}; "
                             "use .labels(...)")
        return self._children[()]

    def inc(self, n: float = 1.0):
        self._solo().inc(n)

    def dec(self, n: float = 1.0):
        self._solo().dec(n)

    def set(self, v: float):
        self._solo().set(v)

    def observe(self, x: float):
        self._solo().observe(x)

    def get(self, **kw) -> float:
        return (self.labels(**kw) if kw else self._solo()).get()

    def samples(self) -> Iterable[tuple]:
        """(suffix, label_pairs, value) rows, snapshot under the lock."""
        with self._lock:
            items = sorted(self._children.items())
            for key, ch in items:
                pairs = tuple(zip(self.labelnames, key))
                if self.kind == "histogram":
                    # bucket_counts[i] is already cumulative (observe
                    # increments every bucket x fits under), matching
                    # Prometheus `le` semantics — emit directly
                    for le, c in zip(self.buckets, ch.bucket_counts):
                        yield ("_bucket", pairs + (("le", _fmt(le)),), c)
                    yield ("_bucket", pairs + (("le", "+Inf"),), ch.count)
                    yield ("_sum", pairs, ch.sum)
                    yield ("_count", pairs, ch.count)
                else:
                    yield ("", pairs, ch.value)


class Registry:
    """Named collectors under one roof; see module docstring."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Metric] = {}

    def _register(self, name, help, kind, labelnames, buckets) -> _Metric:
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if m.kind != kind or m.labelnames != tuple(labelnames):
                    raise ValueError(
                        f"metric {name} re-registered as {kind}"
                        f"{tuple(labelnames)} but exists as {m.kind}"
                        f"{m.labelnames}")
                return m
            m = _Metric(name, help, kind, labelnames, buckets)
            self._metrics[name] = m
            return m

    def counter(self, name: str, help: str = "",
                labelnames: Sequence[str] = ()) -> _Metric:
        return self._register(name, help, "counter", labelnames, ())

    def gauge(self, name: str, help: str = "",
              labelnames: Sequence[str] = ()) -> _Metric:
        return self._register(name, help, "gauge", labelnames, ())

    def histogram(self, name: str, help: str = "",
                  labelnames: Sequence[str] = (),
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> _Metric:
        return self._register(name, help, "histogram", labelnames, buckets)

    def get(self, name: str) -> Optional[_Metric]:
        with self._lock:
            return self._metrics.get(name)

    def collect(self):
        with self._lock:
            return sorted(self._metrics.values(), key=lambda m: m.name)

    # ------------------------------------------------------------- export
    def render_prometheus(self) -> str:
        """Text exposition format (version 0.0.4)."""
        out = []
        for m in self.collect():
            if m.help:
                out.append(f"# HELP {m.name} {_escape(m.help)}")
            out.append(f"# TYPE {m.name} {m.kind}")
            for suffix, pairs, value in m.samples():
                if pairs:
                    lbl = ",".join(f'{k}="{_escape(v)}"' for k, v in pairs)
                    out.append(f"{m.name}{suffix}{{{lbl}}} {_fmt(value)}")
                else:
                    out.append(f"{m.name}{suffix} {_fmt(value)}")
        return "\n".join(out) + ("\n" if out else "")

    def to_dict(self) -> dict:
        """JSON mirror: {name: {kind, help, labelnames, series: [...]}}.
        Histogram series carry buckets/counts/sum/count; scalar series a
        single value."""
        out = {}
        for m in self.collect():
            series = []
            with m._lock:
                for key, ch in sorted(m._children.items()):
                    row = {"labels": dict(zip(m.labelnames, key))}
                    if m.kind == "histogram":
                        row.update(buckets=list(m.buckets),
                                   counts=list(ch.bucket_counts),
                                   sum=ch.sum, count=ch.count)
                    else:
                        row["value"] = ch.value
                    series.append(row)
            out[m.name] = {"kind": m.kind, "help": m.help,
                           "labelnames": list(m.labelnames),
                           "series": series}
        return out

    def dump_json(self, path: str):
        with open(path, "w") as f:
            json.dump({"version": 1, "metrics": self.to_dict()}, f,
                      indent=1, sort_keys=True)
            f.write("\n")

    def dump_prometheus(self, path: str):
        with open(path, "w") as f:
            f.write(self.render_prometheus())


# ------------------------------------------------------------ null objects
class _NoopChild:
    __slots__ = ()

    def inc(self, n: float = 1.0):
        pass

    def dec(self, n: float = 1.0):
        pass

    def set(self, v: float):
        pass

    def observe(self, x: float):
        pass

    def get(self, **kw) -> float:
        return 0.0

    def labels(self, **kw) -> "_NoopChild":
        return self


_NOOP = _NoopChild()


class NullRegistry:
    """The disabled default: every instrument is one shared no-op."""

    def counter(self, *a, **kw):
        return _NOOP

    def gauge(self, *a, **kw):
        return _NOOP

    def histogram(self, *a, **kw):
        return _NOOP

    def get(self, name):
        return None

    def collect(self):
        return []

    def render_prometheus(self) -> str:
        return ""

    def to_dict(self) -> dict:
        return {}

    def dump_json(self, path: str):
        with open(path, "w") as f:
            json.dump({"version": 1, "metrics": {}}, f)
            f.write("\n")

    def dump_prometheus(self, path: str):
        with open(path, "w") as f:
            f.write("")


NULL_REGISTRY = NullRegistry()

_default: Registry | NullRegistry | None = None
_default_lock = threading.Lock()
_atexit_registered = False


def _dump_default_registry() -> None:
    """atexit hook: final metrics dump to ``REPRO_METRICS_FILE`` —
    without it a process that exits mid-run (chaos kills, cron smoke
    jobs) leaves no exposition at all. ``.json``
    suffix selects the JSON mirror, anything else the Prometheus text
    format (matching ``launch/serve.py --metrics-file``)."""
    path = os.environ.get(_ENV_METRICS_FILE)
    with _default_lock:
        reg = _default
    if not path or reg is None:
        return
    try:
        if path.endswith(".json"):
            reg.dump_json(path)
        else:
            reg.dump_prometheus(path)
    except Exception:  # noqa: BLE001 — never fail interpreter exit
        pass


def default_registry():
    """The process-wide registry: real when ``REPRO_METRICS`` is truthy
    at first use (or when ``REPRO_METRICS_FILE`` names a final dump
    target, which implies metrics), else the shared
    :data:`NULL_REGISTRY`. Explicit registries passed to
    Scheduler/Engine/Trainer bypass this. When ``REPRO_METRICS_FILE``
    is set, an ``atexit`` hook writes the final exposition there."""
    global _default, _atexit_registered
    if _default is None:
        with _default_lock:
            if _default is None:
                want = metrics_enabled() or bool(
                    os.environ.get(_ENV_METRICS_FILE))
                _default = Registry() if want else NULL_REGISTRY
                if want and not _atexit_registered:
                    atexit.register(_dump_default_registry)
                    _atexit_registered = True
    return _default


def set_default_registry(reg) -> None:
    """Programmatic override (tests, launchers); None re-resolves from
    the environment on next use. The final-dump atexit hook follows
    whatever the default is at exit."""
    global _default, _atexit_registered
    with _default_lock:
        _default = reg
        if reg is not None and not _atexit_registered and \
                os.environ.get(_ENV_METRICS_FILE):
            atexit.register(_dump_default_registry)
            _atexit_registered = True


class MirroredCounts(dict):
    """A plain dict of int counters that mirrors increments into a
    labeled registry counter — the bridge that keeps the engine's
    test-pinned ``trace_counts[name]`` reads working while the same
    counts appear in ``/metrics`` output."""

    def __init__(self, initial: dict, counter, label: str):
        super().__init__(initial)
        self._counter = counter
        self._label = label

    def __setitem__(self, key, value):
        old = dict.get(self, key, 0)
        if value > old:
            self._counter.labels(**{self._label: key}).inc(value - old)
        dict.__setitem__(self, key, value)


__all__ = ["Registry", "NullRegistry", "NULL_REGISTRY", "MirroredCounts",
           "DEFAULT_BUCKETS", "default_registry", "set_default_registry",
           "metrics_enabled"]
