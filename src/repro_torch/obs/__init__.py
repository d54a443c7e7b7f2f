"""Serving observability, counterpart of the host half of ``repro/obs``:

* :mod:`repro_torch.obs.metrics` — counters / gauges / fixed-bucket
  histograms under a thread-safe registry, with Prometheus text
  exposition and a JSON dump. The process default registry is a no-op
  unless ``REPRO_METRICS`` is truthy or an explicit registry is passed.
* :mod:`repro_torch.obs.tracing` — per-request lifecycle span events,
  JSONL on disk via ``REPRO_TRACE_FILE``, exportable to Chrome
  ``trace_event`` JSON for chrome://tracing / Perfetto.
* :mod:`repro_torch.obs.log` — the one logger of the port's status lines
  (``REPRO_LOG_LEVEL``; quiet by default under pytest).
* :mod:`repro_torch.obs.profiling` — opt-in ``torch.profiler`` sessions
  and annotations around prefill waves and decode steps
  (``REPRO_PROFILE_DIR``).
* :mod:`repro_torch.obs.devstats` — the memory gauges the scheduler
  samples every ``REPRO_MEM_SAMPLE_EVERY`` steps.

The JAX package's kernel tier (``cost``, the rest of ``devstats``,
``compilewatch``) is not ported.
"""
from repro_torch.obs.metrics import (NULL_REGISTRY, MirroredCounts,
                                     NullRegistry, Registry,
                                     default_registry, metrics_enabled,
                                     set_default_registry)
from repro_torch.obs.tracing import (Tracer, chrome_trace, default_tracer,
                                     load_jsonl, set_default_tracer,
                                     validate_spans, write_chrome)
from repro_torch.obs.log import banner, get_logger, set_level
from repro_torch.obs.profiling import annotation, profile_dir, session
from repro_torch.obs.devstats import mem_sample_every, sample_memory

__all__ = [
    "Registry", "NullRegistry", "NULL_REGISTRY", "MirroredCounts",
    "default_registry", "set_default_registry", "metrics_enabled",
    "Tracer", "default_tracer", "set_default_tracer", "load_jsonl",
    "chrome_trace", "write_chrome", "validate_spans",
    "get_logger", "set_level", "banner",
    "profile_dir", "session", "annotation",
    "mem_sample_every", "sample_memory",
]
