"""Serving and training observability, counterpart of ``repro/obs``:

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
  and annotations around prefill waves, decode steps and train steps
  (``REPRO_PROFILE_DIR``).

The kernel tier sits underneath:

* :mod:`repro_torch.obs.cost` — analytic per-kernel FLOP/byte estimators
  keyed off the ski/tno plan dicts, the H100's published peaks, roofline
  math, and ``flop_cost`` (``FlopCounterMode``; JAX's ``xla_cost``).
* :mod:`repro_torch.obs.devstats` — kernel regions at the dispatch sites
  and in the autograd Functions' backwards, profiler-trace aggregation
  (device time on the card) / analytic attribution into
  ``repro_kernel_seconds_total{kernel}``, and the memory gauges the
  scheduler samples every ``REPRO_MEM_SAMPLE_EVERY`` steps.
* :mod:`repro_torch.obs.compilewatch` — the compile/retrace watchdog
  (``repro_compiles_total{fn}`` + compile-seconds histogram + budget
  warnings) over the memoised entry points; the port's "compile" is the
  first call at a new argument signature.
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
from repro_torch.obs.cost import (Cost, Peaks, achieved_fraction,
                                  cost_of_plan, decode_step_cost, flop_cost,
                                  peaks)
from repro_torch.obs.compilewatch import CompileWatch
from repro_torch.obs.devstats import (aggregate_chrome, attribute_engine,
                                      kernel_region, mem_sample_every,
                                      sample_memory)

__all__ = [
    "Registry", "NullRegistry", "NULL_REGISTRY", "MirroredCounts",
    "default_registry", "set_default_registry", "metrics_enabled",
    "Tracer", "default_tracer", "set_default_tracer", "load_jsonl",
    "chrome_trace", "write_chrome", "validate_spans",
    "get_logger", "set_level", "banner",
    "profile_dir", "session", "annotation",
    "Cost", "Peaks", "peaks", "cost_of_plan", "decode_step_cost",
    "achieved_fraction", "flop_cost",
    "CompileWatch",
    "kernel_region", "aggregate_chrome", "attribute_engine",
    "mem_sample_every", "sample_memory",
]
