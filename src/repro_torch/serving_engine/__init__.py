"""Continuous-batching serving engine, counterpart of
``repro/serving_engine``: the slot-based decode state (``state.py``),
the engine's prefill → insert → generate loop over the ragged decode path
(``engine.py``: length-bucketed and packed prefill, per-slot sampling
lanes, the non-finite guard with slot quarantine), and the supervised
host loop that serves a queue through it (``scheduler.py``: packed
admission, an asynchronous detokenise worker, request isolation with
retries, deadlines, a bounded queue, SIGTERM preemption with
snapshot/restore (``snapshot.py``), the seeded ``FaultInjector``
(``faults.py``), metrics and request spans).
"""
from repro_torch.serving_engine.engine import Engine, default_slots
from repro_torch.serving_engine.faults import (FaultInjector, FaultSpec,
                                               InjectedFault)
from repro_torch.serving_engine.scheduler import (EngineStepError, Outcome,
                                                  QueueFull, Request,
                                                  Scheduler,
                                                  default_detok_async,
                                                  default_prefill_pack)
from repro_torch.serving_engine.snapshot import load_snapshot, save_snapshot
from repro_torch.serving_engine.state import (DecodeState, init_decode_state,
                                              insert, insert_prefix_cache,
                                              poison, release, select_rows,
                                              take_row)

__all__ = [
    "Engine", "default_slots", "Request", "Scheduler", "Outcome",
    "QueueFull", "EngineStepError", "FaultInjector", "FaultSpec",
    "InjectedFault", "load_snapshot", "save_snapshot", "DecodeState",
    "init_decode_state", "insert", "insert_prefix_cache", "poison",
    "release", "select_rows", "take_row", "default_prefill_pack",
    "default_detok_async",
]
