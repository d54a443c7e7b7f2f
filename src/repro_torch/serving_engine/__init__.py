"""Continuous-batching serving engine, counterpart of
``repro/serving_engine``: the slot-based decode state (``state.py``) and
the engine's prefill → insert → generate loop over the ragged decode path
(``engine.py``): length-bucketed and packed prefill, per-slot sampling
lanes and the non-finite guard with slot quarantine. The JAX package's
scheduler, snapshot, fault injector and metrics are a later slice.
"""
from repro_torch.serving_engine.engine import Engine, default_slots
from repro_torch.serving_engine.state import (DecodeState, init_decode_state,
                                              insert, insert_prefix_cache,
                                              poison, release, select_rows,
                                              take_row)

__all__ = [
    "Engine", "default_slots", "DecodeState", "init_decode_state", "insert",
    "insert_prefix_cache", "poison", "release", "select_rows", "take_row",
]
