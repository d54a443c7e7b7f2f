"""Opt-in ``torch.profiler`` sessions around serving step regions,
counterpart of ``repro/obs/profiling.py`` (which opens ``jax.profiler``).

Set ``REPRO_PROFILE_DIR=/path`` and the scheduler brackets its run loop
in a ``torch.profiler`` session (CPU activities, and CUDA activities when
a card is present) that exports a Chrome trace into that directory, with
named ``record_function`` regions around prefill waves and decode steps
so the device timeline is attributable to serving phases. With the
variable unset every hook is a no-op ``nullcontext``.

The profiler can fail to start (a second concurrent session, a
read-only directory) or to export; ``session`` then logs a warning
instead of taking down the serving loop: observability must never become
the outage."""
from __future__ import annotations

import contextlib
import os
import time

from repro_torch.obs import log as obs_log

_ENV_DIR = "REPRO_PROFILE_DIR"


def profile_dir() -> str | None:
    v = os.environ.get(_ENV_DIR)
    return v or None


def _trace_path(d: str, name: str) -> str:
    """Where ``session(name)`` exports its Chrome trace inside ``d``: one
    file per session (process id and start time in the name)."""
    return os.path.join(d, f"{name}.{os.getpid()}.{time.time_ns()}"
                           ".trace.json")


@contextlib.contextmanager
def session(name: str = "run"):
    """Bracket a region in a ``torch.profiler`` session when
    ``REPRO_PROFILE_DIR`` is set and export its Chrome trace there; no-op
    otherwise. Yields whether a session started. Never raises."""
    d = profile_dir()
    if d is None:
        yield False
        return
    import torch
    lg = obs_log.get_logger("obs")
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = None
    try:
        os.makedirs(d, exist_ok=True)
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
        lg.info(f"profiler session '{name}' -> {d}")
    except Exception as e:  # noqa: BLE001 — never fail the serving loop
        prof = None
        lg.warning(f"profiler session '{name}' failed to start: {e!r}")
    try:
        yield prof is not None
    finally:
        if prof is not None:
            try:
                prof.__exit__(None, None, None)
                prof.export_chrome_trace(_trace_path(d, name))
            except Exception as e:  # noqa: BLE001
                lg.warning(f"profiler stop failed: {e!r}")


def annotation(name: str):
    """Named sub-region (a band on the profiler timeline). Cheap
    nullcontext when no profile dir is configured."""
    if profile_dir() is None:
        return contextlib.nullcontext()
    import torch
    return torch.profiler.record_function(name)


__all__ = ["profile_dir", "session", "annotation"]
