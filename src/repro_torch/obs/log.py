"""One obs-aware logger for the port's status lines, a copy of
``repro/obs/log.py`` rooted at ``"repro_torch"`` (the JAX package's is
``"repro"``; both read the same knob).

Scheduler supervision messages go through one stdlib logger tree rooted
at ``"repro_torch"`` with a single knob:

* ``REPRO_LOG_LEVEL`` — DEBUG | INFO | WARNING | ERROR (or a numeric
  level). Default: **INFO**, except **WARNING under pytest** (detected
  via ``PYTEST_CURRENT_TEST`` / an imported ``pytest`` module) so test
  output stays quiet without every suite silencing banners by hand.

``get_logger()`` configures the root handler exactly once (an idempotent
StreamHandler with the ``[repro_torch.<sub>] msg`` format); ``set_level``
re-levels at runtime. CLI entry points that *are* the user-facing output
keep printing: this module is for the library's own chatter."""
from __future__ import annotations

import logging
import os
import sys
import threading

_ENV_LEVEL = "REPRO_LOG_LEVEL"
_ROOT = "repro_torch"
_configured = False
_lock = threading.Lock()


def _under_pytest() -> bool:
    return "PYTEST_CURRENT_TEST" in os.environ or "pytest" in sys.modules


def default_level() -> int:
    v = os.environ.get(_ENV_LEVEL)
    if v:
        v = v.strip().upper()
        if v.isdigit():
            return int(v)
        lvl = logging.getLevelName(v)
        if isinstance(lvl, int):
            return lvl
        raise ValueError(f"{_ENV_LEVEL}={v!r} is not a logging level "
                         "(DEBUG/INFO/WARNING/ERROR or an int)")
    return logging.WARNING if _under_pytest() else logging.INFO


class _Formatter(logging.Formatter):
    def format(self, record):
        return f"[{record.name}] {record.getMessage()}"


def _configure():
    global _configured
    with _lock:
        if _configured:
            return
        root = logging.getLogger(_ROOT)
        if not root.handlers:            # respect an app-installed handler
            h = logging.StreamHandler()
            h.setFormatter(_Formatter())
            root.addHandler(h)
            root.propagate = False
        root.setLevel(default_level())
        _configured = True


def get_logger(name: str = "") -> logging.Logger:
    """``get_logger("scheduler")`` → the ``repro_torch.scheduler`` logger (lazy
    one-time handler/level setup on the ``repro`` root)."""
    _configure()
    return logging.getLogger(f"{_ROOT}.{name}" if name else _ROOT)


def set_level(level) -> None:
    """Programmatic re-level (accepts names or ints)."""
    _configure()
    if isinstance(level, str):
        lv = logging.getLevelName(level.strip().upper())
        if not isinstance(lv, int):
            raise ValueError(f"unknown log level {level!r}")
        level = lv
    logging.getLogger(_ROOT).setLevel(level)


def banner(msg: str, name: str = "") -> None:
    """An INFO status line."""
    get_logger(name).info(msg)


__all__ = ["get_logger", "set_level", "banner", "default_level"]
