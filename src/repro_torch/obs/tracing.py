"""Structured per-request trace spans + Chrome trace_event export, a copy
of ``repro/obs/tracing.py``: the same events, span names and checks, so
either package's ``validate_spans`` accepts the other's trace.

The serving timeline recorder. A :class:`Tracer`
collects flat span events — ``begin`` / ``end`` / ``instant`` /
``counter`` — each a small dict stamped with a monotonic timestamp, a
track (the request ``uid``, or ``None`` for engine-global events), and
free-form attributes. Events are appended to an in-memory list and,
when a path is given (or ``REPRO_TRACE_FILE`` is set), streamed as JSONL
so a killed process still leaves a readable trace prefix.

Request lifecycle span schema (emitted by
:class:`~repro_torch.serving_engine.scheduler.Scheduler`):

======================  ====================================================
span / event            meaning
======================  ====================================================
``request``  B..E       submit → terminal; ``E`` carries ``status`` ∈
                        {ok, error, expired, preempted}
``queue``    B..E       submit → admission wave pop (or expiry/preempt)
``prefill``  B..E       engine prefill+insert; ``packed``/``retries`` attrs
``decode``   B..E       slot residency: insert → release
``first_token`` i       TTFT point (prefill-sampled token recorded)
``token``    i          one decoded token recorded for this request
``retry``    i          transient-fault retry (``site``, ``attempt``)
``fault``    i          injector firing (``site``, ``action``, ``spec``)
``quarantine`` i        non-finite guard evicted this request's slot
``expired``  i          deadline watchdog dropped/evicted the request
``step``     B..E       global track: one batched decode step
``snapshot`` B..E       global track: snapshot write
``queue_depth``/… C     global counter tracks (queue, slots, detok)
======================  ====================================================

Export: :func:`chrome_trace` converts an event list to the Chrome
``trace_event`` JSON object format — load the file in ``chrome://tracing``
or https://ui.perfetto.dev. Each request uid gets its own named thread
track; counter events render as counter tracks. :func:`validate_spans`
is the machine-checkable completeness contract (every begun span ends,
every request ends with a terminal status) shared by the tests and the
card's smoke run.
"""
from __future__ import annotations

import atexit
import json
import os
import threading
import time
from typing import Dict, List, Optional

_ENV_TRACE = "REPRO_TRACE_FILE"

#: terminal request statuses a ``request`` end event may carry
TERMINAL_STATUSES = ("ok", "error", "expired", "preempted")


class Tracer:
    """Append-only span event collector; thread-safe (the scheduler loop,
    the detok worker, and a submitter thread all emit concurrently).

    ``clock`` defaults to ``time.perf_counter`` — timestamps are
    monotonic seconds from an arbitrary origin; only differences and
    ordering are meaningful (Chrome export rebases to the first event).
    """

    #: events buffered before a batched disk write — per-event writes
    #: would put a syscall on the per-token hot path (measured > 5% at
    #: S=16 on the CPU smoke engine); batching amortises it to noise. A
    #: killed process still leaves a readable JSONL prefix, short of at
    #: most FLUSH_EVERY trailing events (``flush()`` runs at every
    #: scheduler ``run()`` exit, so completed serving is never lost).
    FLUSH_EVERY = 256

    def __init__(self, path: Optional[str] = None, *,
                 clock=time.perf_counter):
        self.path = path
        self.clock = clock
        self.events: List[dict] = []
        self._lock = threading.Lock()
        self._file = None
        self._pending: List[dict] = []   # not yet serialised to disk
        if path:
            self._file = open(path, "a", buffering=1)  # line-buffered

    # ------------------------------------------------------------- emit
    def _emit(self, ph: str, name: str, uid: Optional[str], attrs: dict):
        ev = {"ts": self.clock(), "ph": ph, "name": name}
        if uid is not None:
            ev["uid"] = uid
        if attrs:
            ev["attrs"] = attrs
        with self._lock:
            self.events.append(ev)
            if self._file is not None:
                self._pending.append(ev)
                if len(self._pending) >= self.FLUSH_EVERY:
                    self._write_pending_locked()

    def _write_pending_locked(self):
        if self._file is None or not self._pending:
            self._pending.clear()
            return
        try:
            self._file.write(
                "".join(json.dumps(ev) + "\n" for ev in self._pending))
        except (OSError, ValueError):
            self._file = None   # fd gone: keep in-memory trace
        self._pending.clear()

    def begin(self, name: str, uid: Optional[str] = None, **attrs):
        self._emit("B", name, uid, attrs)

    def end(self, name: str, uid: Optional[str] = None, **attrs):
        self._emit("E", name, uid, attrs)

    def instant(self, name: str, uid: Optional[str] = None, **attrs):
        self._emit("i", name, uid, attrs)

    def counter(self, name: str, value: float):
        self._emit("C", name, None, {"value": float(value)})

    def close(self):
        with self._lock:
            self._write_pending_locked()
            if self._file is not None:
                try:
                    self._file.close()
                except OSError:
                    pass
                self._file = None

    def flush(self):
        with self._lock:
            self._write_pending_locked()
            if self._file is not None:
                try:
                    self._file.flush()
                except (OSError, ValueError):
                    pass


_default: Optional[Tracer] = None
_default_lock = threading.Lock()
_atexit_registered = False


def _close_default_tracer() -> None:
    """atexit hook: flush+close whatever the default tracer is *now* —
    the JSONL writer batches :attr:`Tracer.FLUSH_EVERY` events, so a
    process that exits without ``close()`` would silently drop the tail
    of the trace."""
    with _default_lock:
        t = _default
    if t is not None:
        try:
            t.close()
        except Exception:  # noqa: BLE001 — never fail interpreter exit
            pass


def default_tracer() -> Optional[Tracer]:
    """Process-wide tracer writing to ``REPRO_TRACE_FILE`` (None when the
    env is unset — tracing is opt-in). Explicit tracers passed to the
    Scheduler bypass this. The first creation registers an ``atexit``
    close so the batched JSONL tail survives an exit without an explicit
    ``close()``."""
    global _default, _atexit_registered
    if _default is None:
        path = os.environ.get(_ENV_TRACE)
        if not path:
            return None
        with _default_lock:
            if _default is None:
                _default = Tracer(path)
                if not _atexit_registered:
                    atexit.register(_close_default_tracer)
                    _atexit_registered = True
    return _default


def set_default_tracer(tracer: Optional[Tracer]) -> None:
    global _default, _atexit_registered
    with _default_lock:
        _default = tracer
        if tracer is not None and not _atexit_registered:
            atexit.register(_close_default_tracer)
            _atexit_registered = True


# ---------------------------------------------------------------- loading
def load_jsonl(path: str) -> List[dict]:
    events = []
    with open(path) as f:
        for i, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                events.append(json.loads(line))
            except ValueError as e:
                raise ValueError(f"{path}:{i}: bad trace line: {e}") from e
    return events


# ----------------------------------------------------------- chrome export
def chrome_trace(events: List[dict]) -> dict:
    """Chrome ``trace_event`` JSON object format. One pid; tid 0 is the
    engine-global track (steps, snapshots), each request uid gets its
    own named tid in order of first appearance; counter events become
    ``ph: "C"`` counter tracks. Timestamps rebase to the first event and
    scale to microseconds (the format's unit)."""
    if not events:
        return {"traceEvents": [], "displayTimeUnit": "ms"}
    t0 = min(e["ts"] for e in events)
    tids: Dict[str, int] = {}
    out = [{"ph": "M", "pid": 1, "tid": 0, "name": "thread_name",
            "args": {"name": "engine"}},
           {"ph": "M", "pid": 1, "tid": 0, "name": "process_name",
            "args": {"name": "repro-serving"}}]

    def tid_of(uid: Optional[str]) -> int:
        if uid is None:
            return 0
        if uid not in tids:
            tids[uid] = len(tids) + 1
            out.append({"ph": "M", "pid": 1, "tid": tids[uid],
                        "name": "thread_name",
                        "args": {"name": f"req {uid}"}})
        return tids[uid]

    for ev in events:
        ts = (ev["ts"] - t0) * 1e6
        attrs = dict(ev.get("attrs", {}))
        uid = ev.get("uid")
        base = {"pid": 1, "ts": ts, "name": ev["name"], "cat": "serving"}
        if ev["ph"] == "C":
            out.append({**base, "ph": "C", "tid": 0,
                        "args": {"value": attrs.get("value", 0)}})
            continue
        if uid is not None:
            attrs["uid"] = uid
        base["tid"] = tid_of(uid)
        if ev["ph"] == "i":
            out.append({**base, "ph": "i", "s": "t", "args": attrs})
        else:
            out.append({**base, "ph": ev["ph"], "args": attrs})
    return {"traceEvents": out, "displayTimeUnit": "ms"}


def write_chrome(events: List[dict], path: str) -> None:
    with open(path, "w") as f:
        json.dump(chrome_trace(events), f, indent=1)
        f.write("\n")


# ------------------------------------------------------------- validation
def validate_spans(events: List[dict]) -> Dict[str, List[dict]]:
    """Machine-check the span contract; returns ``{uid: [request span
    records]}`` (a uid may legitimately carry several sequential request
    spans — e.g. a preempted run resumed in the same process).

    Raises ``ValueError`` when any track has a begin without a matching
    end (or vice versa, or interleaved same-name nesting), when a
    ``request`` end carries no terminal status, or when a request span
    contains no ``queue`` span (every admitted request must have been
    queued first). Each record: ``{"status", "t0", "t1", "children":
    {name: count}, "tokens": n}``.
    """
    open_spans: Dict[tuple, List[dict]] = {}
    requests: Dict[str, List[dict]] = {}
    current: Dict[str, dict] = {}       # uid -> open request record

    def fail(msg, ev):
        raise ValueError(f"trace span error: {msg} (event {ev})")

    for ev in events:
        ph, name, uid = ev["ph"], ev["name"], ev.get("uid")
        key = (uid, name)
        if ph == "B":
            open_spans.setdefault(key, []).append(ev)
            if name == "request":
                if uid is None:
                    fail("request span without uid", ev)
                if uid in current:
                    fail(f"request {uid} re-begun while open", ev)
                rec = {"status": None, "t0": ev["ts"], "t1": None,
                       "children": {}, "tokens": 0,
                       "attrs": dict(ev.get("attrs", {}))}
                current[uid] = rec
                requests.setdefault(uid, []).append(rec)
            elif uid is not None and uid in current:
                c = current[uid]["children"]
                c[name] = c.get(name, 0) + 1
        elif ph == "E":
            stack = open_spans.get(key)
            if not stack:
                fail(f"end without begin: {name} uid={uid}", ev)
            stack.pop()
            if name == "request":
                rec = current.pop(uid, None)
                if rec is None:
                    fail(f"request end for unopened {uid}", ev)
                status = ev.get("attrs", {}).get("status")
                if status not in TERMINAL_STATUSES:
                    fail(f"request {uid} ended with non-terminal "
                         f"status {status!r}", ev)
                rec["status"] = status
                rec["t1"] = ev["ts"]
        elif ph == "i":
            if uid is not None and uid in current:
                rec = current[uid]
                rec["children"][name] = rec["children"].get(name, 0) + 1
                if name in ("token", "first_token"):
                    rec["tokens"] += 1
    dangling = [k for k, v in open_spans.items() if v]
    if dangling:
        raise ValueError(f"trace span error: unclosed spans {dangling}")
    for uid, recs in requests.items():
        for rec in recs:
            if "queue" not in rec["children"]:
                raise ValueError(
                    f"trace span error: request {uid} has no queue span")
    return requests


__all__ = ["Tracer", "TERMINAL_STATUSES", "default_tracer",
           "set_default_tracer", "load_jsonl", "chrome_trace",
           "write_chrome", "validate_spans"]
