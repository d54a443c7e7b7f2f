"""Host-side supervised scheduler: queue, admission, isolation, deadlines,
counterpart of ``repro/serving_engine/scheduler.py`` with the same
semantics, knobs, counters, metric names and span names.

Drives an :class:`~repro_torch.serving_engine.engine.Engine` with the
classic continuous-batching loop (MaxText/JetStream offline_inference
shape):

    while work:
        watchdog: evict expired slots, drop expired queued requests
        if free slots and queued requests:  # greedy prefill-first
            pack ≤ prefill_pack requests → ONE padded batch prefill
            scatter each row into its slot (engine.insert_from)
        else:
            state, tokens, ok = engine.generate(state)   # all slots, 1 step
        record tokens; hand callbacks to the detokenise worker thread;
        evict EOS/max-len/non-finite slots, recycle them for the queue

Admission is *batched* and detokenisation *asynchronous*: up to
``prefill_pack`` queued prompts are packed into one bucketed prefill per
step (``engine.prefill_packed``; prompts that fall off the bucket
ladder, or a pack of one, use the sequential path), and ``on_token``
callbacks run on a background worker thread draining a bounded token
queue, so host-side detokenisation overlaps the next decode step instead
of serialising with it. The worker receives host ints only: a decode
step's tokens and ``ok`` flags come back from the card in one read
(``engine.generate``), a packed wave's first tokens in one ``tolist``,
and no CUDA tensor crosses into the worker thread. Ordering is preserved
(single worker, FIFO), callback exceptions detach the callback (on the
worker), and the queue is drained at every snapshot, whenever deadlines
are armed (watchdog determinism), and before ``run`` returns — so every
fault-tolerance observable is settled when it is read.

The loop is a *supervisor*: one bad request cannot take down the other
S - 1 in-flight generations.

* **Request isolation** — a prefill/insert/emit failure fails only that
  request: its :class:`Outcome` records ``status="error"`` with the
  message, the slot goes back to the free list, the loop continues.
  Transient errors (``RuntimeError``, which in torch includes CUDA errors
  and ``torch.cuda.OutOfMemoryError``, and
  :class:`~repro_torch.serving_engine.faults.InjectedFault`) are retried
  with exponential backoff up to ``max_retries``, as in the JAX package;
  a persistent one ends as an error outcome naming it, so a caller that
  must not serve past a kernel fault checks the outcomes' errors. A
  raising ``on_token`` callback is **detached** (never unwinds the loop)
  and noted on the outcome.
* **Non-finite guard** — ``engine.generate`` quarantines slots whose
  logits went non-finite; the scheduler records an error outcome and
  recycles the slot instead of streaming garbage.
* **Deadlines** — per-request TTL (``Request.deadline`` seconds, or the
  scheduler's ``default_deadline``); a step-loop watchdog evicts expired
  slots and drops expired queued requests with ``status="expired"``.
* **Backpressure** — ``queue_cap`` bounds the queue; ``admission``
  policy is ``"reject"`` (raise :class:`QueueFull`) or ``"block"``
  (``submit`` waits until ``run`` — in another thread — drains a spot).
* **Preemption + snapshot/restore** — SIGTERM/SIGINT (handlers are
  installed only when ``run`` is on the main thread) finishes the current
  step, writes a final snapshot (``snapshot_dir``) and returns; a new
  process calls :meth:`try_restore` and ``run()`` resumes with
  token-exact continuation (a snapshot written by the JAX package's
  scheduler included). Periodic snapshots every ``snapshot_every`` decode
  steps; a *failing* snapshot write is counted and logged, never fatal.
* **Fault injection** — an optional
  :class:`~repro_torch.serving_engine.faults.FaultInjector` fires at the
  prefill / decode / callback / snapshot boundaries so every failure
  mode above is CI-exercised deterministically.

``run()`` still returns ``({uid: [tokens]}, state)``; per-request status
lives in ``scheduler.outcomes`` (``Outcome.tokens`` aliases the same
list as ``results[uid]``).
"""
from __future__ import annotations

import dataclasses
import os
import queue as queue_mod
import signal
import threading
import time
import zlib
from collections import deque
from typing import Callable, Dict, List, Optional

import numpy as np

from repro_torch.obs import devstats as obs_devstats
from repro_torch.obs import log as obs_log
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import profiling as obs_prof
from repro_torch.obs import tracing as obs_tracing
from repro_torch.serving_engine.engine import Engine

#: terminal request states; anything else is pending/in-flight
TERMINAL = ("ok", "error", "expired")

_ENV_PACK = "REPRO_PREFILL_PACK"
_ENV_DETOK = "REPRO_DETOK_ASYNC"


def default_prefill_pack() -> int:
    v = os.environ.get(_ENV_PACK)
    if v is None or v == "":
        return 4
    p = int(v)
    if p < 1:
        raise ValueError(f"{_ENV_PACK}={p} must be >= 1")
    return p


def default_detok_async() -> bool:
    v = os.environ.get(_ENV_DETOK)
    if v is None or v == "":
        return True
    return v.strip().lower() not in ("0", "false", "off", "no")


class QueueFull(RuntimeError):
    """submit() under admission="reject" with a full bounded queue."""


class EngineStepError(RuntimeError):
    """The batched decode step failed persistently (retries exhausted).

    In-flight requests have been failed with explicit error outcomes and
    their slots released; the *queue is left intact*, so a fresh
    ``run()`` (new engine state) serves the remaining requests."""


@dataclasses.dataclass
class Request:
    uid: str
    prompt: np.ndarray            # (p,) int32 prompt tokens
    max_new: int                  # generation budget (tokens)
    eos_id: Optional[int] = None  # stop token (None = run to max_new)
    on_token: Optional[Callable[[str, int], None]] = None  # streaming cb
    deadline: Optional[float] = None  # TTL seconds from submit (None = ∞)
    seed: Optional[int] = None    # sampling seed (None = derived from uid)

    def resolved_seed(self) -> int:
        """Effective sampling seed: explicit, else a stable uid hash so
        two requests with the same prompt still sample distinct streams
        (and a snapshot-resumed request replays the same one)."""
        if self.seed is not None:
            return int(self.seed)
        return zlib.crc32(self.uid.encode()) & 0x7FFFFFFF


@dataclasses.dataclass
class Outcome:
    """Per-request terminal record. ``tokens`` aliases ``results[uid]``."""
    uid: str
    status: str = "pending"             # pending | ok | error | expired
    tokens: List[int] = dataclasses.field(default_factory=list)
    error: Optional[str] = None         # set when status in {error}
    callback_error: Optional[str] = None  # callback detached mid-stream


def _errmsg(e: BaseException) -> str:
    return f"{type(e).__name__}: {e}"


class _DetokWorker:
    """Background detokenise/callback pipeline (the JetThread role in
    MaxText's offline inference): a single daemon thread drains a
    bounded FIFO of (request, host int token) pairs and invokes
    ``on_token`` callbacks off the decode hot loop.

    * **Ordering** — one worker, one FIFO: callbacks fire in exactly the
      emit order, same as the old synchronous path.
    * **Backpressure** — the queue is bounded; when callbacks fall
      behind, ``put`` blocks the scheduler loop instead of buffering
      unboundedly.
    * **Detach-on-raise** — a raising callback (or injected callback
      fault) is detached on the worker: ``req.on_token`` is cleared so
      queued/later tokens for that request are skipped, and the outcome
      records ``callback_error`` — the same observables as the
      synchronous path's isolation boundary.
    * **drain()** — blocks until every queued callback has completed;
      the scheduler drains before watchdog reads when deadlines are
      armed (callbacks may advance an injected clock), before every
      snapshot, and when ``run`` returns, so outcomes are settled at
      each synchronisation point.
    """

    _STOP = object()

    def __init__(self, sched: "Scheduler", cap: int):
        self._sched = sched
        self._q: queue_mod.Queue = queue_mod.Queue(maxsize=cap)
        self._thread: Optional[threading.Thread] = None

    def start(self):
        self._thread = threading.Thread(
            target=self._loop, name="detok-worker", daemon=True)
        self._thread.start()

    def put(self, req: Request, token: int):
        self._q.put((req, token))       # blocks when full: backpressure

    def drain(self):
        self._q.join()

    def stop(self):
        if self._thread is None:
            return
        self._q.put(self._STOP)
        self._thread.join()
        self._thread = None

    def _loop(self):
        sched = self._sched
        while True:
            item = self._q.get()
            try:
                if item is self._STOP:
                    return
                req, token = item
                if req.on_token is None:    # detached mid-queue: skip
                    continue
                try:
                    if sched.injector is not None:
                        sched.injector.callback(req.uid)
                    req.on_token(req.uid, token)
                except Exception as e:  # noqa: BLE001 — isolation boundary
                    req.on_token = None
                    sched.outcomes[req.uid].callback_error = _errmsg(e)
                    sched._m_cb_errors.inc()
                    sched._ti("callback_detached", req.uid,
                              error=_errmsg(e))
                    sched.log(f"[scheduler] request {req.uid}: on_token "
                              f"raised, callback detached ({_errmsg(e)})")
            finally:
                self._q.task_done()


class Scheduler:
    def __init__(self, engine: Engine, *,
                 queue_cap: Optional[int] = None,
                 admission: str = "reject",
                 default_deadline: Optional[float] = None,
                 max_retries: int = 2,
                 backoff_base: float = 0.05,
                 injector=None,
                 snapshot_dir: Optional[str] = None,
                 snapshot_every: int = 0,
                 prefill_pack: Optional[int] = None,
                 detok_async: Optional[bool] = None,
                 detok_cap: int = 1024,
                 clock: Callable[[], float] = time.monotonic,
                 sleep: Callable[[float], None] = time.sleep,
                 log: Optional[Callable[[str], None]] = None,
                 metrics=None,
                 tracer: Optional[obs_tracing.Tracer] = None,
                 mem_sample_every: Optional[int] = None):
        if admission not in ("reject", "block"):
            raise ValueError(f"admission={admission!r}: "
                             "expected 'reject' or 'block'")
        if queue_cap is not None and queue_cap < 1:
            raise ValueError(f"queue_cap={queue_cap} must be >= 1")
        if detok_cap < 1:
            raise ValueError(f"detok_cap={detok_cap} must be >= 1")
        self.engine = engine
        self.queue: deque = deque()
        self.queue_cap = queue_cap
        self.admission = admission
        self.default_deadline = default_deadline
        self.max_retries = int(max_retries)
        self.backoff_base = float(backoff_base)
        self.injector = injector
        self.snapshot_dir = snapshot_dir
        self.snapshot_every = int(snapshot_every)
        self.prefill_pack = (default_prefill_pack() if prefill_pack is None
                             else int(prefill_pack))
        if self.prefill_pack < 1:
            raise ValueError(
                f"prefill_pack={self.prefill_pack} must be >= 1")
        self.detok_async = (default_detok_async() if detok_async is None
                            else bool(detok_async))
        self.detok_cap = int(detok_cap)
        self._detok: Optional[_DetokWorker] = None
        self.clock = clock
        self.sleep = sleep
        # supervision messages route through the one obs logger by
        # default (REPRO_LOG_LEVEL; quiet under pytest) — an explicit
        # ``log=`` callable still wins, e.g. tests capturing lines
        self.log = log or obs_log.get_logger("scheduler").info
        # ---- observability: metrics registry + span tracer. Explicit
        # objects win; else the process defaults (a no-op registry unless
        # REPRO_METRICS, a tracer only under REPRO_TRACE_FILE) — the
        # un-instrumented hot path pays one no-op call per site, no
        # device syncs ever.
        self.metrics = (metrics if metrics is not None
                        else obs_metrics.default_registry())
        self.tracer = (tracer if tracer is not None
                       else obs_tracing.default_tracer())
        # one cached flag gates the per-token path (TTFT/TPOT + instants)
        self._obs_on = (self.tracer is not None or
                        not isinstance(self.metrics,
                                       obs_metrics.NullRegistry))
        # periodic device-memory gauges: every N decode steps sample
        # live device bytes + DecodeState cache/fd-stream bytes. 0 = off
        # (the default; the sample walks the cache on the host, so it
        # stays opt-in).
        if mem_sample_every is None:
            mem_sample_every = (obs_devstats.mem_sample_every()
                                if self._obs_on else 0)
        self.mem_sample_every = int(mem_sample_every)
        m = self.metrics
        self._m_submitted = m.counter(
            "repro_requests_submitted_total", "requests accepted by submit()")
        self._m_rejected = m.counter(
            "repro_requests_rejected_total",
            "submissions refused before queuing", ("reason",))
        self._m_finished = m.counter(
            "repro_requests_finished_total",
            "terminal request outcomes", ("status",))
        self._m_retries = m.counter(
            "repro_retries_total", "transient-fault retries", ("site",))
        self._m_evictions = m.counter(
            "repro_evictions_total", "slot/queue evictions", ("reason",))
        self._m_steps = m.counter(
            "repro_decode_steps_total", "batched decode steps taken")
        self._m_prefills = m.counter(
            "repro_prefills_total", "per-request prefills", ("mode",))
        self._m_packed_waves = m.counter(
            "repro_packed_prefill_waves_total",
            "packed admission batches run")
        self._m_snapshots = m.counter(
            "repro_snapshots_total", "snapshot writes", ("result",))
        self._m_cb_errors = m.counter(
            "repro_callback_errors_total", "on_token callbacks detached")
        self._m_queue_depth = m.gauge(
            "repro_queue_depth", "requests waiting for admission")
        self._m_slots_active = m.gauge(
            "repro_slots_active", "slots holding in-flight requests")
        self._m_detok_depth = m.gauge(
            "repro_detok_queue_depth",
            "tokens waiting for the detokenise worker")
        self._m_ttft = m.histogram(
            "repro_ttft_seconds", "submit -> first token recorded")
        self._m_tpot = m.histogram(
            "repro_tpot_seconds", "inter-token gap per request")
        self._m_step_s = m.histogram(
            "repro_decode_step_seconds",
            "one batched decode step, host wall incl. token sync")
        self._m_prefill_s = m.histogram(
            "repro_prefill_seconds", "admission wave wall time")
        self._m_snap_s = m.histogram(
            "repro_snapshot_seconds", "snapshot write wall time")
        self._t_submit: Dict[str, float] = {}   # uid -> submit clock()
        self._t_last: Dict[str, float] = {}     # uid -> last token clock()
        self._span_open: Dict[str, List[str]] = {}  # uid -> open child spans
        if injector is not None:
            injector.bind(self.metrics, self.tracer)
        self.results: Dict[str, List[int]] = {}
        self.outcomes: Dict[str, Outcome] = {}
        self._deadlines: Dict[str, float] = {}   # uid -> absolute clock()
        self._lock = threading.Lock()
        self._not_full = threading.Condition(self._lock)
        self.steps = 0                # decode steps taken (stats)
        self.prefills = 0
        self.packed_prefills = 0      # packed admission batches run
        self.retries = 0              # transient-fault retries performed
        self.evictions = 0            # deadline/non-finite evictions
        self.snapshot_errors = 0
        self.preempted = False
        self._resume = None           # set by try_restore()

    # ------------------------------------------------------- observability
    def _tb(self, name, uid=None, **attrs):
        if self.tracer is not None:
            self.tracer.begin(name, uid, **attrs)

    def _te(self, name, uid=None, **attrs):
        if self.tracer is not None:
            self.tracer.end(name, uid, **attrs)

    def _ti(self, name, uid=None, **attrs):
        if self.tracer is not None:
            self.tracer.instant(name, uid, **attrs)

    def _open_span(self, uid: str, name: str, **attrs):
        self._span_open.setdefault(uid, []).append(name)
        self._tb(name, uid, **attrs)

    def _close_span(self, uid: str, name: str, **attrs):
        opened = self._span_open.get(uid)
        if opened and name in opened:
            opened.remove(name)
            self._te(name, uid, **attrs)

    def _close_request(self, uid: str, status: str):
        """End any still-open child spans (innermost first), then the
        ``request`` span with its terminal status — the single point that
        guarantees every submitted request leaves a complete span tree."""
        for name in reversed(self._span_open.pop(uid, [])):
            self._te(name, uid)
        self._te("request", uid, status=status)

    def _observe_counters(self, slots_active: Optional[int] = None):
        """Refresh the global gauge/counter tracks (cheap host reads)."""
        self._m_queue_depth.set(len(self.queue))
        if self._detok is not None:
            self._m_detok_depth.set(self._detok._q.qsize())
        if slots_active is not None:
            self._m_slots_active.set(slots_active)
        if self.tracer is not None:
            self.tracer.counter("queue_depth", len(self.queue))
            if slots_active is not None:
                self.tracer.counter("slots_active", slots_active)

    def _ensure_request_spans(self, slot_req: Dict[int, Request]):
        """(Re-)begin request spans for pending work entering ``run()``.
        Fresh submissions opened theirs in :meth:`submit`; requests
        carried across a preemption (same-process re-run or a
        :meth:`try_restore` in a new process) are re-begun with
        ``resumed=True`` — restored in-flight requests get an immediate
        queue B+E pair so every request span satisfies the
        :func:`~repro_torch.obs.tracing.validate_spans` contract."""
        if self.tracer is None:
            return
        with self._lock:
            queued = list(self.queue)
        for req in queued:
            if req.uid not in self._span_open:
                self._tb("request", req.uid, resumed=True)
                self._open_span(req.uid, "queue", resumed=True)
        for slot in sorted(slot_req):
            uid = slot_req[slot].uid
            if uid not in self._span_open:
                self._tb("request", uid, resumed=True)
                self._tb("queue", uid, resumed=True)
                self._te("queue", uid)
                self._open_span(uid, "decode", slot=slot, resumed=True)

    # ----------------------------------------------------------- admission
    def submit(self, req: Request, *, timeout: Optional[float] = None) -> None:
        """Queue a request. Rejects loudly when prompt + generation could
        not fit a slot (an over-capacity run would clamp cache writes and
        corrupt the slot's ring/KV rows mid-generation). With a bounded
        queue, ``admission="reject"`` raises :class:`QueueFull` when
        full; ``"block"`` waits until ``run()`` (in another thread)
        drains a spot (or ``timeout`` seconds elapse — then QueueFull)."""
        p = int(np.asarray(req.prompt).shape[-1])
        if req.max_new < 1:
            self._m_rejected.labels(reason="bad_request").inc()
            raise ValueError(f"request {req.uid}: max_new must be >= 1")
        cap = self.engine.capacity
        # positions written: p prompt + (max_new - 1) fed-back tokens
        # (the final sampled token is emitted but never fed)
        if cap is not None and p + req.max_new - 1 > cap:
            self._m_rejected.labels(reason="over_capacity").inc()
            raise ValueError(
                f"request {req.uid}: prompt {p} + max_new {req.max_new} "
                f"exceeds slot capacity {cap} "
                f"(Engine(max_len={self.engine.max_len}))")
        if req.uid in self.results:
            # a reused uid — including one from an already-completed run —
            # would merge token lists and trip the budget check early,
            # silently truncating the later request
            self._m_rejected.labels(reason="duplicate_uid").inc()
            raise ValueError(f"request uid {req.uid!r} already submitted")
        with self._not_full:
            if self.queue_cap is not None:
                if self.admission == "reject":
                    if len(self.queue) >= self.queue_cap:
                        self._m_rejected.labels(reason="queue_full").inc()
                        raise QueueFull(
                            f"request {req.uid}: queue at capacity "
                            f"{self.queue_cap} (admission='reject')")
                else:                                   # block
                    deadline = (None if timeout is None
                                else self.clock() + timeout)
                    while len(self.queue) >= self.queue_cap:
                        remaining = (None if deadline is None
                                     else deadline - self.clock())
                        if remaining is not None and remaining <= 0:
                            self._m_rejected.labels(
                                reason="queue_full").inc()
                            raise QueueFull(
                                f"request {req.uid}: queue still full "
                                f"after {timeout}s (admission='block')")
                        self._not_full.wait(remaining)
            self.queue.append(req)
            self.results[req.uid] = []
            self.outcomes[req.uid] = Outcome(uid=req.uid,
                                             tokens=self.results[req.uid])
            ttl = (req.deadline if req.deadline is not None
                   else self.default_deadline)
            if ttl is not None:
                self._deadlines[req.uid] = self.clock() + float(ttl)
        self._m_submitted.inc()
        self._t_submit[req.uid] = self.clock()
        self._tb("request", req.uid, prompt_len=p, max_new=req.max_new)
        self._open_span(req.uid, "queue")
        self._observe_counters()

    def _pop_request(self) -> Optional[Request]:
        with self._not_full:
            if not self.queue:
                return None
            req = self.queue.popleft()
            self._not_full.notify()
        self._close_span(req.uid, "queue")
        self._observe_counters()
        return req

    def _pop_up_to(self, n: int) -> List[Request]:
        """Pop at most n queued requests (FIFO) for one admission wave."""
        out: List[Request] = []
        with self._not_full:
            while self.queue and len(out) < n:
                out.append(self.queue.popleft())
                self._not_full.notify()
        for req in out:
            self._close_span(req.uid, "queue")
        if out:
            self._observe_counters()
        return out

    # ------------------------------------------------------------ signals
    def _install_signals(self):
        self._old_handlers = {}
        if threading.current_thread() is not threading.main_thread():
            return                         # signals only land on main

        def handler(signum, frame):
            self.preempted = True
            self.log(f"[scheduler] signal {signum}: "
                     "snapshot-and-exit requested")
        for s in (signal.SIGTERM, signal.SIGINT):
            self._old_handlers[s] = signal.signal(s, handler)

    def _restore_signals(self):
        for s, h in getattr(self, "_old_handlers", {}).items():
            signal.signal(s, h)

    def preempt(self):
        """Programmatic preemption: finish the current step, snapshot
        (when configured), return from ``run``."""
        self.preempted = True

    # ----------------------------------------------------------- outcomes
    def _finish(self, uid: str, status: str, error: Optional[str] = None):
        out = self.outcomes[uid]
        out.status = status
        if error is not None:
            out.error = error
        self._deadlines.pop(uid, None)
        self._m_finished.labels(status=status).inc()
        self._close_request(uid, status)
        self._t_submit.pop(uid, None)
        self._t_last.pop(uid, None)
        if status != "ok":
            self.log(f"[scheduler] request {uid}: {status}"
                     + (f" ({error})" if error else ""))

    def _emit(self, req: Request, token: int) -> bool:
        """Record/stream one token; returns True when the request is done
        (EOS or budget exhausted). Bookkeeping (results, done check) is
        synchronous; the ``on_token`` callback is handed to the detok
        worker when one is live, else invoked inline. A raising callback
        (or an injected callback fault) is detached and noted — never
        unwinds the loop."""
        self.results[req.uid].append(token)
        if self._obs_on:
            now = self.clock()
            if len(self.results[req.uid]) == 1:
                t0 = self._t_submit.get(req.uid)
                if t0 is not None:
                    self._m_ttft.observe(now - t0)
                self._ti("first_token", req.uid)
            else:
                prev = self._t_last.get(req.uid)
                if prev is not None:
                    self._m_tpot.observe(now - prev)
                self._ti("token", req.uid)
            self._t_last[req.uid] = now
        if req.on_token is not None:
            if self._detok is not None:
                self._detok.put(req, token)
            else:
                try:
                    if self.injector is not None:
                        self.injector.callback(req.uid)
                    req.on_token(req.uid, token)
                except Exception as e:  # noqa: BLE001 — isolation boundary
                    req.on_token = None
                    self.outcomes[req.uid].callback_error = _errmsg(e)
                    self._m_cb_errors.inc()
                    self._ti("callback_detached", req.uid, error=_errmsg(e))
                    self.log(f"[scheduler] request {req.uid}: on_token "
                             f"raised, callback detached ({_errmsg(e)})")
        done = len(self.results[req.uid]) >= req.max_new
        if req.eos_id is not None and token == req.eos_id:
            done = True
        return done

    def _drain_detok(self):
        if self._detok is not None:
            self._detok.drain()

    # ----------------------------------------------------------- watchdog
    def _expire_queue(self, now: float):
        """Drop queued requests whose deadline passed before admission."""
        with self._not_full:
            if not self._deadlines:
                return
            keep = deque()
            for req in self.queue:
                dl = self._deadlines.get(req.uid)
                if dl is not None and now > dl:
                    self._ti("expired", req.uid, where="queue")
                    self._m_evictions.labels(reason="deadline").inc()
                    self._finish(req.uid, "expired",
                                 "deadline exceeded while queued")
                    self.evictions += 1
                    self._not_full.notify()
                else:
                    keep.append(req)
            self.queue = keep

    def _expire_slots(self, now: float, state, slot_req: Dict[int, Request],
                      free: List[int]):
        for slot in sorted(slot_req):
            req = slot_req[slot]
            dl = self._deadlines.get(req.uid)
            if dl is not None and now > dl:
                self._ti("expired", req.uid, where="slot", slot=slot)
                self._m_evictions.labels(reason="deadline").inc()
                self._finish(
                    req.uid, "expired",
                    f"deadline exceeded after "
                    f"{len(self.results[req.uid])} tokens")
                self.evictions += 1
                state = self.engine.release(state, slot)
                del slot_req[slot]
                free.append(slot)
        return state

    # ------------------------------------------------------------ retries
    def _backoff(self, attempt: int, *, site: str = "other",
                 uid: Optional[str] = None):
        self.retries += 1
        self._m_retries.labels(site=site).inc()
        self._ti("retry", uid, site=site, attempt=attempt)
        if self.backoff_base > 0:
            self.sleep(self.backoff_base * (2 ** attempt))

    def _prefill_with_retry(self, req: Request):
        """Transient (RuntimeError-family) prefill failures retry with
        exponential backoff; anything else — and retry exhaustion —
        propagates to the caller's isolation boundary."""
        for attempt in range(self.max_retries + 1):
            try:
                if self.injector is not None:
                    self.injector.prefill(req.uid)
                return self.engine.prefill(req.prompt,
                                           seed=req.resolved_seed())
            except RuntimeError as e:
                if attempt >= self.max_retries:
                    raise
                self.log(f"[scheduler] prefill {req.uid} attempt {attempt} "
                         f"failed ({_errmsg(e)}); retrying")
                self._backoff(attempt, site="prefill", uid=req.uid)

    def _admit(self, req: Request, state, slot_req: Dict[int, Request],
               free: List[int]):
        """Prefill + insert one request; failures fail only this request
        (error outcome, slot back on the free list). A failing or
        1-token request's open ``prefill`` span is closed by
        ``_finish`` → ``_close_request``."""
        slot = free.pop()
        self._open_span(req.uid, "prefill")
        try:
            prefix, first, plen = self._prefill_with_retry(req)
        except Exception as e:          # noqa: BLE001 — isolation boundary
            self._finish(req.uid, "error", f"prefill failed: {_errmsg(e)}")
            free.append(slot)
            return state
        self.prefills += 1
        self._m_prefills.labels(mode="single").inc()
        tok = int(first)                # host sync: the first token
        if self._emit(req, tok):        # 1-token request: done
            self._finish(req.uid, "ok")
            free.append(slot)
            return state
        try:
            state = self.engine.insert(state, prefix, plen, tok, slot,
                                       seed=req.resolved_seed())
        except Exception as e:          # noqa: BLE001 — isolation boundary
            self._finish(req.uid, "error", f"insert failed: {_errmsg(e)}")
            free.append(slot)
            return state
        self._close_span(req.uid, "prefill")
        self._open_span(req.uid, "decode", slot=slot)
        slot_req[slot] = req
        return state

    def _gate_with_retry(self, req: Request) -> bool:
        """Run only the injector's prefill gate for one request of a
        packed batch (the engine call is shared — per-uid faults must
        still fail per-request). Returns False (error outcome recorded)
        when the gate fails persistently."""
        if self.injector is None:
            return True
        for attempt in range(self.max_retries + 1):
            try:
                self.injector.prefill(req.uid)
                return True
            except RuntimeError as e:
                if attempt >= self.max_retries:
                    self._finish(req.uid, "error",
                                 f"prefill failed: {_errmsg(e)}")
                    return False
                self.log(f"[scheduler] prefill {req.uid} attempt {attempt} "
                         f"failed ({_errmsg(e)}); retrying")
                self._backoff(attempt, site="prefill", uid=req.uid)
        return False                     # unreachable

    def _admit_packed(self, reqs: List[Request], state,
                      slot_req: Dict[int, Request], free: List[int]):
        """Admit several requests through ONE packed batch prefill.
        Per-request isolation is preserved: the injector gate runs (and
        retries) per uid before the shared engine call; a persistent
        engine-side failure fails only the packed survivors; insert
        failures fail only their own row."""
        survivors = [r for r in reqs if self._gate_with_retry(r)]
        if not survivors:
            return state
        for r in survivors:
            self._open_span(r.uid, "prefill", packed=True)
        prompts = [r.prompt for r in survivors]
        seeds = [r.resolved_seed() for r in survivors]
        packed = None
        for attempt in range(self.max_retries + 1):
            try:
                packed, first, plens = self.engine.prefill_packed(
                    prompts, seeds)
                break
            except RuntimeError as e:
                if attempt >= self.max_retries:
                    for r in survivors:
                        self._finish(r.uid, "error",
                                     f"prefill failed: {_errmsg(e)}")
                    return state
                self.log(f"[scheduler] packed prefill ({len(survivors)} "
                         f"reqs) attempt {attempt} failed ({_errmsg(e)}); "
                         "retrying")
                self._backoff(attempt, site="prefill")
            except Exception as e:      # noqa: BLE001 — isolation boundary
                for r in survivors:
                    self._finish(r.uid, "error",
                                 f"prefill failed: {_errmsg(e)}")
                return state
        self.packed_prefills += 1
        self._m_packed_waves.inc()
        first_h = first.tolist()         # host sync: first-token stream
        for row, req in enumerate(survivors):
            self.prefills += 1
            self._m_prefills.labels(mode="packed").inc()
            tok = first_h[row]
            if self._emit(req, tok):     # 1-token request: done
                self._finish(req.uid, "ok")
                continue
            slot = free.pop()
            try:
                state = self.engine.insert_from(
                    state, packed, row, plens[row], tok, slot,
                    seed=seeds[row])
            except Exception as e:      # noqa: BLE001 — isolation boundary
                self._finish(req.uid, "error",
                             f"insert failed: {_errmsg(e)}")
                free.append(slot)
                continue
            self._close_span(req.uid, "prefill")
            self._open_span(req.uid, "decode", slot=slot)
            slot_req[slot] = req
        return state

    def _admit_batch(self, reqs: List[Request], state,
                     slot_req: Dict[int, Request], free: List[int]):
        """Route a wave of admissions: prompts on the bucket ladder go
        through the packed path together; off-ladder prompts (and a
        wave of one) use the sequential b=1 path."""
        t0 = self.clock()
        with obs_prof.annotation("prefill_wave"):
            packable: List[Request] = []
            rest: List[Request] = []
            for r in reqs:
                p = int(np.asarray(r.prompt).shape[-1])
                (packable if self.engine.bucket_for(p) is not None
                 else rest).append(r)
            if len(packable) >= 2:
                state = self._admit_packed(packable, state, slot_req, free)
            else:
                rest = reqs
            for req in rest:
                state = self._admit(req, state, slot_req, free)
        self._m_prefill_s.observe(self.clock() - t0)
        return state

    def _generate_with_retry(self, state, slot_req: Dict[int, Request],
                             free: List[int]):
        """One batched decode step with transient-fault retry. The engine
        step is functional (it writes only into tensors it makes), so a
        failed call leaves ``state`` intact and the retry replays the
        identical step. On exhaustion
        every in-flight request gets an explicit error outcome, slots are
        released, the queue is left intact, and EngineStepError raises —
        a fresh run() serves the remainder."""
        last_err: Optional[BaseException] = None
        for attempt in range(self.max_retries + 1):
            try:
                if self.injector is not None:
                    bad = self.injector.decode(self.steps)
                    if bad is not None:
                        state = self.engine.poison_slot(state, bad)
                return self.engine.generate(state)
            except RuntimeError as e:
                last_err = e
                if attempt >= self.max_retries:
                    break
                self.log(f"[scheduler] decode step {self.steps} attempt "
                         f"{attempt} failed ({_errmsg(e)}); retrying")
                self._backoff(attempt, site="decode")
        for slot in sorted(slot_req):
            req = slot_req[slot]
            self._finish(req.uid, "error",
                         f"engine step failed: {_errmsg(last_err)}")
            state = self.engine.release(state, slot)
            free.append(slot)
        slot_req.clear()
        raise EngineStepError(
            f"decode step {self.steps} failed after "
            f"{self.max_retries + 1} attempts") from last_err

    # ----------------------------------------------------------- snapshot
    def _snapshot(self, state, slot_req: Dict[int, Request],
                  free: List[int], *, final: bool = False):
        """Best-effort: a failing snapshot write is counted and logged,
        never fatal to serving (the previous committed snapshot stays
        valid — manifest saves are atomic)."""
        if self.snapshot_dir is None:
            return
        from repro_torch.serving_engine import snapshot as snap
        # settle in-flight callbacks first: a snapshot must capture
        # callback_error/detach outcomes that are already "emitted"
        self._drain_detok()
        t0 = self.clock()
        self._tb("snapshot", step=self.steps, final=final)
        result = "ok"
        try:
            if self.injector is not None:
                self.injector.snapshot(self.steps)
            snap.save_snapshot(self.snapshot_dir, self, state, slot_req,
                               free, metrics=self.metrics)
        except Exception as e:          # noqa: BLE001 — isolation boundary
            result = "error"
            self.snapshot_errors += 1
            self.log(f"[scheduler] snapshot"
                     f"{' (final)' if final else ''} failed: {_errmsg(e)}")
        self._m_snapshots.labels(result=result).inc()
        self._m_snap_s.observe(self.clock() - t0)
        self._te("snapshot", result=result)

    def try_restore(self, *, callbacks: Optional[Dict] = None) -> bool:
        """Load the latest committed snapshot from ``snapshot_dir`` into
        this (fresh) scheduler; the next ``run()`` resumes token-exact.
        ``callbacks`` re-attaches ``on_token`` closures by uid (they
        cannot be serialized). Returns False when there is no snapshot.
        Each in-flight request's sampling lane is re-derived from its
        seed and the tokens it has emitted (one draw each), so a snapshot
        of either package resumes the port's sampled stream where it
        stopped."""
        from repro_torch.serving_engine import snapshot as snap
        if self.snapshot_dir is None:
            return False
        loaded = snap.load_snapshot(self.snapshot_dir, self.engine)
        if loaded is None:
            return False
        extra = loaded["extra"]
        self.steps = int(extra["steps"])
        self.prefills = int(extra["prefills"])
        self.results = {uid: [int(t) for t in toks]
                        for uid, toks in extra["results"].items()}
        self.outcomes = {}
        for uid, o in extra["outcomes"].items():
            self.outcomes[uid] = Outcome(
                uid=uid, status=o["status"],
                tokens=self.results.setdefault(uid, []),
                error=o["error"], callback_error=o["callback_error"])
        now = self.clock()
        self._deadlines = {uid: now + float(rem)
                           for uid, rem in extra["deadline_remaining"].items()}
        with self._not_full:
            self.queue = deque(snap.meta_request(m, callbacks)
                               for m in extra["queue"])
        slot_req = {int(slot): snap.meta_request(m, callbacks)
                    for slot, m in extra["slot_req"]}
        state = self.engine.with_lanes(loaded["state"], {
            slot: (req.resolved_seed(), len(self.results[req.uid]))
            for slot, req in slot_req.items()})
        self._resume = {
            "state": state,
            "slot_req": slot_req,
            "free": [int(s) for s in extra["free"]],
        }
        self.log(f"[scheduler] restored snapshot at step {self.steps}: "
                 f"{len(slot_req)} in-flight, {len(self.queue)} queued")
        return True

    # --------------------------------------------------------------- run
    def run(self, state=None, *, stop: Optional[Callable[[], bool]] = None,
            idle_sleep: float = 0.002):
        """Drain the queue; returns ({uid: [generated tokens]}, state).
        Reentrant: pass the returned state back in to keep serving. When
        preempted (SIGTERM/SIGINT or :meth:`preempt`) it snapshots and
        returns early with ``self.preempted`` set. With ``stop`` given,
        an empty queue idles (sleeping ``idle_sleep`` between polls)
        instead of returning, until ``stop()`` is truthy — the
        online-serving mode used by the latency benchmark's open-loop
        arrival process."""
        eng = self.engine
        resume, self._resume = self._resume, None
        if resume is not None:
            if state is None:
                state = resume["state"]
            free = resume["free"]
            slot_req = resume["slot_req"]
        else:
            if state is None:
                state = eng.init_state()
            free = list(range(eng.slots))[::-1]  # pop() admits slot 0 first
            slot_req = {}
        self.preempted = False
        # per-drain cache for sample_memory's pytree byte sums: the
        # decode cache is fixed-shape for the whole drain, so only the
        # live-array total is re-measured at each sampling step
        self._mem_reuse: dict = {}
        self._install_signals()
        if self.detok_async and self._detok is None:
            self._detok = _DetokWorker(self, self.detok_cap)
            self._detok.start()
        self._ensure_request_spans(slot_req)
        prof = obs_prof.session("serve")     # no-op unless REPRO_PROFILE_DIR
        prof.__enter__()
        try:
            while True:
                with self._lock:
                    has_queue = bool(self.queue)
                if self.preempted:
                    break
                if not (has_queue or slot_req):
                    if stop is None or stop():
                        break
                    self.sleep(idle_sleep)           # idle: await arrivals
                    continue
                if self._deadlines:
                    # callbacks may advance an injected clock — settle
                    # them before the watchdog reads it
                    self._drain_detok()
                now = self.clock()
                self._expire_queue(now)              # watchdog: queue TTLs
                state = self._expire_slots(now, state, slot_req, free)
                if free:                             # greedy prefill-first
                    wave = self._pop_up_to(min(len(free),
                                               self.prefill_pack))
                    if wave:
                        state = self._admit_batch(wave, state, slot_req,
                                                  free)
                        continue
                if not slot_req:
                    continue     # everything expired/errored; re-check queue
                t_step = self.clock()
                self._tb("step", step=self.steps)
                try:
                    with obs_prof.annotation("decode_step"):
                        state, toks, ok = self._generate_with_retry(
                            state, slot_req, free)
                    self.steps += 1
                    self._m_steps.inc()
                    # generate read them back in one transfer: host ints
                    toks_h = toks.tolist()
                    ok_h = ok.tolist()
                finally:
                    # close the step span on EngineStepError too — a
                    # persistent decode failure must not dangle spans
                    self._m_step_s.observe(self.clock() - t_step)
                    self._te("step")
                for slot in sorted(slot_req):
                    req = slot_req[slot]
                    if not ok_h[slot]:
                        # quarantined on device; recycle the slot
                        self._ti("quarantine", req.uid, slot=slot,
                                 step=self.steps - 1)
                        self._m_evictions.labels(reason="nonfinite").inc()
                        self._finish(
                            req.uid, "error",
                            f"non-finite logits at step {self.steps - 1} "
                            f"(slot {slot} quarantined after "
                            f"{len(self.results[req.uid])} tokens)")
                        self.evictions += 1
                        state = eng.release(state, slot)
                        del slot_req[slot]
                        free.append(slot)
                        continue
                    if self._emit(req, toks_h[slot]):
                        self._finish(req.uid, "ok")
                        state = eng.release(state, slot)
                        del slot_req[slot]
                        free.append(slot)
                self._observe_counters(len(slot_req))
                if (self.mem_sample_every
                        and self.steps % self.mem_sample_every == 0):
                    obs_devstats.sample_memory(self.metrics, state,
                                               reuse=self._mem_reuse)
                if (self.snapshot_every and not self.preempted
                        and self.steps % self.snapshot_every == 0):
                    self._snapshot(state, slot_req, free)
            if self.preempted:
                self._snapshot(state, slot_req, free, final=True)
                # close every open span with a preempted terminus so the
                # trace of this run validates; a later run (or a restore
                # in a new process) re-begins them with resumed=True
                for uid in sorted(self._span_open):
                    self._ti("preempt", uid)
                    self._close_request(uid, "preempted")
        finally:
            if self._detok is not None:
                # settle every in-flight callback before handing results
                # back (streamed == recorded is an observable)
                self._detok.drain()
                self._detok.stop()
                self._detok = None
            self._restore_signals()
            prof.__exit__(None, None, None)
            if self.tracer is not None:
                self.tracer.flush()
        return self.results, state
