"""Deterministic fault injection for the serving engine (chaos harness),
a copy of ``repro/serving_engine/faults.py``: the same sites, specs and
numpy generator, so a seed fires the same schedule in both packages.

The scheduler calls an injector at its four host-side boundaries —
prefill, decode step, token callback, snapshot write — and the injector
either does nothing, raises :class:`InjectedFault` (a ``RuntimeError``,
so the scheduler's transient-retry machinery sees it exactly like a real
step failure), or, at the decode site, names a slot whose cache row the
engine poisons with NaN so the non-finite guard is exercised end to end
through the real quarantine path rather than a mocked one.

Two modes, freely combined:

* **scripted** — a list of :class:`FaultSpec`; each spec counts its own
  matching visits (site, optionally restricted to one request uid) and
  fires for ``count`` consecutive matches starting at visit ``at``.
  ``count=1`` is a transient fault (one retry survives it); a large
  ``count`` is a persistent fault (retries exhaust, the request or step
  fails for real).
* **seeded** — per-site firing ``rates`` drawn from
  ``np.random.default_rng(seed)`` in visit order: the same seed and the
  same visit sequence always produce the same fault schedule, so a
  seeded chaos run is exactly reproducible.

Every decision is appended to ``self.log`` as ``(site, visit, action,
detail)`` for post-mortem assertions in tests. When the scheduler calls
:meth:`~FaultInjector.bind` with its obs registry/tracer, every
firing also increments ``repro_faults_injected_total{site,action,spec}``
and lands in the request trace as a ``fault`` instant tagged with the
site, action, and originating spec — chaos runs are attributable
per-request in the Perfetto timeline.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

SITES = ("prefill", "decode", "callback", "snapshot")


class InjectedFault(RuntimeError):
    """A fault deliberately raised by :class:`FaultInjector`."""


@dataclasses.dataclass
class FaultSpec:
    """One scripted fault: fire on matching visits [at, at + count)."""
    site: str                          # prefill | decode | callback | snapshot
    at: int = 0                        # first matching visit that fires
    uid: Optional[str] = None          # restrict to one request (prefill/callback)
    count: int = 1                     # consecutive firings (1 = transient)
    poison_slot: Optional[int] = None  # decode only: NaN-poison this slot
                                       # instead of raising

    def __post_init__(self):
        if self.site not in SITES:
            raise ValueError(f"unknown fault site {self.site!r}; "
                             f"expected one of {SITES}")
        if self.poison_slot is not None and self.site != "decode":
            raise ValueError("poison_slot is only meaningful at the "
                             "'decode' site")
        if self.count < 1:
            raise ValueError(f"count={self.count} must be >= 1")


class FaultInjector:
    def __init__(self, specs: Sequence[FaultSpec] = (), *,
                 seed: Optional[int] = None,
                 rates: Optional[Dict[str, float]] = None):
        self.specs = list(specs)
        self.rates = dict(rates or {})
        for site in self.rates:
            if site not in SITES:
                raise ValueError(f"unknown fault site {site!r} in rates")
        if self.rates and seed is None:
            raise ValueError("seeded mode (rates=...) requires a seed — "
                             "chaos runs must be reproducible")
        self._rng = np.random.default_rng(seed)
        self._hits: List[int] = [0] * len(self.specs)   # per-spec match count
        self._visits: Dict[str, int] = {s: 0 for s in SITES}
        self.fired = 0
        self.log: List[Tuple[str, int, str, str]] = []
        self._tracer = None
        self._m_fired = None
        # the scheduler's detokenise worker hits the callback site from
        # its own thread while the loop thread hits prefill/decode —
        # serialise counter/rng mutation so schedules stay deterministic
        # per site (visit order within a site is still FIFO)
        self._mutex = threading.Lock()

    # ------------------------------------------------------- observability
    def bind(self, metrics=None, tracer=None) -> None:
        """Attach an obs registry / span tracer (the Scheduler calls this
        at construction). Idempotent; either argument may be None."""
        self._tracer = tracer
        if metrics is not None:
            self._m_fired = metrics.counter(
                "repro_faults_injected_total",
                "chaos injector firings", ("site", "action", "spec"))

    def _record(self, site: str, uid: Optional[str], action, spec: str):
        if self._m_fired is not None:
            self._m_fired.labels(site=site, action=action[0],
                                 spec=spec).inc()
        if self._tracer is not None:
            self._tracer.instant("fault", uid, site=site,
                                 action=action[0], spec=spec,
                                 detail=str(action[1]))

    # ------------------------------------------------------------ matching
    def _decide(self, site: str, uid: Optional[str] = None):
        """Returns None, ("raise", msg) or ("poison", slot)."""
        with self._mutex:
            return self._decide_locked(site, uid)

    def _decide_locked(self, site: str, uid: Optional[str] = None):
        visit = self._visits[site]
        self._visits[site] += 1
        action = None
        spec_label = ""
        for i, sp in enumerate(self.specs):
            if sp.site != site or (sp.uid is not None and sp.uid != uid):
                continue
            hit = self._hits[i]
            self._hits[i] += 1
            if action is None and sp.at <= hit < sp.at + sp.count:
                spec_label = f"spec{i}"
                if sp.poison_slot is not None:
                    action = ("poison", sp.poison_slot)
                else:
                    action = ("raise",
                              f"scripted {site} fault (spec {i}, hit {hit})")
        rate = self.rates.get(site, 0.0)
        if rate > 0.0:
            # always draw, even when a scripted spec already fired: the
            # random stream advances once per visit so the schedule only
            # depends on (seed, visit order), never on the scripted plan
            drawn = self._rng.random() < rate
            if action is None and drawn:
                spec_label = "seeded"
                action = ("raise", f"seeded {site} fault (visit {visit})")
        if action is not None:
            self.fired += 1
            self.log.append((site, visit, action[0], str(action[1])))
            self._record(site, uid, action, spec_label)
        return action

    # --------------------------------------------------------------- sites
    def prefill(self, uid: str) -> None:
        act = self._decide("prefill", uid)
        if act is not None:
            raise InjectedFault(f"{act[1]} [uid={uid}]")

    def decode(self, step: int) -> Optional[int]:
        """May raise (transient/persistent step fault) or return a slot
        index for the engine to NaN-poison (non-finite injection)."""
        act = self._decide("decode")
        if act is None:
            return None
        if act[0] == "poison":
            return int(act[1])
        raise InjectedFault(f"{act[1]} [step={step}]")

    def callback(self, uid: str) -> None:
        act = self._decide("callback", uid)
        if act is not None:
            raise InjectedFault(f"{act[1]} [uid={uid}]")

    def snapshot(self, step: int) -> None:
        act = self._decide("snapshot")
        if act is not None:
            raise InjectedFault(f"{act[1]} [step={step}]")
