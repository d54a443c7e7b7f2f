"""Engine snapshot/restore: preemptible serving, counterpart of
``repro/serving_engine/snapshot.py``.

Serializes the full serving state through
:mod:`repro_torch.checkpoint.manifest` (the training checkpoints'
atomic COMMITTED-marker layout), so a preempted server resumes
mid-generation with **token-exact** continuation:

* the device side — the :class:`~repro_torch.serving_engine.state.DecodeState`
  (every slot's cache rows, per-slot positions/tokens/active mask/lanes)
  is the manifest's array tree, in the JAX package's layout
  (``bridge.decode_state_to_jax``: the same leaves in the same order);
* the host side — scheduler bookkeeping (slot→request map, pending
  queue, per-request emitted tokens, outcomes, free-slot order, step
  counters, remaining deadline budgets) rides in the manifest's JSON
  ``extra``, the same keys as the JAX package's.

So a snapshot written by the JAX ``Scheduler`` resumes in the port. On
restore the arrays become the engine's state through
``Engine.state_from_jax``: the host positions and their device copy are
rebuilt and the engine's kernel constants are shared, not realised again.

``on_token`` callbacks are host closures and cannot be serialized;
:meth:`Scheduler.try_restore` re-attaches them from a ``callbacks``
mapping keyed by uid.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch import bridge
from repro_torch.checkpoint import manifest

SNAPSHOT_KIND = "serving-engine-snapshot"


def request_meta(req) -> Dict[str, Any]:
    return {
        "uid": req.uid,
        "prompt": np.asarray(req.prompt).astype(np.int64).tolist(),
        "max_new": int(req.max_new),
        "eos_id": None if req.eos_id is None else int(req.eos_id),
        # explicit sampling seed only; a None seed re-derives from the
        # uid on restore, which is stable by construction
        "seed": None if req.seed is None else int(req.seed),
    }


def meta_request(meta: Dict[str, Any], callbacks: Optional[Dict] = None):
    from repro_torch.serving_engine.scheduler import Request
    uid = meta["uid"]
    return Request(
        uid=uid,
        prompt=np.asarray(meta["prompt"], np.int32),
        max_new=int(meta["max_new"]),
        eos_id=meta["eos_id"],
        on_token=(callbacks or {}).get(uid),
        seed=meta.get("seed"),
    )


def save_snapshot(snapshot_dir: str, sched, state, slot_req: Dict,
                  free, *, metrics=None) -> str:
    """Write one committed snapshot (manifest step = scheduler decode
    steps taken). Returns the step directory path. ``metrics`` (an obs
    registry) gets per-snapshot size gauges: the bytes of the step
    directory with its data files (the JAX package's gauge sums only the
    directory's top-level entries)."""
    now = sched.clock()
    extra = {
        "kind": SNAPSHOT_KIND,
        "slots": sched.engine.slots,
        "max_len": sched.engine.max_len,
        "steps": sched.steps,
        "prefills": sched.prefills,
        "slot_req": [[int(slot), request_meta(req)]
                     for slot, req in sorted(slot_req.items())],
        "queue": [request_meta(r) for r in list(sched.queue)],
        "free": [int(s) for s in free],
        "results": {uid: [int(t) for t in toks]
                    for uid, toks in sched.results.items()},
        "outcomes": {uid: {"status": o.status, "error": o.error,
                           "callback_error": o.callback_error}
                     for uid, o in sched.outcomes.items()},
        # deadlines are wall-clock budgets: persist the *remaining* time
        # and re-arm on restore (a preempted second does not count)
        "deadline_remaining": {uid: float(dl - now)
                               for uid, dl in sched._deadlines.items()},
    }
    tree = bridge.decode_state_to_jax(state, sched.engine.cfg)
    path = manifest.save(snapshot_dir, sched.steps, tree, extra=extra)
    if metrics is not None:
        try:
            nbytes = snapshot_bytes(path)
            metrics.gauge(
                "repro_snapshot_bytes",
                "size of the latest committed snapshot").set(nbytes)
            metrics.gauge(
                "repro_snapshot_inflight_requests",
                "in-flight requests captured by the latest snapshot",
            ).set(len(slot_req))
        except OSError:
            pass        # metrics must never fail a snapshot
    return path


def snapshot_bytes(path: str) -> int:
    """Bytes of one committed snapshot's step directory (data included)."""
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files)


def load_snapshot(snapshot_dir: str, engine, *,
                  step: Optional[int] = None) -> Optional[Dict[str, Any]]:
    """Returns {"state": DecodeState, "extra": dict} from the latest (or
    given) committed snapshot, or None when the directory holds none.
    Raises ValueError when the snapshot's engine geometry (slots,
    max_len) does not match ``engine`` — a mismatched resume would decode
    from misaligned cache rows, silently wrong — before any array is
    read."""
    if step is None:
        step = manifest.latest_step(snapshot_dir)
        if step is None:
            return None
    step_dir = os.path.join(snapshot_dir, f"step_{step:09d}")
    with open(os.path.join(step_dir, "manifest.json")) as f:
        extra = json.load(f).get("extra", {})
    if extra.get("kind") != SNAPSHOT_KIND:
        raise ValueError(
            f"{snapshot_dir} step {step} is not a serving-engine snapshot "
            f"(kind={extra.get('kind')!r})")
    if (int(extra["slots"]) != engine.slots
            or int(extra["max_len"]) != engine.max_len):
        raise ValueError(
            f"snapshot geometry (slots={extra['slots']}, "
            f"max_len={extra['max_len']}) does not match engine "
            f"(slots={engine.slots}, max_len={engine.max_len})")
    # host tensors shaped like this engine's state: restore checks the
    # leaf count and every shape against them
    like = manifest.tree_map(
        lambda t: torch.empty(t.shape, dtype=t.dtype),
        bridge.decode_state_to_jax(engine.init_state(), engine.cfg))
    tree, extra = manifest.restore(snapshot_dir, like, step=step)
    return {"state": engine.state_from_jax(tree), "extra": extra}


__all__ = ["SNAPSHOT_KIND", "save_snapshot", "load_snapshot",
           "request_meta", "meta_request", "snapshot_bytes"]
