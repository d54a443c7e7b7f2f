"""The port's supervised Scheduler (repro_torch.serving_engine.scheduler)
against the JAX package's, on bridged smoke weights (fd fp32,
REPRO_FD_STREAM_C=4 so short requests cross several overlap-save
blocks).

Each scenario runs once through each package, the same traffic and the
same scripted faults, and the two must agree exactly: every request's
tokens, its outcome (status, error and callback-error messages), the
counters (steps, prefills, packed_prefills, retries, evictions,
snapshot_errors) and the injector's log. The traffic is
``tests/test_faults.py``'s (4 requests over 2 slots) and
``tests/test_frontend.py``'s packed and off-ladder mixes. Greedy decode
only: the port samples from its own counter hash (see
``test_torch_snapshot.py`` for its sampled runs). Behaviour that has no
JAX twin to compare (blocking admission, its timeout) is held to what
``tests/test_faults.py`` asserts of JAX.
"""
import os
import threading
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import repro.serving_engine as jse  # noqa: E402
import repro_torch.serving_engine as tse  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduce_for_smoke as jreduce  # noqa: E402
from repro.models.transformer import init_model as jinit_model  # noqa: E402
from repro.nn.params import unbox  # noqa: E402
from repro.serving_engine import faults as jfaults  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config, reduce_for_smoke  # noqa: E402
from repro_torch.serving_engine import faults as tfaults  # noqa: E402

torch.set_num_threads(1)
FD = "fd-tnn-lm-wt103"
PLENS = [3, 6, 5, 2]                  # tests/test_faults.py's traffic
GENS = [8, 9, 10, 8]
FRONT_PLENS = [3, 7, 5, 9, 4, 6]      # tests/test_frontend.py's packed mix
FRONT_GENS = [8, 5, 10, 6, 7, 9]
SIDES = ("jax", "port")
COUNTERS = ("steps", "prefills", "packed_prefills", "retries", "evictions",
            "snapshot_errors")


@pytest.fixture(scope="module")
def env():
    """Both packages' smoke model on the same weights, the traffic, and an
    engine cache keyed by (side, slots, max_len, options): a JAX engine
    compiles once per geometry, so scenarios share them."""
    old = os.environ.get("REPRO_FD_STREAM_C")
    os.environ["REPRO_FD_STREAM_C"] = "4"
    try:
        jcfg = jreduce(jget_config(FD), dtype="float32",
                       param_dtype="float32")
        cfg = reduce_for_smoke(get_config(FD))
        jparams, _ = unbox(jinit_model(jax.random.PRNGKey(0), jcfg))
        model = bridge.params_from_jax(jax.tree.map(np.asarray, jparams),
                                       cfg, device="cpu")
        rng = np.random.default_rng(7)
        prompts = [rng.integers(0, cfg.vocab, (p,)).astype(np.int32)
                   for p in PLENS]
        engines = {}

        def engine(side, slots=2, max_len=32, **kw):
            key = (side, slots, max_len, tuple(sorted(kw.items())))
            if key not in engines:
                if side == "jax":
                    engines[key] = jse.Engine(jcfg, jparams, slots=slots,
                                              max_len=max_len, **kw)
                else:
                    engines[key] = tse.Engine(cfg, model, slots=slots,
                                              max_len=max_len, **kw)
            return engines[key]

        yield SimpleNamespace(cfg=cfg, prompts=prompts, engine=engine)
    finally:
        if old is None:
            os.environ.pop("REPRO_FD_STREAM_C", None)
        else:
            os.environ["REPRO_FD_STREAM_C"] = old


def ns(side):
    """The package's serving names (Scheduler, Request, FaultSpec, ...)."""
    return jse if side == "jax" else tse


def fleet(side, prompts, gens=GENS, uid_prefix="r", **kw):
    return [ns(side).Request(uid=f"{uid_prefix}{i}", prompt=pr, max_new=g,
                             **kw)
            for i, (pr, g) in enumerate(zip(prompts, gens))]


def summary(sched) -> dict:
    """Everything a scenario must reproduce across the packages."""
    return {
        "results": {u: list(t) for u, t in sched.results.items()},
        "outcomes": {u: (o.status, o.error, o.callback_error)
                     for u, o in sched.outcomes.items()},
        "counters": {k: getattr(sched, k) for k in COUNTERS},
        "log": (None if sched.injector is None
                else [tuple(e) for e in sched.injector.log]),
    }


def serve(env, side, reqs, *, engine_kw=None, **sched_kw):
    eng = env.engine(side, **(engine_kw or {}))
    sched = ns(side).Scheduler(eng, backoff_base=0.0, **sched_kw)
    for r in reqs:
        sched.submit(r)
    sched.run()
    return sched


def both(fn):
    """``fn(side)`` → summary for each package; asserts they are equal
    and returns the port's."""
    got = {side: fn(side) for side in SIDES}
    assert got["port"] == got["jax"]
    return got["port"]


@pytest.fixture(scope="module")
def baseline(env):
    """The fault-free run of test_faults.py's traffic (equal in both)."""
    out = both(lambda side: summary(serve(env, side,
                                          fleet(side, env.prompts))))
    assert all(o[0] == "ok" for o in out["outcomes"].values())
    return out["results"]


# ------------------------------------------------------------ clean runs
def test_clean_run_matches_jax(env, baseline):
    out = both(lambda side: summary(serve(env, side,
                                          fleet(side, env.prompts))))
    assert out["results"] == baseline
    assert out["counters"]["packed_prefills"] == 1      # first wave packs 2
    assert [len(baseline[f"r{i}"]) for i in range(4)] == GENS


@pytest.mark.parametrize("pack", [4, 1])
def test_packed_admission_matches_jax(env, pack):
    """tests/test_frontend.py's packed traffic over 4 slots, packed
    (prefill_pack=4) and sequential (1): the same tokens, counters."""
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, env.cfg.vocab, (p,)).astype(np.int32)
               for p in FRONT_PLENS]
    out = both(lambda side: summary(serve(
        env, side, fleet(side, prompts, FRONT_GENS),
        engine_kw={"slots": 4}, prefill_pack=pack)))
    assert (out["counters"]["packed_prefills"] >= 1) == (pack > 1)


def test_packed_equals_sequential(env):
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, env.cfg.vocab, (p,)).astype(np.int32)
               for p in FRONT_PLENS]
    res = [summary(serve(env, "port", fleet("port", prompts, FRONT_GENS),
                         engine_kw={"slots": 4}, prefill_pack=pack))
           ["results"] for pack in (4, 1)]
    assert res[0] == res[1]


@pytest.mark.parametrize("use_buckets", [True, False])
def test_off_ladder_matches_jax(env, use_buckets):
    """With bucketing off every admission takes the per-length loop (no
    packed wave); the tokens equal the bucketed engine's and JAX's."""
    rng = np.random.default_rng(13)
    prompts = [rng.integers(0, env.cfg.vocab, (p,)).astype(np.int32)
               for p in (3, 6, 5)]
    kw = {"slots": 4, "max_len": 24, "use_buckets": use_buckets}
    out = both(lambda side: summary(serve(
        env, side, fleet(side, prompts, [6, 6, 6]), engine_kw=kw)))
    if not use_buckets:
        assert out["counters"]["packed_prefills"] == 0
        assert env.engine("port", **kw).trace_counts["prefill_bucket"] == 0
        on = summary(serve(env, "port", fleet("port", prompts, [6, 6, 6]),
                           engine_kw=dict(kw, use_buckets=True)))
        assert on["results"] == out["results"]


# -------------------------------------------------------- scripted faults
def _recorder(streamed):
    def cb(uid, tok):
        streamed.setdefault(uid, []).append(tok)
    return cb


SCRIPTED = {
    # test_faults.py's scenarios, each as (FaultSpec kwargs, scheduler kw)
    "prefill_persistent": ([dict(site="prefill", uid="r1", count=99)], {}),
    "prefill_transient": ([dict(site="prefill", uid="r0", count=1)],
                          {"max_retries": 2}),
    "decode_transient": ([dict(site="decode", at=2, count=1)],
                         {"max_retries": 1}),
    "poison_slot": ([dict(site="decode", at=3, poison_slot=0)], {}),
    "prefill_and_decode": ([dict(site="prefill", uid="r1", count=99),
                            dict(site="decode", at=1)], {"max_retries": 2}),
    "callback_fault": ([dict(site="callback", uid="r2", at=1)], {}),
    "packed_gate_transient": ([dict(site="prefill", uid="r1", count=2)],
                              {"max_retries": 2}),
}


@pytest.mark.parametrize("detok_async", [True, False])
@pytest.mark.parametrize("case", sorted(SCRIPTED))
def test_scripted_faults_match_jax(env, baseline, case, detok_async):
    """The same FaultSpec list gives the same outcomes, retries,
    evictions and injector log in both packages; requests that no fault
    reached keep the fault-free tokens."""
    specs, kw = SCRIPTED[case]

    def run(side):
        streamed = {}
        inj = ns(side).FaultInjector(
            specs=[ns(side).FaultSpec(**s) for s in specs])
        sched = serve(env, side, fleet(side, env.prompts,
                                       on_token=_recorder(streamed)),
                      injector=inj, detok_async=detok_async, **kw)
        out = summary(sched)
        out["streamed"] = streamed
        return out

    out = both(run)
    for uid, (status, error, cb_error) in out["outcomes"].items():
        if status == "ok":
            assert out["results"][uid] == baseline[uid], uid
        else:
            assert "InjectedFault" in error or "non-finite" in error, error
        if cb_error is None:
            assert out["streamed"].get(uid, []) == out["results"][uid]
    if case == "poison_slot":
        got, base = out["results"]["r0"], baseline["r0"]
        assert out["outcomes"]["r0"][0] == "error"
        assert 0 < len(got) < len(base) and got == base[:len(got)]
        assert out["counters"]["evictions"] == 1
    if case == "callback_fault":
        assert "InjectedFault" in out["outcomes"]["r2"][2]
        assert out["streamed"]["r2"] == baseline["r2"][:1]


def test_raising_callback_detached_matches_jax(env, baseline):
    calls = {}

    def run(side):
        calls[side] = 0

        def bad_cb(uid, tok):
            calls[side] += 1
            raise ZeroDivisionError("callback bug")

        reqs = fleet(side, env.prompts)
        reqs[1].on_token = bad_cb
        return summary(serve(env, side, reqs))

    out = both(run)
    assert calls == {"jax": 1, "port": 1}
    status, _, cb_error = out["outcomes"]["r1"]
    assert status == "ok" and "ZeroDivisionError" in cb_error
    assert out["results"] == baseline


def test_persistent_decode_failure_is_reentrant(env, baseline):
    """Retry exhaustion fails the in-flight requests with explicit
    outcomes and leaves the queue intact; a fresh run() serves the rest
    exactly — in both packages alike."""
    def run(side):
        inj = ns(side).FaultInjector(
            specs=[ns(side).FaultSpec(site="decode", at=1, count=99)])
        sched = ns(side).Scheduler(env.engine(side), injector=inj,
                                   max_retries=1, backoff_base=0.0)
        for r in fleet(side, env.prompts):
            sched.submit(r)
        with pytest.raises(ns(side).EngineStepError):
            sched.run()
        first = summary(sched)
        first["queue"] = [r.uid for r in sched.queue]
        sched.injector = None
        sched.run()
        return {"first": first, "second": summary(sched)}

    out = both(run)
    assert out["first"]["queue"] == ["r2", "r3"]
    for u in ("r0", "r1"):
        assert out["first"]["outcomes"][u][0] == "error"
        assert "engine step failed" in out["first"]["outcomes"][u][1]
    assert out["first"]["outcomes"]["r2"][0] == "pending"
    for u in ("r2", "r3"):
        assert out["second"]["outcomes"][u][0] == "ok"
        assert out["second"]["results"][u] == baseline[u]


# ---------------------------------------------------------- seeded chaos
def test_seeded_injector_schedule_matches_jax():
    """A seeded injector fires the same schedule in both packages for the
    same visit sequence (the same numpy generator, one draw a visit)."""
    rates = {"prefill": 0.3, "decode": 0.2, "callback": 0.25,
             "snapshot": 0.5}
    specs = [dict(site="decode", at=4, count=2),
             dict(site="prefill", uid="u3", at=1)]

    def run(mod):
        inj = mod.FaultInjector([mod.FaultSpec(**s) for s in specs],
                                seed=11, rates=rates)
        seen = []
        for v in range(120):
            site = ("prefill", "decode", "callback", "snapshot")[v % 4]
            try:
                if site == "decode":
                    seen.append(inj.decode(v))
                elif site == "snapshot":
                    inj.snapshot(v)
                else:
                    getattr(inj, site)(f"u{v % 5}")
                seen.append(None)
            except mod.InjectedFault as e:
                seen.append(str(e))
        return seen, inj.log, inj.fired

    got, want = run(tfaults), run(jfaults)
    assert got == want
    assert 0 < want[2] < 120


@pytest.mark.parametrize("seed", [0, 1, 5])
def test_seeded_chaos_run_matches_jax(env, seed):
    """The launcher's chaos rates (prefill 0.15, decode 0.02, callback
    0.1) under the same seed: the same log, outcomes and tokens. Inline
    callbacks, so every site is visited in one deterministic order."""
    rates = {"prefill": 0.15, "decode": 0.02, "callback": 0.1}

    def run(side):
        streamed = {}
        inj = ns(side).FaultInjector(seed=seed, rates=rates)
        sched = serve(env, side, fleet(side, env.prompts,
                                       on_token=_recorder(streamed)),
                      injector=inj, detok_async=False)
        return summary(sched)

    out = both(run)
    assert all(o[0] in ("ok", "error") for o in out["outcomes"].values())


def test_seeded_chaos_async_detok_outcomes(env, baseline):
    """With the worker thread the callback site's draws interleave with
    the loop's, so the schedule is not pinned; every request still ends
    terminal, every error names an InjectedFault, and ok requests keep
    the fault-free tokens."""
    inj = tse.FaultInjector(seed=0, rates={"prefill": 0.15, "decode": 0.02,
                                           "callback": 0.1})
    streamed = {}
    sched = serve(env, "port", fleet("port", env.prompts,
                                     on_token=_recorder(streamed)),
                  injector=inj, detok_async=True)
    for uid, o in sched.outcomes.items():
        assert o.status in ("ok", "error"), o
        if o.status == "ok":
            assert sched.results[uid] == baseline[uid]
        else:
            assert "InjectedFault" in o.error
        if o.callback_error is not None:
            assert "InjectedFault" in o.callback_error
    assert inj.fired == len(inj.log) > 0


# ---------------------------------------------------- deadlines (fake clock)
def test_deadline_evicts_expired_slot_as_jax(env):
    def run(side):
        clk = {"t": 0.0}

        def tick(uid, tok):
            clk["t"] += 2.0                     # each streamed token: +2s

        reqs = fleet(side, env.prompts[:2], gens=[10, 10], on_token=tick)
        reqs[0].deadline = 5.0                  # expires after ~3 tokens
        return summary(serve(env, side, reqs, clock=lambda: clk["t"]))

    out = both(run)
    status, error, _ = out["outcomes"]["r0"]
    assert status == "expired" and "deadline" in error
    assert 0 < len(out["results"]["r0"]) < 10
    assert out["counters"]["evictions"] >= 1
    assert out["outcomes"]["r1"][0] == "ok"
    assert len(out["results"]["r1"]) == 10


def test_deadline_drops_expired_queued_request_as_jax(env):
    def run(side):
        clk = {"t": 0.0}

        def tick(uid, tok):
            clk["t"] += 1.0

        reqs = fleet(side, env.prompts[:3], gens=[12, 12, 4], on_token=tick)
        reqs[2].deadline = 4.0
        return summary(serve(env, side, reqs, clock=lambda: clk["t"]))

    out = both(run)
    assert out["outcomes"]["r2"][0] == "expired"
    assert "queued" in out["outcomes"]["r2"][1]
    assert out["results"]["r2"] == []
    assert out["outcomes"]["r0"][0] == out["outcomes"]["r1"][0] == "ok"


# ------------------------------------------------------------ backpressure
def test_bounded_queue_reject(env):
    """admission="reject": the request past the cap raises QueueFull in
    both packages and leaves no bookkeeping behind."""
    def run(side):
        sched = ns(side).Scheduler(env.engine(side), queue_cap=2)
        for r in fleet(side, env.prompts[:2]):
            sched.submit(r)
        with pytest.raises(ns(side).QueueFull, match="capacity") as e:
            sched.submit(ns(side).Request(uid="over",
                                          prompt=env.prompts[2], max_new=4))
        assert "over" not in sched.results and "over" not in sched.outcomes
        sched.run()
        return str(e.value), summary(sched)

    msg, out = both(run)
    assert all(o[0] == "ok" for o in out["outcomes"].values())


def test_bounded_queue_block_unblocks_as_run_drains(env, baseline):
    """admission="block": submit waits until run() — in another thread,
    where no signal handler is installed — pops a spot."""
    sched = tse.Scheduler(env.engine("port"), queue_cap=1,
                          admission="block")
    reqs = fleet("port", env.prompts[:2], gens=[12, 8])
    sched.submit(reqs[0])                       # queue now at cap
    t = threading.Thread(target=sched.run)
    t.start()
    sched.submit(reqs[1], timeout=30.0)         # blocks until r0 is popped
    t.join(timeout=60.0)
    assert not t.is_alive()
    assert len(sched.results["r0"]) == 12 and len(sched.results["r1"]) == 8
    for u in ("r0", "r1"):
        assert sched.outcomes[u].status == "ok"
        base, got = baseline[u], sched.results[u]
        n = min(len(base), len(got))
        assert got[:n] == base[:n], u


def test_block_admission_timeout_raises(env):
    sched = tse.Scheduler(env.engine("port"), queue_cap=1,
                          admission="block")
    sched.submit(fleet("port", env.prompts[:1])[0])
    with pytest.raises(tse.QueueFull, match="still full"):
        sched.submit(tse.Request(uid="late", prompt=env.prompts[1],
                                 max_new=4), timeout=0.05)


def test_submit_refusals_match_jax(env):
    """Over-capacity, max_new < 1 and a reused uid raise the same
    ValueErrors in both packages."""
    def run(side):
        sched = serve(env, side, fleet(side, env.prompts[:1], gens=[4]))
        msgs = []
        for req in (
                ns(side).Request(uid="big", prompt=env.prompts[0],
                                 max_new=40),
                ns(side).Request(uid="none", prompt=env.prompts[0],
                                 max_new=0),
                ns(side).Request(uid="r0", prompt=env.prompts[0],
                                 max_new=4)):
            with pytest.raises(ValueError) as e:
                sched.submit(req)
            msgs.append(str(e.value))
        return msgs

    msgs = both(run)
    assert "exceeds slot capacity" in msgs[0] and "already" in msgs[2]


# -------------------------------------------------------- detokenise worker
def test_detok_ordering_and_detach_on_raise(env):
    """Callbacks fire in emit order through the worker; a raising callback
    is detached without losing the request's recorded tokens; the
    outcomes equal JAX's."""
    rng = np.random.default_rng(17)
    prompts = [rng.integers(0, env.cfg.vocab, (p,)).astype(np.int32)
               for p in (3, 5, 4)]

    def run(side):
        order, streamed = [], {}

        def good(uid, tok):
            assert isinstance(tok, int)
            order.append((uid, tok))
            streamed.setdefault(uid, []).append(tok)

        def bad(uid, tok):
            streamed.setdefault(uid, []).append(tok)
            if len(streamed[uid]) == 3:
                raise RuntimeError("client hung up")

        R = ns(side).Request
        reqs = [R(uid="a", prompt=prompts[0], max_new=8, on_token=good),
                R(uid="b", prompt=prompts[1], max_new=8, on_token=bad),
                R(uid="c", prompt=prompts[2], max_new=8, on_token=good)]
        out = summary(serve(env, side, reqs, engine_kw={"slots": 4},
                            detok_async=True))
        out["streamed"], out["order"] = streamed, order
        return out

    out = both(run)
    res = out["results"]
    status, _, cb_error = out["outcomes"]["b"]
    assert status == "ok" and "client hung up" in cb_error
    assert len(res["b"]) == 8 and out["streamed"]["b"] == res["b"][:3]
    for uid in ("a", "c"):
        assert out["streamed"][uid] == res[uid]
        assert [t for u, t in out["order"] if u == uid] == res[uid]


def test_detok_backpressure_tiny_queue(env):
    """detok_cap=1 with a slow callback: the loop blocks on the worker's
    queue instead of buffering, and every token arrives in order."""
    import time
    streamed = {}

    def slow(uid, tok):
        time.sleep(0.001)
        streamed.setdefault(uid, []).append(tok)

    sched = serve(env, "port", fleet("port", env.prompts[:2], gens=[10, 10],
                                     on_token=slow),
                  detok_async=True, detok_cap=1)
    for uid in ("r0", "r1"):
        assert streamed[uid] == sched.results[uid]


def test_run_in_thread_installs_no_signal_handler(env):
    """run() off the main thread leaves SIGTERM/SIGINT alone (signal
    handlers can only be installed from the main thread)."""
    import signal
    before = signal.getsignal(signal.SIGTERM)
    sched = tse.Scheduler(env.engine("port"))
    for r in fleet("port", env.prompts[:1], gens=[3]):
        sched.submit(r)
    errors = []

    def target():
        try:
            sched.run()
        except BaseException as e:  # noqa: BLE001 — surfaced below
            errors.append(e)

    t = threading.Thread(target=target)
    t.start()
    t.join(timeout=60.0)
    assert not t.is_alive() and errors == []
    assert signal.getsignal(signal.SIGTERM) is before
    assert sched.outcomes["r0"].status == "ok"
