"""The port's observability (repro_torch.obs) and the ``--engine``
launcher against the JAX package's (repro.obs, repro.launch.serve).

* metrics — the same sequence of registry operations gives Prometheus
  text and a JSON dump byte-identical to JAX's; ``NullRegistry`` and the
  ``REPRO_METRICS`` default behave alike; ``MirroredCounts`` on the
  engine;
* tracing — the same tracer calls give JAX's events apart from
  timestamps; the port's scheduler trace equals JAX's scheduler trace on
  the same traffic (timestamps aside) and both packages' ``validate_spans``
  accept it; its metrics equal JAX's apart from the timing histograms'
  sums and buckets;
* log, profiling (a no-op without ``REPRO_PROFILE_DIR``, a CPU Chrome
  trace with it), the memory gauges against JAX's ``sample_memory``;
* the ``--engine`` CLI at ``--smoke --device cpu`` with ``--chaos 0``,
  ``--metrics-file`` and ``--trace-file``, and the refusals of its flags
  without ``--engine``, which are JAX's.
"""
import json
import logging
import os
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import repro.serving_engine as jse  # noqa: E402
import repro_torch.serving_engine as tse  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduce_for_smoke as jreduce  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models.transformer import init_model as jinit_model  # noqa: E402
from repro.nn.params import unbox  # noqa: E402
from repro.obs import devstats as jdevstats  # noqa: E402
from repro.obs import metrics as jmetrics  # noqa: E402
from repro.obs import tracing as jtracing  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config, reduce_for_smoke  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.obs import devstats as tdevstats  # noqa: E402
from repro_torch.obs import log as tlog  # noqa: E402
from repro_torch.obs import metrics as tmetrics  # noqa: E402
from repro_torch.obs import profiling as tprof  # noqa: E402
from repro_torch.obs import tracing as ttracing  # noqa: E402

torch.set_num_threads(1)
FD = "fd-tnn-lm-wt103"
PLENS = [3, 6, 5, 2]                  # tests/test_obs.py's traffic
GENS = [6, 7, 8, 6]
MAX_LEN = 32
#: timing series: their values are clocks, not counts
TIMED = ("repro_ttft_seconds", "repro_tpot_seconds",
         "repro_decode_step_seconds", "repro_prefill_seconds",
         "repro_snapshot_seconds")


@pytest.fixture(scope="module")
def env():
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
        yield SimpleNamespace(jcfg=jcfg, cfg=cfg, jparams=jparams,
                              model=model, prompts=prompts)
    finally:
        if old is None:
            os.environ.pop("REPRO_FD_STREAM_C", None)
        else:
            os.environ["REPRO_FD_STREAM_C"] = old


# =============================================================== metrics
def _registry_ops(mod, reg):
    """A fixed sequence touching every instrument kind, labels, escapes,
    integer and fractional values, custom buckets and +Inf."""
    c = reg.counter("repro_requests_total", 'served "requests"\nper kind',
                    ("kind", "status"))
    c.labels(kind="gen", status="ok").inc()
    c.labels(kind="gen", status="ok").inc(2.5)
    c.labels(kind='a"b\\c', status="error").inc(3)
    g = reg.gauge("repro_queue_depth", "waiting")
    g.set(7)
    g.inc(0.25)
    g.dec(2)
    h = reg.histogram("repro_latency_seconds", "latency",
                      buckets=(0.5, 0.001, 2.0))
    for x in (0.0005, 0.3, 0.3, 1.7, 99.0):
        h.observe(x)
    hl = reg.histogram("repro_step_seconds", "", ("fn",))
    hl.labels(fn="decode").observe(0.004)
    hl.labels(fn="prefill").observe(12.0)
    reg.counter("repro_zero_total")
    assert reg.counter("repro_requests_total", "",
                       ("kind", "status")) is c      # idempotent
    with pytest.raises(ValueError):
        reg.gauge("repro_requests_total")
    with pytest.raises(ValueError):
        reg.counter("bad-name")
    with pytest.raises(ValueError):
        c.labels(kind="x").inc()
    with pytest.raises(ValueError):
        c.labels(kind="x", status="y").inc(-1)
    with pytest.raises(TypeError):
        c.labels(kind="x", status="y").set(1)
    mirrored = mod.MirroredCounts({"generate": 0, "insert": 0},
                                  reg.counter("repro_engine_traces_total",
                                              "traces", ("fn",)), "fn")
    mirrored["generate"] += 1
    mirrored["generate"] += 2
    mirrored["insert"] = 1
    mirrored["insert"] = 1                   # no increase: no inc
    return reg


def test_prometheus_and_json_byte_identical(tmp_path):
    got = _registry_ops(tmetrics, tmetrics.Registry())
    want = _registry_ops(jmetrics, jmetrics.Registry())
    assert got.render_prometheus() == want.render_prometheus()
    assert got.to_dict() == want.to_dict()
    for reg, name in ((got, "port"), (want, "jax")):
        reg.dump_json(str(tmp_path / f"{name}.json"))
        reg.dump_prometheus(str(tmp_path / f"{name}.prom"))
    for ext in ("json", "prom"):
        assert (tmp_path / f"port.{ext}").read_bytes() == \
            (tmp_path / f"jax.{ext}").read_bytes()
    assert got.get("repro_engine_traces_total").get(fn="generate") == 3


def test_null_registry_matches_jax(tmp_path):
    null = tmetrics.NULL_REGISTRY
    for m in (null.counter("a"), null.gauge("b"), null.histogram("c")):
        m.inc()
        m.labels(x="1").observe(2.0)
        assert m.get() == 0.0
    assert null.get("a") is None and null.collect() == []
    assert null.render_prometheus() == "" and null.to_dict() == {}
    null.dump_json(str(tmp_path / "port.json"))
    jmetrics.NULL_REGISTRY.dump_json(str(tmp_path / "jax.json"))
    assert (tmp_path / "port.json").read_bytes() == \
        (tmp_path / "jax.json").read_bytes()


def test_default_registry_env_gate(monkeypatch):
    monkeypatch.delenv("REPRO_METRICS_FILE", raising=False)
    try:
        for value, real in (("", False), ("0", False), ("off", False),
                            ("1", True), ("yes", True)):
            monkeypatch.setenv("REPRO_METRICS", value)
            tmetrics.set_default_registry(None)
            assert tmetrics.metrics_enabled() is real
            assert isinstance(tmetrics.default_registry(),
                              tmetrics.Registry) is real
    finally:
        tmetrics.set_default_registry(None)


def test_engine_trace_counts_mirrored(env):
    reg = tmetrics.Registry()
    eng = tse.Engine(env.cfg, env.model, slots=2, max_len=MAX_LEN,
                     metrics=reg)
    assert isinstance(eng.trace_counts, tmetrics.MirroredCounts)
    sched = tse.Scheduler(eng)
    for i, (pr, g) in enumerate(zip(env.prompts, GENS)):
        sched.submit(tse.Request(uid=f"r{i}", prompt=pr, max_new=g))
    sched.run()
    traces = reg.get("repro_engine_traces_total")
    for fn, n in eng.trace_counts.items():
        assert traces.get(fn=fn) == n
    assert eng.trace_counts["generate"] == 1
    plain = tse.Engine(env.cfg, env.model, slots=2, max_len=MAX_LEN,
                       metrics=tmetrics.NULL_REGISTRY)
    assert type(plain.trace_counts) is dict


# =============================================================== tracing
def _no_ts(events):
    return [{k: v for k, v in e.items() if k != "ts"} for e in events]


def _tracer_ops(tr):
    tr.begin("request", "u1", prompt_len=3)
    tr.begin("queue", "u1")
    tr.counter("queue_depth", 1)
    tr.end("queue", "u1")
    tr.instant("first_token", "u1")
    tr.begin("step", step=0)
    tr.end("step")
    tr.instant("token", "u1")
    tr.end("request", "u1", status="ok")
    return tr


def test_tracer_events_and_chrome_match_jax(tmp_path):
    got = _tracer_ops(ttracing.Tracer(str(tmp_path / "port.jsonl")))
    want = _tracer_ops(jtracing.Tracer(str(tmp_path / "jax.jsonl")))
    got.close()
    want.close()
    assert _no_ts(got.events) == _no_ts(want.events)
    assert _no_ts(ttracing.load_jsonl(str(tmp_path / "port.jsonl"))) == \
        _no_ts(want.events)

    def chrome(mod, events):
        out = mod.chrome_trace(events)
        return [{k: v for k, v in e.items() if k != "ts"}
                for e in out["traceEvents"]]
    assert chrome(ttracing, got.events) == chrome(jtracing, want.events)
    ttracing.write_chrome(got.events, str(tmp_path / "c.json"))
    assert json.loads((tmp_path / "c.json").read_text())["traceEvents"]
    recs = ttracing.validate_spans(got.events)
    assert recs["u1"][0]["status"] == "ok" and recs["u1"][0]["tokens"] == 2
    assert ttracing.chrome_trace([]) == jtracing.chrome_trace([])


def test_validate_spans_rejects_incomplete():
    tr = ttracing.Tracer()
    tr.begin("request", "u1")
    tr.begin("queue", "u1")
    with pytest.raises(ValueError, match="unclosed"):
        ttracing.validate_spans(tr.events)
    tr.end("queue", "u1")
    tr.end("request", "u1", status="weird")
    with pytest.raises(ValueError, match="non-terminal"):
        ttracing.validate_spans(tr.events)
    tr2 = ttracing.Tracer()
    tr2.begin("request", "u2")
    tr2.end("request", "u2", status="ok")
    with pytest.raises(ValueError, match="no queue span"):
        ttracing.validate_spans(tr2.events)


def _traced_run(mod, eng, prompts, injector=None):
    reg, tr = mod_obs(mod)
    sched = mod.Scheduler(eng, metrics=reg, tracer=tr, detok_async=False,
                          injector=injector, backoff_base=0.0)
    for i, (pr, g) in enumerate(zip(prompts, GENS)):
        sched.submit(mod.Request(uid=f"r{i}", prompt=pr, max_new=g))
    sched.run()
    return sched, reg, tr


def mod_obs(mod):
    if mod is jse:
        return jmetrics.Registry(), jtracing.Tracer()
    return tmetrics.Registry(), ttracing.Tracer()


def _untimed(reg) -> dict:
    """The registry's JSON mirror with the timing series' values dropped
    (their counts kept)."""
    out = reg.to_dict()
    for name in TIMED:
        if name in out:
            for s in out[name]["series"]:
                s.pop("sum")
                s.pop("counts")
    return out


@pytest.mark.parametrize("chaos", [False, True])
def test_scheduler_trace_and_metrics_match_jax(env, chaos):
    """The same traffic (packed first wave, inline callbacks) through both
    schedulers, clean and with scripted faults: the same span events
    apart from timestamps, accepted by both packages' validate_spans, and
    the same metrics apart from the timing histograms' values."""
    def run(mod):
        inj = None
        if chaos:
            inj = mod.FaultInjector(specs=[
                mod.FaultSpec(site="prefill", uid="r1", count=99),
                mod.FaultSpec(site="decode", at=1)])
        if mod is jse:
            eng = jse.Engine(env.jcfg, env.jparams, slots=2, max_len=MAX_LEN)
        else:
            eng = tse.Engine(env.cfg, env.model, slots=2, max_len=MAX_LEN)
        return _traced_run(mod, eng, env.prompts, inj)

    sched, reg, tr = run(tse)
    jsched, jreg, jtr = run(jse)
    assert _no_ts(tr.events) == _no_ts(jtr.events)
    spans = ttracing.validate_spans(tr.events)
    jspans = jtracing.validate_spans(tr.events)      # JAX's check, port trace
    assert sorted(spans) == sorted(jspans) == [f"r{i}" for i in range(4)]
    for uid, recs in spans.items():
        assert len(recs) == 1
        assert recs[0]["status"] == sched.outcomes[uid].status
        assert recs[0]["tokens"] == len(sched.results[uid])
    assert _untimed(reg) == _untimed(jreg)
    assert reg.get("repro_decode_steps_total").get() == sched.steps
    assert reg.get("repro_decode_step_seconds").get() == sched.steps
    if chaos:
        assert reg.get("repro_faults_injected_total").get(
            site="prefill", action="raise", spec="spec0") == 3
        assert spans["r1"][0]["status"] == "error"


def test_async_detok_trace_validates(env):
    """With the worker thread (callbacks on every request) the trace still
    closes every span; the worker's detach instant lands on its request."""
    reg, tr = tmetrics.Registry(), ttracing.Tracer()
    eng = tse.Engine(env.cfg, env.model, slots=2, max_len=MAX_LEN,
                     metrics=reg)

    def bad(uid, tok):
        raise RuntimeError("client gone")

    sched = tse.Scheduler(eng, metrics=reg, tracer=tr, detok_async=True)
    for i, (pr, g) in enumerate(zip(env.prompts, GENS)):
        sched.submit(tse.Request(uid=f"r{i}", prompt=pr, max_new=g,
                                 on_token=bad if i == 2 else None))
    sched.run()
    spans = jtracing.validate_spans(tr.events)
    assert spans["r2"][0]["children"]["callback_detached"] == 1
    assert reg.get("repro_callback_errors_total").get() == 1
    packed = [e for e in tr.events if e["name"] == "prefill"
              and e["ph"] == "B" and e.get("attrs", {}).get("packed")]
    assert len(packed) == 2


def test_preempt_closes_spans_and_restore_resumes(env, tmp_path):
    reg, tr = tmetrics.Registry(), ttracing.Tracer()
    eng = tse.Engine(env.cfg, env.model, slots=2, max_len=MAX_LEN)
    sched = tse.Scheduler(eng, metrics=reg, tracer=tr,
                          snapshot_dir=str(tmp_path))
    n = {"tok": 0}

    def kill_soon(u, t):
        n["tok"] += 1
        if n["tok"] == 5:
            sched.preempt()

    for i, (pr, g) in enumerate(zip(env.prompts, GENS)):
        sched.submit(tse.Request(uid=f"r{i}", prompt=pr, max_new=g,
                                 on_token=kill_soon))
    sched.run()
    assert sched.preempted
    pre = {u: r[-1]["status"] for u, r in
           jtracing.validate_spans(tr.events).items()}
    assert "preempted" in pre.values()
    sched2 = tse.Scheduler(eng, metrics=reg, tracer=tr,
                           snapshot_dir=str(tmp_path))
    assert sched2.try_restore()
    results, _ = sched2.run()
    spans = jtracing.validate_spans(tr.events)
    for i, g in enumerate(GENS):
        recs = spans[f"r{i}"]
        assert recs[-1]["status"] == "ok"
        assert sum(r["tokens"] for r in recs) == g == len(results[f"r{i}"])
        if len(recs) > 1:
            assert recs[-1]["attrs"].get("resumed") is True


# ====================================================== memory, log, prof
def test_sample_memory_matches_jax(env):
    """The cache byte gauges equal JAX's for the same engine geometry; on
    the CPU the live-device gauge is left unset."""
    reg = tmetrics.Registry()
    eng = tse.Engine(env.cfg, env.model, slots=2, max_len=MAX_LEN)
    got = tdevstats.sample_memory(reg, eng.init_state(), reuse={})
    jeng = jse.Engine(env.jcfg, env.jparams, slots=2, max_len=MAX_LEN)
    want = jdevstats.sample_memory(jmetrics.Registry(), jeng.init_state())
    assert "repro_live_device_bytes" not in got
    for name in ("repro_decode_cache_bytes", "repro_fd_stream_bytes"):
        assert got[name] == want[name] > 0
        assert reg.get(name).get() == got[name]


def test_mem_sample_every_knob(env, monkeypatch):
    monkeypatch.setenv("REPRO_MEM_SAMPLE_EVERY", "2")
    assert tdevstats.mem_sample_every() == 2
    reg = tmetrics.Registry()
    eng = tse.Engine(env.cfg, env.model, slots=2, max_len=MAX_LEN)
    sched = tse.Scheduler(eng, metrics=reg)
    assert sched.mem_sample_every == 2
    sched.submit(tse.Request(uid="r0", prompt=env.prompts[0], max_new=5))
    sched.run()
    assert reg.get("repro_decode_cache_bytes").get() > 0
    monkeypatch.setenv("REPRO_MEM_SAMPLE_EVERY", "x")
    with pytest.raises(ValueError):
        tdevstats.mem_sample_every()


def test_log_level_knob_and_logger(monkeypatch):
    import io
    monkeypatch.delenv("REPRO_LOG_LEVEL", raising=False)
    assert tlog.default_level() == logging.WARNING      # under pytest
    monkeypatch.setenv("REPRO_LOG_LEVEL", "15")
    assert tlog.default_level() == 15
    monkeypatch.setenv("REPRO_LOG_LEVEL", "bogus")
    with pytest.raises(ValueError):
        tlog.default_level()
    monkeypatch.delenv("REPRO_LOG_LEVEL")
    root = tlog.get_logger()
    assert root.name == "repro_torch"
    buf = io.StringIO()
    h = logging.StreamHandler(buf)
    h.setFormatter(root.handlers[0].formatter)
    root.addHandler(h)
    tlog.set_level("INFO")
    try:
        tlog.get_logger("scheduler").info("hello")
        assert "[repro_torch.scheduler] hello" in buf.getvalue()
        tlog.set_level(logging.WARNING)
        tlog.banner("below level", "scheduler")
        assert "below level" not in buf.getvalue()
    finally:
        root.removeHandler(h)
        tlog.set_level(tlog.default_level())
    with pytest.raises(ValueError):
        tlog.set_level("NOT_A_LEVEL")


def test_scheduler_default_log_is_quiet_under_pytest(env, capsys):
    sched = tse.Scheduler(tse.Engine(env.cfg, env.model, slots=2,
                                     max_len=MAX_LEN))
    sched.log("should not appear")
    out = capsys.readouterr()
    assert "should not appear" not in out.out + out.err


def test_profiling_noop_without_env(monkeypatch):
    monkeypatch.delenv("REPRO_PROFILE_DIR", raising=False)
    with tprof.session("x") as started:
        assert started is False
    with tprof.annotation("y"):
        pass


def test_profiling_session_writes_cpu_trace(env, monkeypatch, tmp_path):
    """Under REPRO_PROFILE_DIR a scheduler run leaves a Chrome trace with
    its decode-step and prefill-wave annotations."""
    monkeypatch.setenv("REPRO_PROFILE_DIR", str(tmp_path))
    sched = tse.Scheduler(tse.Engine(env.cfg, env.model, slots=2,
                                     max_len=MAX_LEN))
    sched.submit(tse.Request(uid="r0", prompt=env.prompts[0], max_new=3))
    sched.run()
    traces = sorted(tmp_path.glob("serve.*.trace.json"))
    assert len(traces) == 1
    names = {e.get("name") for e in
             json.loads(traces[0].read_text())["traceEvents"]}
    assert {"decode_step", "prefill_wave"} <= names


# ================================================================== CLI
CLI = ["--arch", FD, "--smoke", "--batch", "3", "--prompt-len", "6",
       "--gen-len", "5"]


def test_cli_engine_chaos_metrics_and_trace(tmp_path, capsys, monkeypatch):
    monkeypatch.setenv("REPRO_FD_STREAM_C", "4")
    metrics, trace = tmp_path / "m.json", tmp_path / "t.jsonl"
    try:
        assert tserve.main(CLI + ["--device", "cpu", "--engine", "--slots",
                                  "2", "--chaos", "0", "--metrics-file",
                                  str(metrics), "--trace-file",
                                  str(trace)]) == 0
    finally:
        tmetrics.set_default_registry(None)
    out = capsys.readouterr().out
    assert "[serve] engine(2 slots, greedy) generated" in out
    assert "[serve] chaos(seed=0):" in out
    dump = json.loads(metrics.read_text())
    assert dump["version"] == 1
    finished = dump["metrics"]["repro_requests_finished_total"]["series"]
    assert sum(s["value"] for s in finished) == 3
    spans = jtracing.validate_spans(ttracing.load_jsonl(str(trace)))
    assert sorted(spans) == ["req0", "req1", "req2"]
    assert all(len(r) == 1 for r in spans.values())
    chrome = json.loads((tmp_path / "t.jsonl.chrome.json").read_text())
    assert chrome["traceEvents"]


def test_cli_sampled_engine_and_prometheus(tmp_path, capsys, monkeypatch):
    monkeypatch.setenv("REPRO_FD_STREAM_C", "4")
    prom = tmp_path / "m.prom"
    try:
        assert tserve.main(CLI + ["--device", "cpu", "--engine",
                                  "--temperature", "0.7", "--top-k", "8",
                                  "--seed", "13", "--metrics-file",
                                  str(prom)]) == 0
    finally:
        tmetrics.set_default_registry(None)
    out = capsys.readouterr().out
    assert "T=0.7/top8" in out and "packed=" in out
    assert "# TYPE repro_requests_finished_total counter" in prom.read_text()


@pytest.mark.parametrize("extra", [
    ["--chaos", "0"], ["--deadline", "1.5"], ["--queue-cap", "2"],
    ["--trace-file", "t.jsonl"], ["--top-k", "4"],
    ["--top-k", "4", "--temperature", "0.5"], ["--temperature", "-1"],
    ["--engine", "--top-k", "-2", "--temperature", "0.5"],
])
def test_cli_refusals_match_jax(extra, capsys):
    """Each flag the solo path cannot honour is refused with JAX's
    message, before any model is built."""
    msgs = []
    for main in (tserve.main, jserve.main):
        with pytest.raises(SystemExit) as e:
            main(CLI + extra)
        assert e.value.code == 2
        msgs.append(capsys.readouterr().err.strip().splitlines()[-1])
    assert msgs[0] == msgs[1], msgs
