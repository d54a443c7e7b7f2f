"""The kernel tier of the port's observability (repro_torch.obs.cost,
compilewatch, the kernel half of devstats) and the Trainer's metrics,
against the JAX package's (repro.obs, ``tests/test_obs_kernel.py`` and
``tests/test_obs.py``, whose test names each case keeps).

* cost model — every family estimator, ``cost_of_plan`` on SKI (dense,
  windowed, fft), causal/acausal FD and baseline plans built by both
  packages from the bridged smoke models' parameters, ``decode_step_cost``
  of three smoke archs, ``seconds`` and ``achieved_fraction``: JAX's values
  to 1e-12 relative; ``peaks`` (the CPU overrides as JAX's, the H100's
  data-sheet figures by name and dtype, an unknown card raising);
  ``flop_cost`` (``FlopCounterMode``, JAX's ``xla_cost``) on a matmul;
* compile watchdog — counts, timing, the retrace warning, the untimed
  mark; the engine's compiles pinned across two fleets, equal to
  ``trace_counts`` and to the JAX engine's ``compile_watch.counts()``;
* attribution — ``aggregate_chrome`` on JAX's synthetic events and on
  card-shaped ones (device ranges, launch correlation, the refusal of a
  card trace without device events for its regions), a CPU profile of
  every ``kernels/ops.py`` entry and its backward under JAX's region
  names, ``attribute_engine``'s analytic and profile paths;
* the Trainer's metric families against JAX's Trainer on the same toy
  step and failure hook, and ``launch.train --smoke --device cpu
  --metrics-file --trace-file`` with JAX's assertions.
"""
import contextlib
import importlib.util
import json
import math
import os
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import repro.serving_engine as jse  # noqa: E402
import repro_torch.serving_engine as tse  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduce_for_smoke as jreduce  # noqa: E402
from repro.core import ski as jski  # noqa: E402
from repro.core import tno as jtno  # noqa: E402
from repro.data.pipeline import DataConfig as JDataConfig  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro.nn.params import unbox  # noqa: E402
from repro.obs import compilewatch as jcompile  # noqa: E402
from repro.obs import cost as jcost  # noqa: E402
from repro.obs import devstats as jdevstats  # noqa: E402
from repro.obs import metrics as jmetrics  # noqa: E402
from repro.runtime import trainer as jtrainer  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config, reduce_for_smoke  # noqa: E402
from repro_torch.core import ski, tno  # noqa: E402
from repro_torch.data.pipeline import DataConfig  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.obs import compilewatch as tcompile  # noqa: E402
from repro_torch.obs import cost as tcost  # noqa: E402
from repro_torch.obs import devstats as tdevstats  # noqa: E402
from repro_torch.obs import metrics as tmetrics  # noqa: E402
from repro_torch.obs import profiling as tprof  # noqa: E402
from repro_torch.obs import tracing as ttracing  # noqa: E402
from repro_torch.runtime import trainer as ttrainer  # noqa: E402

torch.set_num_threads(1)
FD = "fd-tnn-lm-wt103"
PLENS = [3, 6, 5, 2]                  # tests/test_obs_kernel.py's traffic
GENS = [6, 7, 8, 6]
MAX_LEN = 32
REL = 1e-12
H100 = "NVIDIA H100 80GB HBM3"


def _close(a: float, b: float) -> bool:
    return math.isclose(a, b, rel_tol=REL, abs_tol=0.0)


def _same_costs(got: dict, want: dict) -> None:
    assert sorted(got) == sorted(want)
    for k in want:
        assert _close(got[k].flops, want[k].flops), (k, got[k], want[k])
        assert _close(got[k].bytes, want[k].bytes), (k, got[k], want[k])


@pytest.fixture(scope="module")
def env():
    old = os.environ.get("REPRO_FD_STREAM_C")
    os.environ["REPRO_FD_STREAM_C"] = "4"
    try:
        jcfg = jreduce(jget_config(FD), dtype="float32",
                       param_dtype="float32")
        cfg = reduce_for_smoke(get_config(FD))
        jparams, _ = unbox(jtransformer.init_model(jax.random.PRNGKey(0),
                                                   jcfg))
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


# ============================================================ cost model
def test_cost_arithmetic():
    for mod in (tcost, jcost):
        a, b = mod.Cost(10.0, 4.0), mod.Cost(5.0, 1.0)
        assert (a + b).flops == 15.0 and (a + b).bytes == 5.0
        assert a.scale(3).flops == 30.0 and a.scale(3).bytes == 12.0
        t = mod.total({"x": a, "y": b})
        assert t.flops == 15.0 and t.bytes == 5.0


#: (estimator, positional args, keyword args) at the paths' shapes
ESTIMATORS = [
    ("short_conv_cost", (512, 32, 512, 8), {}),
    ("short_conv_cost", (2048, 4, 5376, 8), {"elem": 2}),
    ("interp_cost", (512, 64, 512, 8), {}),
    ("gram_cost", ("dense", 64, 512, 8), {}),
    ("gram_cost", ("windowed", 512, 512, 8), {"bw": 96}),
    ("gram_cost", ("fft", 8192, 64, 2), {}),
    ("rfft_cost", (1024, 512, 8), {}),
    ("fd_mul_cost", (513, 512, 8), {}),
    ("fd_khat_grad_cost", (513, 512, 8), {}),
    ("hilbert_window_cost", (512, 512), {}),
    ("ssd_cost", (2048, 5120, 128, 8), {"elem": 2}),
    ("attention_decode_cost", (1152, 8, 256, 4), {}),
    ("mlp_cost", (2560, 10240, 4, 1), {}),
    ("lm_head_cost", (2560, 262144, 4), {"elem": 2}),
]


@pytest.mark.parametrize("name,args,kw", ESTIMATORS,
                         ids=[f"{e[0]}-{i}" for i, e in
                              enumerate(ESTIMATORS)])
def test_estimators_match_jax(name, args, kw):
    got = getattr(tcost, name)(*args, **kw)
    want = getattr(jcost, name)(*args, **kw)
    assert _close(got.flops, want.flops) and _close(got.bytes, want.bytes)


def test_fft_flops_and_dtype_bytes_match_jax():
    for n in (1, 2, 7, 1024, 16384):
        assert _close(tcost.fft_flops(n), jcost.fft_flops(n))
    for t, j in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16),
                 ("float16", "float16")):
        assert tcost.dtype_bytes(t) == jcost.dtype_bytes(j)


def test_windowed_gram_band_budget_env(monkeypatch):
    """Without ``bw`` the windowed Gram reads each package's band budget;
    under one ``REPRO_SKI_BAND_MAX`` both price the same band."""
    monkeypatch.setenv("REPRO_SKI_BAND_MAX", "96")
    got = tcost.gram_cost("windowed", 512, 64, 2)
    want = jcost.gram_cost("windowed", 512, 64, 2)
    assert _close(got.flops, want.flops) and _close(got.bytes, want.bytes)
    assert got.flops == 2.0 * 2 * 64 * 512 * 96
    with pytest.raises(ValueError, match="unknown gram variant"):
        tcost.gram_cost("sparse", 16, 8)


def test_peaks_platforms_and_env_override(monkeypatch):
    monkeypatch.delenv("REPRO_CPU_PEAK_FLOPS", raising=False)
    monkeypatch.delenv("REPRO_CPU_PEAK_BW", raising=False)
    assert tcost.peaks("cpu") == tcost.Peaks(*dataclass_values(
        jcost.peaks("cpu")))
    monkeypatch.setenv("REPRO_CPU_PEAK_FLOPS", "1e11")
    monkeypatch.setenv("REPRO_CPU_PEAK_BW", "4e10")
    pk = tcost.peaks("cpu")
    assert pk.flops == 1e11 and pk.mem_bw == 4e10
    assert dataclass_values(pk) == dataclass_values(jcost.peaks("cpu"))
    if not torch.cuda.is_available():         # the default platform
        assert tcost.peaks() == pk
    monkeypatch.setenv("REPRO_CPU_PEAK_FLOPS", "fast")
    for mod in (tcost, jcost):
        with pytest.raises(ValueError, match="REPRO_CPU_PEAK_FLOPS"):
            mod.peaks("cpu")
    with pytest.raises(ValueError, match="unknown platform"):
        tcost.peaks("tpu")                     # the port runs on CUDA


def dataclass_values(pk) -> tuple:
    return (pk.flops, pk.mem_bw, pk.collective_bw)


@pytest.mark.parametrize("name,bw,fp32,bf16", [
    (H100, 3.35e12, 67e12, 989e12),
    ("NVIDIA H100 PCIe", 2.0e12, 51e12, 756e12),
    ("NVIDIA H100 NVL", 3.9e12, 60e12, 835.5e12)])
def test_peaks_h100_by_name_and_dtype(name, bw, fp32, bf16):
    """The data sheet's figures by the card's name; the FLOP rate follows
    the dtype (TF32 is off for the fp32 tier, so fp32 is the CUDA cores'
    rate); ``chip_smoke.py`` reads the same table."""
    assert tcost.peaks("gpu", name=name) == tcost.Peaks(fp32, bw, 0.0)
    assert tcost.peaks("gpu", dtype=torch.float32, name=name).flops == fp32
    for dt in (torch.bfloat16, torch.float16, "bfloat16"):
        assert tcost.peaks("gpu", dtype=dt, name=name).flops == bf16
    root = Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  root / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert smoke.PEAKS is tcost.GPU_PEAKS
    assert smoke._peaks(name)[1] == (bw, fp32, tcost.GPU_PEAKS[
        smoke._peaks(name)[0]][2], bf16)


def test_peaks_unknown_card_raises():
    for name in ("NVIDIA A100-SXM4-80GB", "Tesla V100", ""):
        with pytest.raises(RuntimeError, match="no published peaks"):
            tcost.peaks("gpu", name=name)
    with pytest.raises(ValueError, match="no peak FLOP rate"):
        tcost.peaks("gpu", dtype=torch.int8, name=H100)


def test_roofline_seconds_and_fraction():
    pk = tcost.Peaks(flops=100.0, mem_bw=10.0)
    compute_bound = tcost.Cost(flops=1000.0, bytes=1.0)
    s = tcost.seconds(compute_bound, pk)
    assert s["dominant"] == "compute" and s["bound_s"] == 10.0
    memory_bound = tcost.Cost(flops=1.0, bytes=1000.0)
    s = tcost.seconds(memory_bound, pk)
    assert s["dominant"] == "memory" and s["bound_s"] == 100.0
    assert tcost.achieved_fraction(compute_bound, 10.0, pk) \
        == pytest.approx(1.0)
    assert tcost.achieved_fraction(compute_bound, 100.0, pk) \
        == pytest.approx(0.1)
    assert math.isnan(tcost.achieved_fraction(compute_bound, 0.0, pk))
    # JAX's values on the H100's peaks and the FD path's costs
    hp = tcost.peaks("gpu", name=H100)
    jp = jcost.Peaks(hp.flops, hp.mem_bw)
    for f, b, t in ((223371264.0, 104927232.0, 3.1e-5),
                    (5.6e9, 1.05e8, 1e-3), (0.0, 8.0, 1e-6)):
        got = tcost.seconds(tcost.Cost(f, b), hp)
        want = jcost.seconds(jcost.Cost(f, b), jp)
        assert got["dominant"] == want["dominant"]
        for k in ("compute_s", "memory_s", "bound_s"):
            assert _close(got[k], want[k])
        assert _close(tcost.achieved_fraction(tcost.Cost(f, b), t, hp),
                      jcost.achieved_fraction(jcost.Cost(f, b), t, jp))


# ------------------------------------------ plans built by both packages
def _bridged(arch, variant, causal=True):
    """A smoke arch's TNO mixer of ``variant``: JAX's init, loaded leaf for
    leaf into the port's module through the bridge's flattening; returns
    (d, port TNOConfig, JAX TNOConfig, port params, JAX params)."""
    cfg = reduce_for_smoke(get_config(arch))
    jcfg = jreduce(jget_config(arch))
    tcfg = transformer._tno_cfg(cfg, variant, causal).tno
    jtcfg = jtransformer._tno_cfg(jcfg, variant, causal).tno
    jp, _ = unbox(jtno.tno_init(jax.random.PRNGKey(0), jtcfg))
    params = tno.tno_init(tcfg)
    flat = dict(bridge._flatten(jax.tree.map(np.asarray, jp)))
    assert set(flat) == {k for k, _ in params.named_parameters()}
    with torch.no_grad():
        for k, prm in params.named_parameters():
            prm.copy_(bridge._as_torch(flat[k]))
    return cfg.d_model, tcfg, jtcfg, params, jp


@pytest.mark.parametrize("variant", ["dense", "windowed", "fft"])
def test_ski_plan_cost_dispatch(variant):
    """cost_of_plan keys off the plan dicts each package builds from the
    same parameters, and its kernel names track the plan's variant."""
    d, tcfg, jtcfg, params, jp = _bridged("ski-tnn-lm-wt103", "ski")
    n = 64
    plan = ski.ski_plan(params, tcfg.ski_cfg(), n, True, variant=variant)
    jplan = jski.ski_plan(jp, jtcfg.ski_cfg(), n, True, variant=variant)
    assert plan["variant"] == jplan["variant"] == variant
    got = tcost.cost_of_plan(plan, n=n, d=d, batch=2)
    _same_costs(got, jcost.cost_of_plan(jplan, n=n, d=d, batch=2))
    keys = {"dense": {"interp_reduce", "ski_fused"},
            "windowed": {"interp_reduce", "ski_windowed", "ski_expand2"},
            "fft": {"interp_reduce", "ski_fft_gram", "ski_expand2"}}
    assert set(got) == keys[variant]
    if variant == "dense":                 # the TNO's own plan is dense
        _same_costs(tcost.cost_of_plan(tno.tno_plan(params, tcfg, n), n=n,
                                       d=d, dtype=torch.bfloat16),
                    jcost.cost_of_plan(jtno.tno_plan(jp, jtcfg, n), n=n,
                                       d=d, dtype=jnp.bfloat16))


@pytest.mark.parametrize("kind", ["fd-causal", "fd-acausal", "tno"])
def test_fd_and_baseline_plan_cost(kind):
    arch, variant = (("tnn-lm-wt103", "tno") if kind == "tno"
                     else (FD, "fd"))
    d, tcfg, jtcfg, params, jp = _bridged(arch, variant,
                                          causal=kind != "fd-acausal")
    n = 24
    plan = tno.tno_plan(params, tcfg, n)
    jplan = jtno.tno_plan(jp, jtcfg, n)
    assert sorted(plan) == sorted(jplan)
    got = tcost.cost_of_plan(plan, n=n, d=d, batch=3)
    _same_costs(got, jcost.cost_of_plan(jplan, n=n, d=d, batch=3))
    want_keys = {"fd-causal": {"rfft", "fd_mul", "hilbert_window"},
                 "fd-acausal": {"rfft", "fd_mul"},
                 "tno": {"toeplitz_fft"}}[kind]
    assert set(got) == want_keys
    with pytest.raises(ValueError, match="unrecognised plan keys"):
        tcost.cost_of_plan({"mystery": 1}, n=n, d=6)


@pytest.mark.parametrize("arch", [FD, "mamba2-2.7b", "gemma3-4b"])
def test_decode_step_cost_families(arch):
    """The same keys and values as JAX's at smoke size (gemma3's head
    width is the reference's d // n_heads, not its config's head_dim)."""
    cfg = reduce_for_smoke(get_config(arch))
    jcfg = jreduce(jget_config(arch))
    for batch in (1, 4):
        got = tcost.decode_step_cost(cfg, batch=batch, max_len=MAX_LEN)
        _same_costs(got, jcost.decode_step_cost(jcfg, batch=batch,
                                                max_len=MAX_LEN))
    costs = tcost.decode_step_cost(cfg, batch=4, max_len=MAX_LEN)
    c1 = tcost.decode_step_cost(cfg, batch=1, max_len=MAX_LEN)
    family = {FD: "fd_stream", "mamba2-2.7b": "ssd",
              "gemma3-4b": "attention"}[arch]
    assert family in costs and {"embed", "lm_head"} <= set(costs)
    assert costs["lm_head"].flops == pytest.approx(4 * c1["lm_head"].flops)


def test_xla_cost_cross_check_matmul():
    """``flop_cost`` (FlopCounterMode) on a plain matmul counts 2·m·n·k,
    the estimators' convention (JAX holds XLA's cost_analysis so)."""
    a = torch.ones(32, 48)
    b = torch.ones(48, 16)
    got = tcost.flop_cost(lambda x, y: x @ y, a, b)
    assert got["flops"] == 2.0 * 32 * 48 * 16
    assert "bytes" not in got and sum(got["raw"].values()) == got["flops"]
    mlp = tcost.mlp_cost(48, 64, batch=2, tokens=3)
    w = [torch.ones(48, 64), torch.ones(48, 64), torch.ones(64, 48)]
    x = torch.ones(6, 48)
    got = tcost.flop_cost(lambda: ((x @ w[0]) * (x @ w[1])) @ w[2])
    assert got["flops"] == mlp.flops


# ======================================================= compile watchdog
class _FakeLog:
    def __init__(self):
        self.warnings = []

    def warning(self, msg, *a):
        self.warnings.append(msg % a if a else msg)


def test_compilewatch_counts_time_and_warn():
    """The port's compile is the first call at a new argument signature;
    the counts, the registry and the warning text are JAX's for the same
    call sequence."""
    def run(mod, reg, log, x4, x8):
        w = mod.CompileWatch(metrics=reg, prefix="t.", logger=log)
        w.expect("f", 1)
        f = w.wrap("f", lambda x: x * 2)
        f(x4)
        f(x4)                               # seen signature: no compile
        assert w.count("f") == 1 and not log.warnings
        f(x8)                               # new shape -> compile
        return w

    reg, log = tmetrics.Registry(), _FakeLog()
    w = run(tcompile, reg, log, torch.ones(4), torch.ones(8))
    jreg, jlog = jmetrics.Registry(), _FakeLog()
    jw = run(jcompile, jreg, jlog, jnp.ones((4,)), jnp.ones((8,)))
    assert w.counts() == jw.counts() == {"f": 2}
    assert log.warnings == jlog.warnings
    assert len(log.warnings) == 1
    assert "compile watchdog: t.f retraced" in log.warnings[0]
    assert reg.get("repro_compiles_total").get(fn="t.f") == 2
    h = reg.get("repro_compile_seconds").labels(fn="t.f")
    assert h.count == 2 and h.sum > 0       # both first calls were timed
    assert reg.to_dict()["repro_compiles_total"] \
        == jreg.to_dict()["repro_compiles_total"]


def test_compilewatch_signature_rule():
    """Tensors count by (shape, dtype, device), containers element by
    element, other arguments by value; an unhashable one by identity."""
    w = tcompile.CompileWatch(metrics=tmetrics.Registry())
    f = w.wrap("g", lambda *a, **k: None)
    x = torch.ones(2, 3)
    f(x, 1)
    f(torch.zeros(2, 3), 1)                 # same signature
    f(x, 2)                                 # another value
    f(x.double(), 1)                        # another dtype
    f({"t": x, "n": "a"}, k=[x])
    f({"n": "a", "t": torch.ones(2, 3)}, k=[torch.ones(2, 3)])  # same
    model = torch.nn.Linear(1, 1)
    f(model)
    f(model)                                # the same module
    f(torch.nn.Linear(1, 1))                # another module
    assert w.count("g") == 6


def test_compilewatch_untimed_mark():
    """A first call recorded without a live timing (the engine's
    ``_trace``) still counts, just without a latency observation."""
    reg = tmetrics.Registry()
    w = tcompile.CompileWatch(metrics=reg)
    w._mark("g")
    assert w.count("g") == 1
    assert reg.get("repro_compiles_total").get(fn="g") == 1
    assert reg.get("repro_compile_seconds").labels(fn="g").count == 0


def _fleet(mod, prompts, uid_prefix):
    return [mod.Request(uid=f"{uid_prefix}{i}", prompt=pr, max_new=g)
            for i, (pr, g) in enumerate(zip(prompts, GENS))]


def test_engine_compiles_pinned_across_fleets(env):
    """Compiles track SHAPES, not request count: a second identical fleet
    through the same engine compiles nothing new. The watch's counts are
    the engine's ``trace_counts`` (and the registry's
    ``repro_compiles_total{fn="engine.*"}``), and the JAX engine's
    ``compile_watch.counts()`` on the same fleets."""
    def fleets(mod, eng):
        sched = mod.Scheduler(eng)
        for r in _fleet(mod, env.prompts, "a"):
            sched.submit(r)
        results, state = sched.run()
        assert all(len(results[f"a{i}"]) == g for i, g in enumerate(GENS))
        first = eng.compile_watch.counts()
        sched2 = mod.Scheduler(eng)
        for r in _fleet(mod, env.prompts, "b"):
            sched2.submit(r)
        results2, _ = sched2.run(state)
        assert all(len(results2[f"b{i}"]) == g for i, g in enumerate(GENS))
        assert eng.compile_watch.counts() == first
        return first

    reg = tmetrics.Registry()
    eng = tse.Engine(env.cfg, env.model, slots=4, max_len=MAX_LEN,
                     metrics=reg)
    first = fleets(tse, eng)
    assert first and first.get("generate", 0) >= 1
    assert first == {k: v for k, v in eng.trace_counts.items() if v}
    compiles = reg.get("repro_compiles_total")
    for fn, n in eng.trace_counts.items():
        assert compiles.get(fn="engine." + fn) == n
    for name, n in first.items():             # within the budgets
        exp = eng.compile_watch._expected.get(name)
        assert exp is None or n <= exp, (name, n, exp)
    jeng = jse.Engine(env.jcfg, env.jparams, slots=4, max_len=MAX_LEN,
                      metrics=jmetrics.Registry())
    assert fleets(jse, jeng) == first
    assert eng.compile_watch._expected == jeng.compile_watch._expected


# ============================================================ attribution
P = tdevstats.KERNEL_SCOPE_PREFIX


def test_aggregate_chrome_synthetic():
    events = [
        {"name": P + "fd_mul", "ph": "X", "dur": 1500.0},
        {"name": P + "fd_mul", "ph": "X", "dur": 500.0},
        {"name": P + "rfft", "ph": "B", "ts": 100.0, "pid": 1, "tid": 2},
        {"name": P + "rfft", "ph": "E", "ts": 400.0, "pid": 1, "tid": 2},
        {"name": "unrelated", "ph": "X", "dur": 9e9},
    ]
    got = tdevstats.aggregate_chrome(events)
    want = jdevstats.aggregate_chrome(events)
    assert got == want == {"fd_mul": pytest.approx(2e-3),
                           "rfft": pytest.approx(3e-4)}
    assert P == jdevstats.KERNEL_SCOPE_PREFIX


def _card_trace(annotations: bool) -> list:
    """A card trace as the profiler writes one: a host region around two
    launches (one a driver call), a launch outside any region, their
    kernels by correlation id, and the device ranges of the region."""
    ev = [{"ph": "X", "cat": "user_annotation", "name": P + "fd_tno",
           "pid": 1, "tid": 2, "ts": 100.0, "dur": 50.0},
          {"ph": "X", "cat": "user_annotation", "name": P + "fd_tno",
           "pid": 1, "tid": 3, "ts": 300.0, "dur": 50.0},
          {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
           "pid": 1, "tid": 2, "ts": 110.0, "dur": 5.0,
           "args": {"correlation": 7}},
          {"ph": "X", "cat": "cuda_driver", "name": "cuLaunchKernel",
           "pid": 1, "tid": 3, "ts": 320.0, "dur": 5.0,
           "args": {"correlation": 8}},
          {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
           "pid": 1, "tid": 2, "ts": 200.0, "dur": 5.0,
           "args": {"correlation": 9}},
          {"ph": "X", "cat": "kernel", "name": "fd_mul_vec2", "pid": 0,
           "tid": 7, "ts": 400.0, "dur": 30.0, "args": {"correlation": 7}},
          {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoD", "pid": 0,
           "tid": 7, "ts": 440.0, "dur": 10.0, "args": {"correlation": 8}},
          {"ph": "X", "cat": "kernel", "name": "other", "pid": 0, "tid": 7,
           "ts": 460.0, "dur": 40.0, "args": {"correlation": 9}}]
    if annotations:
        ev += [{"ph": "X", "cat": "gpu_user_annotation", "name": P + "fd_tno",
                "pid": 0, "tid": 7, "ts": 400.0, "dur": 35.0},
               {"ph": "X", "cat": "gpu_user_annotation", "name": P + "fd_tno",
                "pid": 0, "tid": 7, "ts": 440.0, "dur": 10.0}]
    return ev


def test_aggregate_chrome_card_trace_device_time():
    """On a card trace a region's time is device time: its device ranges
    where the profiler wrote them, else its kernels by launch
    correlation; never the host ranges (100 µs here)."""
    got = tdevstats.aggregate_chrome(_card_trace(True))
    assert got == {"fd_tno": pytest.approx(45e-6)}
    got = tdevstats.aggregate_chrome(_card_trace(False))
    assert got == {"fd_tno": pytest.approx(40e-6)}
    assert tdevstats.region_kernels(_card_trace(False)) == {
        "fd_tno": {"fd_mul_vec2": [1, pytest.approx(30e-6)],
                   "Memcpy DtoD": [1, pytest.approx(10e-6)]}}


def test_aggregate_chrome_card_trace_without_device_regions_raises():
    ev = [e for e in _card_trace(False) if e["cat"] not in _LAUNCHES]
    with pytest.raises(ValueError, match="none for the kernel regions"):
        tdevstats.aggregate_chrome(ev)


_LAUNCHES = ("cuda_runtime", "cuda_driver")


def test_kernel_region_nullcontext_without_env(monkeypatch):
    monkeypatch.delenv("REPRO_PROFILE_DIR", raising=False)
    assert isinstance(tdevstats.kernel_region("fd_tno"),
                      contextlib.nullcontext)
    monkeypatch.setenv("REPRO_PROFILE_DIR", "/nonexistent")
    assert not isinstance(tdevstats.kernel_region("fd_tno"),
                          contextlib.nullcontext)
    with pytest.raises(KeyError, match="inside"):     # swallows nothing
        with tdevstats.kernel_region("fd_tno"):
            raise KeyError("inside")


def _op_cases():
    g = torch.Generator().manual_seed(0)

    def t(*shape):
        return torch.randn(*shape, generator=g)
    b, n, d, r, m = 2, 16, 8, 4, 3
    lo, w_lo, _ = ski.make_inducing(n, r, None)
    a_dense = t(d, r, r)
    a_coef = t(d, 2 * r - 1)
    return {
        "fd_tno": (lambda x, k: ops.fd_tno(x, k), (t(b, n, d), t(d, n + 1)),
                   "fd_tno"),
        "short_conv": (lambda x, f: ops.short_conv(x, f, True),
                       (t(b, n, d), t(d, m)), "short_conv"),
        "interp_reduce": (lambda x: ops.interp_reduce(x, lo, w_lo, r),
                          (t(b, n, d),), "interp_reduce"),
        "interp_expand": (lambda z: ops.interp_expand(z, lo, w_lo),
                          (t(b, r, d),), "interp_expand"),
        "ski_fused_pass2": (lambda x, z: ops.ski_fused_pass2(
            x, z, a_dense, t(d, m), True), (t(b, n, d), t(b, r, d)),
            "ski_fused"),
        "ski_fused_tno": (lambda x, a: ops.ski_fused_tno(
            x, a, t(d, m), lo, w_lo, r, True), (t(b, n, d), a_dense),
            "ski_fused"),
        "ski_windowed": (lambda x, c: ops.ski_fused_tno_coef(
            x, c, t(d, m), lo, w_lo, r, True, "windowed"),
            (t(b, n, d), a_coef), "ski_windowed"),
        "ski_fft": (lambda x, c: ops.ski_fused_tno_coef(
            x, c, t(d, m), lo, w_lo, r, True, "fft"),
            (t(b, n, d), a_coef), "ski_fft"),
        "ssd": (lambda x, dt: ops.ssd_scan(
            x, dt, -torch.rand(2, generator=g), t(1, 8, 1, 4),
            t(1, 8, 1, 4), t(2), chunk=4),
            (t(1, 8, 2, 3), torch.rand(1, 8, 2, generator=g) + 0.1), "ssd"),
    }


OP_CASES = ["fd_tno", "short_conv", "interp_reduce", "interp_expand",
            "ski_fused_pass2", "ski_fused_tno", "ski_windowed", "ski_fft",
            "ssd"]


@pytest.mark.parametrize("case", OP_CASES)
def test_ops_entries_profile_under_jax_region_names(case, monkeypatch,
                                                    tmp_path):
    """A real CPU ``torch.profiler`` trace of each ``kernels/ops.py`` entry
    (and of its autograd Function's backward, where the entry is
    differentiable) under ``REPRO_PROFILE_DIR`` gives a row under the JAX
    package's region name (``src/repro/kernels/ops.py``)."""
    fn, args, region = _op_cases()[case]
    monkeypatch.setenv("REPRO_PROFILE_DIR", str(tmp_path))
    backward = case != "ski_fused_pass2"      # forward-only on the card
    args = [a.requires_grad_(backward) for a in args]
    with tprof.session("ops"):
        y = fn(*args)
        if backward:
            y.sum().backward()
    events = tdevstats.load_profile_traces(str(tmp_path))
    rows = tdevstats.aggregate_chrome(events)
    assert set(rows) == {region} and rows[region] > 0
    entries = [e for e in events if e.get("name") == P + region]
    assert len(entries) == (2 if backward else 1)


def _scheduled(env, reg):
    eng = tse.Engine(env.cfg, env.model, slots=4, max_len=MAX_LEN,
                     metrics=reg)
    sched = tse.Scheduler(eng, metrics=reg)
    for r in _fleet(tse, env.prompts, "r"):
        sched.submit(r)
    t0 = time.perf_counter()
    sched.run()
    return eng, time.perf_counter() - t0


def test_attribute_engine_coverage_and_memory(env):
    """The analytic path: engine-drain seconds split by the FLOP shares of
    one decode step account for most of the measured drain, over JAX's
    kernel families for the arch."""
    reg = tmetrics.Registry()
    eng, drain_s = _scheduled(env, reg)
    attr = tdevstats.attribute_engine(eng, reg, drain_s=drain_s)
    assert attr["path"] == "analytic" and attr["device_s"] > 0
    assert attr["coverage"] is not None and attr["coverage"] >= 0.5
    kernels = {row["kernel"] for row in attr["rows"]}
    assert kernels == set(jcost.decode_step_cost(env.jcfg, 4, MAX_LEN))
    assert sum(row["frac"] for row in attr["rows"]) == pytest.approx(1.0)
    sec = reg.get("repro_kernel_seconds_total")
    assert sum(sec.get(kernel=k) for k in kernels) \
        == pytest.approx(attr["device_s"], rel=1e-6)
    fracs = reg.get("repro_kernel_roofline_frac")
    assert any(fracs.get(kernel=k) > 0 for k in kernels)


def test_attribute_engine_profile_path(env, tmp_path):
    """With a profile whose trace holds kernel regions, their seconds are
    the rows (JAX's profile path)."""
    doc = {"traceEvents": [
        {"name": P + "fd_tno", "ph": "X", "dur": 3000.0},
        {"name": P + "fd_mul", "ph": "X", "dur": 1000.0}]}
    (tmp_path / "serve.1.2.trace.json").write_text(json.dumps(doc))
    reg = tmetrics.Registry()
    eng, drain_s = _scheduled(env, reg)
    attr = tdevstats.attribute_engine(eng, reg, drain_s=drain_s,
                                      profile_dir=str(tmp_path))
    assert attr["path"] == "profile"
    assert [(r["kernel"], r["frac"]) for r in attr["rows"]] == [
        ("fd_tno", pytest.approx(0.75)), ("fd_mul", pytest.approx(0.25))]
    assert reg.get("repro_kernel_seconds_total").get(kernel="fd_tno") \
        == pytest.approx(3e-3)


# ============================================================== trainer
def _untimed(reg) -> dict:
    """The registry's JSON mirror with the step-time series' values and
    the throughput gauge's value dropped (counts kept)."""
    out = reg.to_dict()
    for s in out["repro_train_step_seconds"]["series"]:
        s.pop("sum")
        s.pop("counts")
    for s in out["repro_train_tokens_per_s"]["series"]:
        assert s.pop("value") > 0
    return out


def test_trainer_metrics():
    """tests/test_obs.py's toy step and failure hook through both
    Trainers: the same families, labels and counter values."""
    def failure_hook_factory():
        boom = {"armed": True}

        def hook(step, attempt):
            if step == 2 and attempt == 0 and boom["armed"]:
                boom["armed"] = False
                raise RuntimeError("injected")
        return hook

    data = dict(vocab=16, global_batch=2, seq_len=4, seed=0)
    jreg = jmetrics.Registry()
    jtr = jtrainer.Trainer(
        jtrainer.TrainerConfig(total_steps=5, max_retries=1,
                               undonated_retry_copy=False, log_every=0),
        lambda state, batch: (state + 1, {"loss": 1.0 / (state + 1.0)}),
        JDataConfig(**data), failure_hook=failure_hook_factory(),
        metrics=jreg)
    _, jstep = jtr.run(jnp.float32(0.0))

    def train_step(model, opt, batch):
        s = opt["s"]
        return {"s": s + 1}, {"loss": 1.0 / (s + 1.0)}

    reg = tmetrics.Registry()
    tr = ttrainer.Trainer(
        ttrainer.TrainerConfig(total_steps=5, max_retries=1, log_every=0),
        train_step, DataConfig(**data), failure_hook=failure_hook_factory(),
        metrics=reg)
    opt, step = tr.run(torch.nn.Linear(1, 1), {"s": torch.zeros(())})
    assert step == jstep == 5 and float(opt["s"]) == 5.0
    assert reg.get("repro_train_steps_total").get() == 5
    assert reg.get("repro_train_retries_total").get() == 1
    assert reg.get("repro_train_step_seconds").get() == 5
    assert reg.get("repro_train_loss").get() == pytest.approx(0.2)
    assert reg.get("repro_train_tokens_per_s").get() > 0
    assert len(tr.step_seconds) == len(tr.metrics_history) == 5
    assert _untimed(reg) == _untimed(jreg)


def test_train_entrypoint_emits_obs_artifacts(tmp_path, monkeypatch,
                                              capsys):
    """--metrics-file/--trace-file with JAX's assertions (3 steps, one
    compile, 6 span events, the Chrome export), under a CPU profile whose
    kernel regions are the FD layers' forwards and backwards; a
    checkpointed run counts JAX's ``{mode}`` labels."""
    mpath = str(tmp_path / "train.json")
    tpath = str(tmp_path / "train.jsonl")
    monkeypatch.setenv("REPRO_PROFILE_DIR", str(tmp_path / "prof"))
    argv = ["--arch", FD, "--smoke", "--device", "cpu", "--steps", "3",
            "--seq-len", "16", "--global-batch", "2"]
    try:
        assert ttrain.main(argv + ["--metrics-file", mpath, "--trace-file",
                                   tpath]) == 0
    finally:
        tmetrics.set_default_registry(None)
        ttracing.set_default_tracer(None)
    doc = json.load(open(mpath))["metrics"]
    assert doc["repro_train_steps_total"]["series"][0]["value"] == 3
    compiles = doc["repro_compiles_total"]["series"]
    assert [(s["labels"]["fn"], s["value"]) for s in compiles] \
        == [("train.train_step", 1)]
    assert doc["repro_compile_seconds"]["series"][0]["count"] == 1
    events = [json.loads(ln) for ln in open(tpath) if ln.strip()]
    steps = [e for e in events if e["name"] == "train_step"]
    assert len(steps) == 6                   # 3 steps x (B + E)
    assert {e["ph"] for e in steps} == {"B", "E"}
    assert os.path.exists(tpath + ".chrome.json")
    out = capsys.readouterr().out
    assert "WARNING" not in out and f"metrics: {mpath}" in out
    trace = tdevstats.load_profile_traces(str(tmp_path / "prof"))
    assert set(tdevstats.aggregate_chrome(trace)) == {"fd_tno"}
    n_layers = reduce_for_smoke(get_config(FD)).n_layers
    assert sum(e.get("name") == P + "fd_tno" for e in trace) \
        == 3 * n_layers * 2                  # forward + backward
    assert sum(e.get("name") == "train_step" for e in trace) == 3

    monkeypatch.delenv("REPRO_PROFILE_DIR")
    ck = str(tmp_path / "ckpt")
    try:
        assert ttrain.main(argv + ["--ckpt-dir", ck, "--ckpt-every", "2",
                                   "--metrics-file", mpath]) == 0
    finally:
        tmetrics.set_default_registry(None)
    doc = json.load(open(mpath))["metrics"]
    assert {s["labels"]["mode"]: s["value"] for s in
            doc["repro_train_checkpoints_total"]["series"]} \
        == {"async": 1, "sync": 1}
