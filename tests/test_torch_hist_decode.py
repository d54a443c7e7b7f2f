"""Port parity for the hist-replay decode cache (``repro_torch.models.
serving``: the baseline ``tno`` mixer's only decode, and FD's under
``REPRO_FD_STREAM=0`` or without parameters) against the JAX package, on
the smoke ``tnn-lm-wt103`` and ``fd-tnn-lm-wt103`` with weights bridged from
JAX, REPRO_FD_STREAM_C=4 set for both packages.

Contracts, each with its tolerance:
* greedy ``generate`` equals JAX ``generate`` at the same ``max_len``
  token for token (the baseline's RPE reads t / n, so its taps depend on
  max_len), and the port's ``tno`` Engine equals the JAX Engine and the
  port's solo decode;
* decode logits against the port's forward at n = max_len: 1e-5 of their
  scale (the replay sums the exact causal Toeplitz action in fp32, the
  forward takes it by FFT);
* ``PLAN_EVALS``: one realisation a layer at ``init_cache``, none a step;
  a params-less cache realises once a layer and step;
* stream against hist decode (fd): the same greedy tokens, logits within
  2e-2 (the tier of tests/test_fd_stream.py: overlap-save blocks reorder
  the sums);
* scalar against per-row positions: bitwise; ragged rows against their
  batch-1 decodes: 1e-5 of the logits' scale;
* JAX hist caches through ``bridge.cache_from_jax``: ``kcoef`` within 1e-5
  of its scale against the port's own, ``hist`` exact; snapshots pass both
  ways between the packages' Schedulers, token-exact.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import repro.serving_engine as jse  # noqa: E402
import repro_torch.serving_engine as tse  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduce_for_smoke as jreduce  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.launch.steps import StepBuilder  # noqa: E402
from repro.models import serving as jserving  # noqa: E402
from repro.models.transformer import init_model as jinit_model  # noqa: E402
from repro.nn.params import unbox  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config, reduce_for_smoke  # noqa: E402
from repro_torch.kernels import fd_stream  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import serving  # noqa: E402
from repro_torch.models.transformer import forward  # noqa: E402

torch.set_num_threads(1)
ARCHS = {"tno": "tnn-lm-wt103", "fd": "fd-tnn-lm-wt103"}


@pytest.fixture(scope="module")
def models():
    """{mixer: (JAX cfg, port cfg, JAX params, bridged port model)}."""
    out = {}
    for mixer, arch in ARCHS.items():
        jcfg = jreduce(jget_config(arch))
        cfg = reduce_for_smoke(get_config(arch))
        jparams, _ = unbox(jinit_model(jax.random.PRNGKey(0), jcfg))
        model = bridge.params_from_jax(jax.tree.map(np.asarray, jparams),
                                       cfg, device="cpu")
        out[mixer] = (jcfg, cfg, jparams, model)
    return out


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    """C = 4 for both packages; FD decode pinned to the hist cache."""
    monkeypatch.setenv("REPRO_FD_STREAM_C", "4")
    monkeypatch.setenv("REPRO_FD_STREAM", "0")


def _toks(b, s, vocab, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, (b, s))


def _decode_all(model, cfg, toks, cache, positions=None):
    """Teacher-force toks (b, s) one step at a time; positions(t) gives
    each step's ``cur_len`` (default the int t). Returns (logits (b, s,
    V_pad), last cache)."""
    got = []
    with torch.no_grad():
        for t in range(toks.shape[1]):
            pos = t if positions is None else positions(t)
            logits, cache = serving.decode_step(model, cfg, toks[:, t:t + 1],
                                                cache, pos)
            got.append(logits[:, 0])
    return torch.stack(got, 1), cache


def _rel(got, want) -> float:
    return float((got - want).abs().max() / want.abs().max())


# ------------------------------------------------------------ solo decode
@pytest.mark.parametrize("p,gen,max_len", [(5, 7, 12), (3, 9, 16)])
@pytest.mark.parametrize("mixer", sorted(ARCHS))
def test_generate_is_token_exact_vs_jax(models, mixer, p, gen, max_len):
    jcfg, cfg, jparams, model = models[mixer]
    prompt = _toks(3, p, cfg.vocab, seed=p)
    want = jserve.generate(StepBuilder(jcfg), jparams,
                           jnp.asarray(prompt, jnp.int32), gen,
                           max_len=max_len)
    with torch.inference_mode():
        got = serve.generate(model, cfg, torch.from_numpy(prompt), gen,
                             max_len=max_len)
    assert got.shape == (3, p + gen)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("mixer", sorted(ARCHS))
def test_decode_logits_match_forward_at_max_len(models, mixer):
    """Token-by-token decode over a whole max_len sequence reproduces the
    forward run at n = max_len, position by position."""
    _, cfg, _, model = models[mixer]
    toks = torch.from_numpy(_toks(2, 11, cfg.vocab))
    with torch.no_grad():
        want = forward(model, cfg, toks)
        cache = serving.init_cache(cfg, 2, 11, params=model)
    assert all(set(lc) == {"hist", "kcoef"} for lc in cache)
    got, _ = _decode_all(model, cfg, toks, cache)
    assert _rel(got, want) <= 1e-5


@pytest.mark.parametrize("mixer", sorted(ARCHS))
def test_plan_realised_once_per_layer(models, mixer):
    """With parameters the kernel is realised once a layer at init and
    never in a step; a params-less cache realises it once a layer and step
    (mirrors tests/test_serving.py::
    test_hist_plan_realised_once_per_layer_bucket). Both decode alike."""
    _, cfg, _, model = models[mixer]
    s = 8
    toks = torch.from_numpy(_toks(1, s, cfg.vocab))
    serving.PLAN_EVALS[mixer] = 0
    with torch.no_grad():
        cache = serving.init_cache(cfg, 1, s, params=model)
    assert serving.PLAN_EVALS[mixer] == cfg.n_layers
    memo, _ = _decode_all(model, cfg, toks, cache)
    assert serving.PLAN_EVALS[mixer] == cfg.n_layers
    serving.PLAN_EVALS[mixer] = 0
    bare = serving.init_cache(cfg, 1, s)
    assert all(set(lc) == {"hist"} for lc in bare)
    legacy, _ = _decode_all(model, cfg, toks, bare)
    assert serving.PLAN_EVALS[mixer] == s * cfg.n_layers
    assert torch.equal(legacy, memo)


def test_stream_matches_hist_replay(models, monkeypatch):
    """FD decode through the streaming cache and through the hist cache:
    the same greedy tokens over a generation crossing 4 C-blocks, logits
    within the streaming tier (mirrors tests/test_fd_stream.py::
    test_serving_stream_matches_hist_replay)."""
    _, cfg, _, model = models["fd"]
    prompt = torch.from_numpy(_toks(1, 3, cfg.vocab))
    max_len = 17

    def decode(cache):
        toks = [prompt[:, i] for i in range(3)]
        logits = []
        with torch.no_grad():
            for t in range(max_len - 1):
                lg, cache = serving.decode_step(
                    model, cfg, toks[t][:, None], cache, t)
                logits.append(lg[:, 0])
                if t + 1 >= 3:
                    toks.append(torch.argmax(lg[:, 0], dim=-1))
        return torch.stack(toks, 1), torch.stack(logits, 1)

    with torch.no_grad():
        hist_cache = serving.init_cache(cfg, 1, max_len, params=model)
        monkeypatch.setenv("REPRO_FD_STREAM", "1")
        stream_cache = serving.init_cache(cfg, 1, max_len, params=model)
    assert serving.stream_block_of(stream_cache) == 4
    assert serving.stream_block_of(hist_cache) is None
    th, lh = decode(hist_cache)
    ts, ls = decode(stream_cache)
    assert torch.equal(th, ts)
    np.testing.assert_allclose(ls.numpy(), lh.numpy(), rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("mixer", sorted(ARCHS))
def test_per_row_positions_equal_scalar_bitwise(models, mixer):
    """decode_step with per-row positions (a list, or Positions) of equal
    entries gives the scalar call's bits (the lockstep case is the ragged
    case broadcast)."""
    _, cfg, _, model = models[mixer]
    toks = torch.from_numpy(_toks(2, 6, cfg.vocab))
    with torch.no_grad():
        cache = serving.init_cache(cfg, 2, 6, params=model)
    ls, cs = _decode_all(model, cfg, toks, cache)
    lv, cv = _decode_all(model, cfg, toks, cache, positions=lambda t: [t, t])
    lp, _ = _decode_all(model, cfg, toks, cache,
                        positions=lambda t: fd_stream.positions([t, t], 2,
                                                                "cpu"))
    assert torch.equal(ls, lv) and torch.equal(ls, lp)
    for a, b in zip(cs, cv):
        assert torch.equal(a["hist"], b["hist"])


def test_ragged_rows_equal_their_solo_decode(models):
    """Rows at different positions in one step: each row's logits equal
    its own batch-1 decode at that position within 1e-5 of their scale
    (the batch-2 and batch-1 matmuls round differently)."""
    _, cfg, _, model = models["tno"]
    toks = torch.from_numpy(_toks(2, 7, cfg.vocab, seed=3))
    with torch.no_grad():
        cache = serving.init_cache(cfg, 2, 8, params=model)
        # row 0 runs 3 steps ahead of row 1
        for t in range(3):
            _, cache = serving.decode_step(model, cfg, toks[:, t:t + 1],
                                           cache, [t, 0] if t else 0)
        rag, _ = serving.decode_step(model, cfg, toks[:, 3:4], cache, [3, 1])
    with torch.no_grad():
        solo0, _ = _decode_all(model, cfg, toks[:1, :4],
                               serving.init_cache(cfg, 1, 8, params=model))
        # row 1 rewrote position 0 at each of the 3 steps: toks[1, 2] last
        solo1, _ = _decode_all(model, cfg, toks[1:, 2:4],
            serving.init_cache(cfg, 1, 8, params=model))
    assert _rel(rag[0, 0], solo0[0, -1]) <= 1e-5
    assert _rel(rag[1, 0], solo1[0, -1]) <= 1e-5


def test_cache_capacity_reads_hist(models, monkeypatch):
    _, cfg, _, model = models["tno"]
    with torch.no_grad():
        cache = serving.init_cache(cfg, 2, 13, params=model)
    assert serving.cache_capacity(cache) == 13
    assert serving.cache_capacity(serving.init_cache(cfg, 1, 9)) == 9
    _, fcfg, _, fmodel = models["fd"]
    monkeypatch.setenv("REPRO_FD_STREAM", "1")
    with torch.no_grad():
        mixed = (serving.init_cache(fcfg, 1, 20, params=fmodel)[:1]
                 + serving.init_cache(fcfg, 1, 11)[1:])
    assert serving.cache_capacity(mixed) == 11


# ---------------------------------------------------------- the bridge
@pytest.mark.parametrize("mixer", sorted(ARCHS))
@pytest.mark.parametrize("with_params", [True, False],
                         ids=["kcoef", "bare"])
def test_cache_from_jax_carries_hist_caches(models, mixer, with_params):
    """A JAX hist cache (``kcoef`` with a leading layer axis in the scanned
    stack) comes over leaf for leaf: ``kcoef`` within 1e-5 of the port's
    own, ``hist`` exact; with ``shared`` the port's taps themselves."""
    jcfg, cfg, jparams, model = models[mixer]
    jcache = jserving.init_cache(jcfg, 2, 12,
                                 params=jparams if with_params else None)
    sub = jcache["blocks"]["sub0"]
    assert sub["hist"].shape == (cfg.n_layers, 2, 12, cfg.d_model)
    jcache = jax.tree.map(np.asarray, jcache)
    jcache["blocks"]["sub0"]["hist"] = np.random.default_rng(0).standard_normal(
        sub["hist"].shape).astype(np.float32)
    got = bridge.cache_from_jax(jcache, cfg, "cpu")
    with torch.no_grad():
        want = serving.init_cache(cfg, 2, 12,
                                  params=model if with_params else None)
    for i, (lg, lw) in enumerate(zip(got, want)):
        assert lg.keys() == lw.keys()
        np.testing.assert_array_equal(lg["hist"].numpy(),
                                      jcache["blocks"]["sub0"]["hist"][i])
        if with_params:
            assert lg["kcoef"].shape == (cfg.d_model, 12)
            assert _rel(lg["kcoef"], lw["kcoef"]) <= 1e-5
    if with_params:
        shared = bridge.cache_from_jax(jcache, cfg, "cpu", shared=want)
        assert all(s["kcoef"] is w["kcoef"] for s, w in zip(shared, want))


# ---------------------------------------------------------- the engine
def _prompts(vocab, plens, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, (p,)).astype(np.int32) for p in plens]


PLENS, GENS, MAX_LEN = [3, 6, 5, 2], [8, 5, 6, 9], 16


@pytest.mark.parametrize("mixer", sorted(ARCHS))
def test_engine_matches_jax_engine_and_solo(models, mixer):
    """4 staggered requests through S = 2 slots of an Engine on hist caches
    (the prompts teacher-forced through the bucket's masked steps, slots
    recycled; FD without chunked prefill): the JAX Engine's tokens and the
    port's solo decode at the same max_len, token for token. The taps are
    realised once a layer an Engine and shared by every state."""
    jcfg, cfg, jparams, model = models[mixer]
    prompts = _prompts(cfg.vocab, PLENS, seed=1)
    serving.PLAN_EVALS[mixer] = 0
    eng = tse.Engine(cfg, model, slots=2, max_len=MAX_LEN)
    assert eng._chunk_c is None and eng.capacity == MAX_LEN
    assert eng.init_state().cache[0]["kcoef"] is \
        eng._prefix_template[0]["kcoef"]
    sched = tse.Scheduler(eng)
    jsched = jse.Scheduler(jse.Engine(jcfg, jparams, slots=2,
                                      max_len=MAX_LEN))
    for i, (pr, g) in enumerate(zip(prompts, GENS)):
        sched.submit(tse.Request(uid=f"r{i}", prompt=pr, max_new=g))
        jsched.submit(jse.Request(uid=f"r{i}", prompt=pr, max_new=g))
    got, _ = sched.run()
    assert serving.PLAN_EVALS[mixer] == cfg.n_layers
    want, _ = jsched.run()
    with torch.inference_mode():
        solo = [serve.generate(model, cfg, torch.from_numpy(
            pr.astype(np.int64))[None], g, max_len=MAX_LEN)[0, len(pr):]
            .tolist() for pr, g in zip(prompts, GENS)]
    for i in range(len(prompts)):
        assert list(got[f"r{i}"]) == list(map(int, want[f"r{i}"])), i
        assert list(got[f"r{i}"]) == solo[i], i


def _preempted(mod, eng, prompts, snap_dir, n=7):
    box = {"n": 0, "sched": None}

    def cb(uid, tok):
        box["n"] += 1
        if box["n"] == n:
            box["sched"].preempt()
    sched = mod.Scheduler(eng, snapshot_dir=snap_dir, detok_async=False)
    box["sched"] = sched
    for i, (pr, g) in enumerate(zip(prompts, GENS)):
        sched.submit(mod.Request(uid=f"r{i}", prompt=pr, max_new=g,
                                 on_token=cb))
    partial, _ = sched.run()
    assert sched.preempted
    return {u: list(t) for u, t in partial.items()}


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_tno_snapshot_crosses_packages(models, tmp_path, writer):
    """A tno Scheduler preempted after 7 tokens snapshots; the other
    package restores it and finishes: the tokens before plus after equal
    an uninterrupted JAX run."""
    jcfg, cfg, jparams, model = models["tno"]
    prompts = _prompts(cfg.vocab, PLENS, seed=4)
    jeng = jse.Engine(jcfg, jparams, slots=2, max_len=MAX_LEN)
    whole = jse.Scheduler(jeng)
    for i, (pr, g) in enumerate(zip(prompts, GENS)):
        whole.submit(jse.Request(uid=f"r{i}", prompt=pr, max_new=g))
    want, _ = whole.run()
    snap_dir = str(tmp_path / "snap")
    eng = tse.Engine(cfg, model, slots=2, max_len=MAX_LEN)
    if writer == "jax":
        partial = _preempted(jse, jeng, prompts, snap_dir)
        sched = tse.Scheduler(eng, snapshot_dir=snap_dir)
    else:
        partial = _preempted(tse, eng, prompts, snap_dir)
        sched = jse.Scheduler(jeng, snapshot_dir=snap_dir)
    assert os.listdir(snap_dir)
    assert sched.try_restore()
    resumed, _ = sched.run()
    for u, toks in want.items():
        assert list(map(int, resumed[u])) == list(map(int, toks)), u
        assert list(map(int, resumed[u]))[:len(partial[u])] == partial[u]


# ---------------------------------------------------------- the launcher
@pytest.mark.parametrize("arch,engine", [
    ("tnn-lm-wt103", False), ("tnn-lm-wt103", True),
    ("fd-tnn-lm-wt103", False)], ids=["tno", "tno-engine", "fd-hist"])
def test_serve_main_runs_hist_archs_on_cpu(arch, engine, capsys):
    """``launch.serve --smoke --device cpu`` serves the baseline, lockstep
    and through the engine, and FD under REPRO_FD_STREAM=0."""
    args = ["--arch", arch, "--smoke", "--device", "cpu", "--batch", "2",
            "--prompt-len", "5", "--gen-len", "4"]
    assert serve.main(args + (["--engine", "--slots", "2"] if engine
                              else [])) == 0
    out = capsys.readouterr().out
    assert ("engine(2 slots, greedy) generated 8 tokens" if engine
            else "generated 8 tokens") in out
