"""The port's engine snapshots (repro_torch.serving_engine.snapshot) at
smoke size (fd fp32, REPRO_FD_STREAM_C=4), on weights bridged from the
JAX package.

Contracts:
* preempt → snapshot → restore in a fresh Scheduler (and a fresh Engine)
  resumes token-exact, greedy and sampled, also when the preemption comes
  from the detokenise worker thread; the restored state holds the host
  positions, their device copy and the Engine's own kernel constants
  (the same tensors, not copies);
* a geometry mismatch (slots, max_len) or a snapshot of another kind
  raises before any array is read; a failing snapshot write is never
  fatal;
* the snapshot layout is the JAX package's: a snapshot written by the JAX
  ``Scheduler`` resumes in the port (``bridge.decode_state_from_jax``)
  and JAX's tokens before plus the port's after equal JAX's
  uninterrupted run; one written by the port resumes in JAX the same way;
* ``bridge.decode_state_from_jax`` / ``decode_state_to_jax`` against the
  JAX engine's own state (cache rows within 1e-5 × max, positions,
  tokens and liveness exact).
"""
import json
import os
import shutil
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
from repro_torch import bridge  # noqa: E402
from repro_torch.checkpoint import manifest  # noqa: E402
from repro_torch.configs import get_config, reduce_for_smoke  # noqa: E402
from repro_torch.serving_engine import snapshot as snap  # noqa: E402
from repro_torch.serving_engine import state as st  # noqa: E402

torch.set_num_threads(1)
FD = "fd-tnn-lm-wt103"
PLENS = [3, 6, 5, 2]
GENS = [8, 9, 10, 8]
MAX_LEN = 32


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
        jeng = jse.Engine(jcfg, jparams, slots=2, max_len=MAX_LEN)
        sched = jse.Scheduler(jeng)
        for r in fleet(jse, prompts):
            sched.submit(r)
        baseline, _ = sched.run()
        yield SimpleNamespace(
            jcfg=jcfg, cfg=cfg, jparams=jparams, model=model,
            prompts=prompts, jeng=jeng,
            engine=lambda **kw: tse.Engine(cfg, model, **{
                "slots": 2, "max_len": MAX_LEN, **kw}),
            baseline={u: list(t) for u, t in baseline.items()})
    finally:
        if old is None:
            os.environ.pop("REPRO_FD_STREAM_C", None)
        else:
            os.environ["REPRO_FD_STREAM_C"] = old


def fleet(mod, prompts, gens=GENS, **kw):
    return [mod.Request(uid=f"r{i}", prompt=pr, max_new=g, **kw)
            for i, (pr, g) in enumerate(zip(prompts, gens))]


def _preempt_after(n):
    """A callback that preempts its scheduler at the n-th token it sees
    (``box["sched"]`` is set once the scheduler exists)."""
    box = {"n": 0, "sched": None}

    def cb(uid, tok):
        box["n"] += 1
        if box["n"] == n:
            box["sched"].preempt()
    return box, cb


def _preempted_run(mod, eng, prompts, snap_dir, n=7, **kw):
    box, cb = _preempt_after(n)
    sched = mod.Scheduler(eng, snapshot_dir=snap_dir, **kw)
    box["sched"] = sched
    for r in fleet(mod, prompts, on_token=cb):
        sched.submit(r)
    partial, _ = sched.run()
    assert sched.preempted
    return {u: list(t) for u, t in partial.items()}


# --------------------------------------------------------------- greedy
@pytest.mark.parametrize("detok_async", [True, False])
def test_preempt_snapshot_resume_token_exact(env, tmp_path, detok_async):
    snap_dir = str(tmp_path / "snap")
    eng = env.engine()
    partial = _preempted_run(tse, eng, env.prompts, snap_dir,
                             detok_async=detok_async)
    n_partial = sum(map(len, partial.values()))
    assert 0 < n_partial < sum(map(len, env.baseline.values()))

    streamed = {}
    sched2 = tse.Scheduler(env.engine(), snapshot_dir=snap_dir,
                           detok_async=detok_async)
    assert sched2.try_restore(callbacks={
        "r0": lambda u, t: streamed.setdefault(u, []).append(t)})
    resumed, _ = sched2.run()
    for u, want in env.baseline.items():
        assert sched2.outcomes[u].status == "ok", sched2.outcomes[u]
        assert resumed[u] == want, u
        assert resumed[u][:len(partial[u])] == partial[u]
    if "r0" in streamed:
        assert resumed["r0"][-len(streamed["r0"]):] == streamed["r0"]


def test_restored_state_shares_constants_and_rebuilds_positions(env,
                                                                tmp_path):
    """The restored DecodeState: positions and liveness on the host equal
    the snapshotted ones, tokens on the engine's device, every shared
    leaf the new Engine's own template tensor, every per-slot leaf equal
    to the snapshotted row."""
    snap_dir = str(tmp_path / "snap")
    sched = tse.Scheduler(env.engine(), snapshot_dir=snap_dir,
                          detok_async=False)
    box, cb = _preempt_after(5)
    box["sched"] = sched
    for r in fleet(tse, env.prompts, on_token=cb):
        sched.submit(r)
    _, state = sched.run()
    eng2 = env.engine()
    loaded = snap.load_snapshot(snap_dir, eng2)
    got = loaded["state"]
    assert got.cur_len.device.type == "cpu" and got.active.device.type == "cpu"
    assert got.cur_len.dtype == torch.int64 and got.active.dtype == torch.bool
    assert torch.equal(got.cur_len, state.cur_len)
    assert torch.equal(got.active, state.active)
    assert torch.equal(got.tokens, state.tokens)
    assert got.tokens.device == eng2.device
    for lc_got, lc_want, lc_tmpl in zip(got.cache, state.cache,
                                        eng2._prefix_template):
        for name, leaf in lc_got.items():
            if name in st.SHARED_LEAVES:
                assert leaf is lc_tmpl[name], name
            else:
                assert torch.equal(leaf, lc_want[name]), name
    assert loaded["extra"]["steps"] == sched.steps
    assert sorted(int(s) for s, _ in loaded["extra"]["slot_req"]) == \
        sorted(int(s) for s in range(2) if bool(state.active[s]))


# -------------------------------------------------------------- sampled
def test_sampled_preempt_resume_token_exact(env, tmp_path):
    """A sampled engine's streams (seeded requests) survive a snapshot:
    each restored request's lane resumes at its token count."""
    kw = {"slots": 1, "max_len": 16, "temperature": 0.8}
    rng = np.random.default_rng(41)
    prompts = [rng.integers(0, env.cfg.vocab, (p,)).astype(np.int32)
               for p in (3, 4)]

    def reqs(cb=None):
        return [tse.Request(uid=f"r{i}", prompt=pr, max_new=8, seed=777 + i,
                            on_token=cb) for i, pr in enumerate(prompts)]

    sched = tse.Scheduler(env.engine(**kw))
    for r in reqs():
        sched.submit(r)
    baseline, _ = sched.run()

    box, cb = _preempt_after(3)
    sched1 = tse.Scheduler(env.engine(**kw), snapshot_dir=str(tmp_path),
                           snapshot_every=1)
    box["sched"] = sched1
    for r in reqs(cb):
        sched1.submit(r)
    sched1.run()
    assert sched1.preempted
    sched2 = tse.Scheduler(env.engine(**kw), snapshot_dir=str(tmp_path))
    assert sched2.try_restore()
    resumed, _ = sched2.run()
    assert resumed == baseline


def test_sampled_preempt_from_worker_thread(env, tmp_path):
    """Preempt from the detokenise worker itself (the callback calls
    preempt()) on a sampled 2-slot engine: every token is streamed exactly
    once across the two runs and the union is the uninterrupted run."""
    kw = {"temperature": 0.7, "top_k": 8, "max_len": 24}
    rng = np.random.default_rng(37)
    prompts = [rng.integers(0, env.cfg.vocab, (p,)).astype(np.int32)
               for p in (3, 5, 4)]
    gens = [10, 8, 12]

    def reqs(cb=None):
        return [tse.Request(uid=f"r{i}", prompt=pr, max_new=g, seed=50 + i,
                            on_token=cb)
                for i, (pr, g) in enumerate(zip(prompts, gens))]

    sched = tse.Scheduler(env.engine(**kw))
    for r in reqs():
        sched.submit(r)
    baseline, _ = sched.run()

    streamed1, streamed2 = {}, {}
    sched1 = tse.Scheduler(env.engine(**kw), snapshot_dir=str(tmp_path),
                           snapshot_every=2, detok_async=True)

    def cb1(uid, tok):
        streamed1.setdefault(uid, []).append(tok)
        if sum(map(len, streamed1.values())) == 9:
            sched1.preempt()

    for r in reqs(cb1):
        sched1.submit(r)
    sched1.run()
    assert sched1.preempted

    def cb2(uid, tok):
        streamed2.setdefault(uid, []).append(tok)

    sched2 = tse.Scheduler(env.engine(**kw), snapshot_dir=str(tmp_path),
                           detok_async=True)
    assert sched2.try_restore(callbacks={u: cb2 for u in baseline})
    resumed, _ = sched2.run()
    for uid in baseline:
        assert sched2.outcomes[uid].status == "ok"
        assert resumed[uid] == baseline[uid], uid
        assert (streamed1.get(uid, []) + streamed2.get(uid, [])
                == baseline[uid]), uid


# ------------------------------------------------------------- refusals
def _write_snapshot(env, snap_dir):
    sched = tse.Scheduler(env.engine(), snapshot_dir=snap_dir,
                          snapshot_every=2)
    for r in fleet(tse, env.prompts[:2]):
        sched.submit(r)
    sched.run()
    return manifest.latest_step(snap_dir)


@pytest.mark.parametrize("geometry", [{"slots": 3}, {"max_len": 24}])
def test_geometry_mismatch_raises_before_arrays_read(env, tmp_path,
                                                     geometry):
    snap_dir = str(tmp_path / "snap")
    step = _write_snapshot(env, snap_dir)
    # no array file left: a mismatch must be named before any is opened
    shutil.rmtree(os.path.join(snap_dir, f"step_{step:09d}", "data"))
    with pytest.raises(ValueError, match="geometry"):
        tse.Scheduler(env.engine(**geometry),
                      snapshot_dir=snap_dir).try_restore()


def test_other_kind_of_checkpoint_refused(env, tmp_path):
    manifest.save(str(tmp_path), 3, {"w": torch.zeros(2)},
                  extra={"kind": "train"})
    with pytest.raises(ValueError, match="not a serving-engine snapshot"):
        tse.Scheduler(env.engine(), snapshot_dir=str(tmp_path)).try_restore()


def test_try_restore_without_snapshot_is_noop(env, tmp_path):
    os.makedirs(str(tmp_path / "empty"))
    assert not tse.Scheduler(env.engine(), snapshot_dir=str(
        tmp_path / "empty")).try_restore()
    assert tse.Scheduler(env.engine()).try_restore() is False


def test_snapshot_write_fault_never_fatal(env, tmp_path):
    """Every snapshot write fails (injected): counted, logged, and serving
    goes on token-exact — as in the JAX package, counter for counter."""
    def run(mod, d):
        inj = mod.FaultInjector(specs=[mod.FaultSpec(site="snapshot",
                                                     count=99)])
        eng = env.jeng if mod is jse else env.engine()
        sched = mod.Scheduler(eng, injector=inj, backoff_base=0.0,
                              snapshot_dir=d, snapshot_every=2)
        for r in fleet(mod, env.prompts):
            sched.submit(r)
        res, _ = sched.run()
        return ({u: list(t) for u, t in res.items()}, sched.snapshot_errors,
                sched.steps, [tuple(e) for e in inj.log])

    got = run(tse, str(tmp_path / "port"))
    assert got == run(jse, str(tmp_path / "jax"))
    assert got[0] == env.baseline and got[1] >= 1
    assert manifest.latest_step(str(tmp_path / "port")) is None


def test_snapshot_metrics_gauges(env, tmp_path):
    """repro_snapshot_bytes is the step directory with its data files."""
    from repro_torch.obs.metrics import Registry
    reg = Registry()
    snap_dir = str(tmp_path / "snap")
    sched = tse.Scheduler(env.engine(), snapshot_dir=snap_dir,
                          snapshot_every=2, metrics=reg)
    for r in fleet(tse, env.prompts[:2]):
        sched.submit(r)
    sched.run()
    step_dir = os.path.join(snap_dir,
                            f"step_{manifest.latest_step(snap_dir):09d}")
    assert reg.get("repro_snapshot_bytes").get() == \
        snap.snapshot_bytes(step_dir) > 0
    assert reg.get("repro_snapshots_total").get(result="ok") >= 1


# ------------------------------------------------------ across packages
def test_jax_snapshot_resumes_in_port(env, tmp_path):
    """The JAX Scheduler is preempted after 7 tokens and snapshots; the
    port restores that snapshot into its own Engine and finishes: JAX's
    tokens before plus the port's after equal JAX's uninterrupted run."""
    snap_dir = str(tmp_path / "snap")
    partial = _preempted_run(jse, env.jeng, env.prompts, snap_dir,
                             detok_async=False)
    sched = tse.Scheduler(env.engine(), snapshot_dir=snap_dir)
    assert sched.try_restore()
    assert {u: list(t) for u, t in sched.results.items()} == partial
    resumed, _ = sched.run()
    assert 0 < sum(map(len, partial.values())) < sum(
        map(len, env.baseline.values()))
    for u, want in env.baseline.items():
        assert sched.outcomes[u].status == "ok"
        assert resumed[u] == want, u
        assert resumed[u][:len(partial[u])] == partial[u]


def test_port_snapshot_resumes_in_jax(env, tmp_path):
    snap_dir = str(tmp_path / "snap")
    partial = _preempted_run(tse, env.engine(), env.prompts, snap_dir,
                             detok_async=False)
    sched = jse.Scheduler(env.jeng, snapshot_dir=snap_dir)
    assert sched.try_restore()
    resumed, _ = sched.run()
    for u, want in env.baseline.items():
        assert resumed[u] == want, u
        assert resumed[u][:len(partial[u])] == partial[u]


def test_snapshot_extra_keys_match_jax(env, tmp_path):
    """Both packages write the same manifest: the same ``extra`` keys and
    the same leaf count and shapes."""
    metas = {}
    for mod, eng in ((jse, env.jeng), (tse, env.engine())):
        d = str(tmp_path / mod.__name__)
        _preempted_run(mod, eng, env.prompts, d, detok_async=False)
        step = manifest.latest_step(d)
        with open(os.path.join(d, f"step_{step:09d}", "manifest.json")) as f:
            metas[mod.__name__] = json.load(f)
    j, t = metas["repro.serving_engine"], metas["repro_torch.serving_engine"]
    assert sorted(t["extra"]) == sorted(j["extra"])
    assert t["extra"]["kind"] == j["extra"]["kind"]
    assert t["n_leaves"] == j["n_leaves"]
    assert [m["shape"] for m in t["leaves"]] == \
        [m["shape"] for m in j["leaves"]]


def test_decode_state_bridge_matches_jax_state(env):
    """A JAX engine state with two admitted requests, through
    ``decode_state_from_jax``, equals the port engine's state after the
    same admissions (cache rows within 1e-5 × max, the rest exact), and
    ``decode_state_to_jax`` gives back JAX's leaf shapes."""
    jeng, eng = env.jeng, env.engine()
    jstate, state = jeng.init_state(), eng.init_state()
    for slot, pr in enumerate(env.prompts[:2]):
        prefix, first, plen = jeng.prefill(pr)
        jstate = jeng.insert(jstate, prefix, plen, int(first), slot)
        prefix, first, plen = eng.prefill(pr)
        state = eng.insert(state, prefix, plen, int(first), slot)
    jstate, jtoks, _ = jeng.generate(jstate)
    state, toks, _ = eng.generate(state)
    assert np.asarray(jtoks).tolist() == toks.tolist()
    host = jax.tree.map(np.asarray, jstate)
    got = bridge.decode_state_from_jax(host, env.cfg, "cpu")
    assert got.cur_len.tolist() == host.cur_len.tolist() == \
        state.cur_len.tolist()
    assert got.active.tolist() == host.active.tolist()
    assert got.tokens.tolist() == host.tokens.tolist() == state.tokens.tolist()
    assert torch.equal(got.rng, torch.zeros(2, 2, dtype=torch.int64))
    for lc_got, lc_port in zip(got.cache, state.cache):
        assert lc_got.keys() == lc_port.keys()
        for name in lc_got:
            a, b = lc_got[name], lc_port[name]
            assert a.shape == b.shape and a.dtype == b.dtype, name
            if b.numel():
                err = float((a - b).abs().max())
                assert err <= 1e-5 * float(b.abs().max()), (name, err)
    # shared leaves taken from a template, not copied
    shared = bridge.decode_state_from_jax(host, env.cfg, "cpu",
                                          template=eng._prefix_template)
    assert shared.cache[0]["khead"] is eng._prefix_template[0]["khead"]
    back = bridge.decode_state_to_jax(got, env.cfg)
    jl = jax.tree_util.tree_leaves(jstate)
    tl = manifest.tree_leaves(back)
    assert [tuple(x.shape) for x in tl] == [tuple(x.shape) for x in jl]


def test_decode_state_bridge_refusals(env):
    host = jax.tree.map(np.asarray, env.jeng.init_state())
    with pytest.raises(ValueError, match="slots"):
        bridge.decode_state_from_jax(
            bridge.JaxDecodeState(host.cache, host.cur_len[:1],
                                  host.tokens[:1], host.active[:1],
                                  host.rng[:1]), env.cfg, "cpu")
    other = tse.Engine(env.cfg, env.model, slots=2, max_len=16)
    with pytest.raises(ValueError, match="shared leaf"):
        bridge.decode_state_from_jax(host, env.cfg, "cpu",
                                     template=other._prefix_template)
