"""The port's continuous-batching engine (repro_torch.serving_engine)
against the port's own solo decode and against the JAX engine, at smoke
size with REPRO_FD_STREAM_C=4 so short requests cross several
overlap-save blocks.

Contracts, each with its tolerance:
* ragged parity — staggered requests through S slots emit, token for
  token, what the port's solo ``launch.serve.generate`` emits at the same
  max_len (fd fp32, mamba fp32 and bf16: the dtypes the port's solo
  generate serves); the fd fp32 case also equals the JAX engine's tokens
  (JAX ``Scheduler`` on the same weights through ``bridge``). Exact on the
  CPU: every op of a decode row is computed the same way at batch 1 and
  batch S;
* eviction and recycling, trace counts, capacity, the bucket ladder (equal
  to JAX's), ``insert`` isolation, the unclassified-leaf raise, the
  non-finite guard;
* packed prefill — first tokens equal the b = 1 prefills'; per-slot cache
  leaves within 1e-5 × max of the b = 1 cache and of JAX's packed cache
  (``bridge.cache_from_jax``): packed and b = 1 rows are not bitwise equal
  (FFT batches), as JAX's own packed rows are not (caveat B).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduce_for_smoke as jreduce  # noqa: E402
from repro.models.transformer import init_model as jinit_model  # noqa: E402
from repro.nn.params import unbox  # noqa: E402
from repro.serving_engine import Engine as JEngine  # noqa: E402
from repro.serving_engine import Request, Scheduler  # noqa: E402
from repro.serving_engine.state import take_row as jtake_row  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config, reduce_for_smoke  # noqa: E402
from repro_torch.launch.serve import generate  # noqa: E402
from repro_torch.models.transformer import init_model  # noqa: E402
from repro_torch.serving_engine import Engine, default_slots  # noqa: E402
from repro_torch.serving_engine import state as st  # noqa: E402

torch.set_num_threads(1)
FD = "fd-tnn-lm-wt103"
MAMBA = "mamba2-2.7b"


@pytest.fixture(autouse=True)
def _block_size(monkeypatch):
    monkeypatch.setenv("REPRO_FD_STREAM_C", "4")


@pytest.fixture(scope="module")
def fd():
    """(JAX cfg, port cfg, JAX params, bridged port model): fd fp32."""
    jcfg = jreduce(jget_config(FD), dtype="float32", param_dtype="float32")
    cfg = reduce_for_smoke(get_config(FD))
    jparams, _ = unbox(jinit_model(jax.random.PRNGKey(0), jcfg))
    model = bridge.params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                                   device="cpu")
    return jcfg, cfg, jparams, model


def _mamba(dtype):
    cfg = reduce_for_smoke(get_config(MAMBA), dtype=dtype, param_dtype=dtype)
    return cfg, init_model(cfg, torch.Generator().manual_seed(0),
                           device="cpu")


def _prompts(vocab, plens, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, (p,)) for p in plens]


def _solo(model, cfg, prompts, gens, max_len, **kw):
    with torch.inference_mode():
        return [generate(model, cfg, torch.from_numpy(pr)[None], g,
                         max_len=max_len, **kw)[0, len(pr):].tolist()
                for pr, g in zip(prompts, gens)]


def serve(eng, prompts, gens, seeds=None, pack=False, poison=None):
    """Drive ``eng`` until every request has its tokens: requests enter in
    order as slots free (the first wave through one ``prefill_packed``
    when ``pack``), one ``generate`` a step, finished slots released.
    ``poison`` = (step, request): poison that request's slot before that
    step. Returns ({request: tokens}, {request: ok}, steps)."""
    seeds = seeds or [0] * len(prompts)
    queue = list(range(len(prompts)))
    out = {i: [] for i in queue}
    oks = {i: True for i in queue}
    slot_of, free = {}, list(range(eng.slots))
    state, steps = eng.init_state(), 0

    def admit(state, i, s, cache, first, plen, row=None):
        out[i].append(int(first))
        if len(out[i]) >= gens[i]:
            free.append(s)
            return state
        slot_of[s] = i
        if row is None:
            return eng.insert(state, cache, plen, first, s, seed=seeds[i])
        return eng.insert_from(state, cache, row, plen, first, s,
                               seed=seeds[i])

    with torch.inference_mode():
        if pack:
            wave = [queue.pop(0) for _ in range(min(len(free), len(queue)))]
            cache, first, plens = eng.prefill_packed(
                [prompts[i] for i in wave], [seeds[i] for i in wave])
            for row, i in enumerate(wave):
                state = admit(state, i, free.pop(0), cache, first[row],
                              plens[row], row)
        while queue or slot_of:
            while queue and free:
                i = queue.pop(0)
                cache, first, plen = eng.prefill(prompts[i], seed=seeds[i])
                state = admit(state, i, free.pop(0), cache, first, plen)
            if not slot_of:
                continue
            if poison is not None and steps == poison[0]:
                s = next(s for s, i in slot_of.items() if i == poison[1])
                state = eng.poison_slot(state, s)
            state, toks, ok = eng.generate(state)
            steps += 1
            for s, i in list(slot_of.items()):
                if ok[s]:
                    out[i].append(int(toks[s]))
                else:
                    oks[i] = False
                    assert not bool(state.active[s])
                if not ok[s] or len(out[i]) >= gens[i]:
                    state = eng.release(state, s)
                    del slot_of[s]
                    free.append(s)
    return out, oks, steps


def _jax_engine_tokens(jcfg, jparams, prompts, gens, max_len, slots):
    eng = JEngine(jcfg, jparams, slots=slots, max_len=max_len)
    sched = Scheduler(eng)
    for i, (pr, g) in enumerate(zip(prompts, gens)):
        sched.submit(Request(uid=f"r{i}", prompt=pr.astype(np.int32),
                             max_new=g))
    res, _ = sched.run()
    return [list(map(int, res[f"r{i}"])) for i in range(len(prompts))]


# ------------------------------------------------------- ragged parity
@pytest.mark.parametrize("case", ["fd-float32", "mamba-float32",
                                  "mamba-bfloat16"])
def test_engine_ragged_parity(case, fd):
    """4 staggered requests through S = 4 slots == 4 solo decodes, token
    for token; fd fp32 also == the JAX engine on the same weights."""
    mixer, dtype = case.split("-")
    if mixer == "fd":
        jcfg, cfg, jparams, model = fd
    else:
        cfg, model = _mamba(dtype)
    plens, gens = [3, 6, 5, 2], [8, 5, 6, 9]
    prompts = _prompts(cfg.vocab, plens, seed=1)
    max_len = 24
    solo = _solo(model, cfg, prompts, gens, max_len)
    eng = Engine(cfg, model, slots=4, max_len=max_len)
    got, oks, steps = serve(eng, prompts, gens)
    assert all(oks.values()) and steps == max(gens) - 1
    for i in range(len(prompts)):
        assert got[i] == solo[i], f"{case} r{i}: {got[i]} != {solo[i]}"
    if mixer == "fd":
        want = _jax_engine_tokens(jcfg, jparams, prompts, gens, max_len, 4)
        assert [got[i] for i in range(4)] == want


def test_engine_eviction_recycle_more_requests_than_slots(fd):
    """6 requests over 2 slots: every slot is recycled, every request
    completes token-exact, and the shapes trace once each."""
    _, cfg, _, model = fd
    plens, gens = [3, 7, 5, 9, 4, 6], [10, 6, 12, 8, 5, 7]
    prompts = _prompts(cfg.vocab, plens, seed=2)
    max_len = 32
    solo = _solo(model, cfg, prompts, gens, max_len)
    for pack in (False, True):
        eng = Engine(cfg, model, slots=2, max_len=max_len)
        got, oks, steps = serve(eng, prompts, gens, pack=pack)
        assert all(oks.values()) and steps > max(gens)
        assert [got[i] for i in range(6)] == solo, pack
        tc = eng.trace_counts
        assert tc["generate"] == 1 and tc["insert"] == 1, tc
        assert tc["decode1"] == 0 and tc["chunk1"] == 0, tc
        assert tc["insert_from"] == int(pack), tc
        assert tc["prefill_bucket"] <= 2 * len(eng.buckets) + pack, tc


def test_engine_per_length_fallback_is_token_exact(fd, monkeypatch):
    """REPRO_PREFILL_BUCKETS=0: every prompt takes the per-length
    chunk/token loop (one decode1 and one chunk1 shape), same tokens."""
    _, cfg, _, model = fd
    monkeypatch.setenv("REPRO_PREFILL_BUCKETS", "0")
    plens, gens = [3, 9, 6], [6, 4, 5]
    prompts = _prompts(cfg.vocab, plens, seed=3)
    solo = _solo(model, cfg, prompts, gens, 20)
    eng = Engine(cfg, model, slots=2, max_len=20)
    assert eng.bucket_for(3) is None
    got, _, _ = serve(eng, prompts, gens)
    assert [got[i] for i in range(3)] == solo
    assert eng.trace_counts["prefill_bucket"] == 0
    assert eng.trace_counts["decode1"] == 1
    assert eng.trace_counts["chunk1"] == 1


# ----------------------------------------------------------- the guard
def test_poisoned_slot_is_isolated(fd):
    """A poisoned slot alone ends ok=False and is deactivated; every other
    request's tokens are those of the clean run."""
    _, cfg, _, model = fd
    plens, gens = [3, 6, 5, 2, 7], [8, 9, 6, 9, 5]
    prompts = _prompts(cfg.vocab, plens, seed=4)
    clean, oks, _ = serve(Engine(cfg, model, slots=3, max_len=24), prompts,
                          gens)
    assert all(oks.values())
    got, oks, _ = serve(Engine(cfg, model, slots=3, max_len=24), prompts,
                        gens, poison=(2, 1))
    assert oks == {0: True, 1: False, 2: True, 3: True, 4: True}
    assert got[1] == clean[1][:len(got[1])] and len(got[1]) == 3
    for i in (0, 2, 3, 4):
        assert got[i] == clean[i], i


def test_guard_flags_only_active_slots(fd):
    """A poisoned parked slot is not flagged (its row is scratch); with
    the guard off a poisoned active slot advances on garbage."""
    _, cfg, _, model = fd
    eng = Engine(cfg, model, slots=2, max_len=16)
    with torch.inference_mode():
        cache, first, plen = eng.prefill(_prompts(cfg.vocab, [5], 5)[0])
        state = eng.insert(eng.init_state(), cache, plen, first, 0)
        state, _, ok = eng.generate(eng.poison_slot(state, 1))
        assert ok.tolist() == [True, True]
        state, _, ok = eng.generate(eng.poison_slot(state, 0))
        assert ok.tolist() == [False, True]
        assert state.active.tolist() == [False, False]
        assert state.cur_len.tolist() == [plen + 1, 0]
        off = Engine(cfg, model, slots=2, max_len=16, guard_nonfinite=False)
        s2 = off.insert(off.init_state(), cache, plen, first, 0)
        s2, _, ok = off.generate(off.poison_slot(s2, 0))
        assert ok.tolist() == [True, True] and s2.cur_len[0] == plen + 1


# ------------------------------------------------------- state and slots
def test_insert_leaves_other_slots_untouched(fd):
    """insert is a pure slot-row slice-in: every per-slot leaf outside the
    target row and every shared leaf are bitwise unchanged, and the shared
    leaves are the engine template's own tensors."""
    _, cfg, _, model = fd
    eng = Engine(cfg, model, slots=3, max_len=16)
    with torch.inference_mode():
        state = eng.init_state()
        prefix, first, plen = eng.prefill(_prompts(cfg.vocab, [5], 6)[0])
        state = eng.insert(state, prefix, plen, first, 0)
        before = [{k: v.clone() for k, v in lc.items()} for lc in state.cache]
        state = eng.insert(state, prefix, plen, first, 2)
    for lb, la, lt, lp in zip(before, state.cache, eng._prefix_template,
                              prefix):
        for name, a in la.items():
            if name in st.SHARED_LEAVES:
                assert a is lt[name], name
                assert torch.equal(a, lb[name]), name
            else:
                assert torch.equal(a[:2], lb[name][:2]), name
                assert torch.equal(a[2], lp[name][0]), name
    assert state.active.tolist() == [True, False, True]
    assert state.cur_len.tolist() == [plen, 0, plen]
    assert state.tokens.tolist() == [int(first), 0, int(first)]


def test_insert_writes_the_prefix_row_and_nothing_else_in_place(fd):
    """The inserted row equals the prefix cache; neither the old state,
    the prefix nor the template is written."""
    _, cfg, _, model = fd
    eng = Engine(cfg, model, slots=2, max_len=16)
    with torch.inference_mode():
        state = eng.init_state()
        prefix, first, plen = eng.prefill(_prompts(cfg.vocab, [6], 7)[0])
        saved = [[{k: v.clone() for k, v in lc.items()} for lc in c]
                 for c in (state.cache, prefix, eng._prefix_template)]
        inserted = eng.insert(state, prefix, plen, first, 1)
        stepped = eng.generate(inserted)[0]
    for lc_new, lc_pre in zip(inserted.cache, prefix):
        for name in st.PER_SLOT_LEAVES & lc_new.keys():
            assert torch.equal(lc_new[name][1], lc_pre[name][0]), name
    for kept, c in zip(saved, (state.cache, prefix, eng._prefix_template)):
        for lk, lc in zip(kept, c):
            for name in lk:
                assert torch.equal(lk[name], lc[name]), name
    assert not torch.equal(stepped.cache[0]["ring"],
                           inserted.cache[0]["ring"])


def test_unclassified_leaf_raises():
    dst = [{"mystery": torch.zeros(2, 4), "ring": torch.zeros(2, 4, 3)}]
    src = [{"mystery": torch.ones(1, 4), "ring": torch.ones(1, 4, 3)}]
    with pytest.raises(NotImplementedError, match="mystery"):
        st.insert_prefix_cache(dst, src, 0)
    with pytest.raises(NotImplementedError, match="mystery"):
        st.select_rows(torch.ones(2, dtype=torch.bool), dst, dst)
    with pytest.raises(NotImplementedError, match="mystery"):
        st.empty_cache(dst, 3)


def test_engine_slots_env_and_validation(fd, monkeypatch):
    _, cfg, _, model = fd
    monkeypatch.delenv("REPRO_ENGINE_SLOTS", raising=False)
    assert default_slots() == 8
    monkeypatch.setenv("REPRO_ENGINE_SLOTS", "3")
    assert default_slots() == 3
    assert Engine(cfg, model, max_len=16).slots == 3
    monkeypatch.setenv("REPRO_ENGINE_SLOTS", "0")
    with pytest.raises(ValueError):
        default_slots()
    with pytest.raises(ValueError, match="slots"):
        Engine(cfg, model, slots=0, max_len=16)


# ------------------------------------------------------------- capacity
def test_capacity_gates_prompts_and_steps(fd):
    _, cfg, _, model = fd
    eng = Engine(cfg, model, slots=2, max_len=16)
    assert eng.capacity == 16
    with pytest.raises(ValueError, match="exceeds slot capacity"):
        eng.prefill(_prompts(cfg.vocab, [17], 8)[0])
    with pytest.raises(ValueError, match="exceeds slot capacity"):
        eng.prefill_packed(_prompts(cfg.vocab, [3, 17], 8))
    with pytest.raises(ValueError, match="empty prompt"):
        eng.prefill(np.zeros((0,), np.int64))
    # a 16-token prompt fills the slot: its next step would write past it
    with torch.inference_mode():
        cache, first, plen = eng.prefill(_prompts(cfg.vocab, [16], 9)[0])
        state = eng.insert(eng.init_state(), cache, plen, first, 0)
        with pytest.raises(ValueError, match="at capacity"):
            eng.generate(state)
    mcfg, mamba = _mamba("float32")
    mamba_eng = Engine(mcfg, mamba, slots=1, max_len=16)
    assert mamba_eng.capacity is None and mamba_eng.buckets == [16]


# ------------------------------------------------------------- buckets
@pytest.mark.parametrize("max_len,bucket0", [(16, 4), (16, 3), (24, 16),
                                             (32, 1), (64, 8)])
def test_bucket_ladder_equals_jax(fd, max_len, bucket0):
    jcfg, cfg, jparams, model = fd
    eng = Engine(cfg, model, slots=1, max_len=max_len, bucket0=bucket0)
    jeng = JEngine(jcfg, jparams, slots=1, max_len=max_len, bucket0=bucket0)
    assert eng.buckets == jeng.buckets
    assert eng.capacity == jeng.capacity
    for p in range(1, max_len + 1):
        assert eng.bucket_for(p) == jeng.bucket_for(p), p
    off = Engine(cfg, model, slots=1, max_len=16, use_buckets=False)
    assert off.bucket_for(4) is None


def test_bucket_env_knobs_as_jax(fd, monkeypatch):
    """REPRO_PREFILL_BUCKET0 sets the smallest rung and
    REPRO_PREFILL_BUCKETS=0 turns the ladder off, as in JAX."""
    jcfg, cfg, jparams, model = fd
    monkeypatch.setenv("REPRO_PREFILL_BUCKET0", "8")
    eng = Engine(cfg, model, slots=1, max_len=64)
    assert eng.buckets == JEngine(jcfg, jparams, slots=1,
                                  max_len=64).buckets == [8, 16, 32, 64]
    monkeypatch.setenv("REPRO_PREFILL_BUCKETS", "0")
    assert not Engine(cfg, model, slots=1, max_len=64).use_buckets


def test_prefill_counts_shapes_per_bucket_not_per_length(fd):
    """Ragged lengths inside one bucket add ONE prefill_bucket shape;
    only a bucket change, the aligned path (no remainder) or a new packed
    batch size adds another."""
    _, cfg, _, model = fd
    eng = Engine(cfg, model, slots=4, max_len=16, bucket0=4)
    with torch.inference_mode():
        for p in (2, 3):
            eng.prefill(_prompts(cfg.vocab, [p], p)[0])
        assert eng.trace_counts["prefill_bucket"] == 1
        eng.prefill(_prompts(cfg.vocab, [4], 4)[0])        # aligned
        assert eng.trace_counts["prefill_bucket"] == 2
        for p in (5, 6, 7):
            eng.prefill(_prompts(cfg.vocab, [p], p)[0])
        assert eng.trace_counts["prefill_bucket"] == 3
        for seed in (0, 1):
            eng.prefill_packed(_prompts(cfg.vocab, [3, 6, 5], seed))
        assert eng.trace_counts["prefill_bucket"] == 4
        eng.prefill_packed(_prompts(cfg.vocab, [2, 3], 2))
        assert eng.trace_counts["prefill_bucket"] == 5
    assert eng.trace_counts["decode1"] == eng.trace_counts["chunk1"] == 0
    with pytest.raises(ValueError, match="at least one"):
        eng.prefill_packed([])


# ------------------------------------------------------ packed prefill
def _close(got, want, what):
    assert got.shape == want.shape, what
    if not want.numel():
        return
    scale = max(float(want.abs().max()), 1e-6)
    err = float((got.float() - want.float()).abs().max())
    assert err <= 1e-5 * scale, f"{what}: {err} > 1e-5 * {scale}"


def test_packed_rows_match_b1_prefill_and_jax(fd):
    """Row i of prefill_packed gives the first token of a b = 1 prefill of
    prompt i, and its per-slot cache within 1e-5 × max of that b = 1
    cache and of the JAX engine's packed row (through cache_from_jax)."""
    jcfg, cfg, jparams, model = fd
    prompts = _prompts(cfg.vocab, [3, 6, 5, 8], seed=7)  # ragged + aligned
    eng = Engine(cfg, model, slots=4, max_len=16, bucket0=4)
    jeng = JEngine(jcfg, jparams, slots=4, max_len=16, bucket0=4)
    with torch.inference_mode():
        packed, first, plens = eng.prefill_packed(prompts)
        solo = [eng.prefill(pr) for pr in prompts]
    jpacked, jfirst, _ = jeng.prefill_packed(
        [pr.astype(np.int32) for pr in prompts])
    assert plens == [3, 6, 5, 8]
    assert first.tolist() == [int(f) for _, f, _ in solo]
    assert first.tolist() == np.asarray(jfirst).tolist()
    for i in range(len(prompts)):
        row = st.take_row(packed, i)
        jrow = bridge.cache_from_jax(
            jax.tree.map(np.asarray, jtake_row(jpacked, i)), cfg, "cpu")
        for layer, (lr, ls, lj) in enumerate(zip(row, solo[i][0], jrow)):
            for name in lr:
                what = f"row {i} layer {layer} {name}"
                _close(lr[name], ls[name], what + " vs b=1")
                _close(lr[name], lj[name], what + " vs JAX")


@pytest.mark.parametrize("scan", [True, False], ids=["blocks", "tail"])
def test_cache_from_jax_carries_stream_caches(fd, scan):
    """A JAX stream cache, scanned ``blocks`` or ``tail<i>`` layers, comes
    over leaf for leaf: the kernel leaves within 1e-5 × max of the port's
    own ``init_cache`` on the same weights, every shape equal."""
    import dataclasses

    from repro.models import serving as jserving
    from repro_torch.models import serving
    jcfg, cfg, jparams, model = fd
    if not scan:
        jcfg = dataclasses.replace(jcfg, scan_layers=False)
        cfg = dataclasses.replace(cfg, scan_layers=False)
        jparams, _ = unbox(jinit_model(jax.random.PRNGKey(0), jcfg))
        model = bridge.params_from_jax(jax.tree.map(np.asarray, jparams),
                                       cfg, device="cpu")
    jcache = jserving.init_cache(jcfg, 2, 12, params=jparams)
    assert ("blocks" in jcache) == scan and ("tail1" in jcache) != scan
    got = bridge.cache_from_jax(jax.tree.map(np.asarray, jcache), cfg, "cpu")
    with torch.no_grad():
        want = serving.init_cache(cfg, 2, 12, params=model)
    for layer, (lg, lw) in enumerate(zip(got, want)):
        assert lg.keys() == lw.keys(), layer
        for name in lg:
            _close(lg[name], lw[name], f"layer {layer} {name}")


def test_cache_from_jax_refuses_unknown_leaves(fd):
    """A leaf the port's caches do not have is refused (attention ``k``
    was, until the attention caches were ported; tests/test_torch_zoo.py
    carries them); the JAX params-less hist cache, once refused, and the
    stream cache come over layer for layer."""
    jcfg, cfg, jparams, _ = fd
    from repro.models import serving as jserving
    cache = jax.tree.map(np.asarray, jserving.init_cache(jcfg, 2, 8))
    odd = {"blocks": {"sub0": dict(cache["blocks"]["sub0"],
                                   mystery=np.zeros((cfg.n_layers, 2, 8),
                                                    np.float32))}}
    with pytest.raises(ValueError,
                       match=r"'layers\.0\.mystery' has no port"):
        bridge.cache_from_jax(odd, cfg, "cpu")
    hist = bridge.cache_from_jax(cache, cfg, "cpu")
    assert [set(lc) for lc in hist] == [{"hist"}] * cfg.n_layers
    stream = jax.tree.map(np.asarray, jserving.init_cache(jcfg, 2, 8,
                                                          params=jparams))
    got = bridge.cache_from_jax(stream, cfg, "cpu")
    assert len(got) == cfg.n_layers
    assert got[1]["cap"].shape == (8, 0) and got[0]["ring"].shape == (2, 4,
                                                                      128)
    with pytest.raises(ValueError, match="no leaves"):
        bridge.cache_from_jax({"blocks": {"sub0": {}}}, cfg, "cpu")
