"""Port parity for the jamba hybrid ``jamba-1.5-large-398b`` (an 8-layer
period of Mamba layers with dense and MoE FFNs and one attention layer at
index 4) against the JAX package, on its smoke config (16 layers: two
scanned blocks, ``blocks/sub0..7``) and on a 5-layer cut of it (tail
layers ``tail0..4`` only, the cut the card runs at full width), with the
JAX parameters carried over by ``bridge.params_from_jax`` and the same
seeded numpy inputs. REPRO_FD_STREAM_C=4 is set for both packages.

Tolerances, each with its reason:
* fp32 (``dtype`` and ``param_dtype`` float32): logits, the MoE aux loss
  and the eval loss within 1e-5 of the largest magnitude (matmul, SSD
  and softmax sums in another order), also with the FD mixer in place of
  the attention layer; every cache leaf after prefill and decode steps
  within 1e-5 of its largest magnitude (the same sums, carried in the
  KV, conv and SSD-state leaves);
* bf16 (the config's own dtype): logits and loss within 2e-2 of their
  scale at the 5-layer cut (JAX's own bf16-vs-fp32-activation distance
  there is 1.8e-2), and at 16 layers within twice that distance (about
  5e-2 there), against JAX's layers run one by one outside the layer
  scan: JAX's scanned bf16 forward can route a router near-tie to
  another expert than its layers run op by op (tests/test_torch_zoo.py's
  MoE rule); and at both depths the port's logits at least half that
  distance from JAX's fp32-activation logits, which a port computing in
  fp32 would sit within 3e-4 (the cut) and 7e-3 (16 layers) of;
* greedy decode, the Engine against solo decode and the JAX Engine, and
  snapshots resumed in either package: token-exact (fp32);
* the bridge's and snapshots' round trips: bitwise, each leaf in its own
  dtype (bf16 KV and conv leaves beside the fp32 SSD state).
"""
import dataclasses
import functools
import hashlib
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
from repro.data import pipeline as jpipeline  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.launch.steps import StepBuilder  # noqa: E402
from repro.models import serving as jserving  # noqa: E402
from repro.models.context import Ctx  # noqa: E402
from repro.models.transformer import forward as jforward  # noqa: E402
from repro.models.transformer import init_model as jinit_model  # noqa: E402
from repro.models.transformer import loss_fn as jloss_fn  # noqa: E402
from repro.nn.params import unbox  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config, reduce_for_smoke  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import serving  # noqa: E402
from repro_torch.models.transformer import (  # noqa: E402
    Model, backbone, forward, init_model, loss_fn)
from repro_torch.serving_engine import snapshot as snap  # noqa: E402
from repro_torch.serving_engine import state as st  # noqa: E402
from test_torch_zoo import _jax_op_by_op, _rel, _torch_batch  # noqa: E402

torch.set_num_threads(1)
ARCH = "jamba-1.5-large-398b"
FP32 = {"dtype": "float32", "param_dtype": "float32"}
CUT = {"n_layers": 5}            # layers 0-4 of the period: tails only
TOL = 1e-5
BF16_TOL = 2e-2


@pytest.fixture(autouse=True)
def _block_size(monkeypatch):
    monkeypatch.setenv("REPRO_FD_STREAM_C", "4")


@functools.lru_cache(maxsize=None)
def _setup(fp32=True, mixer="", cut=False):
    """(JAX cfg, port cfg, JAX params as numpy, bridged port model) of the
    smoke hybrid (16 layers) or its 5-layer cut."""
    kw = dict(FP32 if fp32 else {}, **(CUT if cut else {}))
    jcfg = dataclasses.replace(jreduce(jget_config(ARCH), **kw),
                               mixer_override=mixer)
    cfg = dataclasses.replace(reduce_for_smoke(get_config(ARCH), **kw),
                              mixer_override=mixer)
    init = jax.jit(lambda k: unbox(jinit_model(k, jcfg))[0])
    tree = jax.tree.map(np.asarray, init(jax.random.PRNGKey(0)))
    model = bridge.params_from_jax(tree, cfg, device="cpu")
    return jcfg, cfg, tree, model


def _batch(cfg, s=40, seed=3, b=2):
    return jpipeline.batch_at(jpipeline.DataConfig(
        vocab=cfg.vocab, seq_len=s, global_batch=b, seed=seed), 0)


def _toks(b, s, vocab, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, (b, s))


# ----------------------------------------------------------------- config
@pytest.mark.parametrize("smoke", [False, True])
def test_config_is_a_copy(smoke):
    """The port's config equals JAX's field by field, with its layer
    kinds, blocks, tails and analytic count."""
    j, p = jget_config(ARCH), get_config(ARCH)
    if smoke:
        j, p = jreduce(j), reduce_for_smoke(p)
    assert vars(j) == vars(p)
    assert j.layers_spec == p.layers_spec
    assert (j.period, j.n_scan_blocks, j.n_tail_layers) == (
        p.period, p.n_scan_blocks, p.n_tail_layers)
    assert j.param_count() == p.param_count()


def test_param_count_at_72_layers_and_the_cut():
    """jamba at its published widths: 398,633,918,464 parameters at 72
    layers and 24,050,696,192 (7,139,262,464 active) at the 5-layer cut,
    in both packages; the cut holds every layer kind of the period and no
    scanned block. The port's leaves of the cut (on ``meta``: nothing is
    allocated) add the norm scales and Mamba's per-head and gate-norm
    vectors, which the analytic count leaves out."""
    full = get_config(ARCH)
    assert full.param_count()["total"] == 398_633_918_464
    assert jget_config(ARCH).param_count() == full.param_count()
    cut = dataclasses.replace(full, **CUT)
    pc = cut.param_count()
    assert pc == {"total": 24_050_696_192, "active": 7_139_262_464,
                  "embedding": 1_073_741_824}
    assert pc == dataclasses.replace(jget_config(ARCH), **CUT).param_count()
    assert cut.layers_spec == (("mamba", "dense"), ("mamba", "moe"),
                               ("mamba", "dense"), ("mamba", "moe"),
                               ("attention", "dense"))
    assert (cut.n_scan_blocks, cut.n_tail_layers) == (0, 5)
    model = Model(cut, device="meta")
    vectors = 5 * 2 * 8192 + 8192 + 4 * (16384 + 3 * 256)
    assert sum(p.numel() for p in model.parameters()) == \
        24_050_696_192 + vectors
    assert model.layers[1].ffn.w_gate.shape == (16, 8192, 24576)
    assert model.layers[1].ffn.w_gate.dtype == torch.bfloat16
    assert model.layers[0].mixer.a_log.dtype == torch.float32


@pytest.mark.parametrize("cut", [False, True], ids=["16", "cut5"])
def test_init_model_matches_jax_layout(cut):
    """The port's own init (bf16) builds every leaf of the JAX tree,
    ``blocks/sub0..7`` or ``tail0..4``, with its shape and dtype."""
    _, cfg, tree, _ = _setup(False, cut=cut)
    assert set(tree) >= ({"tail0", "tail4"} if cut else {"blocks"})
    got = init_model(cfg, torch.Generator().manual_seed(0),
                     device="cpu").state_dict()
    want = bridge._port_leaves(tree, cfg)
    assert set(got) == set(want)
    for name, arr in want.items():
        assert tuple(got[name].shape) == arr.shape, name
        assert got[name].dtype == bridge._as_torch(arr).dtype, name


# Checksums of the CPU generator's draws (seed 0, ``device="cpu"``) taken
# before the draws learned to run on a CUDA generator's device: a CPU
# generator must keep drawing the same bits.
DRAWS = {
    ("jamba-1.5-large-398b", True):
        "ca7dc8393c886edf1cd57396b0483e105559ab7e1069901ca294781f0ccc45f1",
    ("jamba-1.5-large-398b", False):
        "fb61cb12500dae4b8d7a14bddd43a1097fcac2da0bfa8cdb88f6a8b5eeaf8f0a",
    ("fd-tnn-lm-wt103", False):
        "e9d3477587fff6c9232e37fc2ee0af8bc350c9df13b6c3e817d767872ffdb627",
    ("ski-tnn-lm-wt103", False):
        "79ebde2fbae7b4c6f03b117bef4cb954864fdd3420e47ac939cf2973fb571931",
}


@pytest.mark.parametrize("arch,fp32", list(DRAWS))
def test_cpu_generator_draws_are_unchanged(arch, fp32):
    """A smoke model drawn from a CPU generator (lecun, the embeddings'
    normal, Mamba's conv taps, the RPE and SKI filters) hashes as before
    the draws took the generator's device."""
    cfg = reduce_for_smoke(get_config(arch), **(FP32 if fp32 else {}))
    model = init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    h = hashlib.sha256()
    for name, v in model.state_dict().items():
        h.update(name.encode())
        h.update(v.contiguous().view(torch.uint8).numpy().tobytes())
    assert h.hexdigest() == DRAWS[(arch, fp32)]


# ------------------------------------------------------- forward and loss
@pytest.mark.parametrize("mixer", ["", "fd"])
@pytest.mark.parametrize("cut", [False, True], ids=["16", "cut5"])
def test_fp32_logits_aux_and_loss_match_jax(cut, mixer):
    """The bridged fp32 hybrid's logits, MoE aux loss and eval loss
    against JAX's within 1e-5 of their scale; with ``--mixer fd`` only the
    attention layers become FD (``(fd, dense)``), the Mamba layers stay."""
    jcfg, cfg, tree, model = _setup(True, mixer, cut)
    if mixer:
        assert [m for m, _ in cfg.layers_spec].count("fd") == (
            1 if cut else 2)
        assert "attention" not in dict(cfg.layers_spec)
    batch = _batch(cfg)
    want, jaux = jforward(tree, jcfg, Ctx(), batch)
    jl, jm = jloss_fn(tree, jcfg, Ctx(), batch)
    tb = _torch_batch(batch)
    with torch.no_grad():
        got = forward(model, cfg, tb["tokens"])
        _, aux = backbone(model, cfg, tb["tokens"])
        loss, metrics = loss_fn(model, cfg, tb)
    assert got.shape == (2, 40, cfg.vocab_padded)
    assert _rel(got, want) <= TOL
    assert float(aux) > 0
    assert abs(float(aux) - float(jaux)) <= TOL * abs(float(jaux))
    assert abs(float(metrics["aux"]) - float(jm["aux"])) <= \
        TOL * abs(float(jm["aux"]))
    assert abs(loss.item() - float(jl)) <= TOL * abs(float(jl))


@pytest.mark.parametrize("cut", [False, True], ids=["16", "cut5"])
def test_bf16_logits_match_jax_op_by_op(cut):
    """The bridged bf16 hybrid against JAX's layers run one by one, logits
    and loss within the bf16 tier at the cut, whose noise (the distance
    bf16 rounding alone puts between JAX's own bf16 logits and its
    fp32-activation logits of the same weights) is below it; at 16
    layers, where that noise reaches about 5e-2 of the scale and the
    port's distance from JAX grows with it layer by layer, within twice
    the noise (tests/test_torch_zoo.py's rule). The port's logits are at
    least half the noise away from JAX's fp32-activation logits: they
    carry bf16 rounding of their own."""
    jcfg, cfg, tree, model = _setup(False, cut=cut)
    batch = _batch(cfg)
    want = _jax_op_by_op(tree, jcfg, batch)
    want32 = _jax_op_by_op(tree, dataclasses.replace(jcfg, dtype="float32"),
                           batch)
    noise = _rel(want, want32)
    if cut:
        assert noise < BF16_TOL
    tol = BF16_TOL if cut else max(BF16_TOL, 2 * noise)
    with torch.no_grad():
        got = forward(model, cfg, _torch_batch(batch)["tokens"])
        loss, _ = loss_fn(model, cfg, _torch_batch(batch))
    assert got.dtype == torch.bfloat16
    assert _rel(got, want) <= tol
    assert _rel(got, want32) >= noise / 2
    jl, _ = jloss_fn(tree, jcfg, Ctx(), batch)
    assert abs(loss.item() - float(jl)) <= tol * abs(float(jl))


# ------------------------------------------------------------------ decode
@pytest.mark.parametrize("p,gen,max_len,cut,mixer", [
    (5, 9, 16, False, ""), (11, 6, 20, False, ""), (7, 8, 16, True, ""),
    (6, 7, 16, False, "fd")])
def test_generate_is_token_exact_vs_jax(p, gen, max_len, cut, mixer):
    """Greedy decode through the mixed caches (the prompt token by token,
    as JAX does: no chunked prefill for a Mamba layer), at the same
    max_len; with ``--mixer fd`` the attention layers' caches are FD
    streams beside the Mamba caches."""
    jcfg, cfg, tree, model = _setup(True, mixer, cut)
    prompt = _toks(3, p, cfg.vocab, seed=p)
    want = jserve.generate(StepBuilder(jcfg), tree,
                           jnp.asarray(prompt, jnp.int32), gen,
                           max_len=max_len)
    with torch.inference_mode():
        got = serve.generate(model, cfg, torch.from_numpy(prompt), gen,
                             max_len=max_len)
        cache = serving.init_cache(cfg, 1, max_len, params=model)
    assert not serving.supports_chunked_prefill(cfg, cache)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _leaf_kinds(cfg, cache) -> None:
    """Each layer's cache is its mixer's: {k, v} for attention (the
    activation dtype), {conv (activation dtype), state (fp32)} for
    Mamba; the capacity is the attention layer's max_len."""
    act = getattr(torch, cfg.dtype)
    for (mixer, _), lc in zip(cfg.layers_spec, cache):
        if mixer == "attention":
            assert set(lc) == {"k", "v"}
            assert lc["k"].dtype == lc["v"].dtype == act
        else:
            assert set(lc) == {"conv", "state"}
            assert lc["conv"].dtype == act
            assert lc["state"].dtype == torch.float32


@pytest.mark.parametrize("cut", [False, True], ids=["16", "cut5"])
def test_cache_leaves_match_jax_after_decode(cut):
    """6 prompt tokens and 3 more decode steps teacher-forced through both
    packages: the logits of every step, and then every cache leaf (KV,
    conv window, SSD state) through ``bridge.cache_from_jax``, within 1e-5
    of their scale; ``cache_capacity`` is the attention layer's max_len."""
    jcfg, cfg, tree, model = _setup(True, cut=cut)
    toks = _toks(2, 9, cfg.vocab, seed=4)
    step = StepBuilder(jcfg).serve_step_jit()
    jcache = jserving.init_cache(jcfg, 2, 16, params=tree)
    cache = serving.init_cache(cfg, 2, 16, params=model)
    _leaf_kinds(cfg, cache)
    assert serving.cache_capacity(cache) == 16
    with torch.inference_mode():
        for t in range(9):
            jl, jcache = step(tree, {"tokens": jnp.asarray(toks[:, t:t + 1],
                                                           jnp.int32)},
                              jcache, jnp.int32(t))
            lg, cache = serving.decode_step(
                model, cfg, torch.from_numpy(toks[:, t:t + 1]), cache, t)
            assert _rel(lg, jl) <= TOL, t
    got = bridge.cache_from_jax(jax.tree.map(np.asarray, jcache), cfg, "cpu")
    _leaf_kinds(cfg, got)
    for i, (lc_got, lc) in enumerate(zip(got, cache)):
        assert lc_got.keys() == lc.keys()
        for name in lc:
            assert lc_got[name].shape == lc[name].shape, (i, name)
            assert _rel(lc[name], lc_got[name]) <= TOL, (i, name)


# -------------------------------------------------------------- the engine
PLENS, GENS, MAX_LEN = [3, 10, 6, 2], [8, 5, 9, 12], 24


def _prompts(vocab, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, (p,)).astype(np.int32) for p in PLENS]


def _requests(mod, prompts, **kw):
    return [mod.Request(uid=f"r{i}", prompt=pr, max_new=g, **kw)
            for i, (pr, g) in enumerate(zip(prompts, GENS))]


@functools.lru_cache(maxsize=None)
def _jax_engine():
    jcfg, _, tree, _ = _setup(True)
    jeng = jse.Engine(jcfg, tree, slots=2, max_len=MAX_LEN)
    sched = jse.Scheduler(jeng)
    for r in _requests(jse, _prompts(jcfg.vocab)):
        sched.submit(r)
    out, _ = sched.run()
    return jeng, {u: list(map(int, t)) for u, t in out.items()}


def test_engine_matches_jax_engine_and_solo():
    """4 staggered requests through 2 slots of an fp32 hybrid Engine (its
    slots recycled, parked rows in every step: 2 rows never fill the
    4-slot minimum capacity of an expert): JAX's Engine and the port's
    solo decode at the same max_len, token for token. The Engine's
    capacity is the KV layer's max_len."""
    _, cfg, _, model = _setup(True)
    _, want = _jax_engine()
    prompts = _prompts(cfg.vocab)
    eng = tse.Engine(cfg, model, slots=2, max_len=MAX_LEN)
    assert eng.capacity == MAX_LEN and eng._chunk_c is None
    sched = tse.Scheduler(eng)
    for r in _requests(tse, prompts):
        sched.submit(r)
    got, _ = sched.run()
    with torch.inference_mode():
        solo = [serve.generate(model, cfg, torch.from_numpy(
            pr.astype(np.int64))[None], g, max_len=MAX_LEN)[0, len(pr):]
            .tolist() for pr, g in zip(prompts, GENS)]
    for i in range(len(prompts)):
        assert list(got[f"r{i}"]) == want[f"r{i}"], i
        assert list(got[f"r{i}"]) == solo[i], i


def test_state_updates_keep_each_leaf_dtype():
    """A bf16 hybrid's engine state holds bf16 k, v and conv rows beside
    fp32 SSD state rows: ``insert_from`` a packed prefill, the masked step
    with a parked slot, ``take_row``, ``select_rows``, ``release`` and
    ``poison`` keep every leaf's dtype, and an insert into the parked slot
    writes its packed row over the scratch bit for bit."""
    _, cfg, _, model = _setup(False)
    eng = tse.Engine(cfg, model, slots=2, max_len=MAX_LEN)
    dtypes = [{k: v.dtype for k, v in lc.items()}
              for lc in eng.init_state().cache]
    assert {d for lcd in dtypes for d in lcd.values()} == {
        torch.bfloat16, torch.float32}

    def check(cache):
        assert [{k: v.dtype for k, v in lc.items()} for lc in cache] == \
            dtypes
    prompts = _prompts(cfg.vocab, seed=2)
    with torch.inference_mode():
        packed, first, plens = eng.prefill_packed(prompts[:2])
        check(packed)
        check(st.take_row(packed, 1))
        state = eng.init_state()
        state = eng.insert_from(state, packed, 0, plens[0], first[0], 0)
        check(state.cache)
        before = state.cache
        state, _, ok = eng.generate(state)      # slot 1 parked: scratch rows
        assert ok.tolist() == [True, True]
        check(state.cache)
        check(st.select_rows(torch.tensor([True, False]), state.cache,
                             before))
        state = eng.insert_from(state, packed, 1, plens[1], first[1], 1)
        check(state.cache)
        for lc, lp in zip(state.cache, packed):
            for k in lc:
                assert torch.equal(lc[k][1], lp[k][1]), k
        check(eng.release(state, 0).cache)
        check(eng.poison_slot(state, 0).cache)


def test_decode_state_bridge_matches_jax_state():
    """A JAX engine state with two admitted requests and one step, through
    ``decode_state_from_jax``, equals the port engine's after the same
    (the KV, conv and SSD-state rows within 1e-5 of their scale, the rest
    exact); ``decode_state_to_jax`` gives back JAX's leaves and shapes,
    and the port's state goes there and back bitwise."""
    _, cfg, _, model = _setup(True)
    jeng, _ = _jax_engine()
    eng = tse.Engine(cfg, model, slots=2, max_len=MAX_LEN)
    jstate, state = jeng.init_state(), eng.init_state()
    for slot, pr in enumerate(_prompts(cfg.vocab, seed=3)[:2]):
        prefix, first, plen = jeng.prefill(pr)
        jstate = jeng.insert(jstate, prefix, plen, int(first), slot)
        prefix, first, plen = eng.prefill(pr)
        state = eng.insert(state, prefix, plen, int(first), slot)
    jstate, jtoks, _ = jeng.generate(jstate)
    state, toks, _ = eng.generate(state)
    assert np.asarray(jtoks).tolist() == toks.tolist()
    host = jax.tree.map(np.asarray, jstate)
    got = bridge.decode_state_from_jax(host, cfg, "cpu")
    assert got.cur_len.tolist() == state.cur_len.tolist()
    assert got.tokens.tolist() == state.tokens.tolist()
    _leaf_kinds(cfg, got.cache)
    for lc_got, lc in zip(got.cache, state.cache):
        assert lc_got.keys() == lc.keys()
        for name in lc:
            assert _rel(lc[name], lc_got[name]) <= TOL, name
    back = bridge.decode_state_to_jax(state, cfg)
    flat = dict(bridge._flatten(back.cache))
    want = dict(bridge._flatten(host.cache))
    assert flat.keys() == want.keys()
    assert all(tuple(flat[k].shape) == want[k].shape for k in want)
    again = bridge.decode_state_from_jax(back, cfg, "cpu",
                                         template=eng._prefix_template)
    for lc_again, lc in zip(again.cache, state.cache):
        for name in lc:
            assert lc_again[name].dtype == lc[name].dtype
            assert torch.equal(lc_again[name], lc[name]), name


def _preempted(mod, eng, prompts, snap_dir, n=9):
    box = {"n": 0, "sched": None}

    def cb(uid, tok):
        box["n"] += 1
        if box["n"] == n:
            box["sched"].preempt()
    sched = mod.Scheduler(eng, snapshot_dir=snap_dir, detok_async=False)
    box["sched"] = sched
    for r in _requests(mod, prompts, on_token=cb):
        sched.submit(r)
    partial, state = sched.run()
    assert sched.preempted
    return {u: list(map(int, t)) for u, t in partial.items()}, state


def test_snapshot_restores_the_mixed_state_bitwise(tmp_path):
    """A bf16 hybrid Scheduler preempted after 9 tokens: the snapshot's
    state, loaded into a new Engine, equals the preempted state leaf for
    leaf and bit for bit in each leaf's dtype (bf16 KV and conv, fp32
    state), and the resumed run ends where the uninterrupted one does."""
    _, cfg, _, model = _setup(False)
    prompts = _prompts(cfg.vocab, seed=4)
    whole = tse.Scheduler(tse.Engine(cfg, model, slots=2, max_len=MAX_LEN))
    for r in _requests(tse, prompts):
        whole.submit(r)
    want, _ = whole.run()
    snap_dir = str(tmp_path / "snap")
    partial, state = _preempted(
        tse, tse.Engine(cfg, model, slots=2, max_len=MAX_LEN), prompts,
        snap_dir)
    eng = tse.Engine(cfg, model, slots=2, max_len=MAX_LEN)
    loaded = snap.load_snapshot(snap_dir, eng)["state"]
    assert torch.equal(loaded.cur_len, state.cur_len)
    assert torch.equal(loaded.tokens, state.tokens)
    for lc_got, lc in zip(loaded.cache, state.cache):
        assert lc_got.keys() == lc.keys()
        for name in lc:
            assert lc_got[name].dtype == lc[name].dtype, name
            assert torch.equal(lc_got[name], lc[name]), name
    sched = tse.Scheduler(eng, snapshot_dir=snap_dir)
    assert sched.try_restore()
    resumed, _ = sched.run()
    for u, toks in want.items():
        assert list(resumed[u]) == list(toks), u
        assert list(resumed[u])[:len(partial[u])] == partial[u]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_snapshot_crosses_packages(tmp_path, writer):
    """An fp32 hybrid Scheduler preempted after 9 tokens snapshots its
    mixed cache rows; the other package restores it and finishes: the
    tokens before plus after equal JAX's uninterrupted run."""
    jcfg, cfg, tree, model = _setup(True)
    jeng, want = _jax_engine()
    prompts = _prompts(cfg.vocab)
    snap_dir = str(tmp_path / "snap")
    eng = tse.Engine(cfg, model, slots=2, max_len=MAX_LEN)
    if writer == "jax":
        partial, _ = _preempted(jse, jeng, prompts, snap_dir)
        sched = tse.Scheduler(eng, snapshot_dir=snap_dir)
    else:
        partial, _ = _preempted(tse, eng, prompts, snap_dir)
        sched = jse.Scheduler(jeng, snapshot_dir=snap_dir)
    assert os.listdir(snap_dir)
    assert sched.try_restore()
    resumed, _ = sched.run()
    for u, toks in want.items():
        assert list(map(int, resumed[u])) == toks, u
        assert list(map(int, resumed[u]))[:len(partial[u])] == partial[u]


# ------------------------------------------------------------ the launcher
@pytest.mark.parametrize("extra", [[], ["--engine", "--slots", "2"],
                                   ["--mixer", "fd"],
                                   ["--mixer", "fd", "--engine"]],
                         ids=["lockstep", "engine", "fd", "fd-engine"])
def test_serve_main_runs_on_cpu(extra, capsys):
    args = ["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "2",
            "--prompt-len", "5", "--gen-len", "4"]
    assert serve.main(args + extra) == 0
    out = capsys.readouterr().out
    assert ("generated 8 tokens in" in out
            and ("engine(" in out) == ("--engine" in extra))


# --------------------------------------------------------------- refusals
def test_encoder_decoder_still_refused():
    """jamba as an encdec config has no encoder layers (enc_layers 0),
    which JAX's init_model cannot build (an IndexError); the port refuses
    it by name (the encdec kind itself runs: test_torch_encdec.py)."""
    cfg = dataclasses.replace(reduce_for_smoke(get_config(ARCH)),
                              kind="encdec")
    with pytest.raises(ValueError, match="enc_layers >= 1"):
        Model(cfg, device="meta")

