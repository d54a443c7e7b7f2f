"""Port parity for the attention decoders of the model zoo (``gemma3-4b``,
``stablelm-3b``, ``phi3-medium-14b``, ``qwen2-72b``, and with MoE FFNs
``granite-moe-3b-a800m`` and ``grok-1-314b``) and the paper's mixers
dropped into them by ``mixer_override``, against the JAX package, on smoke
configs with the JAX parameters carried over by ``bridge.params_from_jax``
and the same seeded numpy inputs. Mirrors tests/test_models.py (:35, :57,
:191, :202) for these archs. REPRO_FD_STREAM_C=4 is set for both packages.
Decode against the forward takes the MoE archs at capacity factor 8.0, as
JAX's test does: the forward's batch of tokens would drop assignments that
a decode step of 2 rows keeps.

Tolerances, each with its reason:
* fp32 (each arch with ``dtype`` and ``param_dtype`` float32): logits,
  eval loss and every gradient against ``jax.grad`` within 1e-5 of the
  largest magnitude (matmul, softmax and FFT sums in other orders);
  decode logits against the port's forward within 1e-5 of their scale;
* bf16 (the configs' own dtype): logits and loss within 2e-2 of their
  scale, the bf16 tier, or, where bf16 rounding alone moves JAX's own
  logits farther than 1e-2 from its fp32 run of the same weights (a TNO
  override amplifies the residual stream's roundings: 4-6% in JAX itself
  at 12 gemma3 layers), within twice that distance. The two packages round
  to bf16 at different places (XLA keeps fused elementwise chains in
  fp32), so their distance is of the size of each one's bf16 noise;
* losses after AdamW steps: 1e-4 relative, parameters within 2·Σ lr per
  element (Adam's first steps amplify round-off, m/√v ≈ ±1) and 99% of
  them within 1e-5;
* greedy decode, the Engine and snapshots: token-exact against JAX at the
  same max_len (fp32, where no top-2 near-tie flips between packages);
* MoE archs in bf16: the router's bf16 logits can route a near-tied token
  to another expert in JAX's forward (its scanned layers compiled, the
  bf16 chains fused in fp32) than in the same layers run op by op, as the
  port runs them. The port is held at the bf16 tier to JAX's layers run
  op by op, and to JAX's forward within the larger of that tier and twice
  the distance between JAX's two evaluations;
* cache leaves through the bridge: exact (bytes move).
"""
import dataclasses
import functools
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
from repro.models import transformer as jtransformer  # noqa: E402
from repro.models.context import Ctx  # noqa: E402
from repro.models.transformer import forward as jforward  # noqa: E402
from repro.models.transformer import init_model as jinit_model  # noqa: E402
from repro.models.transformer import loss_fn as jloss_fn  # noqa: E402
from repro.nn.layers import rmsnorm as jrmsnorm  # noqa: E402
from repro.nn.params import unbox  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config, reduce_for_smoke  # noqa: E402
from repro_torch.launch import serve, train  # noqa: E402
from repro_torch.launch.steps import loss_and_grads  # noqa: E402
from repro_torch.launch.steps import make_train_step  # noqa: E402
from repro_torch.models import serving  # noqa: E402
from repro_torch.models.transformer import (  # noqa: E402
    Model, forward, init_model, loss_fn)
from repro_torch.optim import adamw  # noqa: E402

torch.set_num_threads(1)
MOE_ARCHS = ("granite-moe-3b-a800m", "grok-1-314b")
ARCHS = ("gemma3-4b", "stablelm-3b", "phi3-medium-14b", "qwen2-72b",
         *MOE_ARCHS)
FP32 = {"dtype": "float32", "param_dtype": "float32"}
TOL = 1e-5


@pytest.fixture(autouse=True)
def _block_size(monkeypatch):
    monkeypatch.setenv("REPRO_FD_STREAM_C", "4")


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _rel(got, want) -> float:
    got, want = _f32(got), _f32(want)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-30)


@functools.lru_cache(maxsize=None)
def _setup(arch, fp32=False, mixer="", **kw):
    """(JAX cfg, port cfg, JAX params as numpy, bridged port model) of the
    smoke config; callers that train build their own model."""
    kw = dict(FP32 if fp32 else {}, **kw)
    jcfg = dataclasses.replace(jreduce(jget_config(arch), **kw),
                               mixer_override=mixer)
    cfg = dataclasses.replace(reduce_for_smoke(get_config(arch), **kw),
                              mixer_override=mixer)
    init = jax.jit(lambda k: unbox(jinit_model(k, jcfg))[0])
    tree = jax.tree.map(np.asarray, init(jax.random.PRNGKey(0)))
    model = bridge.params_from_jax(tree, cfg, device="cpu")
    return jcfg, cfg, tree, model


def _batch(cfg, s=24, seed=3, b=2):
    return jpipeline.batch_at(jpipeline.DataConfig(
        vocab=cfg.vocab, seq_len=s, global_batch=b, seed=seed), 0)


def _torch_batch(batch):
    return {k: torch.from_numpy(np.asarray(v)).long()
            for k, v in batch.items()}


def _jax_op_by_op(tree, jcfg, batch):
    """JAX's forward logits with its layers called one by one, outside
    the layer scan (so each op runs alone, as in the port)."""
    ctx, per = Ctx(), jcfg.period
    n_scan = jcfg.n_scan_blocks * per
    x = jtransformer.embed_tokens(tree, jcfg, ctx,
                                  jnp.asarray(batch["tokens"]))
    for i, (mixer, ffn) in enumerate(jcfg.layers_spec):
        p = (jax.tree.map(lambda a: a[i // per],
                          tree["blocks"][f"sub{i % per}"])
             if i < n_scan else tree[f"tail{i - n_scan}"])
        x, _ = jtransformer.layer_apply(p, jcfg, ctx, mixer, ffn, x,
                                        mask_kind="causal")
    x = jrmsnorm(tree["norm_f"], x, jcfg.norm_eps)
    return jtransformer.unembed(tree, jcfg, ctx, x)


def _hold_logits(arch, fp32, mixer="", s=24, **kw):
    """The port's logits and eval loss against JAX's on one batch, at the
    tier of the module docstring."""
    jcfg, cfg, tree, model = _setup(arch, fp32, mixer, **kw)
    batch = _batch(cfg, s=s)
    want, _ = jforward(tree, jcfg, Ctx(), batch)
    jl, _ = jloss_fn(tree, jcfg, Ctx(), batch)
    with torch.no_grad():
        got = forward(model, cfg, _torch_batch(batch)["tokens"])
        loss, _ = loss_fn(model, cfg, _torch_batch(batch))
    assert got.shape == (2, s, cfg.vocab_padded)
    assert got.dtype == getattr(torch, cfg.dtype)
    if fp32:
        tol = TOL
    else:
        f32, _ = jforward(tree, dataclasses.replace(jcfg, dtype="float32"),
                          Ctx(), batch)
        tol = max(2e-2, 2 * _rel(want, f32))
    jtol = tol
    if not fp32 and arch in MOE_ARCHS:
        by_op = _jax_op_by_op(tree, jcfg, batch)
        assert _rel(got, by_op) <= tol
        jtol = max(tol, 2 * _rel(want, by_op))
    assert _rel(got, want) <= jtol
    assert abs(loss.item() - float(jl)) <= jtol * abs(float(jl))
    return cfg, model


# ----------------------------------------------------------------- configs
@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", [*ARCHS, "whisper-medium", "paligemma-3b"])
def test_configs_are_copies(arch, smoke):
    """The port's config copy matches the JAX registry field for field."""
    j, p = jget_config(arch), get_config(arch)
    if smoke:
        j, p = jreduce(j), reduce_for_smoke(p)
    assert vars(j) == vars(p)
    assert j.layers_spec == p.layers_spec
    assert (j.period, j.n_scan_blocks, j.n_tail_layers) == (
        p.period, p.n_scan_blocks, p.n_tail_layers)
    assert j.param_count() == p.param_count()


@pytest.mark.parametrize("mixer", ["", "fd"])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_count_analytic_matches_actual(arch, mixer):
    """Mirrors tests/test_models.py::test_param_count_analytic_matches_
    actual: the analytic count within 5% of the port's own leaves (it
    leaves out norms, biases and the TNO mixers' RPEs), and equal to the
    JAX package's."""
    cfg = dataclasses.replace(reduce_for_smoke(get_config(arch)),
                              mixer_override=mixer)
    model = init_model(cfg, torch.Generator().manual_seed(0), device="meta")
    actual = sum(p.numel() for p in model.parameters())
    pc = cfg.param_count()
    assert abs(actual - pc["total"]) / actual < 0.05, (actual, pc)
    assert pc == dataclasses.replace(jreduce(jget_config(arch)),
                                     mixer_override=mixer).param_count()


def test_gemma3_full_width_param_count():
    """gemma3-4b at full width: 34 layers, 5 blocks of period 6 and 4 tail
    layers, 4,550,819,840 parameters by the analytic count."""
    cfg = get_config("gemma3-4b")
    assert (cfg.n_scan_blocks, cfg.n_tail_layers) == (5, 4)
    assert cfg.param_count()["total"] == 4_550_819_840
    spec = cfg.layers_spec
    assert [m for m, _ in spec[:6]] == ["local"] * 5 + ["attention"]


def test_granite_full_width_param_count():
    """granite-moe-3b-a800m at full width: 32 (attention, moe) layers of 40
    experts, top-8, 3,374,972,928 parameters by the analytic count,
    959,053,824 active; the port's own leaves add the 65 norm scales."""
    cfg = get_config("granite-moe-3b-a800m")
    assert (cfg.n_scan_blocks, cfg.n_tail_layers) == (32, 0)
    assert set(cfg.layers_spec) == {("attention", "moe")}
    assert cfg.param_count() == {"total": 3_374_972_928,
                                 "active": 959_053_824,
                                 "embedding": 151_781_376}
    model = Model(cfg, device="meta")
    assert sum(p.numel() for p in model.parameters()) == \
        3_374_972_928 + 65 * 1536
    assert model.layers[0].ffn.router.dtype == torch.float32
    assert model.layers[0].ffn.w_gate.shape == (40, 1536, 512)
    assert model.layers[0].ffn.w_gate.dtype == torch.bfloat16


@pytest.mark.parametrize("arch", ARCHS)
def test_init_model_matches_jax_layout(arch):
    """The port's own init builds every leaf of the JAX tree with its
    shape and dtype (bf16 matrices, fp32 norm scales)."""
    _, cfg, tree, _ = _setup(arch)
    got = init_model(cfg, torch.Generator().manual_seed(0),
                     device="cpu").state_dict()
    want = bridge._port_leaves(tree, cfg)
    assert set(got) == set(want)
    for name, arr in want.items():
        assert tuple(got[name].shape) == arr.shape, name
        assert got[name].dtype == bridge._as_torch(arr).dtype, name
        if arr.size > 1000:               # std within 20% of JAX's
            a = bridge._as_torch(arr).float()
            assert abs(float(got[name].float().std()) / float(a.std())
                       - 1) < 0.2, name


# ------------------------------------------------------- forward and loss
@pytest.mark.parametrize("fp32", [True, False], ids=["fp32", "bf16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_logits_and_loss_match_jax(arch, fp32):
    _hold_logits(arch, fp32, s=40)


@pytest.mark.parametrize("arch", ARCHS)
def test_grads_match_jax(arch):
    """Every parameter's gradient of the training loss against
    ``jax.grad`` (fp32; s = 64 takes the smoke attn_chunk's two q-chunks
    under ``torch.utils.checkpoint``)."""
    jcfg, cfg, tree, model = _setup(arch, True)
    batch = _batch(cfg, s=64, seed=4)
    jg = jax.grad(lambda p: jloss_fn(p, jcfg, Ctx(), batch)[0])(
        jax.tree.map(jnp.asarray, tree))
    want = bridge._port_leaves(jax.tree.map(np.asarray, jg), cfg)
    _, _, grads = loss_and_grads(model, cfg, _torch_batch(batch))
    assert set(grads) == set(want)
    for k, g in grads.items():
        assert _rel(g, want[k]) <= TOL, k


@pytest.mark.parametrize("arch", ARCHS)
def test_three_train_steps_track_jax(arch):
    jcfg, cfg, tree, _ = _setup(arch, True)
    kw = dict(lr=1e-3, warmup_steps=1, total_steps=3)
    sb = StepBuilder(jcfg, opt_cfg=jadamw.OptConfig(**kw))
    jstep = jax.jit(sb.make_train_step())
    jstate = {"params": jax.tree.map(jnp.asarray, tree)}
    jstate["opt"] = jadamw.init(sb.opt_cfg, jstate["params"])
    model = bridge.params_from_jax(tree, cfg, device="cpu")
    ocfg = adamw.OptConfig(**kw)
    opt = adamw.init(ocfg, dict(model.named_parameters()))
    step = make_train_step(cfg, ocfg)
    dcfg = jpipeline.DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=2,
                                seed=0)
    lrs = []
    for i in range(3):
        batch = jpipeline.batch_at(dcfg, i)
        jstate, jm = jstep(jstate, batch)
        opt, m = step(model, opt, _torch_batch(batch))
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-4)
        lrs.append(float(m["lr"]))
    want = bridge._port_leaves(jax.tree.map(np.asarray, jstate["params"]),
                               cfg)
    bound = 2 * sum(lrs)
    for k, p in model.named_parameters():
        diff = np.abs(p.detach().numpy() - want[k])
        assert diff.max() <= bound, k
        assert np.mean(diff <= 1e-5) >= 0.99, k


# ------------------------------------------------------------------ decode
def _toks(b, s, vocab, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, (b, s))


@pytest.mark.parametrize("p,gen,max_len", [(5, 9, 16), (11, 6, 20)])
@pytest.mark.parametrize("arch", ["gemma3-4b", "qwen2-72b", *MOE_ARCHS])
def test_generate_is_token_exact_vs_jax(arch, p, gen, max_len):
    """Greedy decode through the KV caches; the smoke window (8) binds in
    gemma3's local layers before the end. The MoE archs at their own
    capacity factor: a step of 3 rows never drops."""
    jcfg, cfg, tree, model = _setup(arch, True)
    prompt = _toks(3, p, cfg.vocab, seed=p)
    want = jserve.generate(StepBuilder(jcfg), tree,
                           jnp.asarray(prompt, jnp.int32), gen,
                           max_len=max_len)
    with torch.inference_mode():
        got = serve.generate(model, cfg, torch.from_numpy(prompt), gen,
                             max_len=max_len)
    assert got.shape == (3, p + gen)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_logits_match_forward(arch):
    """Mirrors tests/test_models.py::test_decode_matches_forward: decode
    token by token over 14 positions reproduces the forward, position by
    position (fp32); the caches are KV caches in the activation dtype."""
    kw = {"moe_capacity_factor": 8.0} if arch in MOE_ARCHS else {}
    _, cfg, _, model = _setup(arch, True, **kw)
    toks = torch.from_numpy(_toks(2, 14, cfg.vocab))
    with torch.no_grad():
        want = forward(model, cfg, toks)
        cache = serving.init_cache(cfg, 2, 14, params=model)
        assert all(set(lc) == {"k", "v"} and lc["k"].shape ==
                   (2, 14, cfg.n_kv_heads, cfg.head_dim) for lc in cache)
        assert serving.cache_capacity(cache) == 14
        got = []
        for t in range(14):
            lg, cache = serving.decode_step(model, cfg, toks[:, t:t + 1],
                                            cache, t)
            got.append(lg[:, 0])
    assert _rel(torch.stack(got, 1), want) <= TOL


def test_bf16_cache_dtype_and_decode():
    """The bf16 gemma3's KV cache is bf16 (JAX: the activation dtype); its
    greedy tokens are those of the bf16 forward wherever the forward's
    top-2 margin is clear of bf16 noise."""
    _, cfg, _, model = _setup("gemma3-4b")
    prompt = torch.from_numpy(_toks(2, 6, cfg.vocab, seed=2))
    cache = serving.init_cache(cfg, 2, 16, params=model)
    assert all(lc["k"].dtype == torch.bfloat16 for lc in cache)
    with torch.inference_mode():
        seqs = serve.generate(model, cfg, prompt, 10, max_len=16)
        lg = forward(model, cfg, seqs)[:, 5:15].float()
    top2 = torch.topk(lg, 2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) > 0.05 * float(lg.abs().max())
    pred = torch.argmax(lg, dim=-1)
    assert bool(clear.any())
    assert torch.equal(pred[clear], seqs[:, 6:][clear])


# --------------------------------------------- tail layers and the bridge
TAIL = {"n_layers": 13}          # 2 blocks of period 6 and 1 tail layer


@pytest.mark.parametrize("mixer", ["", "fd"])
def test_tail_layer_model_matches_jax(mixer):
    """gemma3 with n_layers = 2 · period + 1: the JAX tree holds
    ``blocks/sub0..5`` stacked over 2 blocks and ``tail0``; the bridge
    unrolls it into 13 layers and stacks it back to the same tree; logits
    and loss match JAX, also with every layer an FD mixer (whose stream
    cache's leaf ``tail`` is not the layer ``tail0``)."""
    jcfg, cfg, tree, model = _setup("gemma3-4b", True, mixer, **TAIL)
    assert (cfg.n_scan_blocks, cfg.n_tail_layers) == (2, 1)
    assert set(tree) >= {"blocks", "tail0"}
    assert len(model.layers) == 13
    back = dict(bridge._flatten(bridge.params_to_jax(model)))
    flat = dict(bridge._flatten(tree))
    assert back.keys() == flat.keys()
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k].numpy(), v, err_msg=k)
    _hold_logits("gemma3-4b", True, mixer, **TAIL)


@pytest.mark.parametrize("stream", ["1", "0"], ids=["stream", "hist"])
def test_tail_layer_fd_override_generates_like_jax(stream, monkeypatch):
    """The FD override of the tail-layer gemma3 decodes token-exact against
    JAX, through the streaming caches (chunked prefill) and the hist
    caches."""
    monkeypatch.setenv("REPRO_FD_STREAM", stream)
    jcfg, cfg, tree, model = _setup("gemma3-4b", True, "fd", **TAIL)
    prompt = _toks(2, 9, cfg.vocab, seed=5)
    want = jserve.generate(StepBuilder(jcfg), tree,
                           jnp.asarray(prompt, jnp.int32), 7, max_len=16)
    with torch.inference_mode():
        got = serve.generate(model, cfg, torch.from_numpy(prompt), 7,
                             max_len=16)
        cache = serving.init_cache(cfg, 1, 16, params=model)
    assert serving.supports_chunked_prefill(cfg, cache) == (stream == "1")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("mixer", ["", "fd"])
def test_cache_from_jax_carries_tail_layer_caches(mixer):
    """A JAX serving cache of the tail-layer gemma3 (KV leaves, or with
    the FD override the stream leaves, ``tail`` included) comes over leaf
    for leaf, each layer's from its block row or from ``tail0``, and goes
    back to the same JAX layout through ``decode_state_to_jax``."""
    jcfg, cfg, tree, model = _setup("gemma3-4b", True, mixer, **TAIL)
    jcache = jax.tree.map(np.asarray, jserving.init_cache(
        jcfg, 2, 16, params=tree if mixer else None))
    rng = np.random.default_rng(0)
    jcache = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(
        a.dtype) if a.size and a.dtype == np.float32 else a, jcache)
    got = bridge.cache_from_jax(jcache, cfg, "cpu")
    assert len(got) == 13
    want_keys = {"k", "v"} if not mixer else set(jcache["tail0"])
    assert all(set(lc) == want_keys for lc in got)
    for i, lc in enumerate(got):
        src = (jcache["tail0"] if i == 12 else
               {k: v[i // 6] for k, v in jcache["blocks"][f"sub{i % 6}"]
                .items()})
        for k, v in lc.items():
            np.testing.assert_array_equal(v.numpy(), src[k], err_msg=(i, k))
    state = tse.DecodeState(cache=got, cur_len=torch.zeros(2, dtype=torch.long),
                            tokens=torch.zeros(2, dtype=torch.long),
                            active=torch.zeros(2, dtype=torch.bool),
                            rng=torch.zeros(2, 2, dtype=torch.long))
    back = bridge.decode_state_to_jax(state, cfg).cache
    flat, want = dict(bridge._flatten(back)), dict(bridge._flatten(jcache))
    assert flat.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_array_equal(flat[k].numpy(), v, err_msg=k)


# ------------------------------------------------- the paper's mixers in
@pytest.mark.parametrize("fp32", [True, False], ids=["fp32", "bf16"])
@pytest.mark.parametrize("arch,mixer", [("phi3-medium-14b", "fd"),
                                        ("gemma3-4b", "ski"),
                                        ("gemma3-4b", "fd"),
                                        ("qwen2-72b", "tno"),
                                        ("granite-moe-3b-a800m", "fd")])
def test_mixer_override_matches_jax(arch, mixer, fp32):
    """Mirrors tests/test_models.py::test_mixer_override_tnoizes_attention_
    arch: every attention and local layer takes the paper's mixer (its
    leaves fp32 in a bf16 model, computing in fp32 as JAX's promotion
    does, and cast back), and the logits and loss are JAX's; granite's
    layers become (fd, moe)."""
    cfg, model = _hold_logits(arch, fp32, mixer)
    assert all(m == mixer for m, _ in cfg.layers_spec)
    assert all(p.dtype == torch.float32
               for layer in model.layers for p in layer.mixer.parameters())


def test_ski_override_has_no_decode():
    _, cfg, _, model = _setup("gemma3-4b", True, "ski")
    with pytest.raises(NotImplementedError, match="Appendix B"):
        serving.init_cache(cfg, 1, 8, params=model)


# -------------------------------------------------------------- the engine
PLENS, GENS, MAX_LEN = [3, 10, 6, 2], [8, 5, 9, 12], 16


def _prompts(vocab, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, (p,)).astype(np.int32) for p in PLENS]


def test_engine_matches_jax_engine_and_solo():
    """4 staggered requests through S = 2 slots of a gemma3 Engine (fp32):
    the prompts teacher-forced through the bucket's masked steps, slots
    recycled; the JAX Engine's tokens and the port's solo decode at the
    same max_len, token for token."""
    jcfg, cfg, tree, model = _setup("gemma3-4b", True)
    prompts = _prompts(cfg.vocab, seed=1)
    eng = tse.Engine(cfg, model, slots=2, max_len=MAX_LEN)
    assert eng._chunk_c is None and eng.capacity == MAX_LEN
    sched = tse.Scheduler(eng)
    jsched = jse.Scheduler(jse.Engine(jcfg, tree, slots=2, max_len=MAX_LEN))
    for i, (pr, g) in enumerate(zip(prompts, GENS)):
        sched.submit(tse.Request(uid=f"r{i}", prompt=pr, max_new=g))
        jsched.submit(jse.Request(uid=f"r{i}", prompt=pr, max_new=g))
    got, _ = sched.run()
    want, _ = jsched.run()
    with torch.inference_mode():
        solo = [serve.generate(model, cfg, torch.from_numpy(
            pr.astype(np.int64))[None], g, max_len=MAX_LEN)[0, len(pr):]
            .tolist() for pr, g in zip(prompts, GENS)]
    for i in range(len(prompts)):
        assert list(got[f"r{i}"]) == list(map(int, want[f"r{i}"])), i
        assert list(got[f"r{i}"]) == solo[i], i


def test_engine_poisoned_slot_is_isolated():
    """A NaN KV row trips the non-finite guard for its slot alone."""
    _, cfg, _, model = _setup("gemma3-4b", True)
    eng = tse.Engine(cfg, model, slots=2, max_len=MAX_LEN)
    prompts = _prompts(cfg.vocab, seed=2)[:2]
    with torch.inference_mode():
        state = eng.init_state()
        for s, pr in enumerate(prompts):
            cache, first, plen = eng.prefill(pr)
            state = eng.insert(state, cache, plen, first, s)
        state = eng.poison_slot(state, 1)
        state, _, ok = eng.generate(state)
    assert ok.tolist() == [True, False]
    assert state.active.tolist() == [True, False]


def _preempted(mod, eng, prompts, snap_dir, n=9):
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
def test_snapshot_crosses_packages(tmp_path, writer):
    """A gemma3 Scheduler preempted after 9 tokens snapshots (the KV rows
    of every slot); the other package restores it and finishes: the tokens
    before plus after equal an uninterrupted JAX run."""
    jcfg, cfg, tree, model = _setup("gemma3-4b", True)
    prompts = _prompts(cfg.vocab, seed=4)
    jeng = jse.Engine(jcfg, tree, slots=2, max_len=MAX_LEN)
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


# ------------------------------------------------------------ the launchers
@pytest.mark.parametrize("extra", [[], ["--engine", "--slots", "2"],
                                   ["--mixer", "fd"]],
                         ids=["lockstep", "engine", "fd"])
@pytest.mark.parametrize("arch", ARCHS)
def test_serve_main_runs_on_cpu(arch, extra, capsys):
    args = ["--arch", arch, "--smoke", "--device", "cpu", "--batch", "2",
            "--prompt-len", "5", "--gen-len", "4"]
    assert serve.main(args + extra) == 0
    out = capsys.readouterr().out
    assert ("engine(2 slots, greedy) generated 8 tokens" if extra[:1] ==
            ["--engine"] else "generated 8 tokens") in out


@pytest.mark.parametrize("mixer", ["", "fd", "ski", "tno"])
def test_train_main_runs_on_cpu(mixer, capsys):
    """``launch.train --arch gemma3-4b --smoke --device cpu``, also with
    each paper mixer in place of its attention (bf16 activations, fp32
    mixer leaves)."""
    args = ["--arch", "gemma3-4b", "--smoke", "--device", "cpu", "--steps",
            "2", "--seq-len", "16", "--global-batch", "2"]
    assert train.main(args + (["--mixer", mixer] if mixer else [])) == 0
    assert "[train] 2 steps" in capsys.readouterr().out
