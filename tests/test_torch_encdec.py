"""Port parity for the encoder-decoder kind (``whisper-medium``, smoke
config: 2 encoder and 2 decoder layers, d = 128, 4 heads × 32) against the
JAX package, with the JAX parameters carried over by
``bridge.params_from_jax`` and the same seeded numpy inputs (token ids and
the stub encoder frames ``enc_embed``). Mirrors tests/test_models.py for
this kind. REPRO_FD_STREAM_C=4 is set for both packages.

Tolerances, each with its reason:
* fp32 (``dtype`` and ``param_dtype`` float32): cross-attention, logits,
  the eval loss, ``encode`` and every gradient against ``jax.grad``
  within 1e-5 of the largest magnitude (matmul, softmax and FFT sums in
  another order); decode logits against the port's forward within 1e-5
  of their scale;
* bf16 (the config's own dtype): cross-attention, logits and loss within
  2e-2 of their scale, the bf16 tier (the two packages round to bf16 at
  other places);
* greedy decode: token-exact against a JAX greedy loop of ``encode`` and
  ``decode_step`` with ``enc_out`` at the same max_len (fp32; JAX's own
  ``generate`` passes no ``enc_out``, see ROADMAP);
* the bridge's round trip: bitwise.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduce_for_smoke as jreduce  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import serving as jserving  # noqa: E402
from repro.models.context import Ctx  # noqa: E402
from repro.models.transformer import forward as jforward  # noqa: E402
from repro.models.transformer import init_model as jinit_model  # noqa: E402
from repro.models.transformer import loss_fn as jloss_fn  # noqa: E402
from repro.nn.params import unbox  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config, reduce_for_smoke  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch.steps import loss_and_grads, make_forward  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import serving  # noqa: E402
from repro_torch.models.transformer import (  # noqa: E402
    Model, forward, init_model, loss_fn)

torch.set_num_threads(1)
ARCH = "whisper-medium"
FP32 = {"dtype": "float32", "param_dtype": "float32"}
TOL, BF16_TOL = 1e-5, 2e-2


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
def _setup(fp32=True, mixer=""):
    """(JAX cfg, port cfg, JAX params as numpy, bridged port model)."""
    kw = FP32 if fp32 else {}
    jcfg = dataclasses.replace(jreduce(jget_config(ARCH), **kw),
                               mixer_override=mixer)
    cfg = dataclasses.replace(reduce_for_smoke(get_config(ARCH), **kw),
                              mixer_override=mixer)
    init = jax.jit(lambda k: unbox(jinit_model(k, jcfg))[0])
    tree = jax.tree.map(np.asarray, init(jax.random.PRNGKey(0)))
    return jcfg, cfg, tree, bridge.params_from_jax(tree, cfg, device="cpu")


def _batch(cfg, b=2, s=24, s_enc=20, seed=3) -> dict:
    """Token ids, next-token labels and stub encoder frames (numpy)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (b, s + 1))
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:],
            "enc_embed": rng.standard_normal((b, s_enc, cfg.d_model),
                                             dtype=np.float32)}


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tbatch(batch):
    return {k: torch.from_numpy(v).long() if v.dtype.kind == "i"
            else torch.from_numpy(v) for k, v in batch.items()}


# ----------------------------------------------------------------- configs
def test_full_width_counts():
    """whisper-medium at full width (on ``meta``): 24 + 24 layers, d 1024,
    vocab 51,865 padded to 51,968; 1,012,525,056 parameters, of which
    ``param_count()`` counts 509,083,648: like JAX's, it leaves out the
    encoder and the cross-attention (and the norm scales)."""
    cfg = get_config(ARCH)
    model = Model(cfg, device="meta")
    assert (cfg.kind, cfg.enc_layers, cfg.vocab_padded) == ("encdec", 24,
                                                            51968)
    assert cfg.param_count()["total"] == 509_083_648
    n = {part: sum(p.numel() for k, p in model.named_parameters()
                   if k.startswith(part))
         for part in ("enc_", "layers.", "embed", "unembed")}
    assert n == {"enc_": 402_703_360, "layers.": 503_390_208,
                 "embed": 53_215_232, "unembed": 53_215_232}
    assert sum(p.numel() for p in model.parameters()) == 1_012_525_056
    assert all(p.dtype == torch.bfloat16 for k, p in model.named_parameters()
               if not k.endswith(".scale"))


def test_init_model_matches_jax_layout():
    """The port's own init builds every JAX leaf (the encoder's stack
    unrolled) with its shape and dtype."""
    _, cfg, tree, _ = _setup(fp32=False)
    got = init_model(cfg, torch.Generator().manual_seed(0),
                     device="cpu").state_dict()
    want = bridge._port_leaves(tree, cfg)
    assert set(got) == set(want)
    assert {"enc_layers.1.mixer.wq", "enc_norm_f.scale",
            "layers.0.norm_x.scale", "layers.1.cross.wo"} <= set(got)
    for name, arr in want.items():
        assert tuple(got[name].shape) == arr.shape, name
        assert got[name].dtype == bridge._as_torch(arr).dtype, name


def test_bridge_round_trips_the_encoder():
    """``enc_blocks`` (leading axis enc_layers), ``enc_norm_f`` and the
    decoder layers' ``norm_x`` and ``cross`` leaves come over and go back
    bitwise; the optimizer state's moments and 0-d error-feedback leaves
    through ``opt_from_jax``/``opt_to_jax`` too."""
    _, cfg, tree, model = _setup()
    assert tree["enc_blocks"]["mixer"]["wq"].shape[0] == cfg.enc_layers
    torch.testing.assert_close(
        model.enc_layers[1].mixer.wk,
        torch.from_numpy(tree["enc_blocks"]["mixer"]["wk"][1].copy()),
        rtol=0, atol=0)
    back = dict(bridge._flatten(bridge.params_to_jax(model)))
    flat = dict(bridge._flatten(tree))
    assert back.keys() == flat.keys()
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k].numpy(), v, err_msg=k)
    jopt = jax.tree.map(np.asarray, jadamw.init(
        jadamw.OptConfig(), jax.tree.map(jnp.asarray, tree)))
    rng = np.random.default_rng(0)
    jopt = jopt._replace(mu=jax.tree.map(
        lambda a: rng.standard_normal(a.shape).astype(a.dtype), jopt.mu))
    opt = bridge.opt_from_jax(jopt, cfg, "cpu")
    state = bridge.train_state_to_jax(model, opt)
    path = jax.tree_util.tree_flatten_with_path
    got = {jax.tree_util.keystr(k): v for k, v in path(state["opt"])[0]}
    want = {jax.tree_util.keystr(k): v for k, v in path(jopt)[0]}
    assert got.keys() == want.keys() and ".err['enc_norm_f']['scale']" in got
    for k, v in want.items():
        np.testing.assert_array_equal(np.asarray(got[k]), v, err_msg=k)


# ----------------------------------------------------------- cross-attention
@pytest.mark.parametrize("fp32", [True, False], ids=["fp32", "bf16"])
def test_cross_attention_matches_jax(fp32):
    """Layer 0's cross sublayer alone: q from x (64 positions, two smoke
    q-chunks), k and v from a source of 40 positions, no RoPE on either
    side, the full mask."""
    jcfg, cfg, tree, model = _setup(fp32)
    dt = jnp.float32 if fp32 else jnp.bfloat16
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 64, cfg.d_model), dtype=np.float32)
    src = rng.standard_normal((2, 40, cfg.d_model), dtype=np.float32)
    jp = jax.tree.map(lambda a: jnp.asarray(a[0]),
                      tree["blocks"]["sub0"]["cross"])
    want = jattn.attn_apply(jp, jcfg, Ctx(), jnp.asarray(x).astype(dt),
                            mask_kind="full",
                            kv_src=jnp.asarray(src).astype(dt))
    tdt = getattr(torch, cfg.dtype)
    with torch.no_grad():
        got = attn.attn_apply(model.layers[0].cross, cfg,
                              torch.from_numpy(x).to(tdt), mask_kind="full",
                              kv_src=torch.from_numpy(src).to(tdt))
    assert got.shape == (2, 64, cfg.d_model) and got.dtype == tdt
    assert _rel(got, want) <= (TOL if fp32 else BF16_TOL)


def test_cross_attention_rotates_neither_side():
    """Moving the source's rows or the queries' positions changes nothing
    but the order: without RoPE a row's output depends on its own x and
    the source as a set."""
    _, cfg, _, model = _setup()
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.standard_normal((1, 6, cfg.d_model),
                                             dtype=np.float32))
    src = torch.from_numpy(rng.standard_normal((1, 9, cfg.d_model),
                                               dtype=np.float32))
    with torch.no_grad():
        y = attn.attn_apply(model.layers[0].cross, cfg, x, mask_kind="full",
                            kv_src=src)
        y_perm = attn.attn_apply(model.layers[0].cross, cfg, x.flip(1),
                                 mask_kind="full", kv_src=src.flip(1))
    torch.testing.assert_close(y_perm.flip(1), y, rtol=1e-5, atol=1e-6)


# ------------------------------------------------------- forward and loss
@pytest.mark.parametrize("mixer", ["", "fd"])
@pytest.mark.parametrize("fp32", [True, False], ids=["fp32", "bf16"])
def test_logits_and_loss_match_jax(fp32, mixer):
    """Logits through ``forward`` and ``make_forward`` and the eval loss
    against JAX's; ``--mixer fd`` replaces the decoder's attention mixers
    (the encoder stays attention, as in JAX)."""
    jcfg, cfg, tree, model = _setup(fp32, mixer)
    batch = _batch(cfg, s=40)
    want, _ = jforward(tree, jcfg, Ctx(), _jbatch(batch))
    jl, _ = jloss_fn(tree, jcfg, Ctx(), _jbatch(batch))
    tb = _tbatch(batch)
    with torch.no_grad():
        got = forward(model, cfg, tb["tokens"], enc_embed=tb["enc_embed"])
        loss, _ = loss_fn(model, cfg, tb)
    again = make_forward(cfg)(model, tb["tokens"], enc_embed=tb["enc_embed"])
    assert torch.equal(again, got)
    assert got.shape == (2, 40, cfg.vocab_padded)
    assert got.dtype == getattr(torch, cfg.dtype)
    tol = TOL if fp32 else BF16_TOL
    assert _rel(got, want) <= tol
    assert abs(loss.item() - float(jl)) <= tol * abs(float(jl))
    if mixer:
        assert all(type(layer.mixer).__name__ == "GTU"
                   for layer in model.layers)
        assert all(type(layer.mixer).__name__ == "Attention"
                   for layer in model.enc_layers)


@pytest.mark.parametrize("mixer", ["", "fd"])
def test_grads_match_jax(mixer):
    """Every parameter's gradient of the training loss (the encoder's and
    the cross sublayers' included) against ``jax.grad`` (fp32; s = 64 is
    two smoke q-chunks under ``torch.utils.checkpoint``)."""
    jcfg, cfg, tree, model = _setup(True, mixer)
    batch = _batch(cfg, s=64, s_enc=36, seed=4)
    jg = jax.grad(lambda p: jloss_fn(p, jcfg, Ctx(), _jbatch(batch))[0])(
        jax.tree.map(jnp.asarray, tree))
    want = bridge._port_leaves(jax.tree.map(np.asarray, jg), cfg)
    _, _, grads = loss_and_grads(model, cfg, _tbatch(batch))
    assert set(grads) == set(want)
    for k, g in grads.items():
        assert _rel(g, want[k]) <= TOL, k


# ------------------------------------------------------------------ decode
def test_encode_matches_jax():
    jcfg, cfg, tree, model = _setup()
    emb = _batch(cfg)["enc_embed"]
    want = jserving.encode(tree, jcfg, Ctx(), jnp.asarray(emb))
    with torch.no_grad():
        got = serving.encode(model, cfg, torch.from_numpy(emb))
    assert _rel(got, want) <= TOL


@pytest.mark.parametrize("mixer", ["", "fd"])
def test_decode_logits_match_forward(mixer):
    """``encode`` once, then ``decode_step`` token by token with
    ``enc_out`` over 14 positions reproduces the forward position by
    position (fp32), through KV caches or, with ``--mixer fd``, the FD
    stream caches."""
    _, cfg, _, model = _setup(True, mixer)
    batch = _tbatch(_batch(cfg, s=14))
    toks = batch["tokens"]
    with torch.no_grad():
        want = forward(model, cfg, toks, enc_embed=batch["enc_embed"])
        enc_out = serving.encode(model, cfg, batch["enc_embed"])
        cache = serving.init_cache(cfg, 2, 14, params=model)
        got = []
        for t in range(14):
            lg, cache = serving.decode_step(model, cfg, toks[:, t:t + 1],
                                            cache, t, enc_out=enc_out)
            got.append(lg[:, 0])
    assert _rel(torch.stack(got, 1), want) <= TOL


def _jax_greedy(jcfg, tree, prompt, enc_embed, gen: int, max_len: int):
    """JAX's encode, then a greedy loop of ``decode_step`` with
    ``enc_out``: the prompt teacher-forced token by token, each new token
    the argmax clamped to the vocab, as ``generate`` picks."""
    b, p = prompt.shape
    enc_out = jserving.encode(tree, jcfg, Ctx(), jnp.asarray(enc_embed))
    cache = jserving.init_cache(jcfg, b, max_len, params=tree)
    step = jax.jit(lambda c, t, pos: jserving.decode_step(
        tree, jcfg, Ctx(), {"tokens": t, "enc_out": enc_out}, c, pos))
    out = [np.asarray(prompt)]
    logits = None
    for pos in range(p + gen - 1):
        if pos < p:
            tok = jnp.asarray(prompt[:, pos:pos + 1], jnp.int32)
        else:
            tok = jnp.minimum(jnp.argmax(logits[:, -1], -1),
                              jcfg.vocab - 1).astype(jnp.int32)[:, None]
            out.append(np.asarray(tok))
        logits, cache = step(cache, tok, jnp.int32(pos))
    out.append(np.asarray(jnp.minimum(jnp.argmax(logits[:, -1], -1),
                                      jcfg.vocab - 1))[:, None])
    return np.concatenate(out, 1)


@pytest.mark.parametrize("mixer", ["", "fd"])
def test_generate_is_token_exact_vs_jax(mixer):
    """``launch.serve.generate`` with ``enc_out`` against JAX's encode +
    decode_step loop (fp32, the same max_len)."""
    jcfg, cfg, tree, model = _setup(True, mixer)
    batch = _batch(cfg, b=3, s=6, s_enc=18, seed=5)
    prompt = batch["tokens"]
    want = _jax_greedy(jcfg, tree, prompt, batch["enc_embed"], 9, 16)
    with torch.inference_mode():
        enc_out = serving.encode(model, cfg,
                                 torch.from_numpy(batch["enc_embed"]))
        got = serve.generate(model, cfg, torch.from_numpy(prompt), 9,
                             max_len=16, enc_out=enc_out)
    assert got.shape == (3, 15)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("extra", [[], ["--mixer", "fd"]],
                         ids=["plain", "fd"])
def test_serve_main_runs_on_cpu(extra, capsys):
    """The launcher draws the stub frames from --seed, encodes them once
    and feeds every step."""
    args = ["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "2",
            "--prompt-len", "5", "--gen-len", "4"]
    assert serve.main(args + extra) == 0
    assert "generated 8 tokens in" in capsys.readouterr().out


def test_enc_frames_follow_jax_shape_rule():
    """(batch, min(max_len, 4096), d) in the activation dtype, from the
    seed alone."""
    cfg = reduce_for_smoke(get_config(ARCH))
    a = serve.enc_frames(cfg, 2, 3, 9, "cpu")
    assert a.shape == (2, 9, cfg.d_model) and a.dtype == torch.bfloat16
    assert torch.equal(a, serve.enc_frames(cfg, 2, 3, 9, "cpu"))
    assert serve.enc_frames(cfg, 1, 0, 5000, "meta").shape[1] == 4096


# --------------------------------------------------------------- refusals
def test_refusals():
    """An encdec decode step without ``enc_out``, a forward or loss
    without ``enc_embed``, the serving engine (as JAX's), chunked prefill
    and an encdec config without encoder layers (JAX's init_model cannot
    build one) all raise; none falls back."""
    from repro_torch.serving_engine import Engine
    _, cfg, _, model = _setup()
    toks = torch.zeros(1, 1, dtype=torch.long)
    cache = serving.init_cache(cfg, 1, 4, params=model)
    with pytest.raises(ValueError, match="needs enc_out"):
        serving.decode_step(model, cfg, toks, cache, 0)
    with pytest.raises(ValueError, match="needs enc_embed"):
        forward(model, cfg, toks)
    with pytest.raises(ValueError, match="needs enc_embed"):
        loss_fn(model, cfg, {"tokens": toks, "labels": toks})
    with pytest.raises(NotImplementedError, match="decoder archs"):
        Engine(cfg, model, slots=2, max_len=8)
    assert not serving.supports_chunked_prefill(cfg, cache)
    with pytest.raises(ValueError, match="chunked_prefill=True"):
        serve.generate(model, cfg, toks, 2, chunked_prefill=True,
                       enc_out=torch.zeros(1, 3, cfg.d_model))
    with pytest.raises(ValueError, match="enc_layers >= 1"):
        Model(dataclasses.replace(cfg, enc_layers=0), device="meta")
