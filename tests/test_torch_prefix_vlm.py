"""Port parity for the prefix-VLM kind (``paligemma-3b``, smoke config: 2
layers, d = 128, 4 heads / 1 kv head × 32, 8 stub patches) against the
JAX package, with the JAX parameters carried over by
``bridge.params_from_jax`` and the same seeded numpy inputs (token ids and
the stub patch embeddings ``patches``), plain and with the paper's ``tno``
and ``ski`` mixers, which the prefix mask runs bidirectionally. Mirrors
tests/test_models.py for this kind. REPRO_FD_STREAM_C=4 is set for both
packages.

Tolerances, each with its reason:
* fp32 (``dtype`` and ``param_dtype`` float32): logits, the eval loss and
  every gradient against ``jax.grad`` within 1e-5 of the largest
  magnitude (matmul, softmax and FFT sums in another order); decode
  logits against the port's forward within 1e-5 of their scale;
* bf16 (the config's own dtype): logits and loss within 2e-2 of their
  scale, the bf16 tier (the two packages round to bf16 at other places);
* greedy decode of the text alone: token-exact against JAX's
  ``generate`` at the same max_len (fp32).
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
from repro.launch import serve as jserve  # noqa: E402
from repro.launch.steps import StepBuilder  # noqa: E402
from repro.models.context import Ctx  # noqa: E402
from repro.models.transformer import forward as jforward  # noqa: E402
from repro.models.transformer import init_model as jinit_model  # noqa: E402
from repro.models.transformer import loss_fn as jloss_fn  # noqa: E402
from repro.nn.params import unbox  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config, reduce_for_smoke  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch.steps import loss_and_grads  # noqa: E402
from repro_torch.models import serving  # noqa: E402
from repro_torch.models.transformer import (  # noqa: E402
    Model, forward, init_model, loss_fn)

torch.set_num_threads(1)
ARCH = "paligemma-3b"
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


def _cfgs(fp32=True, mixer="", **kw):
    kw = dict(FP32 if fp32 else {}, **kw)
    return (dataclasses.replace(jreduce(jget_config(ARCH), **kw),
                                mixer_override=mixer),
            dataclasses.replace(reduce_for_smoke(get_config(ARCH), **kw),
                                mixer_override=mixer))


@functools.lru_cache(maxsize=None)
def _setup(fp32=True, mixer=""):
    """(JAX cfg, port cfg, JAX params as numpy, bridged port model)."""
    jcfg, cfg = _cfgs(fp32, mixer)
    init = jax.jit(lambda k: unbox(jinit_model(k, jcfg))[0])
    tree = jax.tree.map(np.asarray, init(jax.random.PRNGKey(0)))
    return jcfg, cfg, tree, bridge.params_from_jax(tree, cfg, device="cpu")


def _batch(cfg, b=2, s=24, seed=3) -> dict:
    """Token ids, next-token labels and stub patches (numpy)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (b, s + 1))
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:],
            "patches": rng.standard_normal((b, cfg.n_prefix, cfg.d_model),
                                           dtype=np.float32)}


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tbatch(batch):
    return {k: torch.from_numpy(v).long() if v.dtype.kind == "i"
            else torch.from_numpy(v) for k, v in batch.items()}


# ----------------------------------------------------------------- configs
def test_full_width_counts():
    """paligemma-3b at full width (on ``meta``): 18 layers, MQA (8 heads,
    1 kv head × 256), vocab 257,216 padded to 257,280, 256 patches;
    3,035,703,296 parameters, ``param_count()``'s 3,035,627,520 and the
    37 norm scales."""
    cfg = get_config(ARCH)
    assert (cfg.kind, cfg.n_prefix, cfg.vocab_padded) == ("prefix_vlm", 256,
                                                          257280)
    assert cfg.param_count()["total"] == 3_035_627_520
    model = Model(cfg, device="meta")
    assert sum(p.numel() for p in model.parameters()) == \
        3_035_627_520 + 37 * 2048
    assert model.layers[0].mixer.wk.shape == (2048, 256)


# ------------------------------------------------------- forward and loss
@pytest.mark.parametrize("mixer", ["", "tno", "ski"])
@pytest.mark.parametrize("fp32", [True, False], ids=["fp32", "bf16"])
def test_logits_and_loss_match_jax(fp32, mixer):
    """Logits over the text (the prefix stripped) and the eval loss over
    the text alone against JAX's, [patches, tokens] under the prefix
    mask."""
    jcfg, cfg, tree, model = _setup(fp32, mixer)
    batch = _batch(cfg, s=40)
    want, _ = jforward(tree, jcfg, Ctx(), _jbatch(batch))
    jl, _ = jloss_fn(tree, jcfg, Ctx(), _jbatch(batch))
    tb = _tbatch(batch)
    with torch.no_grad():
        got = forward(model, cfg, tb["tokens"], patches=tb["patches"])
        loss, _ = loss_fn(model, cfg, tb)
    assert got.shape == (2, 40, cfg.vocab_padded)
    assert got.dtype == getattr(torch, cfg.dtype)
    tol = TOL if fp32 else BF16_TOL
    assert _rel(got, want) <= tol
    assert abs(loss.item() - float(jl)) <= tol * abs(float(jl))


@pytest.mark.parametrize("mixer", ["", "tno", "ski"])
def test_grads_match_jax(mixer):
    """Every parameter's gradient of the training loss against
    ``jax.grad`` (fp32; 8 + 56 = 64 positions, two smoke q-chunks)."""
    jcfg, cfg, tree, model = _setup(True, mixer)
    batch = _batch(cfg, s=56, seed=4)
    jg = jax.grad(lambda p: jloss_fn(p, jcfg, Ctx(), _jbatch(batch))[0])(
        jax.tree.map(jnp.asarray, tree))
    want = bridge._port_leaves(jax.tree.map(np.asarray, jg), cfg)
    _, _, grads = loss_and_grads(model, cfg, _tbatch(batch))
    assert set(grads) == set(want)
    for k, g in grads.items():
        assert _rel(g, want[k]) <= TOL, k


def test_the_prefix_mask_makes_tno_mixers_bidirectional():
    """Under the prefix mask a text position sees the later text through a
    TNO mixer (JAX's ``causal = mask_kind in ("causal", "local")``), and
    through attention it does not (only the prefix is bidirectional)."""
    for mixer, sees_later in (("", False), ("tno", True), ("ski", True)):
        _, cfg, _, model = _setup(True, mixer)
        tb = _tbatch(_batch(cfg, s=16))
        later = tb["tokens"].clone()
        later[:, -1] = (later[:, -1] + 1) % cfg.vocab
        with torch.no_grad():
            a = forward(model, cfg, tb["tokens"], patches=tb["patches"])
            b = forward(model, cfg, later, patches=tb["patches"])
        assert (not torch.equal(a[:, 0], b[:, 0])) == sees_later, mixer
        assert not torch.equal(a[:, -1], b[:, -1])


# ------------------------------------------------------------------ decode
@pytest.mark.parametrize("mixer", ["", "tno"])
def test_generate_text_alone_is_token_exact_vs_jax(mixer):
    """Greedy ``generate`` serves the text alone, as JAX's ``generate``
    does (its decode never sees the patches): token-exact (fp32, the same
    max_len), MQA KV caches or, for ``tno``, the hist-replay caches."""
    jcfg, cfg, tree, model = _setup(True, mixer)
    prompt = np.random.default_rng(5).integers(0, cfg.vocab, (3, 7))
    want = jserve.generate(StepBuilder(jcfg), tree,
                           jnp.asarray(prompt, jnp.int32), 8, max_len=16)
    with torch.inference_mode():
        got = serve.generate(model, cfg, torch.from_numpy(prompt), 8,
                             max_len=16)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_decode_matches_the_forward_with_the_prefix_cut_to_0():
    """The text-only decode reproduces the forward at ``n_prefix = 0`` (no
    patches) position by position, and not the forward with the patches
    in front: JAX's decode ignores them, and so does the port's."""
    _, cfg, _, model = _setup()
    cfg0 = dataclasses.replace(cfg, n_prefix=0)
    tb = _tbatch(_batch(cfg, s=12))
    toks = tb["tokens"]
    with torch.no_grad():
        text = forward(model, cfg0, toks,
                       patches=torch.zeros(2, 0, cfg.d_model))
        prefixed = forward(model, cfg, toks, patches=tb["patches"])
        cache = serving.init_cache(cfg, 2, 12, params=model)
        assert all(lc["k"].shape == (2, 12, 1, cfg.head_dim) for lc in cache)
        got = []
        for t in range(12):
            lg, cache = serving.decode_step(model, cfg, toks[:, t:t + 1],
                                            cache, t)
            got.append(lg[:, 0])
    got = torch.stack(got, 1)
    assert _rel(got, text) <= TOL
    assert _rel(got, prefixed) > 1e-2


@pytest.mark.parametrize("extra", [[], ["--mixer", "tno"]],
                         ids=["plain", "tno"])
def test_serve_main_runs_on_cpu(extra, capsys):
    args = ["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "2",
            "--prompt-len", "5", "--gen-len", "4"]
    assert serve.main(args + extra) == 0
    assert "generated 8 tokens in" in capsys.readouterr().out


# --------------------------------------------------------------- refusals
def test_fd_is_refused_in_both_packages():
    """JAX builds the FD layers causal and runs them bidirectionally under
    the prefix mask: its forward fails on the spectrum's shapes. The port
    refuses the model outright (``Model``, ``init_model``, the
    launcher)."""
    jcfg, cfg = _cfgs(True, "fd")
    tree = unbox(jinit_model(jax.random.PRNGKey(0), jcfg))[0]
    with pytest.raises(TypeError, match="incompatible shapes"):
        jforward(tree, jcfg, Ctx(), _jbatch(_batch(cfg, s=8)))
    for build in (lambda: Model(cfg, device="meta"),
                  lambda: init_model(cfg, torch.Generator(), device="cpu"),
                  lambda: serve.main(["--arch", ARCH, "--smoke", "--device",
                                      "cpu", "--mixer", "fd"])):
        with pytest.raises(NotImplementedError, match="prefix_vlm with an "
                                                      "fd mixer"):
            build()


def test_refusals():
    """A forward without ``patches`` and the serving engine (as JAX's)
    raise; chunked prefill is not offered."""
    from repro_torch.serving_engine import Engine
    _, cfg, _, model = _setup()
    toks = torch.zeros(1, 4, dtype=torch.long)
    with pytest.raises(ValueError, match="needs patches"):
        forward(model, cfg, toks)
    with pytest.raises(NotImplementedError, match="decoder archs"):
        Engine(cfg, model, slots=2, max_len=8)
    cache = serving.init_cache(cfg, 1, 8, params=model)
    assert not serving.supports_chunked_prefill(cfg, cache)
