"""Port parity for FD streaming serving (repro_torch.models.serving,
repro_torch.kernels.fd_stream, repro_torch.launch.serve) against the JAX
package, with REPRO_FD_STREAM_C=4 set for both so short sequences cross
several overlap-save blocks.

Tolerances, each with its reason:
* cache kernel leaves (khead, khs_*, kseg_*): 1e-5 of their scale, fp32
  FFT summation order (torch vs XLA);
* decode_step loop vs the port's own forward: rtol = atol = 2e-2, the tier
  of tests/test_serving.py (overlap-save vs one long FFT reorder the sums);
* greedy generate vs JAX generate at the same max_len: token-exact.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduce_for_smoke as jreduce  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.launch.steps import StepBuilder  # noqa: E402
from repro.models import serving as jserving  # noqa: E402
from repro.models.transformer import init_model as jinit_model  # noqa: E402
from repro.nn.params import unbox  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config, reduce_for_smoke  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import serving  # noqa: E402
from repro_torch.models.transformer import forward  # noqa: E402

torch.set_num_threads(1)
ARCH = "fd-tnn-lm-wt103"


@pytest.fixture(scope="module")
def models():
    jcfg = jreduce(jget_config(ARCH))
    cfg = reduce_for_smoke(get_config(ARCH))
    init = jax.jit(lambda k: unbox(jinit_model(k, jcfg))[0])
    jparams = init(jax.random.PRNGKey(0))
    model = bridge.params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                                   device="cpu")
    return jcfg, cfg, jparams, model


@pytest.fixture(autouse=True)
def _block_size(monkeypatch):
    monkeypatch.setenv("REPRO_FD_STREAM_C", "4")


def _toks(b, s, vocab, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, (b, s))


def test_init_cache_kernel_leaves_match_jax(models):
    jcfg, cfg, jparams, model = models
    b, max_len = 2, 14
    jcache = jserving.init_cache(jcfg, b, max_len, params=jparams)
    with torch.no_grad():
        cache = serving.init_cache(cfg, b, max_len, params=model)
    assert serving.stream_block_of(cache) == 4 and len(cache) == cfg.n_layers
    for leaf in ("khead", "khs_re", "khs_im", "kseg_re", "kseg_im"):
        want = np.asarray(jcache["blocks"]["sub0"][leaf])    # (layers, ...)
        got = np.stack([lc[leaf].numpy() for lc in cache])
        assert got.shape == want.shape, leaf
        scale = max(float(np.abs(want).max()), 1e-6)
        assert float(np.abs(got - want).max()) <= 1e-5 * scale, leaf
    for leaf in ("ring", "tail", "uspec_re", "uspec_im", "cap"):
        assert (np.stack([lc[leaf].numpy() for lc in cache]).shape
                == jcache["blocks"]["sub0"][leaf].shape), leaf


def test_decode_steps_reproduce_forward(models):
    """Token-by-token decode across several C-blocks plus a partial block
    (C=4, s=11) reproduces the one-shot forward, position by position."""
    _, cfg, _, model = models
    toks = torch.from_numpy(_toks(2, 11, cfg.vocab))
    with torch.no_grad():
        want = forward(model, cfg, toks)
        cache = serving.init_cache(cfg, 2, 11, params=model)
        got = []
        for t in range(11):
            logits, cache = serving.decode_step(model, cfg, toks[:, t:t + 1],
                                                cache, t)
            got.append(logits[:, 0])
    np.testing.assert_allclose(torch.stack(got, 1).numpy(), want.numpy(),
                               rtol=2e-2, atol=2e-2)


def test_decode_chunk_equals_steps(models):
    """One chunked-prefill block leaves the same cache and last logits as C
    decode steps (fp32 summation order only)."""
    _, cfg, _, model = models
    toks = torch.from_numpy(_toks(2, 8, cfg.vocab, seed=2))
    with torch.no_grad():
        c0 = serving.init_cache(cfg, 2, 8, params=model)
        lc, cc = serving.decode_chunk(model, cfg, toks[:, :4], c0, 0)
        cs = c0
        for t in range(4):
            ls, cs = serving.decode_step(model, cfg, toks[:, t:t + 1], cs, t)
    np.testing.assert_allclose(lc[:, -1].numpy(), ls[:, 0].numpy(),
                               rtol=1e-4, atol=1e-4)
    for a, b in zip(cc, cs):
        for leaf in ("ring", "tail", "uspec_re", "uspec_im"):
            np.testing.assert_allclose(a[leaf].numpy(), b[leaf].numpy(),
                                       rtol=1e-4, atol=1e-4, err_msg=leaf)


@pytest.mark.parametrize("p,gen", [(6, 7), (9, 4)])
def test_generate_is_token_exact_vs_jax(models, p, gen):
    """Prompt lengths not multiples of C=4 (chunked prefill plus a
    teacher-forced remainder), generation crossing block boundaries, the
    same max_len for both packages."""
    jcfg, cfg, jparams, model = models
    max_len = 16
    prompt = _toks(3, p, cfg.vocab, seed=p)
    want = jserve.generate(StepBuilder(jcfg), jparams,
                           jnp.asarray(prompt, jnp.int32), gen,
                           max_len=max_len)
    with torch.inference_mode():
        got = serve.generate(model, cfg, torch.from_numpy(prompt), gen,
                             max_len=max_len)
        tok_by_tok = serve.generate(model, cfg, torch.from_numpy(prompt), gen,
                                    max_len=max_len, chunked_prefill=False)
    assert got.shape == (3, p + gen)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(tok_by_tok.numpy(), got.numpy())


def test_unported_paths_raise(models, monkeypatch):
    """The FD fallbacks that once raised take the hist-replay cache: a
    params-less ``init_cache`` (``hist`` alone) and ``REPRO_FD_STREAM=0``
    (``hist`` and the memoised ``kcoef``); SKI decode still raises."""
    import dataclasses
    _, cfg, _, model = models
    bare = serving.init_cache(cfg, 1, 8)
    assert all(set(lc) == {"hist"} and lc["hist"].shape == (1, 8, 128)
               for lc in bare)
    monkeypatch.setenv("REPRO_FD_STREAM", "0")
    with torch.no_grad():
        hist = serving.init_cache(cfg, 1, 8, params=model)
    assert all(set(lc) == {"hist", "kcoef"} and lc["kcoef"].shape == (128, 8)
               for lc in hist)
    assert serving.cache_capacity(hist) == 8
    assert not serving.supports_chunked_prefill(cfg, hist)
    ski = dataclasses.replace(cfg, pattern=(("ski", "dense"),))
    with pytest.raises(NotImplementedError, match="Appendix B"):
        serving.init_cache(ski, 1, 8)


def test_serve_main_runs_on_cpu(capsys):
    assert serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                       "--batch", "2", "--prompt-len", "6",
                       "--gen-len", "5"]) == 0
    assert "generated 10 tokens" in capsys.readouterr().out
