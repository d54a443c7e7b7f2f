"""Port parity for GQA attention (``repro_torch.models.attention``: RoPE,
the four masks, the q-chunked softmax, the self-attention sublayer with and
without QKV bias, and the KV-cache decode step) against the JAX package
(``repro/models/attention.py``) on the same seeded numpy inputs and
parameters.

Tolerances, each with its reason:
* masks: exact (booleans);
* RoPE, the chunked softmax, ``attn_apply`` and ``attn_decode`` in fp32:
  1e-5 of the largest magnitude (fp32 sin/cos, exp and matmul sums in
  another order); in bf16 2e-2 of it (the bf16 tier: the projections and
  the output round to bf16 in both packages);
* chunked against unchunked attention, and GQA against MHA with the kv
  weights tiled: 1e-6 (the same sums, over other batch shapes);
* ``attn_decode`` with a scalar position against per-row positions all
  equal to it: bitwise (the scalar case is the per-row case broadcast).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduce_for_smoke as jreduce  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models.context import Ctx  # noqa: E402
from repro.nn.params import unbox  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config, reduce_for_smoke  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402

torch.set_num_threads(1)
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _rel(got, want) -> float:
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-30)


def _x(*shape, seed=1, dtype="float32"):
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return a, torch.from_numpy(a).to(getattr(torch, dtype))


def _cfgs(arch, dtype="float32", **kw):
    kw = dict(dtype=dtype, param_dtype=dtype, **kw)
    return jreduce(jget_config(arch), **kw), \
        reduce_for_smoke(get_config(arch), **kw)


def _layer(arch, dtype="float32", seed=0, **kw):
    """(JAX cfg, JAX params, port cfg, port module) of one attention
    sublayer holding the same values; the QKV biases (zeros at init) are
    drawn so that they matter."""
    jcfg, cfg = _cfgs(arch, dtype, **kw)
    jp, _ = unbox(jattn.attn_init(jax.random.PRNGKey(seed), jcfg))
    jp = jax.tree.map(np.asarray, jp)
    rng = np.random.default_rng(seed + 7)
    for name in ("bq", "bk", "bv"):
        if name in jp:
            jp[name] = (0.1 * rng.standard_normal(jp[name].shape)).astype(
                jp[name].dtype)
    params = attn.attn_init(cfg)
    with torch.no_grad():
        for k, p in params.named_parameters():
            p.copy_(bridge._as_torch(jp[k]))
    return jcfg, jp, cfg, params


# ------------------------------------------------------------------- RoPE
@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
@pytest.mark.parametrize("per_row", [False, True], ids=["shared", "per-row"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rope_matches_jax(dtype, per_row, theta):
    xa, xt = _x(2, 9, 3, 16, dtype=dtype)
    if per_row:
        pos = np.array([[0, 1, 2, 3, 4, 5, 6, 7, 8],
                        [1000, 1001, 3, 7, 1023, 1024, 1151, 0, 5]])
    else:
        pos = np.arange(1000, 1009)
    want = jattn.rope(jnp.asarray(xa, getattr(jnp, dtype)), jnp.asarray(pos),
                      theta)
    got = attn.rope(xt, torch.from_numpy(pos), theta)
    assert got.dtype == xt.dtype and got.shape == xt.shape
    assert _rel(got, want) <= TOL[dtype]


# ---------------------------------------------------------------- masking
@pytest.mark.parametrize("kind", ["causal", "local", "prefix", "full"])
def test_mask_for_matches_jax(kind):
    q, k = np.arange(3, 15), np.arange(16)
    want = jattn.mask_for(kind, jnp.asarray(q), jnp.asarray(k), window=4,
                          prefix=5)
    got = attn.mask_for(kind, torch.from_numpy(q), torch.from_numpy(k),
                        window=4, prefix=5)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_sliding_window_masks_far_tokens():
    """Mirrors tests/test_models.py::test_sliding_window_masks_far_tokens."""
    m = attn.mask_for("local", torch.arange(16), torch.arange(16), window=4)
    assert m[10, 10] and m[10, 7] and not m[10, 6] and not m[5, 9]


def test_prefix_mask_bidirectional_over_prefix():
    """Mirrors tests/test_models.py::
    test_prefix_mask_bidirectional_over_prefix."""
    m = attn.mask_for("prefix", torch.arange(8), torch.arange(8), prefix=3)
    assert m[0, 2]
    assert m[5, 3] and not m[3, 5]


def test_mask_for_refuses_unknown_kind():
    with pytest.raises(ValueError, match="diagonal"):
        attn.mask_for("diagonal", torch.arange(3), torch.arange(3))


# --------------------------------------------------------- the core softmax
@pytest.mark.parametrize("kind", ["causal", "local", "prefix", "full"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_matches_jax(dtype, kind):
    """q (2, 24, 4, 16) against k, v of 2 kv heads (GQA), in 3 q-chunks of
    8, every mask kind, at a query offset."""
    qa, qt = _x(2, 24, 4, 16, seed=1, dtype=dtype)
    ka, kt = _x(2, 24, 2, 16, seed=2, dtype=dtype)
    va, vt = _x(2, 24, 2, 16, seed=3, dtype=dtype)
    jd = getattr(jnp, dtype)
    kw = dict(mask_kind=kind, window=5, prefix=6, chunk=8)
    want = jattn.attention(jnp.asarray(qa, jd), jnp.asarray(ka, jd),
                           jnp.asarray(va, jd), **kw)
    got = attn.attention(qt, kt, vt, **kw)
    assert got.dtype == qt.dtype
    assert _rel(got, want) <= TOL[dtype]


@pytest.mark.parametrize("kind", ["causal", "local"])
def test_attention_chunked_matches_unchunked(kind):
    """Chunks of 8 and of 4 give the single chunk's values, and so do the
    gradients through the checkpointed chunks."""
    qa, _ = _x(2, 32, 4, 16, seed=4)
    ka, _ = _x(2, 32, 2, 16, seed=5)
    va, _ = _x(2, 32, 2, 16, seed=6)
    outs, grads = [], []
    for chunk in (32, 8, 4, 12):      # 12 does not divide 32: one chunk
        q, k, v = (torch.from_numpy(a).requires_grad_() for a in (qa, ka, va))
        y = attn.attention(q, k, v, mask_kind=kind, window=6, chunk=chunk)
        (y * torch.arange(y.numel()).reshape(y.shape).sin()).sum().backward()
        outs.append(y.detach())
        grads.append([t.grad for t in (q, k, v)])
    for y, g in zip(outs[1:], grads[1:]):
        assert _rel(y, outs[0].numpy()) <= 1e-6
        for a, b in zip(g, grads[0]):
            assert _rel(a, b.numpy()) <= 1e-6


def test_gqa_matches_mha_with_tiled_kv():
    """Mirrors tests/test_models.py::test_gqa_vs_mha_equivalence: GQA with
    kv repeated equals MHA whose kv weights (and biases) are tiled."""
    jcfg, jp, cfg, params = _layer("qwen2-72b", n_heads=4, n_kv_heads=2,
                                   head_dim=16)
    _, x = _x(2, 16, cfg.d_model)
    y = attn.attn_apply(params, cfg, x)
    mha = dataclasses.replace(cfg, n_kv_heads=4)
    tiled = attn.attn_init(mha)
    hd = cfg.head_dim
    with torch.no_grad():
        for name, p in tiled.named_parameters():
            src = getattr(params, name)
            if name in ("wk", "wv"):
                src = src.reshape(cfg.d_model, 2, hd).repeat_interleave(
                    2, dim=1).reshape(cfg.d_model, 4 * hd)
            elif name in ("bk", "bv"):
                src = src.reshape(2, hd).repeat_interleave(2, 0).reshape(-1)
            p.copy_(src)
        y2 = attn.attn_apply(tiled, mha, x)
    assert _rel(y.detach(), y2.numpy()) <= 1e-6


# ------------------------------------------------------------ the sublayer
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch,kind", [("qwen2-72b", "causal"),
                                       ("phi3-medium-14b", "causal"),
                                       ("gemma3-4b", "local"),
                                       ("stablelm-3b", "prefix")],
                         ids=["bias", "no-bias", "local", "mha-prefix"])
def test_attn_apply_matches_jax(arch, kind, dtype):
    """The sublayer with QKV bias (qwen2) and without, GQA and MHA, in
    q-chunks (the smoke attn_chunk is 32: s = 64 takes two)."""
    jcfg, jp, cfg, params = _layer(arch, dtype)
    assert ("bq" in jp) == cfg.qkv_bias == (params.bq is not None)
    xa, xt = _x(2, 64, cfg.d_model, dtype=dtype)
    want = jattn.attn_apply(jp, jcfg, Ctx(), jnp.asarray(
        xa, getattr(jnp, dtype)), mask_kind=kind, prefix=5)
    with torch.no_grad():
        got = attn.attn_apply(params, cfg, xt, mask_kind=kind, prefix=5)
    assert got.dtype == xt.dtype
    assert _rel(got, want) <= TOL[dtype]


def test_attn_apply_grads_match_jax():
    """Every parameter's and the input's gradient through the chunked
    sublayer against ``jax.grad`` (fp32)."""
    jcfg, jp, cfg, params = _layer("qwen2-72b")
    xa, _ = _x(2, 64, cfg.d_model)
    cot, _ = _x(2, 64, cfg.d_model, seed=9)
    jgx, jgp = jax.grad(lambda x, p: jnp.sum(jattn.attn_apply(
        p, jcfg, Ctx(), x) * cot), argnums=(0, 1))(
            jnp.asarray(xa), jax.tree.map(jnp.asarray, jp))
    x = torch.from_numpy(xa).requires_grad_()
    (attn.attn_apply(params, cfg, x) * torch.from_numpy(cot)).sum().backward()
    assert _rel(x.grad, jgx) <= 1e-5
    for k, p in params.named_parameters():
        assert _rel(p.grad, jgp[k]) <= 1e-5, k


def test_cross_attention_refused():
    """Cross-attention, once refused, runs (the encoder-decoder kind): q
    from x, k and v from a source of another length, no RoPE, the full
    mask, against JAX's ``attn_apply`` with ``kv_src`` (fp32, 1e-5; GQA
    here, whisper's MHA in test_torch_encdec.py)."""
    jcfg, jp, cfg, params = _layer("qwen2-72b")
    xa, _ = _x(2, 40, cfg.d_model)
    src, _ = _x(2, 9, cfg.d_model, seed=11)
    want = jattn.attn_apply(jp, jcfg, Ctx(), jnp.asarray(xa),
                            mask_kind="full", kv_src=jnp.asarray(src))
    with torch.no_grad():
        got = attn.attn_apply(params, cfg, torch.from_numpy(xa),
                              mask_kind="full", kv_src=torch.from_numpy(src))
    assert got.shape == (2, 40, cfg.d_model)
    assert _rel(got, want) <= 1e-5


# -------------------------------------------------------------- decode path
def _jax_cache(cache):
    return {k: jnp.asarray(v.float().numpy()).astype(jnp.bfloat16)
            if v.dtype == torch.bfloat16 else jnp.asarray(v.numpy())
            for k, v in cache.items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch,kind", [("qwen2-72b", "causal"),
                                       ("gemma3-4b", "local")])
def test_attn_decode_matches_jax(arch, kind, dtype):
    """Eleven steps at per-row positions (row 1 three behind row 0) over a
    cache of 12, past the smoke window of 8: y and the cache leaves."""
    jcfg, jp, cfg, params = _layer(arch, dtype)
    tdt = getattr(torch, dtype)
    cache = attn.decode_cache_init(cfg, 2, 12, tdt)
    jcache = jattn.decode_cache_init(jcfg, 2, 12, getattr(jnp, dtype))
    assert cache["k"].shape == tuple(jcache["k"].shape) == (2, 12, 2, 32)
    for t in range(11):
        xa, xt = _x(2, 1, cfg.d_model, seed=t, dtype=dtype)
        cur = np.array([t, max(t - 3, 0)])
        want, jcache = jattn.attn_decode(
            jp, jcfg, Ctx(), jnp.asarray(xa, getattr(jnp, dtype)), jcache,
            jnp.asarray(cur), mask_kind=kind, window=cfg.window)
        with torch.no_grad():
            got, cache = attn.attn_decode(params, cfg, xt, cache,
                                          torch.from_numpy(cur),
                                          mask_kind=kind, window=cfg.window)
        assert got.dtype == tdt
        assert _rel(got, want) <= TOL[dtype], t
    for leaf in ("k", "v"):
        assert cache[leaf].dtype == tdt
        assert _rel(cache[leaf], jcache[leaf]) <= TOL[dtype]


@pytest.mark.parametrize("kind", ["causal", "local"])
def test_attn_decode_scalar_equals_per_row_bitwise(kind):
    """Through ``serving.decode_step`` of the smoke gemma3 model (local and
    global layers): an int position and per-row positions all equal to it
    give the same logits and caches, bit for bit."""
    from repro_torch.models import serving
    from repro_torch.models.transformer import init_model
    cfg = reduce_for_smoke(get_config("gemma3-4b"))
    if kind == "causal":
        cfg = dataclasses.replace(cfg, pattern=(("attention", "dense"),),
                                  n_layers=2)
    model = init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (3, 11)))
    runs = []
    with torch.no_grad():
        for per_row in (False, True):
            cache = serving.init_cache(cfg, 3, 12, params=model)
            logits = []
            for t in range(11):
                pos = [t] * 3 if per_row else t
                lg, cache = serving.decode_step(model, cfg, toks[:, t:t + 1],
                                                cache, pos)
                logits.append(lg)
            runs.append((torch.cat(logits, 1), cache))
    (la, ca), (lb, cb) = runs
    assert torch.equal(la, lb)
    for a, b in zip(ca, cb):
        assert a.keys() == b.keys() == {"k", "v"}
        assert all(torch.equal(a[k], b[k]) for k in a)
