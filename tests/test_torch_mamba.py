"""Port parity for the Mamba-2 serving path (repro_torch.kernels.ssd_chunked,
ref.ssd_scan_ref, ssd_scan, the bf16 short conv, models.mamba, the
("mamba", "none") layer, serving caches and greedy generate) against the
JAX package, at smoke sizes.

Tolerances, each with its reason:
* the SSD oracle and the chunked scan against JAX's, fp32: 1e-5 × max|y|
  (fp32 sums in another order: einsum paths, cumsum, exp); bf16: 2e-2 ×
  max|y|, the repository's bf16 tier (the outputs round to bf16, 2^-8
  relative, and fp32 differences can flip a rounding);
* the chunked scan against the sequential oracle (either package):
  1e-5 × max|y| in fp32 (the two formulations differ in summation order
  only, and the inputs are O(1));
* port decode steps against the port's chunked scan: 1e-5 × max|y|;
* the bf16 short conv against JAX ref and Pallas interpret: 1e-2 ×
  max|y| (both sum in fp32 and round once to bf16: at most one bf16 ulp,
  2^-8 relative, apart);
* the bridged smoke model: fp32 logits and mixer outputs 1e-4 × max|want|
  (matmul and SSD sums in another order, compounded over two layers and a
  512-wide unembed), bf16 2e-2 × max|want| (the bf16 tier: every matmul
  rounds to bf16 in both packages, at places that differ);
* decode steps against the forward: the JAX serving tiers of
  tests/test_serving.py (rtol = atol = 2e-2 fp32, 2e-1 bf16);
* greedy generate against JAX generate in fp32: token-exact.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduce_for_smoke as jreduce  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels import ssd_chunked as jssd  # noqa: E402
from repro.kernels.short_conv import short_conv_pallas  # noqa: E402
from repro.kernels.ssd_scan import ssd_scan_pallas  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.launch.steps import StepBuilder  # noqa: E402
from repro.models import mamba as jmamba  # noqa: E402
from repro.models import serving as jserving  # noqa: E402
from repro.models.context import Ctx  # noqa: E402
from repro.models.transformer import forward as jforward  # noqa: E402
from repro.models.transformer import init_model as jinit_model  # noqa: E402
from repro.nn.params import unbox  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config, reduce_for_smoke  # noqa: E402
from repro_torch.kernels import ops, ref, short_conv, ssd_chunked  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd_mod  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import mamba, serving  # noqa: E402
from repro_torch.models.transformer import forward, init_model  # noqa: E402

torch.set_num_threads(1)
ARCH = "mamba2-2.7b"
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# (bt, n, h, p, g, s, chunk): tests/test_kernels.py's SSD shapes (n = 96
# is not a multiple of its chunk), a g = 2 case with a ragged tail, and
# the smoke model's (q 16, p 32, s 16)
SSD_SHAPES = [(1, 64, 2, 8, 1, 8, 16), (2, 128, 4, 16, 2, 16, 32),
              (1, 96, 4, 8, 4, 8, 32), (2, 50, 4, 8, 2, 8, 16),
              (2, 37, 8, 32, 1, 16, 16)]


def _close(got, want, tol, what=""):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: max abs err {err} > {tol} x {scale}"


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(
        jnp.asarray(t, jnp.float32))


def _ssd_inputs(bt, n, h, p, g, s, seed=0):
    """numpy fp32 (x, dt, a, b, c, d_skip), dt positive and a negative as
    the model makes them (softplus, -exp)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((bt, n, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((bt, n, h)))).astype(np.float32)
    a = (-np.exp(0.1 * rng.standard_normal(h))).astype(np.float32)
    b = rng.standard_normal((bt, n, g, s)).astype(np.float32)
    c = rng.standard_normal((bt, n, g, s)).astype(np.float32)
    dsk = (1.0 + 0.1 * rng.standard_normal(h)).astype(np.float32)
    return x, dt, a, b, c, dsk


def _both(arrs, dtype):
    """The same inputs for both packages: x, b, c in ``dtype`` (the same
    rounding to bf16 on both sides), dt, a, d_skip fp32."""
    jdt, tdt = DTYPES[dtype]
    low = (0, 3, 4)
    jx = [jnp.asarray(v).astype(jdt) if i in low else jnp.asarray(v)
          for i, v in enumerate(arrs)]
    tx = [torch.from_numpy(v).to(tdt) if i in low else torch.from_numpy(v)
          for i, v in enumerate(arrs)]
    return jx, tx


# ------------------------------------------------------------ SSD kernels
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bt,n,h,p,g,s,chunk", SSD_SHAPES)
def test_ssd_ref_and_chunked_match_jax(bt, n, h, p, g, s, chunk, dtype):
    jx, tx = _both(_ssd_inputs(bt, n, h, p, g, s), dtype)
    tol = 1e-5 if dtype == "float32" else 2e-2
    want_ref = jref.ssd_scan_ref(*jx)
    got_ref = ref.ssd_scan_ref(*tx)
    assert got_ref.dtype == tx[0].dtype
    _close(_np(got_ref), _np(want_ref), tol, "ssd_scan_ref")
    want = jssd.ssd_scan_chunked(*jx, chunk=chunk)
    got = ssd_chunked.ssd_scan_chunked(*tx, chunk=chunk)
    assert got.dtype == tx[0].dtype and got.shape == (bt, n, h, p)
    _close(_np(got), _np(want), tol, "ssd_scan_chunked")
    # the CPU dispatch of the op is the chunked plain version, exactly
    assert torch.equal(ops.ssd_scan(*tx, chunk=chunk), got)
    if dtype == "float32":
        _close(_np(got), _np(got_ref), 1e-5, "chunked vs sequential")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bt,n,h,p,g,s,chunk",
                         [sh for sh in SSD_SHAPES if sh[1] % sh[6] == 0])
def test_ssd_chunked_matches_pallas_interpret(bt, n, h, p, g, s, chunk,
                                              dtype):
    """JAX's Pallas kernel (interpret mode) asserts n % chunk == 0."""
    jx, tx = _both(_ssd_inputs(bt, n, h, p, g, s, seed=1), dtype)
    want = ssd_scan_pallas(*jx, chunk=chunk, interpret=True)
    got = ssd_chunked.ssd_scan_chunked(*tx, chunk=chunk)
    _close(_np(got), _np(want), 1e-5 if dtype == "float32" else 2e-2,
           "vs ssd_scan_pallas")


def test_ssd_ref_float64_matches_chunked():
    """The oracle runs in float64 for float64 inputs (the card's check of
    the fp32 kernel uses it so)."""
    arrs = _ssd_inputs(2, 40, 4, 8, 2, 8, seed=2)
    t64 = [torch.from_numpy(v).double() for v in arrs]
    y64 = ref.ssd_scan_ref(*t64)
    assert y64.dtype == torch.float64
    y32 = ssd_chunked.ssd_scan_chunked(
        *[torch.from_numpy(v) for v in arrs], chunk=16)
    _close(y32.numpy(), y64.numpy(), 1e-5, "fp32 chunked vs float64 oracle")


@pytest.mark.parametrize("g", [1, 2])
def test_decode_steps_equal_chunked_scan(g):
    bt, n, h, p, s = 2, 21, 4, 8, 8
    arrs = _ssd_inputs(bt, n, h, p, g, s, seed=3)
    x, dt, a, b, c, dsk = (torch.from_numpy(v) for v in arrs)
    want = ssd_chunked.ssd_scan_chunked(x, dt, a, b, c, dsk, chunk=8)
    state = torch.zeros(bt, h, p, s)
    jstate = jnp.zeros((bt, h, p, s), jnp.float32)
    ys = []
    for t in range(n):
        state, y = ssd_chunked.ssd_decode_step(state, x[:, t], dt[:, t], a,
                                               b[:, t], c[:, t], dsk)
        jstate, jy = jssd.ssd_decode_step(
            jstate, arrs[0][:, t], arrs[1][:, t], arrs[2], arrs[3][:, t],
            arrs[4][:, t], arrs[5])
        _close(y.numpy(), np.asarray(jy), 1e-5, f"decode step {t} vs JAX")
        ys.append(y)
    _close(torch.stack(ys, 1).numpy(), want.numpy(), 1e-5, "decode loop")
    _close(state.numpy(), np.asarray(jstate), 1e-5, "final state")


# -------------------------------------------------------- bf16 short conv
@pytest.mark.parametrize("b,n,d,m", [(2, 37, 24, 4), (1, 40, 320, 4),
                                     (2, 3, 8, 4)])
def test_short_conv_bf16_plain_matches_jax(b, n, d, m):
    """Mamba's conv (causal, left = 0) in bf16: x and taps bf16, fp32 sums,
    bf16 out; n < m included."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((b, n, d)).astype(np.float32)
    f = (0.3 * rng.standard_normal((d, m))).astype(np.float32)
    jx, jf = jnp.asarray(x, jnp.bfloat16), jnp.asarray(f, jnp.bfloat16)
    tx = torch.from_numpy(x).bfloat16()
    tf = torch.from_numpy(f).bfloat16()
    got = short_conv.short_conv(tx, tf, 0)
    assert got.dtype == torch.bfloat16
    via_op = ops.short_conv(tx, tf, causal=True)
    assert torch.equal(via_op, got)
    _close(_np(got), _np(jref.short_conv_ref(jx, jf, True)), 1e-2, "ref")
    _close(_np(got), _np(short_conv_pallas(jx, jf, True, interpret=True)),
           1e-2, "pallas interpret")


# ------------------------------------------------------- the smoke model
def _cfgs(dtype):
    over = dict(dtype=dtype, param_dtype=dtype)
    return (jreduce(jget_config(ARCH), **over),
            reduce_for_smoke(get_config(ARCH), **over))


@functools.cache
def _bridged(dtype):
    """(dtype, JAX cfg, port cfg, JAX params, numpy tree, bridged model)
    of the smoke model from JAX's init at seed 0."""
    jcfg, cfg = _cfgs(dtype)
    init = jax.jit(lambda k: unbox(jinit_model(k, jcfg))[0])
    jparams = init(jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, jparams)
    model = bridge.params_from_jax(tree, cfg, device="cpu")
    return dtype, jcfg, cfg, jparams, tree, model


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def models(request):
    return _bridged(request.param)


def _toks(b, s, vocab, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, (b, s))


@pytest.mark.parametrize("smoke", [False, True])
def test_config_is_a_copy(smoke):
    j, p = jget_config(ARCH), get_config(ARCH)
    if smoke:
        j, p = jreduce(j), reduce_for_smoke(p)
    assert vars(j) == vars(p)
    assert (j.d_inner, j.ssm_heads, j.vocab_padded, j.layers_spec) == (
        p.d_inner, p.ssm_heads, p.vocab_padded, p.layers_spec)
    if not smoke:
        assert (p.n_layers, p.d_model, p.vocab_padded, p.ssm_state,
                p.ssm_heads, p.ssd_chunk, p.dtype) == (
                    64, 2560, 50432, 128, 80, 128, "bfloat16")


def test_param_dtypes_follow_the_jax_leaves(models):
    """Per-leaf dtypes after the bridge and after init_model: fp32 norm
    scales, a_log, dt_bias, d_skip, norm_scale; param_dtype elsewhere."""
    dtype, _, cfg, _, tree, model = models
    want = {k: bridge._as_torch(v).dtype
            for k, v in bridge._port_leaves(tree, cfg).items()}
    assert {k: v.dtype for k, v in model.state_dict().items()} == want
    own = init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert {k: v.dtype for k, v in own.state_dict().items()} == want
    f32 = {k for k, v in want.items() if v == torch.float32}
    if dtype == "bfloat16":
        assert f32 == {k for k in want if k.endswith(
            ("scale", "a_log", "dt_bias", "d_skip", "norm_scale"))}
    meta = bridge.Model(cfg, device="meta")
    assert {k: v.dtype for k, v in meta.state_dict().items()} == want


def test_bridge_round_trip_keeps_dtypes(models):
    _, _, cfg, _, tree, model = models
    back = bridge.params_to_jax(model)
    again = bridge.params_from_jax(back, cfg, device="cpu")
    for (k, v), (_, w) in zip(model.state_dict().items(),
                              again.state_dict().items()):
        assert v.dtype == w.dtype and torch.equal(v, w), k


def test_bridge_refuses_a_leaf_of_another_dtype():
    """The bf16 model has leaves of two dtypes: an fp32 leaf handed over in
    bf16 is refused, not cast."""
    _, _, cfg, _, tree, _ = _bridged("bfloat16")
    bad = jax.tree.map(lambda v: v, tree)
    bad["blocks"]["sub0"]["mixer"]["a_log"] = np.asarray(
        bad["blocks"]["sub0"]["mixer"]["a_log"]).astype(jnp.bfloat16)
    with pytest.raises(ValueError, match="a_log: JAX dtype"):
        bridge.params_from_jax(bad, cfg, device="cpu")


def test_mamba_apply_matches_jax(models):
    dtype, jcfg, cfg, jparams, _, model = models
    jdt, tdt = DTYPES[dtype]
    x = np.random.default_rng(5).standard_normal(
        (2, 37, cfg.d_model)).astype(np.float32)
    jp = jax.tree.map(lambda v: v[0], jparams["blocks"]["sub0"]["mixer"])
    want = jmamba.mamba_apply(jp, jcfg, Ctx(), jnp.asarray(x).astype(jdt))
    with torch.no_grad():
        got = mamba.mamba_apply(model.layers[0].mixer, cfg,
                                torch.from_numpy(x).to(tdt))
    assert got.dtype == tdt
    _close(_np(got), _np(want), 1e-4 if dtype == "float32" else 2e-2,
           "mamba_apply")


def test_logits_match_jax(models):
    dtype, jcfg, cfg, jparams, _, model = models
    toks = _toks(2, 37, cfg.vocab)
    want, _ = jforward(jparams, jcfg, Ctx(), {"tokens": toks})
    with torch.no_grad():
        got = forward(model, cfg, torch.from_numpy(toks))
    assert got.shape == (2, 37, cfg.vocab_padded)
    _close(_np(got), _np(want), 1e-4 if dtype == "float32" else 2e-2,
           "logits")


def test_init_cache_matches_jax(models):
    dtype, jcfg, cfg, jparams, _, model = models
    jcache = jserving.init_cache(jcfg, 3, 16, params=jparams)
    cache = serving.init_cache(cfg, 3, 16, params=model)
    assert len(cache) == cfg.n_layers
    for leaf in ("conv", "state"):
        want = jcache["blocks"]["sub0"][leaf]               # (layers, ...)
        for lc in cache:
            assert tuple(lc[leaf].shape) == want.shape[1:], leaf
            assert str(lc[leaf].dtype).removeprefix("torch.") == str(
                want.dtype), leaf
            assert not bool(lc[leaf].any())
    assert not serving.supports_chunked_prefill(cfg, cache)


def test_decode_steps_reproduce_forward(models):
    """The port's tests/test_serving.py::test_decode_matches_forward_per_mixer
    for mamba: token-by-token decode against the one-shot forward."""
    dtype, _, cfg, _, _, model = models
    toks = torch.from_numpy(_toks(1, 8, cfg.vocab, seed=6))
    with torch.no_grad():
        want = forward(model, cfg, toks)
        cache = serving.init_cache(cfg, 1, 8, params=model)
        got = []
        for t in range(8):
            logits, cache = serving.decode_step(model, cfg, toks[:, t:t + 1],
                                                cache, t)
            got.append(logits[:, 0])
    tol = 2e-2 if dtype == "float32" else 2e-1
    np.testing.assert_allclose(_np(torch.stack(got, 1)), _np(want),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("p,gen", [(5, 6), (9, 3)])
def test_generate_is_token_exact_vs_jax(p, gen):
    """In fp32 (in bf16 a near-tie can flip between the packages)."""
    _, jcfg, cfg, jparams, _, model = _bridged("float32")
    prompt = _toks(3, p, cfg.vocab, seed=p)
    want = jserve.generate(StepBuilder(jcfg), jparams,
                           jnp.asarray(prompt, jnp.int32), gen)
    with torch.inference_mode():
        got = serve.generate(model, cfg, torch.from_numpy(prompt), gen)
    assert got.shape == (3, p + gen)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_chunked_prefill_is_refused_for_mamba(models):
    _, _, cfg, _, _, model = models
    with pytest.raises(ValueError, match="chunked_prefill=True"):
        serve.generate(model, cfg, torch.zeros(1, 4, dtype=torch.long), 2,
                       chunked_prefill=True)


def test_serve_main_runs_on_cpu(capsys):
    assert serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                       "--batch", "2", "--prompt-len", "6",
                       "--gen-len", "5"]) == 0
    assert "generated 10 tokens" in capsys.readouterr().out


def test_fp32_tnn_init_is_unchanged():
    """The per-leaf dtypes leave the fp32 TNN models as they were: every
    leaf fp32, and the values drawn from the generator in the same order
    (init_model on the CPU equals a CPU model reset by hand)."""
    from repro_torch.models.transformer import Model
    from repro_torch.nn.layers import reset_parameters
    for arch in ("fd-tnn-lm-wt103", "ski-tnn-lm-wt103"):
        cfg = reduce_for_smoke(get_config(arch))
        got = init_model(cfg, torch.Generator().manual_seed(3), device="cpu")
        want = Model(cfg, device="cpu")
        reset_parameters(want, torch.Generator().manual_seed(3))
        for (k, v), (_, w) in zip(got.state_dict().items(),
                                  want.state_dict().items()):
            assert v.dtype == torch.float32 and torch.equal(v, w), k


# --------------------------------------------------------------- refusals
def test_new_wrappers_refuse_off_the_cpu():
    """A tensor on another device than the CPU or a card, a wrong dtype,
    and an input that requires grad (the kernel is forward-only) are
    refused before any launch."""
    x = torch.empty(1, 8, 2, 4, device="meta")
    dt = torch.empty(1, 8, 2, device="meta")
    hv = torch.empty(2, device="meta")
    bc = torch.empty(1, 8, 1, 4, device="meta")
    with pytest.raises(ValueError, match="tensor on meta"):
        ssd_mod.ssd_scan(x, dt, hv, bc, bc, hv, chunk=4)
    with pytest.raises(TypeError, match="all fp32 or all bf16"):
        ssd_mod.ssd_scan(x.half(), dt, hv, bc.half(), bc.half(), hv)
    with pytest.raises(TypeError, match="all fp32 or all bf16"):
        ssd_mod.ssd_scan(x.bfloat16(), dt, hv, bc, bc, hv)
    with pytest.raises(NotImplementedError, match="item 16"):
        ssd_mod.ssd_scan(x.requires_grad_(), dt, hv, bc, bc, hv)
    xc = torch.empty(1, 8, 4, device="meta", dtype=torch.bfloat16)
    f = torch.empty(4, 4, device="meta", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="tensor on meta"):
        short_conv.short_conv(xc, f, 0)
    with pytest.raises(TypeError, match="both fp32 or both bf16"):
        short_conv.short_conv(xc, f.float(), 0)
    with pytest.raises(TypeError, match="both fp32 or both bf16"):
        short_conv.short_conv(xc.half(), f.half(), 0)
