"""Port parity for large-rank SKI (repro_torch kernels/backend band policy,
kernels/ref, ski_fused's windowed and expand pass 2, ski_grad's
``gram_coef_grad_fft``, ski_vjp's ``SKIFusedTNOCoef``, ops and core/ski's
"windowed" and "fft" plans) against the JAX package, whose
``tests/test_ski_large_r.py`` is the reference. The same numpy inputs go
through the JAX function (its jnp reference, and its Pallas kernels in
interpret mode) and the port's counterpart, which on the CPU runs the
plain versions that the CUDA kernels are held against on the card
(``chip_smoke.py``).

Tolerances, each with its reason:
* the band policy and the rank routing compare exactly (integers);
* the plain versions, the pass-2 wrappers and the op at small sizes at
  1e-5 × max|reference|, the fp32 tier: FFTs and contractions sum in
  another order in torch than in XLA; against the Pallas-interpret custom
  VJP at 1e-4 × max, whose own grads differ from the JAX reference by up
  to 1.3e-5 relative (ROADMAP Queue 3 caveat A);
* the op at n/r = 2048/512, 4096/2048 and 8192/8192 at 1e-4 × max, the
  JAX test's own gate at those sizes (fp32 accumulation-order drift);
* the bridged smoke model: logits at rtol = atol = 1e-4 as
  ``test_torch_ski.py``, loss at 1e-5 relative and each gradient at 1e-5 ×
  max|g| of its leaf, as ``test_torch_ski_train.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduce_for_smoke as jreduce  # noqa: E402
from repro.core import ski as jski  # noqa: E402
from repro.kernels import backend as jbackend  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.ski_fused import (ski_expand_pass2_pallas,  # noqa: E402
                                     ski_windowed_pass2_pallas)
from repro.kernels.ski_grad import gram_coef_grad_fft as jgcg  # noqa: E402
from repro.models.context import Ctx  # noqa: E402
from repro.models.transformer import forward as jforward  # noqa: E402
from repro.models.transformer import init_model as jinit_model  # noqa: E402
from repro.models.transformer import loss_fn as jloss_fn  # noqa: E402
from repro.nn.params import unbox  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config, reduce_for_smoke  # noqa: E402
from repro_torch.core import ski  # noqa: E402
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.kernels import (backend, ops, ref, ski_fused,  # noqa: E402
                                 ski_grad, ski_vjp)
from repro_torch.launch.steps import loss_and_grads  # noqa: E402
from repro_torch.models.transformer import loss_fn  # noqa: E402

torch.set_num_threads(1)
ARCH = "ski-tnn-lm-wt103"
FP32 = 1e-5
LARGE = 1e-4
PALLAS = 1e-4
VARIANTS = ("windowed", "fft")
LEFTS = {"causal": lambda m: 0, "centred": lambda m: m // 2,
         "mirrored": lambda m: m - 1 - m // 2, "last": lambda m: m - 1}
# (b, n, d, r, m): ragged n, d and r; n < m; r = n; two inducing points
SHAPES = {"ragged": (3, 37, 45, 11, 4), "n<m": (2, 3, 5, 3, 4),
          "r=n": (2, 24, 6, 24, 3), "r=2": (2, 20, 8, 2, 5)}
# the JAX test's band-coverage cases (n, r, its tile bn) and r = n
COVERAGE = [(2048, 513, 256), (4096, 2048, 256), (1024, 1024, 64),
            (300, 290, 104), (512, 512, 128), (8192, 8192, 128)]


def _np(a):
    return a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _close(got, want, tol=FP32, what=""):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: max abs err {err} > {tol} x {scale}"


def T(a):
    return torch.from_numpy(np.array(a))


def _f32(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


# ------------------------------------------------------------ band policy
@pytest.mark.parametrize("budget", ["8", "16", "40", "128", "160", "1000"])
def test_band_width_and_fit_match_jax(monkeypatch, budget):
    """band_width and band_fit equal the JAX package's under the same
    REPRO_SKI_BAND_MAX: only band_budget's default differs."""
    monkeypatch.setenv("REPRO_SKI_BAND_MAX", budget)
    assert backend.band_budget() == jbackend.band_budget() == int(budget)
    for n, r in ((512, 512), (2048, 513), (4096, 2048), (300, 290),
                 (8192, 8192), (256, 96), (37, 11), (3, 3), (40, 2)):
        for bn in (8, 64, 104, 128, 256):
            assert backend.band_width(bn, n, r) == jbackend.band_width(
                bn, n, r), (bn, n, r)
            assert backend.band_fit(bn, n, r) == jbackend.band_fit(
                bn, n, r), (bn, n, r, budget)


def test_band_budget_reads_the_knob(monkeypatch):
    """Default 160 on Hopper (the JAX package's 128 was sized for TPU
    VMEM), the knob read at each call, a typo refused."""
    monkeypatch.delenv("REPRO_SKI_BAND_MAX", raising=False)
    assert backend.band_budget() == backend.SKI_BAND_MAX == 160
    monkeypatch.setenv("REPRO_SKI_BAND_MAX", "48")
    assert backend.band_budget() == 48
    monkeypatch.setenv("REPRO_SKI_BAND_MAX", "wide")
    with pytest.raises(ValueError, match="not an integer"):
        backend.band_budget()


@pytest.mark.parametrize("n,r", [(512, 512), (8192, 8192), (2, 2),
                                 (1000, 999), (4096, 2048), (37, 11)])
def test_default_budget_keeps_the_kernel_tile(monkeypatch, n, r):
    """r <= n gives h >= 1, so the 128-row tile's band is at most 136 and
    the default budget never shrinks the tile; the JAX default (128) does
    at h near 1."""
    monkeypatch.delenv("REPRO_SKI_BAND_MAX", raising=False)
    bn, bw = backend.band_fit(128, n, r)
    assert bn == 128 and bw <= 136


@pytest.mark.parametrize("budget", ["", "16"])
@pytest.mark.parametrize("n,r,jbn", COVERAGE)
def test_window_covers_every_tap(monkeypatch, n, r, jbn, budget):
    """Every hat tap of every tile lands in the bw-row window the kernels
    compute or copy, which starts at the node of the tile's first row
    clamped to r - bw: for the port's tile (band_fit from 128 rows) and
    for the JAX test's tile length."""
    monkeypatch.setenv("REPRO_SKI_BAND_MAX", budget)
    lo = ski.make_inducing(n, r, "cpu")[0].numpy()
    for bn, bw in (backend.band_fit(128, n, r),
                   (jbn, backend.band_width(jbn, n, r))):
        for s in range(0, n, bn):
            e = min(s + bn, n) - 1
            w0 = min(lo[s], max(0, r - bw))
            assert lo[s] >= w0 and lo[e] + 1 <= w0 + bw - 1, (s, w0, bw)


# ------------------------------------------------------------ rank routing
@pytest.mark.parametrize("r", [64, 511, 512, 513, 2048, 4096, 4097, 8192])
def test_rank_variant_boundaries_match_jax(r):
    want = ("dense" if r <= 512 else "windowed" if r <= 4096 else "fft")
    assert backend.ski_rank_variant(r) == jbackend.ski_rank_variant(r) == want


def test_rank_variant_gram_byte_guard():
    """r <= 512 with a (d, r, r) Gram over 64 MB goes windowed, in both
    packages: at d = 512 the dense route ends at r = 181."""
    r = 512
    d_ok = backend.SKI_GRAM_BYTES_MAX // (r * r * 4)
    for r_, d, want in ((r, d_ok, "dense"), (r, d_ok + 1, "windowed"),
                        (181, 512, "dense"), (182, 512, "windowed")):
        assert backend.ski_rank_variant(r_, d) == want
        assert jbackend.ski_rank_variant(r_, d) == want


# --------------------------------------------------------- plain versions
@pytest.mark.parametrize("shape", list(SHAPES))
def test_coef_ref_functions_match_jax(shape):
    """toeplitz_gram_matvec_ref, ski_fused_tno_coef_ref (both offsets) and
    gram_coef_grad_ref against JAX ref."""
    b, n, d, r, m = SHAPES[shape]
    rng = np.random.default_rng(b * n + r)
    x, z, gz = _f32(rng, b, n, d), _f32(rng, b, r, d), _f32(rng, b, r, d)
    coef, f = _f32(rng, d, 2 * r - 1), _f32(rng, d, m)
    lo, w_lo, _ = jski.make_inducing(n, r)
    _close(ref.toeplitz_gram_matvec_ref(T(coef), T(z)),
           jref.toeplitz_gram_matvec_ref(coef, z), what="gram matvec")
    for causal in (True, False):
        _close(ref.ski_fused_tno_coef_ref(T(x), T(coef), T(f), T(lo),
                                          T(w_lo), r, causal),
               jref.ski_fused_tno_coef_ref(x, coef, f, lo, w_lo, r, causal),
               what=f"coef op causal={causal}")
    got = ref.gram_coef_grad_ref(T(gz), T(z))
    assert got.shape == (d, 2 * r - 1) and got.dtype == torch.float32
    _close(got, jref.gram_coef_grad_ref(gz, z), what="coef grad")


@pytest.mark.parametrize("b,r,d", [(3, 13, 6), (2, 64, 5), (1, 512, 3),
                                   (4, 2, 7)])
def test_gram_coef_grad_fft_matches_ref(b, r, d):
    """The FFT correlation against the O(r²) diagonal sums, the port's and
    JAX's, and JAX's FFT form."""
    rng = np.random.default_rng(r)
    gz, z = _f32(rng, b, r, d), _f32(rng, b, r, d)
    got = ski_grad.gram_coef_grad_fft(T(gz), T(z))
    assert got.shape == (d, 2 * r - 1) and got.is_contiguous()
    _close(got, ref.gram_coef_grad_ref(T(gz), T(z)), what="port ref")
    _close(got, jref.gram_coef_grad_ref(gz, z), what="jax ref")
    _close(got, jgcg(jnp.asarray(gz), jnp.asarray(z)), what="jax fft")


# ------------------------------------------- pass-2 wrappers vs Pallas
def _pass2_inputs(shape, seed):
    b, n, d, r, m = shape
    rng = np.random.default_rng(seed)
    return (_f32(rng, b, n, d), _f32(rng, b, r, d),
            _f32(rng, d, 2 * r - 1, scale=0.3), _f32(rng, d, m))


@pytest.mark.parametrize("left", list(LEFTS))
@pytest.mark.parametrize("shape", ["ragged", "r=n"])
def test_window_pass2_wrappers_match_pallas(shape, left):
    """ski_windowed_pass2 and ski_expand_pass2 (the plain versions on the
    CPU) against the Pallas kernels in interpret mode at the four offsets:
    causal, centred and the two the backward mirrors them to."""
    x, z, coef, f = _pass2_inputs(SHAPES[shape], seed=5)
    lf = LEFTS[left](f.shape[1])
    got = ski_fused.ski_windowed_pass2(T(x), T(z), T(coef), T(f), True,
                                       left=lf)
    _close(got, ski_windowed_pass2_pallas(x, z, coef, f, True, left=lf,
                                          interpret=True), what="windowed")
    got = ski_fused.ski_expand_pass2(T(x), T(z), T(f), False, left=lf)
    _close(got, ski_expand_pass2_pallas(x, z, f, False, left=lf,
                                        interpret=True), what="expand")


def test_windowed_pass2_under_a_16_wide_band(monkeypatch):
    """REPRO_SKI_BAND_MAX=16 makes the Pallas kernel stream many band
    blocks a tile (the JAX test's case, n=256, r=96); the port's pass 2
    gives the same y, and the band knob changes tiling, never the result."""
    x, z, coef, f = _pass2_inputs((1, 256, 8, 96, 4), seed=6)
    want = ref.ski_expand_pass2_ref(
        T(x), ref.toeplitz_gram_matvec_ref(T(coef), T(z)), T(f), False)
    monkeypatch.setenv("REPRO_SKI_BAND_MAX", "16")
    assert backend.band_fit(128, 256, 96) == (32, 16)
    got = ski_fused.ski_windowed_pass2(T(x), T(z), T(coef), T(f), False)
    _close(got, want, what="port")
    _close(got, ski_windowed_pass2_pallas(x, z, coef, f, False,
                                          interpret=True), what="pallas")


# ----------------------------------------------------- the coefficient op
def _op_inputs(shape, seed, coef_scale=1.0):
    b, n, d, r, m = shape
    rng = np.random.default_rng(seed)
    lo, w_lo, _ = jski.make_inducing(n, r)
    return (_f32(rng, b, n, d), _f32(rng, d, 2 * r - 1, scale=coef_scale),
            _f32(rng, d, m, scale=0.1), np.asarray(lo), np.asarray(w_lo), r)


def _sin_grads(fn, x, coef, f):
    """(y, dx, dcoef, df) of Σ sin(y) through the port's ``fn``."""
    ts = [T(v).requires_grad_() for v in (x, coef, f)]
    y = fn(*ts)
    return (y.detach(), *torch.autograd.grad(torch.sin(y).sum(), ts))


def _jax_sin_grads(x, coef, f, lo, w_lo, r, causal, variant, **kw):
    def fn(*t):
        return jops.ski_fused_tno_coef(*t, jnp.asarray(lo), jnp.asarray(w_lo),
                                       r, causal, variant, **kw)
    args = (jnp.asarray(x), jnp.asarray(coef), jnp.asarray(f))
    grads = jax.grad(lambda *t: jnp.sum(jnp.sin(fn(*t))), argnums=(0, 1, 2))(
        *args)
    return (fn(*args), *grads)


NAMES = ("y", "dx", "dcoef", "dfilt")


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "bidir"])
@pytest.mark.parametrize("variant", VARIANTS)
def test_coef_op_grads_match_jax(variant, causal):
    """ops.ski_fused_tno_coef's y and (dx, dcoef, df) of Σ sin(y), at a
    ragged small shape, against autograd through the port's plain op,
    jax.grad of the JAX reference op, and the JAX Pallas custom VJP in
    interpret mode."""
    x, coef, f, lo, w_lo, r = _op_inputs((2, 75, 16, 11, 4), seed=7)
    ski_vjp.reset_counters()
    got = _sin_grads(lambda *t: ops.ski_fused_tno_coef(
        *t, T(lo), T(w_lo), r, causal, variant), x, coef, f)
    assert ski_vjp.coef_counters == {"fwd": 1, "bwd_kernel": 1, "bwd_ref": 0}
    assert ski_vjp.counters == {"fwd": 0, "bwd_kernel": 0, "bwd_ref": 0}
    plain = _sin_grads(lambda *t: ref.ski_fused_tno_coef_ref(
        *t, T(lo), T(w_lo), r, causal), x, coef, f)
    jax_ref = _jax_sin_grads(x, coef, f, lo, w_lo, r, causal, variant,
                             use_pallas=False)
    jax_pallas = _jax_sin_grads(x, coef, f, lo, w_lo, r, causal, variant,
                                use_pallas=True, interpret=True)
    for name, p, q, j, k in zip(NAMES, got, plain, jax_ref, jax_pallas):
        _close(p, q, FP32, f"{name} vs autograd through ref")
        _close(p, j, FP32, f"{name} vs jax.grad of the reference")
        _close(p, k, PALLAS, f"{name} vs the Pallas custom VJP")


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("n,r", [(2048, 512), (4096, 2048), (8192, 8192)])
def test_coef_op_parity_acceptance_sizes(n, r, variant):
    """The JAX test's acceptance ranks (d=8, m=6, coefficients × 0.05):
    y and the gradients of Σ sin(y) against jax.grad of the JAX reference
    op, at its 1e-4 gate."""
    x, coef, f, lo, w_lo, r = _op_inputs((1, n, 8, r, 6), seed=8,
                                         coef_scale=0.05)
    got = _sin_grads(lambda *t: ops.ski_fused_tno_coef(
        *t, T(lo), T(w_lo), r, False, variant), x, coef, f)
    want = _jax_sin_grads(x, coef, f, lo, w_lo, r, False, variant,
                          use_pallas=False)
    for name, p, q in zip(NAMES, got, want):
        _close(p, q, LARGE, name)


@pytest.mark.parametrize("variant", VARIANTS)
def test_coef_reference_backward_switch(monkeypatch, variant):
    """REPRO_PALLAS_GRAD=0 keeps SKIFusedTNOCoef's forward and returns
    autograd's cotangents through ref.ski_fused_tno_coef_ref, counted as
    bwd_ref; the gradients are the kernel backward's within the fp32
    tier."""
    x, coef, f, lo, w_lo, r = _op_inputs((2, 40, 6, 13, 5), seed=9)

    def grads():
        return _sin_grads(lambda *t: ops.ski_fused_tno_coef(
            *t, T(lo), T(w_lo), r, True, variant), x, coef, f)
    ski_vjp.reset_counters()
    kernel = grads()
    monkeypatch.setenv("REPRO_PALLAS_GRAD", "0")
    reference = grads()
    assert ski_vjp.coef_counters == {"fwd": 2, "bwd_kernel": 1, "bwd_ref": 1}
    assert ops.ski_op_counters()["SKIFusedTNOCoef"] == ski_vjp.coef_counters
    for name, p, q in zip(NAMES, reference, kernel):
        _close(p, q, FP32, name)
    assert not any(ops.ski_counters().values())     # the CPU launches none


def test_coef_inference_counts_no_differentiated_forward():
    x, coef, f, lo, w_lo, r = _op_inputs((2, 30, 4, 7, 3), seed=10)
    ski_vjp.reset_counters()
    with torch.inference_mode():
        y = ops.ski_fused_tno_coef(T(x).requires_grad_(), T(coef), T(f),
                                   T(lo), T(w_lo), r, True, "fft")
    assert y.grad_fn is None
    assert ski_vjp.coef_counters == {"fwd": 0, "bwd_kernel": 0, "bwd_ref": 0}


def test_coef_op_rejects_unknown_variant():
    x, coef, f, lo, w_lo, r = _op_inputs((1, 8, 2, 4, 2), seed=11)
    with pytest.raises(ValueError, match="variant 'dense'"):
        ops.ski_fused_tno_coef(T(x), T(coef), T(f), T(lo), T(w_lo), r, True,
                               "dense")


# -------------------------------------------------- plans and the model
@pytest.mark.parametrize("variant", VARIANTS)
def test_ski_plan_builds_coef_variants(variant):
    """A forced "windowed" or "fft" plan carries the coefficients (masked
    when causal) and no dense Gram, and ski_tno_apply runs it: the same y
    as the dense plan and as the JAX package's plan within the fp32 tier."""
    rng = np.random.default_rng(12)
    vals, filt = _f32(rng, 8, 129, scale=0.3), _f32(rng, 8, 8, scale=0.3)
    cfg = ski.SKIConfig(8, rank=24, filter_size=8)
    params = ski.ski_init(cfg)
    with torch.no_grad():
        params.rpe.vals.copy_(T(vals))
        params.filt.copy_(T(filt))
    jparams = {"rpe": {"vals": jnp.asarray(vals)}, "filt": jnp.asarray(filt)}
    jcfg = jski.SKIConfig(8, rank=24, filter_size=8)
    x = _f32(rng, 2, 96, 8)
    for causal in (True, False):
        plan = ski.ski_plan(params, cfg, 96, causal, variant=variant)
        jplan = jski.ski_plan(jparams, jcfg, 96, causal, variant=variant)
        assert plan["variant"] == variant and "a_dense" not in plan
        _close(plan["a_coef"], jplan["a_coef"], 1e-6, "coefficients")
        got = ski.ski_tno_apply(params, cfg, T(x), causal, plan=plan)
        dense = ski.ski_tno_apply(params, cfg, T(x), causal,
                                  plan=ski.ski_plan(params, cfg, 96, causal,
                                                    variant="dense"))
        _close(got, dense, FP32, "vs the dense plan")
        _close(got, jski.ski_tno_apply(jparams, jcfg, jnp.asarray(x), causal,
                                       plan=jplan), FP32, "vs JAX")


@pytest.fixture(scope="module")
def smoke():
    jcfg = jreduce(jget_config(ARCH))
    cfg = reduce_for_smoke(get_config(ARCH))
    init = jax.jit(lambda k: unbox(jinit_model(k, jcfg))[0])
    tree = jax.tree.map(np.asarray, init(jax.random.PRNGKey(0)))
    batch = pipeline.batch_at(pipeline.DataConfig(
        vocab=cfg.vocab, seq_len=32, global_batch=2, seed=4), 0)
    return jcfg, cfg, tree, batch


@pytest.mark.parametrize("variant", VARIANTS)
def test_smoke_model_on_the_coef_routes_matches_jax(monkeypatch, smoke,
                                                    variant):
    """The bridged smoke ski-tnn-lm-wt103 (r = 8) routed to "windowed" by
    REPRO_SKI_DENSE_RMAX=4, and to "fft" by REPRO_SKI_WINDOWED_RMAX=4 as
    well (both packages read them): logits, loss and every parameter's
    gradient against the JAX package's forward and jax.grad of its
    loss_fn on the same route."""
    jcfg, cfg, tree, batch = smoke
    monkeypatch.setenv("REPRO_SKI_DENSE_RMAX", "4")
    if variant == "fft":
        monkeypatch.setenv("REPRO_SKI_WINDOWED_RMAX", "4")
    assert (backend.ski_rank_variant(cfg.tno_rank, cfg.d_model)
            == jbackend.ski_rank_variant(cfg.tno_rank, cfg.d_model) == variant)
    jtree = jax.tree.map(jnp.asarray, tree)
    want, _ = jforward(jtree, jcfg, Ctx(), {"tokens": batch["tokens"]})
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: jloss_fn(p, jcfg, Ctx(), batch), has_aux=True)(jtree)
    model = bridge.params_from_jax(tree, cfg, device="cpu")
    tbatch = {k: torch.from_numpy(np.asarray(v)).long()
              for k, v in batch.items()}
    with torch.no_grad():
        from repro_torch.models.transformer import forward
        logits = forward(model, cfg, tbatch["tokens"])
        eval_loss, _ = loss_fn(model, cfg, tbatch)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    ski_vjp.reset_counters()
    loss, _, grads = loss_and_grads(model, cfg, tbatch)
    assert ski_vjp.coef_counters == {"fwd": cfg.n_layers,
                                     "bwd_kernel": cfg.n_layers, "bwd_ref": 0}
    assert ski_vjp.counters == {"fwd": 0, "bwd_kernel": 0, "bwd_ref": 0}
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(eval_loss), float(jloss), rtol=1e-5)
    want_g = bridge._port_leaves(jax.tree.map(np.asarray, jgrads), cfg)
    assert set(want_g) == set(grads)
    for k, g in grads.items():
        _close(g, want_g[k], FP32, k)


# ------------------------------------------------ wrappers off the CPU path
def test_window_wrappers_refuse_off_the_cpu():
    """Off the CPU the windowed wrappers launch their kernel or raise: a
    tensor on another device is refused, and so is an input that requires
    grad (a kernel on its own is forward-only). The CPU path counts no
    launch."""
    x = torch.empty(2, 16, 8, device="meta")
    z = torch.empty(2, 4, 8, device="meta")
    coef = torch.empty(8, 7, device="meta")
    f = torch.empty(8, 3, device="meta")
    with pytest.raises(ValueError, match="tensor on meta"):
        ski_fused.ski_windowed_pass2(x, z, coef, f, True)
    with pytest.raises(ValueError, match="tensor on meta"):
        ski_fused.ski_expand_pass2(x, z, f, True)
    with pytest.raises(NotImplementedError, match="forward-only"):
        ski_fused.ski_windowed_pass2(x, z, coef.clone().requires_grad_(), f,
                                     True)
    with pytest.raises(NotImplementedError, match="forward-only"):
        ski_fused.ski_expand_pass2(x.clone().requires_grad_(), z, f, True)
    ski_fused.reset_counters()
    xc, zc = torch.ones(1, 6, 2), torch.ones(1, 3, 2)
    ski_fused.ski_windowed_pass2(xc, zc, torch.ones(2, 5), torch.ones(2, 2),
                                 True)
    ski_fused.ski_expand_pass2(xc, zc, torch.ones(2, 2), False)
    assert not any(ski_fused.counters.values())
