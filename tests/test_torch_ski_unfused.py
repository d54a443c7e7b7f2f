"""Port parity for the unfused SKI-TNO (repro_torch kernels/short_conv, the
interp pair of kernels/interp_matvec with their autograd Functions,
core/toeplitz's FFT matvec, ``core/ski`` with ``fused=False`` and
core/causal_ski) against the JAX package. The same numpy inputs go through
the JAX function (its jnp reference, and its Pallas kernels in interpret
mode) and the port's counterpart, which on the CPU runs the plain versions
that the CUDA kernels are held against on the card (``chip_smoke.py``).

Tolerances, each with its reason:
* kernel-level and op-level outputs and cotangents at 1e-5 × max|reference|,
  the fp32 tier: the sums run in another order in torch than in XLA (the
  Pallas interp kernels' unclamped hat also differs from the clamped
  weights by about 4e-6 at the last row);
* the unfused op against the port's fused op at 1e-4 × max, the tier of
  ``tests/test_ski_fused.py::test_fused_matches_unfused_pipeline``: the
  Gram is applied by FFT in one and as a dense matrix in the other;
* the inducing geometry of a plan bitwise (the same numpy code).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduce_for_smoke as jreduce  # noqa: E402
from repro.core import causal_ski as jcausal_ski  # noqa: E402
from repro.core import ski as jski  # noqa: E402
from repro.core import tno as jtno  # noqa: E402
from repro.core import toeplitz as jtoeplitz  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.interp_matvec import (interp_expand_pallas,  # noqa: E402
                                         interp_reduce_pallas)
from repro.kernels.short_conv import short_conv_pallas  # noqa: E402
from repro.models.transformer import init_model as jinit_model  # noqa: E402
from repro.nn.params import unbox  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config, reduce_for_smoke  # noqa: E402
from repro_torch.core import causal_ski, ski, tno, toeplitz  # noqa: E402
from repro_torch.kernels import (interp_matvec, ops, ref,  # noqa: E402
                                 short_conv)

torch.set_num_threads(1)
ARCH = "ski-tnn-lm-wt103"
FP32 = 1e-5
FUSED = 1e-4

# short conv shapes (b, n, d, m): the model's smoke width, an even m as
# wide as the LM's, ragged n and d, n < m, one tap
CONV_SHAPES = {"smoke": (2, 64, 16, 4), "m=32": (2, 96, 24, 32),
               "ragged": (3, 37, 45, 4), "n<m": (2, 3, 5, 4),
               "m=1": (2, 20, 8, 1)}
LEFTS = {"causal": lambda m: 0, "centred": lambda m: m // 2,
         "mirrored": lambda m: m - 1 - m // 2, "last": lambda m: m - 1}
# interp shapes (b, n, d, r): as tests/test_torch_ski.py, plus r = 2
INTERP_SHAPES = {"smoke": (2, 64, 16, 8), "ragged": (3, 37, 45, 11),
                 "n<m": (2, 3, 5, 3), "r=n": (2, 12, 6, 12),
                 "m=1": (2, 20, 8, 5), "r=2": (2, 40, 33, 2)}


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


def _f32(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _geometry(n, r):
    lo, w_lo, _ = jski.make_inducing(n, r)
    return np.asarray(lo), np.asarray(w_lo)


# ----------------------------------------------------------------- short conv
def _conv_grads(x, f, g, lf):
    """(y, dx, df) of the port's differentiable short conv at offset lf."""
    xt, ft = T(x).requires_grad_(), T(f).requires_grad_()
    y = ops.short_conv(xt, ft, False, left=lf)
    return (y, *torch.autograd.grad(y, (xt, ft), T(g)))


def _jax_conv_grads(fn, x, f, g):
    y, vjp = jax.vjp(fn, jnp.asarray(x), jnp.asarray(f))
    return (y, *vjp(jnp.asarray(g)))


@pytest.mark.parametrize("left", list(LEFTS))
@pytest.mark.parametrize("shape", list(CONV_SHAPES))
def test_short_conv_matches_jax(shape, left):
    """ShortConv's y and (dx, df) — the backward the same conv with the taps
    flipped and left mirrored, and conv_tap_grad — against the JAX
    reference (autodiff) and the Pallas kernel's custom VJP in interpret
    mode (its plain fallback for n < m)."""
    b, n, d, m = CONV_SHAPES[shape]
    rng = np.random.default_rng(b * n + d + m)
    x, f, g = _f32(rng, b, n, d), _f32(rng, d, m), _f32(rng, b, n, d)
    lf = LEFTS[left](m)
    got = _conv_grads(x, f, g, lf)
    assert got[0].shape == (b, n, d)
    names = ("y", "dx", "df")
    for name, p, q in zip(names, got, _jax_conv_grads(
            lambda x, f: jref.short_conv_left_ref(x, f, lf), x, f, g)):
        _close(p, q, what=f"{name} vs ref")
    for name, p, q in zip(names, got, _jax_conv_grads(
            lambda x, f: short_conv_pallas(x, f, False, interpret=True,
                                           left=lf), x, f, g)):
        _close(p, q, what=f"{name} vs pallas")
    # and the plain version with autograd's own backward
    _close(short_conv.short_conv(T(x), T(f), lf),
           jref.short_conv_left_ref(x, f, lf), what="kernel-level wrapper")


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "bidir"])
@pytest.mark.parametrize("shape", ["smoke", "m=32", "n<m"])
def test_short_conv_ref_matches_jax_custom_vjp(shape, causal):
    """short_conv_ref (autograd) and ops.short_conv (ShortConv) against the
    JAX ref's analytic custom VJP; ``left`` defaults to 0 / m//2."""
    b, n, d, m = CONV_SHAPES[shape]
    rng = np.random.default_rng(n + m)
    x, f, g = _f32(rng, b, n, d), _f32(rng, d, m), _f32(rng, b, n, d)
    want = _jax_conv_grads(lambda x, f: jref.short_conv_ref(x, f, causal),
                           x, f, g)
    got = _conv_grads(x, f, g, 0 if causal else m // 2)
    xt, ft = T(x).requires_grad_(), T(f).requires_grad_()
    y = ref.short_conv_ref(xt, ft, causal)
    plain = (y, *torch.autograd.grad(y, (xt, ft), T(g)))
    default = ops.short_conv(T(x), T(f), causal)
    assert torch.equal(default, got[0].detach())
    for name, p, q, w in zip(("y", "dx", "df"), got, plain, want):
        _close(p, w, what=f"ShortConv {name}")
        _close(q, w, what=f"short_conv_ref {name}")


# ---------------------------------------------------------- the interp pair
@pytest.mark.parametrize("shape", list(INTERP_SHAPES))
def test_interp_expand_matches_jax(shape):
    """y = W z: interp_expand_ref and ops.interp_expand (InterpExpand)
    against JAX ref and the Pallas kernel, forward and dz."""
    b, n, d, r = INTERP_SHAPES[shape]
    rng = np.random.default_rng(b + n + d + r)
    z, g = _f32(rng, b, r, d), _f32(rng, b, n, d)
    lo, w_lo = _geometry(n, r)
    _close(ref.interp_expand_ref(T(z), T(lo), T(w_lo)),
           jref.interp_expand_ref(z, lo, w_lo), what="ref")
    zt = T(z).requires_grad_()
    y = ops.interp_expand(zt, T(lo), T(w_lo))
    assert y.shape == (b, n, d)
    (dz,) = torch.autograd.grad(y, zt, T(g))
    for what, fn in (("ref", lambda z: jref.interp_expand_ref(z, lo, w_lo)),
                     ("pallas", lambda z: interp_expand_pallas(
                         z, lo, w_lo, interpret=True))):
        want, vjp = jax.vjp(fn, jnp.asarray(z))
        _close(y, want, what=f"y vs {what}")
        _close(dz, vjp(jnp.asarray(g))[0], what=f"dz vs {what}")


@pytest.mark.parametrize("shape", list(INTERP_SHAPES))
def test_interp_reduce_function_matches_jax(shape):
    """z = Wᵀx: ops.interp_reduce (InterpReduce) forward and dx against JAX
    ref, the Pallas kernel's custom VJP and the two-scatter oracle."""
    b, n, d, r = INTERP_SHAPES[shape]
    rng = np.random.default_rng(b * n + d * r)
    x, g = _f32(rng, b, n, d), _f32(rng, b, r, d)
    lo, w_lo = _geometry(n, r)
    xt = T(x).requires_grad_()
    z = ops.interp_reduce(xt, T(lo), T(w_lo), r)
    assert z.shape == (b, r, d)
    (dx,) = torch.autograd.grad(z, xt, T(g))
    for what, fn in (("ref", lambda x: jref.interp_reduce_ref(x, lo, w_lo, r)),
                     ("pallas", lambda x: interp_reduce_pallas(
                         x, lo, w_lo, r, interpret=True))):
        want, vjp = jax.vjp(fn, jnp.asarray(x))
        _close(z, want, what=f"z vs {what}")
        _close(dx, vjp(jnp.asarray(g))[0], what=f"dx vs {what}")
    _close(ref.interp_reduce_scatter_oracle(T(x), T(lo), T(w_lo), r),
           jref.interp_reduce_scatter_oracle(x, lo, w_lo, r), what="scatter")
    _close(z, ref.interp_reduce_scatter_oracle(T(x), T(lo), T(w_lo), r),
           what="vs scatter oracle")


@pytest.mark.parametrize("shape", ["smoke", "ragged", "r=2"])
def test_interp_pair_are_adjoint(shape):
    """<Wᵀx, z> = <x, W z> (fp64 inner products of the fp32 outputs)."""
    b, n, d, r = INTERP_SHAPES[shape]
    rng = np.random.default_rng(r)
    x, z = T(_f32(rng, b, n, d)), T(_f32(rng, b, r, d))
    lo, w_lo = (T(v) for v in _geometry(n, r))
    lhs = float((ops.interp_reduce(x, lo, w_lo, r).double()
                 * z.double()).sum())
    rhs = float((x.double() * ops.interp_expand(z, lo, w_lo).double()).sum())
    norm = float(x.double().norm() * z.double().norm())
    assert abs(lhs - rhs) <= 1e-6 * norm


# ------------------------------------------------------------- FFT matvec
@pytest.mark.parametrize("n", [1, 2, 7, 64, 257])
def test_toeplitz_matvec_matches_jax(n):
    rng = np.random.default_rng(n)
    t, tc, x = _f32(rng, 3, 2 * n - 1), _f32(rng, 3, n), _f32(rng, 2, 3, n)
    got = toeplitz.toeplitz_matvec(T(t), T(x))
    _close(got, jtoeplitz.toeplitz_matvec(t, x), what="matvec")
    dense = np.einsum("cij,bcj->bci",
                      np.asarray(toeplitz.dense_toeplitz(T(t), n)), x)
    _close(got, dense, what="vs the dense matrix")
    _close(toeplitz.toeplitz_matvec_causal(T(tc), T(x)),
           jtoeplitz.toeplitz_matvec_causal(tc, x), what="causal")
    np.testing.assert_array_equal(
        toeplitz._circulant_coeffs(T(t), n).numpy(),
        np.asarray(jtoeplitz._circulant_coeffs(t, n)))


def test_toeplitz_matvec_rejects_wrong_lags():
    with pytest.raises(ValueError, match="want 7"):
        toeplitz.toeplitz_matvec(torch.zeros(3, 6), torch.zeros(3, 4))
    with pytest.raises(ValueError, match="coefficients for n = 4"):
        toeplitz.toeplitz_matvec_causal(torch.zeros(3, 3), torch.zeros(3, 4))


# --------------------------------------------------------- the unfused op
@pytest.fixture(scope="module")
def bridged():
    """Layer 0's SKI leaves of the smoke ski-tnn-lm-wt103, JAX init, in
    both packages through the bridge."""
    jcfg = jreduce(jget_config(ARCH))
    cfg = reduce_for_smoke(get_config(ARCH))
    init = jax.jit(lambda k: unbox(jinit_model(k, jcfg))[0])
    tree = jax.tree.map(np.asarray, init(jax.random.PRNGKey(0)))
    model = bridge.params_from_jax(tree, cfg, device="cpu")
    jleaves = jax.tree.map(lambda a: jnp.asarray(a[0]),
                           tree["blocks"]["sub0"]["mixer"]["tno"])
    return cfg, model.layers[0].mixer.tno, jleaves


def _tno_cfgs(cfg, causal, fused, use_pallas=None):
    kw = dict(d=cfg.d_model, variant="ski", causal=causal, lam=cfg.tno_lam,
              rank=cfg.tno_rank, filter_size=cfg.tno_filter, fused=fused)
    return tno.TNOConfig(**kw), jtno.TNOConfig(**kw, use_pallas=use_pallas)


def _port_op_grads(params, tcfg, x, g):
    """(y, dx, dvals, dfilt) of Σ y·g through tno_plan / tno_apply."""
    xt = T(x).requires_grad_()
    leaves = (params.rpe.vals, params.filt)
    y = tno.tno_apply(params, tcfg, xt, plan=tno.tno_plan(params, tcfg,
                                                          x.shape[1]))
    return (y, *torch.autograd.grad(y, (xt, *leaves), T(g)))


def _jax_op_grads(jleaves, jcfg, x, g):
    def f(xx, p):
        return jtno.tno_apply(p, jcfg, xx, plan=jtno.tno_plan(p, jcfg,
                                                              xx.shape[1]))
    y, vjp = jax.vjp(f, jnp.asarray(x), jleaves)
    dx, dp = vjp(jnp.asarray(g))
    return y, dx, dp["rpe"]["vals"], dp["filt"]


@pytest.mark.parametrize("use_pallas", [None, True],
                         ids=["jax-default", "jax-pallas-interpret"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "bidir"])
def test_unfused_op_matches_jax(bridged, causal, use_pallas):
    """The unfused SKI-TNO of a TNN block (tno_plan / tno_apply with
    fused=False) and the gradients of every SKI leaf and of x against
    jax.grad of JAX's unfused path at 1e-5, and against the port's fused op
    at 1e-4; the plan is the unfused one (no dense Gram)."""
    cfg, params, jleaves = bridged
    tcfg, jcfg = _tno_cfgs(cfg, causal, False, use_pallas)
    assert tcfg.ski_cfg().fused is False
    plan = tno.tno_plan(params, tcfg, 40)
    assert plan["variant"] == "unfused" and "a_dense" not in plan
    rng = np.random.default_rng(17)
    x, g = _f32(rng, 2, 40, cfg.d_model), _f32(rng, 2, 40, cfg.d_model)
    names = ("y", "dx", "dvals", "dfilt")
    got = _port_op_grads(params, tcfg, x, g)
    for name, p, q in zip(names, got, _jax_op_grads(jleaves, jcfg, x, g)):
        _close(p, q, FP32, f"{name} vs JAX unfused")
    fused = _port_op_grads(params, dataclasses.replace(tcfg, fused=True), x,
                           g)
    for name, p, q in zip(names, got, fused):
        _close(p, q, FUSED, f"{name} vs the port's fused op")


@pytest.mark.parametrize("n", [5, 40, 75])
def test_unfused_plan_matches_jax(bridged, n):
    """ski_plan with fused=False: JAX's unfused plan (geometry bitwise, the
    Gram coefficients at 1e-6), and no dense Gram."""
    cfg, params, jleaves = bridged
    tcfg, jcfg = _tno_cfgs(cfg, True, False)
    plan = ski.ski_plan(params, tcfg.ski_cfg(), n, causal=True)
    jplan = jski.ski_plan(jleaves, jcfg.ski_cfg(), n, causal=True)
    assert plan["variant"] == jplan["variant"] == "unfused"
    assert "a_dense" not in plan and "a_dense" not in jplan
    assert plan["r"] == jplan["r"] and plan["h"] == jplan["h"]
    for key in ("idx_lo", "w_lo"):
        np.testing.assert_array_equal(plan[key].numpy(),
                                      np.asarray(jplan[key]))
    _close(plan["a_coef"], jplan["a_coef"], 1e-6, "a_coef")


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "bidir"])
def test_unfused_matches_fused_at_odd_n(causal):
    """The pair of tests/test_ski_fused.py: d=6, r=9, m=4, n=75 (odd),
    fused against unfused within 1e-4."""
    rng = np.random.default_rng(3)
    cfg = ski.SKIConfig(6, rank=9, filter_size=4, fused=False)
    params = ski.ski_init(cfg)
    with torch.no_grad():
        params.rpe.vals.copy_(T(0.3 * _f32(rng, 6, 129)))
        params.filt.copy_(T(0.3 * _f32(rng, 6, 4)))
    x = T(_f32(rng, 2, 75, 6))
    fused = ski.ski_tno_apply(params, dataclasses.replace(cfg, fused=True), x,
                              causal)
    np.testing.assert_allclose(
        _np(ski.ski_tno_apply(params, cfg, x, causal)), _np(fused),
        rtol=FUSED, atol=FUSED)


def test_unfused_mixer_has_the_fused_leaves():
    """A TNN block's SKI mixer with fused=False has the fused one's leaves
    (no new parameter), so the bridge and checkpoints carry it as they
    are."""
    cfg = reduce_for_smoke(get_config(ARCH))
    params = tno.tno_init(_tno_cfgs(cfg, True, False)[0])
    names = sorted(n for n, _ in params.named_parameters())
    assert names == ["filt", "rpe.vals"]


# ------------------------------------------------------- causal_ski_lowrank
@pytest.mark.parametrize("n", [32, 100])
def test_causal_ski_lowrank_matches_jax(bridged, n):
    """Appendix B's cumulative-sum action against JAX and against the
    masked dense oracle tril(W A Wᵀ) x."""
    cfg, params, jleaves = bridged
    scfg = ski.SKIConfig(cfg.d_model, rank=cfg.tno_rank,
                         filter_size=cfg.tno_filter)
    jcfg = jski.SKIConfig(cfg.d_model, rank=cfg.tno_rank,
                          filter_size=cfg.tno_filter)
    x = _f32(np.random.default_rng(n), 2, n, cfg.d_model)
    with torch.no_grad():
        got = causal_ski.causal_ski_lowrank(params, scfg, T(x))
        r = min(cfg.tno_rank, n)
        lo, w_lo, h = ski.make_inducing(n, r)
        w = ref.dense_interp_matrix(lo, w_lo, r).double()
        a = toeplitz.dense_toeplitz(
            ski.inducing_gram_coeffs(params, scfg, r, h), r).double()
        t_masked = torch.tril(torch.einsum("nr,drs,ms->dnm", w, a, w))
        oracle = torch.einsum("dnm,bmd->bnd", t_masked, T(x).double())
    _close(got, jcausal_ski.causal_ski_lowrank(jleaves, jcfg, jnp.asarray(x)),
           what="vs JAX")
    _close(got, oracle, what="vs the masked dense oracle")


# ------------------------------------------------- counters and the switch
def _unfused_grads(causal):
    rng = np.random.default_rng(21)
    cfg = ski.SKIConfig(8, rank=5, filter_size=4, fused=False)
    params = ski.ski_init(cfg)
    with torch.no_grad():
        params.rpe.vals.copy_(T(0.3 * _f32(rng, 8, 129)))
        params.filt.copy_(T(0.3 * _f32(rng, 8, 4)))
    x = T(_f32(rng, 2, 30, 8)).requires_grad_()
    y = ski.ski_tno_apply(params, cfg, x, causal)
    return torch.autograd.grad(y, (x, params.filt, params.rpe.vals),
                               T(_f32(rng, 2, 30, 8)))


FUNCTIONS = ("ShortConv", "InterpReduce", "InterpExpand")


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "bidir"])
def test_unfused_counters_and_reference_switch(monkeypatch, causal):
    """Each of the three Functions counts one differentiated forward and one
    kernel backward an op; REPRO_PALLAS_GRAD=0 gives one reference backward
    each and the same gradients. The CPU path launches no kernel."""
    ops.reset_ski_counters()
    kernel = _unfused_grads(causal)
    counts = ops.ski_op_counters()
    assert counts["SKIFusedTNO"] == {"fwd": 0, "bwd_kernel": 0, "bwd_ref": 0}
    for name in FUNCTIONS:
        assert counts[name] == {"fwd": 1, "bwd_kernel": 1, "bwd_ref": 0}, name
    monkeypatch.setenv("REPRO_PALLAS_GRAD", "0")
    ops.reset_ski_counters()
    reference = _unfused_grads(causal)
    counts = ops.ski_op_counters()
    for name in FUNCTIONS:
        assert counts[name] == {"fwd": 1, "bwd_kernel": 0, "bwd_ref": 1}, name
    for name, p, q in zip(("dx", "dfilt", "dvals"), reference, kernel):
        _close(p, q, FP32, name)
    assert not any(ops.ski_counters().values())


def test_inference_counts_no_differentiated_forward():
    x = torch.randn(2, 16, 4, requires_grad=True)
    f = torch.randn(4, 3)
    lo, w_lo, _ = ski.make_inducing(16, 5)
    ops.reset_ski_counters()
    with torch.inference_mode():
        outs = (ops.short_conv(x, f, True), ops.interp_reduce(x, lo, w_lo, 5),
                ops.interp_expand(torch.randn(2, 5, 4, requires_grad=True),
                                  lo, w_lo))
    assert all(o.grad_fn is None for o in outs)
    assert all(c == {"fwd": 0, "bwd_kernel": 0, "bwd_ref": 0}
               for c in ops.ski_op_counters().values())


# ------------------------------------------------ wrappers off the CPU path
def test_new_wrappers_refuse_off_the_cpu():
    """Off the CPU the kernel-level wrappers launch their kernel or raise:
    another device is refused, and so is an input that requires grad (the
    kernel on its own is forward-only); the ops entries are differentiable
    (their Functions), so with grad they reach the device check."""
    x = torch.empty(2, 16, 8, device="meta")
    z = torch.empty(2, 4, 8, device="meta")
    f = torch.empty(8, 3, device="meta")
    lo = torch.zeros(16, dtype=torch.int32)
    with pytest.raises(ValueError, match="tensor on meta"):
        short_conv.short_conv(x, f, 1)
    with pytest.raises(ValueError, match="tensor on meta"):
        interp_matvec.interp_expand(z, lo, None)
    with pytest.raises(NotImplementedError, match="forward-only"):
        short_conv.short_conv(x, f.clone().requires_grad_(), 1)
    with pytest.raises(NotImplementedError, match="forward-only"):
        interp_matvec.interp_expand(z.clone().requires_grad_(), lo, None)
    with pytest.raises(ValueError, match="tensor on meta"):
        ops.short_conv(x, f.clone().requires_grad_(), True)
    with pytest.raises(ValueError, match="tensor on meta"):
        ops.interp_expand(z.clone().requires_grad_(), lo, None)
    with pytest.raises(ValueError, match="left=3 outside"):
        short_conv.short_conv(torch.zeros(1, 4, 2), torch.zeros(2, 3), 3)
