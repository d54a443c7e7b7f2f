"""Port parity for bf16 SKI on the routes past the dense one: the
large-rank "windowed" and "fft" routes (the windowed pass 2 and the
expand pass 2 in bf16, ``SKIFusedTNOCoef``), the unfused route
(``interp_expand`` in bf16, ``ski_tno_apply`` with ``fused=False``) and the
bf16 smoke ``ski-tnn-lm-wt103`` routed to both coefficient routes, against
the JAX package, which runs every SKI route in bf16 with fp32 sums
(``tests/test_ski_large_r.py::test_coef_op_bf16_parity``). The same numpy
inputs, rounded to bf16, go through the JAX function (its jnp reference,
and small cases of its Pallas kernels in interpret mode) and the port's
counterpart, which on the CPU runs the plain versions that the bf16 CUDA
instances (``ski_windowed_pass2_bf16``, ``ski_expand_pass2_bf16``,
``interp_expand_bf16``) are held against on the card (``chip_smoke.py``
phase ``ski_bf16``). The last tests hold the CPU model of the windowed
kernel's tensor-core Gram (``test_torch_ski_windowed_tc.py``) to the bf16
instance's two TF32 products.

Tolerances, each with its reason (those of ``test_torch_ski_bf16.py``):
* ``BF16_TOL`` = 1e-2 × max|reference| for an output rounded to bf16 from
  fp32 sums: both sides sum the same bf16 values in fp32, in another
  order, and round once, so they differ by about one bf16 ulp (2^-8 of
  the value) where the two sums straddle a rounding;
* the ops' cotangents at ``GRAD_TOL`` = 2e-2 relative to max|reference|,
  JAX's own ``TOL[bf16]`` (``tests/test_ski_grad.py``);
* the bf16 smoke model: 2e-2 of the quantity's scale, or twice JAX's own
  bf16-vs-fp32 distance on the same bf16-valued weights where that is
  larger (the rule of ``tests/test_torch_zoo.py``); logits by max|diff|,
  a gradient leaf by its relative L2 distance;
* the CPU model of the Gram: bitwise (two products against three on a
  bf16 z, whose lo half is zero), and ``_window_tol`` of float64.

Tests that run a Pallas kernel in interpret mode keep n <= 256 and run
under :func:`_time_limit`.
"""
import contextlib
import dataclasses
import signal

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
from repro.models.context import Ctx  # noqa: E402
from repro.models.transformer import forward as jforward  # noqa: E402
from repro.models.transformer import init_model as jinit_model  # noqa: E402
from repro.models.transformer import loss_fn as jloss_fn  # noqa: E402
from repro.nn.layers import cast_params as jcast_params  # noqa: E402
from repro.nn.params import unbox  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config, reduce_for_smoke  # noqa: E402
from repro_torch.core import ski  # noqa: E402
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.kernels import (backend, interp_matvec, ops,  # noqa: E402
                                 ski_fused, ski_vjp)
from repro_torch.launch.steps import loss_and_grads  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.nn.layers import cast_params  # noqa: E402
from test_torch_ski_windowed_tc import (_float64, _inputs,  # noqa: E402
                                        _kernel_model, _tf32, _window_tol)

torch.set_num_threads(1)
ARCH = "ski-tnn-lm-wt103"
BF16_TOL = 1e-2
GRAD_TOL = 2e-2
MODEL_TOL = 2e-2
#: seconds a test that runs a Pallas kernel in interpret mode may take
INTERPRET_LIMIT = 60
VARIANTS = ("windowed", "fft")
# (b, n, d, r, m): ragged n, d and r; a narrow large-rank shape (r = n / 2,
# the model's m)
PASS2_SHAPES = {"ragged": (3, 37, 45, 11, 4), "n256": (2, 256, 16, 128, 32)}
# interp_expand (b, n, d, r): d % 8 (the kernel's 16-byte lanes) with
# r = n, d % 4 only (8-byte lanes), odd d (one channel a lane) with r = 2
EXPAND_SHAPES = {"d%8 r=n": (2, 24, 16, 24), "d%4": (2, 77, 12, 20),
                 "odd d r=2": (3, 37, 45, 2)}


@contextlib.contextmanager
def _time_limit(seconds: int):
    """Raise TimeoutError in the block after ``seconds`` (SIGALRM)."""
    def expire(signum, frame):
        raise TimeoutError(f"over the {seconds} s limit")
    old = signal.signal(signal.SIGALRM, expire)
    signal.alarm(seconds)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a, dtype=np.float32)


def _rel(got, want) -> float:
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-30))


def _rel_l2(got, want) -> float:
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.linalg.norm(got - want) / (np.linalg.norm(want) + 1e-30))


def _close(got, want, tol, what=""):
    err = _rel(got, want)
    assert err <= tol, f"{what}: max abs err {err:.3e} of the scale > {tol}"


def _bf16(rng, *shape, scale=1.0):
    """bf16 numpy values (ml_dtypes) and the same values as a torch bf16
    tensor."""
    a = (rng.standard_normal(shape) * scale).astype(jnp.bfloat16)
    return a, bridge._tensor(a, "cpu")


def _f32(rng, *shape, scale=1.0):
    a = (rng.standard_normal(shape) * scale).astype(np.float32)
    return a, torch.from_numpy(a.copy())


def _geometry(n, r):
    lo, w_lo, _ = jski.make_inducing(n, r)
    lo, w_lo = np.asarray(lo), np.asarray(w_lo)
    return lo, w_lo, torch.from_numpy(lo.copy()), torch.from_numpy(w_lo.copy())


# ------------------------------------------------- the windowed pass 2s
def _pass2_inputs(shape, seed):
    """x, z (z₂) and the taps bf16, the coefficients fp32 / sqrt(r), as the
    bf16 model hands them to pass 2."""
    b, n, d, r, m = PASS2_SHAPES[shape]
    rng = np.random.default_rng(seed)
    x, xt = _bf16(rng, b, n, d)
    z, zt = _bf16(rng, b, r, d)
    c, ct = _f32(rng, d, 2 * r - 1, scale=1 / np.sqrt(r))
    f, ft = _bf16(rng, d, m)
    return (x, z, c, f), (xt, zt, ct, ft)


def _jax_pass2(variant, x, z, c, f, causal, left):
    def pass2(x, z, c, f):
        z2 = z if variant == "fft" else jref.toeplitz_gram_matvec_ref(c, z)
        return jref.ski_expand_pass2_ref(x, z2, f, causal, left=left)
    return jax.jit(pass2)(*map(jnp.asarray, (x, z, c, f)))


def _port_pass2(variant, x, z, c, f, causal, left):
    if variant == "windowed":
        return ski_fused.ski_windowed_pass2(x, z, c, f, causal, left=left)
    return ski_fused.ski_expand_pass2(x, z, f, causal, left=left)


@pytest.mark.parametrize("orientation", ["forward", "backward"])
@pytest.mark.parametrize("shape", list(PASS2_SHAPES))
@pytest.mark.parametrize("variant", VARIANTS)
def test_window_pass2_bf16_matches_jax(variant, shape, orientation):
    """The windowed pass 2 (from the coefficients) and the expand pass 2
    (from z₂) in bf16 against JAX's reference, in the forward's
    orientation (left 0 causal) and the backward's (coefficients
    lag-flipped, taps flipped, left mirrored), y bf16."""
    (x, z, c, f), (xt, zt, ct, ft) = _pass2_inputs(shape, seed=11)
    m = f.shape[-1]
    left = 0
    if orientation == "backward":
        c, f = c[:, ::-1].copy(), f[:, ::-1].copy()
        ct, ft = ct.flip(-1), ft.flip(-1)
        left = m - 1
    got = _port_pass2(variant, xt, zt, ct, ft, True, left)
    assert got.dtype == torch.bfloat16
    want = _jax_pass2(variant, x, z, c, f, True, left)
    assert want.dtype == jnp.bfloat16
    _close(got, want, BF16_TOL, f"{variant} pass 2 vs JAX ref")


@pytest.mark.parametrize("variant", VARIANTS)
def test_window_pass2_bf16_matches_pallas_interpret(variant):
    """The same at n = 256 (bidirectional taps) against JAX's Pallas kernel
    in interpret mode, on bf16 tiles."""
    (x, z, c, f), (xt, zt, ct, ft) = _pass2_inputs("n256", seed=12)
    args = tuple(map(jnp.asarray, (x, z, c, f)))
    with _time_limit(INTERPRET_LIMIT):
        if variant == "windowed":
            want = ski_windowed_pass2_pallas(*args, False, interpret=True)
        else:
            want = ski_expand_pass2_pallas(args[0], args[1], args[3], False,
                                           interpret=True)
    assert want.dtype == jnp.bfloat16
    got = _port_pass2(variant, xt, zt, ct, ft, False, None)
    _close(got, want, BF16_TOL, f"{variant} pass 2 vs Pallas interpret")


# ---------------------------------------------------- the coefficient op
def _op_inputs(seed, n=96, d=8, r=40, m=6, filt_dtype=jnp.bfloat16):
    """x bf16 (2, n, d), the coefficients fp32 × 0.05 and the taps × 0.1,
    as tests/test_ski_large_r.py::test_coef_op_bf16_parity draws them."""
    rng = np.random.default_rng(seed)
    x, xt = _bf16(rng, 2, n, d)
    c, ct = _f32(rng, d, 2 * r - 1, scale=0.05)
    if filt_dtype == jnp.bfloat16:
        f, ft = _bf16(rng, d, m, scale=0.1)
    else:
        f, ft = _f32(rng, d, m, scale=0.1)
    return (x, c, f), (xt, ct, ft), r


def _port_coef(ts, lo_t, w_t, r, causal, variant):
    leaves = [t.clone().requires_grad_() for t in ts]
    y = ops.ski_fused_tno_coef(*leaves, lo_t, w_t, r, causal, variant)
    grads = torch.autograd.grad(torch.sin(y.float()).sum(), leaves)
    return y.detach(), grads


def _jax_coef(arrs, lo, w_lo, r, causal, variant, **kw):
    """JAX's y and jax.grad of Σ sin(y), one jit."""
    def loss(x, c, f):
        y = jops.ski_fused_tno_coef(x, c, f, lo, w_lo, r, causal, variant,
                                    **kw)
        return jnp.sum(jnp.sin(y.astype(jnp.float32))), y
    (_, y), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True))(*map(jnp.asarray, arrs))
    return y, grads


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "bidir"])
@pytest.mark.parametrize("variant", VARIANTS)
def test_coef_op_bf16_matches_jax(variant, causal):
    """``ops.ski_fused_tno_coef`` on a bf16 x (here the plain versions,
    through SKIFusedTNOCoef's kernel-structured backward: interp_reduce
    three times, pass 2 both ways, gram_coef_grad_fft, conv_tap_grad):
    y within BF16_TOL and (dx, dcoef, df) within GRAD_TOL of JAX's
    reference op and jax.grad; the cotangents in the primal dtypes; one
    differentiated forward and one kernel backward."""
    arrs, ts, r = _op_inputs(seed=21)
    lo, w_lo, lo_t, w_t = _geometry(arrs[0].shape[1], r)
    ski_vjp.reset_counters()
    y, got = _port_coef(ts, lo_t, w_t, r, causal, variant)
    assert ski_vjp.coef_counters == {"fwd": 1, "bwd_kernel": 1, "bwd_ref": 0}
    assert y.dtype == torch.bfloat16
    assert [g.dtype for g in got] == [t.dtype for t in ts]
    jy, want = _jax_coef(arrs, lo, w_lo, r, causal, variant,
                         use_pallas=False)
    assert jy.dtype == jnp.bfloat16
    _close(y, jy, BF16_TOL, "y vs JAX ref")
    for name, p, q in zip(("dx", "dcoef", "df"), got, want):
        assert str(p.dtype) == f"torch.{q.dtype}", name
        _close(p, q, GRAD_TOL, f"{name} vs jax.grad of the reference")


@pytest.mark.parametrize("variant", VARIANTS)
def test_coef_op_bf16_matches_pallas_vjp(variant):
    """The same, bidirectional, fp32 taps beside the bf16 x, against JAX's
    Pallas custom VJP in interpret mode (its windowed or expand kernel
    both ways)."""
    arrs, ts, r = _op_inputs(seed=22, n=64, r=24, filt_dtype=np.float32)
    lo, w_lo, lo_t, w_t = _geometry(arrs[0].shape[1], r)
    y, got = _port_coef(ts, lo_t, w_t, r, False, variant)
    with _time_limit(INTERPRET_LIMIT):
        jy, want = _jax_coef(arrs, lo, w_lo, r, False, variant,
                             use_pallas=True, interpret=True)
    _close(y, jy, BF16_TOL, "y vs Pallas interpret")
    for name, p, q in zip(("dx", "dcoef", "df"), got, want):
        _close(p, q, GRAD_TOL, f"{name} vs the Pallas VJP")


# -------------------------------------------------------- interp_expand
@pytest.mark.parametrize("shape", list(EXPAND_SHAPES))
def test_interp_expand_bf16_matches_jax(shape):
    """y = W z in bf16 (fp32 arithmetic, y rounded once) against JAX's
    ``ops.interp_expand`` on its reference path."""
    b, n, d, r = EXPAND_SHAPES[shape]
    z, zt = _bf16(np.random.default_rng(n + r), b, r, d)
    lo, w_lo, lo_t, w_t = _geometry(n, r)
    got = interp_matvec.interp_expand(zt, lo_t, w_t)
    assert got.dtype == torch.bfloat16 and got.shape == (b, n, d)
    want = jops.interp_expand(jnp.asarray(z), lo, w_lo, use_pallas=False)
    assert want.dtype == jnp.bfloat16
    _close(got, want, BF16_TOL, "interp_expand vs JAX ref")


def test_interp_expand_bf16_matches_pallas_interpret():
    """At n = 256 against JAX's Pallas kernel in interpret mode."""
    z, zt = _bf16(np.random.default_rng(3), 2, 33, 128)
    lo, w_lo, lo_t, w_t = _geometry(256, 33)
    with _time_limit(INTERPRET_LIMIT):
        want = jops.interp_expand(jnp.asarray(z), lo, w_lo, use_pallas=True,
                                  interpret=True)
    assert want.dtype == jnp.bfloat16
    _close(interp_matvec.interp_expand(zt, lo_t, w_t), want, BF16_TOL,
           "interp_expand vs Pallas interpret")


# ------------------------------------------------------- the unfused route
def _ski_pair(d, r, m, seed, fused=False):
    """The port's and JAX's SKI parameters holding the same bf16 values
    (RPE values and taps N(0, 0.5²)), the port's through cast_params."""
    cfg = ski.SKIConfig(d=d, rank=r, filter_size=m, fused=fused)
    jcfg = jski.SKIConfig(d, rank=r, filter_size=m, fused=fused)
    rng = np.random.default_rng(seed)
    vals, vt = _bf16(rng, d, cfg.grid_size, scale=0.5)
    filt, ft = _bf16(rng, d, m, scale=0.5)
    params = cast_params(ski.ski_init(cfg, device="cpu"), torch.bfloat16)
    with torch.no_grad():
        params.rpe.vals.copy_(vt)
        params.filt.copy_(ft)
    return cfg, jcfg, params, {"rpe": {"vals": jnp.asarray(vals)},
                               "filt": jnp.asarray(filt)}


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "bidir"])
def test_unfused_bf16_matches_jax(causal):
    """``ski_tno_apply`` with ``fused=False`` on a bf16 x and bf16 leaves
    (interp_reduce, the short conv, the fp32 rfft Gram returning bf16,
    interp_expand; each op's own backward): y within BF16_TOL and the
    gradients for x, the taps and the RPE values within GRAD_TOL of JAX's
    unfused path and jax.grad; y and every gradient bf16."""
    n, d = 64, 8
    cfg, jcfg, params, jparams = _ski_pair(d, 12, 6, seed=31)
    x, xt = _bf16(np.random.default_rng(32), 2, n, d)
    xt.requires_grad_()
    plan = ski.ski_plan(params, cfg, n, causal)
    assert plan["variant"] == "unfused"
    y = ski.ski_tno_apply(params, cfg, xt, causal, plan=plan)
    assert y.dtype == torch.bfloat16
    leaves = (xt, params.filt, params.rpe.vals)
    got = torch.autograd.grad(torch.sin(y.float()).sum(), leaves)
    assert all(g.dtype == torch.bfloat16 for g in got)

    def loss(p, v):
        out = jski.ski_tno_apply(p, jcfg, v, causal)
        return jnp.sum(jnp.sin(out.astype(jnp.float32))), out
    (_, want_y), (gp, gx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(jparams, jnp.asarray(x))
    assert want_y.dtype == jnp.bfloat16
    _close(y, want_y, BF16_TOL, "y vs JAX")
    for name, p, q in zip(("dx", "dfilt", "dvals"), got,
                          (gx, gp["filt"], gp["rpe"]["vals"])):
        _close(p, q, GRAD_TOL, f"{name} vs jax.grad")


# ---------------------------------------------------------------- refusals
def test_bf16_routes_refuse_wrong_dtypes_off_the_cpu():
    """Off the CPU the three bf16 instances' wrappers reach the device
    check, as the card would launch them; x and z of different dtypes, a
    dtype other than fp32 and bf16, and the unfused route's bf16 x beside
    fp32 taps still raise a TypeError, before any launch."""
    bf = dict(dtype=torch.bfloat16, device="meta")
    x, z = torch.empty(2, 16, 8, **bf), torch.empty(2, 4, 8, **bf)
    f, coef = torch.empty(8, 3, **bf), torch.empty(8, 7, device="meta")
    lo = torch.zeros(16, dtype=torch.int32)
    for call in (lambda: interp_matvec.interp_expand(z, lo, None),
                 lambda: ski_fused.ski_windowed_pass2(x, z, coef, f, True),
                 lambda: ski_fused.ski_expand_pass2(x, z, f, True)):
        with pytest.raises(ValueError, match="tensor on meta"):
            call()
    half = torch.empty(2, 16, 8, dtype=torch.float16, device="meta")
    z32 = torch.empty(2, 4, 8, device="meta")
    for call in (lambda: interp_matvec.interp_expand(half[:, :4], lo, None),
                 lambda: ski_fused.ski_windowed_pass2(half, z, coef, f, True),
                 lambda: ski_fused.ski_expand_pass2(x, z32, f, True)):
        with pytest.raises(TypeError):
            call()
    cfg = ski.SKIConfig(d=8, rank=4, filter_size=3, fused=False)
    params = ski.ski_init(cfg, device="meta")
    ops.reset_ski_counters()
    with pytest.raises(TypeError, match="one dtype"):
        ski.ski_tno_apply(params, cfg, x, causal=True)
    assert not any(ops.ski_counters().values())
    assert {"interp_expand_bf16", "ski_windowed_pass2_bf16",
            "ski_expand_pass2_bf16"} <= set(ops.ski_counters())


# ------------------------------------------- the bf16 smoke model, routed
def _jax_run(jcfg, params, batch, cfg):
    """JAX's logits, loss and gradients (under the port's leaf names), one
    jit."""
    def loss(q):
        logits, _ = jforward(q, jcfg, Ctx(), {"tokens": batch["tokens"]})
        return jloss_fn(q, jcfg, Ctx(), batch)[0], logits
    (value, logits), grads = jax.jit(jax.value_and_grad(
        loss, has_aux=True))(params)
    return (np.asarray(logits, np.float32), float(value),
            bridge._port_leaves(jax.tree.map(np.asarray, grads), cfg))


@pytest.fixture(scope="module")
def smoke():
    """JAX's smoke ski-tnn-lm-wt103 parameters through ``cast_params``
    (bf16), the port's bridged bf16 model, a batch, and JAX's fp32 run on
    the same bf16-valued weights (the noise floor of the bf16 rule). The
    floor is taken once, on the default (dense) route: in fp32 the three
    routes compute one operator to 1e-5 (``test_torch_ski_large_r.py``),
    far below the bf16 distances it measures."""
    bf = dict(dtype="bfloat16", param_dtype="bfloat16")
    jcfg = dataclasses.replace(jreduce(jget_config(ARCH)), **bf)
    jcfg32 = dataclasses.replace(jcfg, dtype="float32", param_dtype="float32")
    cfg = dataclasses.replace(reduce_for_smoke(get_config(ARCH)), **bf)
    init = jax.jit(lambda k: unbox(jinit_model(k, jcfg))[0])
    params = jcast_params(init(jax.random.PRNGKey(0)), jnp.bfloat16)
    params32 = jax.tree.map(lambda a: a.astype(jnp.float32), params)
    batch = pipeline.batch_at(pipeline.DataConfig(
        vocab=cfg.vocab, seq_len=32, global_batch=2, seed=4), 0)
    tree = jax.tree.map(np.asarray, params)
    model = bridge.params_from_jax(tree, cfg, device="cpu",
                                   dtype=torch.bfloat16)
    return dict(jcfg=jcfg, cfg=cfg, params=params, batch=batch, model=model,
                floor=_jax_run(jcfg32, params32, batch, cfg))


def _limit(want, want32, dist=_rel) -> float:
    return max(MODEL_TOL, 2 * dist(want32, want))


@pytest.mark.parametrize("variant", VARIANTS)
def test_bf16_smoke_model_on_the_coef_routes_matches_jax(monkeypatch, smoke,
                                                         variant):
    """The bf16 smoke model (r = 8) routed to "windowed" by
    REPRO_SKI_DENSE_RMAX=4, and to "fft" by REPRO_SKI_WINDOWED_RMAX=4 as
    well (both packages read them): logits, loss and every gradient leaf
    (bf16) against JAX's forward and jax.grad of its loss_fn on the same
    route, each within the zoo's bf16 rule; one SKIFusedTNOCoef forward
    and kernel backward a layer, no SKIFusedTNO."""
    s = smoke
    cfg, batch = s["cfg"], s["batch"]
    monkeypatch.setenv("REPRO_SKI_DENSE_RMAX", "4")
    if variant == "fft":
        monkeypatch.setenv("REPRO_SKI_WINDOWED_RMAX", "4")
    assert (backend.ski_rank_variant(cfg.tno_rank, cfg.d_model)
            == jbackend.ski_rank_variant(cfg.tno_rank, cfg.d_model)
            == variant)

    jl, jloss, jg = _jax_run(s["jcfg"], s["params"], batch, cfg)
    jl32, jloss32, jg32 = s["floor"]
    tbatch = {k: torch.from_numpy(np.asarray(v)).long()
              for k, v in batch.items()}
    with torch.no_grad():
        logits = transformer.forward(s["model"], cfg, tbatch["tokens"])
    assert logits.dtype == torch.bfloat16
    _close(logits, jl, _limit(jl, jl32), "logits")
    ski_vjp.reset_counters()
    loss, _, grads = loss_and_grads(s["model"], cfg, tbatch)
    assert ski_vjp.coef_counters == {"fwd": cfg.n_layers,
                                     "bwd_kernel": cfg.n_layers, "bwd_ref": 0}
    assert ski_vjp.counters == {"fwd": 0, "bwd_kernel": 0, "bwd_ref": 0}
    tol = max(MODEL_TOL, 2 * abs(jloss32 - jloss) / abs(jloss))
    assert abs(float(loss) - jloss) <= tol * abs(jloss), (float(loss), jloss)
    assert set(grads) == set(jg)
    for k, g in grads.items():
        assert g.dtype == torch.bfloat16, k
        err, lim = _rel_l2(g, jg[k]), _limit(jg[k], jg32[k], _rel_l2)
        assert err <= lim, f"{k}: relative L2 distance {err:.3e} > {lim:.3e}"


# ------------------------------ the tensor-core Gram's two bf16 products
def test_bf16_values_are_tf32_values():
    """Every finite bf16 value, widened to fp32, passes through the
    kernel's TF32 rounding unchanged (8 significant bits of TF32's 11, the
    same exponent range): a bf16 z's lo half is zero."""
    bits = torch.arange(-32768, 32768, dtype=torch.int32).to(torch.int16)
    v = bits.view(torch.bfloat16).float()
    v = v[torch.isfinite(v)]
    assert v.numel() == 65536 - 2 * 128   # a sign: an inf, 127 NaNs
    hi = _tf32(v)
    assert torch.equal(hi.view(torch.int32), v.view(torch.int32))
    assert bool((_tf32(v - hi) == 0).all())


@pytest.mark.parametrize("label,b,n,d,r,m,left", [
    ("path", 8, 512, 16, 512, 32, 0), ("r=181", 8, 512, 16, 181, 32, 16),
    ("r<16", 2, 40, 8, 11, 4, 2)], ids=["path", "r=181", "r<16"])
def test_two_tf32_products_equal_three_on_bf16_z(label, b, n, d, r, m, left):
    """On a bf16 z (x and the taps bf16 too) the bf16 instance's two TF32
    products (hi·hi, lo·hi) give the three-product Gram's sums bit for
    bit, and so its window tier against float64."""
    tn, bw = backend.band_fit(128, n, r)
    xn, zn, cn, fn = _inputs(b, n, d, r, m, seed=r + left)
    x, z, f = (torch.from_numpy(a).to(torch.bfloat16).float()
               for a in (xn, zn, fn))
    coef = torch.from_numpy(cn)
    two = _kernel_model(x, z, coef, f, left, tn, bw, products=2)
    three = _kernel_model(x, z, coef, f, left, tn, bw, products=3)
    assert torch.equal(two, three)
    want = _float64(x, z, coef, f, left)
    err = float((two.double() - want).abs().max())
    assert err <= _window_tol(r) * float(want.abs().max()), (err, label)
