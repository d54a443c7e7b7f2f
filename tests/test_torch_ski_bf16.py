"""Port parity for bf16 SKI (the dense route: ``interp_reduce``, the dense
pass 2, ``gram_grad``, ``SKIFusedTNO`` and the ``ski-tnn-lm-wt103`` model
with ``nn.layers.cast_params``) against the JAX package, which runs every
SKI kernel in bf16 with fp32 sums (``tests/test_kernels.py``,
``tests/test_ski_fused.py``, ``tests/test_ski_grad.py``). The same numpy
inputs, rounded to bf16, go through the JAX function (its jnp reference,
and one small case of each Pallas kernel in interpret mode) and the
port's counterpart, which on the CPU runs the plain versions that the bf16
CUDA instances are held against on the card (``chip_smoke.py`` phase
``ski_bf16``).

Tolerances, each with its reason:
* ``BF16_TOL`` = 1e-2 × max|reference| for an output rounded to bf16 from
  fp32 sums (z, y): both sides sum the same bf16 values in fp32, in
  another order, and round once, so they differ by one bf16 ulp (2^-8 of
  the value) where the two sums straddle a rounding. JAX's plain pass 2
  also rounds the short conv to bf16 before it adds it (its
  ``ski_expand_pass2_ref`` calls ``short_conv_ref``); the port's plain
  version and its kernel round once, as JAX's Pallas kernel does: about
  one more ulp of the conv term;
* ``gram_grad`` at 1e-5 × max, the fp32 tier: the products of bf16 values
  are exact in fp32, and only the order of the b-term sums differs;
* ``SKIFusedTNO``'s cotangents at 2e-2 relative to max|reference|, JAX's
  own ``TOL[bf16]`` for its kernel VJP against its reference
  (``tests/test_ski_grad.py``);
* the bf16 smoke model (logits, loss, every gradient leaf): 2e-2 of the
  quantity's scale, or twice the distance between JAX's bf16 run and
  JAX's fp32 run on the same (bf16-valued) weights where that is larger,
  the rule of ``tests/test_torch_zoo.py``: the two packages round to bf16
  at other places (XLA fuses elementwise chains in fp32), so they differ
  by about each one's own bf16 noise. Logits by max|diff| over max|JAX|;
  a gradient leaf by its relative L2 distance (|diff| / |JAX|), which
  averages the rounding noise of the leaf's elements: measured 0.52-0.69
  of the limit on every leaf, where max|diff| over max|g|, the extreme of
  a few thousand noisy elements, ranged 0.40-0.93 of its own;
* ``mixer_apply`` with fp32 leaves: bitwise against the expression it
  replaced, ``gtu_apply(..., x.float()).to(x.dtype)``.

Tests that run a Pallas kernel in interpret mode run under
:func:`_time_limit`.
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
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.ski_grad import gram_grad_pallas  # noqa: E402
from repro.models.context import Ctx  # noqa: E402
from repro.models.transformer import forward as jforward  # noqa: E402
from repro.models.transformer import init_model as jinit_model  # noqa: E402
from repro.models.transformer import loss_fn as jloss_fn  # noqa: E402
from repro.nn.layers import cast_params as jcast_params  # noqa: E402
from repro.nn.params import unbox  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config, reduce_for_smoke  # noqa: E402
from repro_torch.core import ski  # noqa: E402
from repro_torch.core.block import gtu_apply  # noqa: E402
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.kernels import (interp_matvec, ops, ref,  # noqa: E402
                                 ski_fused, ski_grad, ski_vjp)
from repro_torch.launch.steps import loss_and_grads  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.models.transformer import forward, init_model  # noqa: E402
from repro_torch.nn.layers import cast_params  # noqa: E402

torch.set_num_threads(1)
ARCH = "ski-tnn-lm-wt103"
BF16_TOL = 1e-2
FP32 = 1e-5
GRAD_TOL = 2e-2
MODEL_TOL = 2e-2
#: seconds a test that runs a Pallas kernel in interpret mode may take
INTERPRET_LIMIT = 60

# tests/test_kernels.py:57's interp_reduce shapes (b, n, d, r)
REDUCE_SHAPES = {"n256r9": (1, 256, 128, 9), "n512r33": (2, 512, 128, 33),
                 "n512r65": (2, 512, 256, 65), "n2048r17": (1, 2048, 128, 17)}
# tests/test_ski_fused.py:109's pass-2 shapes (b, n, d, r, m)
PASS2_SHAPES = {"n128": (1, 128, 128, 16, 8), "ragged": (1, 100, 136, 17, 8)}
# tests/test_ski_grad.py:46's SKIFusedTNO shapes (n, d, r, m), b = 2
OP_SHAPES = {"n64": (64, 16, 9, 6), "ragged": (75, 20, 11, 4)}


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


# ------------------------------------------------------ the plain versions
@pytest.mark.parametrize("shape", list(REDUCE_SHAPES))
def test_interp_reduce_bf16_matches_jax(shape):
    """z = Wᵀx in bf16 (fp32 sums, z rounded once to bf16) against JAX's
    ``ops.interp_reduce`` on its reference path."""
    b, n, d, r = REDUCE_SHAPES[shape]
    x, xt = _bf16(np.random.default_rng(b * n + r), b, n, d)
    lo, w_lo, lo_t, w_t = _geometry(n, r)
    got = interp_matvec.interp_reduce(xt, lo_t, w_t, r)
    assert got.dtype == torch.bfloat16 and got.shape == (b, r, d)
    want = jops.interp_reduce(jnp.asarray(x), lo, w_lo, r, use_pallas=False)
    assert want.dtype == jnp.bfloat16
    _close(got, want, BF16_TOL, "interp_reduce vs JAX ref")


def test_interp_reduce_bf16_matches_pallas_interpret():
    """The smallest of the shapes above against JAX's Pallas kernel in
    interpret mode, on bf16 tiles."""
    b, n, d, r = REDUCE_SHAPES["n256r9"]
    x, xt = _bf16(np.random.default_rng(5), b, n, d)
    lo, w_lo, lo_t, w_t = _geometry(n, r)
    with _time_limit(INTERPRET_LIMIT):
        want = jops.interp_reduce(jnp.asarray(x), lo, w_lo, r,
                                  use_pallas=True, interpret=True)
    assert want.dtype == jnp.bfloat16
    _close(interp_matvec.interp_reduce(xt, lo_t, w_t, r), want, BF16_TOL,
           "interp_reduce vs Pallas interpret")


def _pass2_inputs(shape, seed, filt_dtype=jnp.bfloat16):
    b, n, d, r, m = PASS2_SHAPES[shape]
    rng = np.random.default_rng(seed)
    x, xt = _bf16(rng, b, n, d)
    z, zt = _bf16(rng, b, r, d)
    a, at = _f32(rng, d, r, r)
    if filt_dtype == jnp.bfloat16:
        f, ft = _bf16(rng, d, m)
    else:
        f, ft = _f32(rng, d, m)
    return (x, z, a, f), (xt, zt, at, ft)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "bidir"])
@pytest.mark.parametrize("shape", list(PASS2_SHAPES))
def test_dense_pass2_bf16_matches_jax(shape, causal):
    """y = W (A z) + T_sparse x with x, z and the taps bf16 and A fp32, in
    both orientations (Aᵀ read in place, as the signal backward runs it),
    against JAX's reference pass 2 (with A transposed for the second)."""
    (x, z, a, f), (xt, zt, at, ft) = _pass2_inputs(shape, seed=7)
    got = ski_fused.ski_fused_pass2(xt, zt, at, ft, causal)
    assert got.dtype == torch.bfloat16
    want = jops.ski_fused_pass2(jnp.asarray(x), jnp.asarray(z),
                                jnp.asarray(a), jnp.asarray(f), causal,
                                use_pallas=False)
    assert want.dtype == jnp.bfloat16
    _close(got, want, BF16_TOL, "pass 2 vs JAX ref")
    m = f.shape[-1]
    left = m - 1 - (0 if causal else m // 2)
    got_t = ski_fused.ski_fused_pass2(xt, zt, at, ft.flip(-1), causal,
                                      left=left, transpose_a=True)
    want_t = jref.ski_fused_pass2_ref(
        jnp.asarray(x), jnp.asarray(z), jnp.asarray(a).transpose(0, 2, 1),
        jnp.asarray(f)[:, ::-1], causal, left=left)
    _close(got_t, want_t, BF16_TOL, "pass 2 with Aᵀ vs JAX ref")


def test_dense_pass2_bf16_matches_pallas_interpret():
    """A small pass 2 (bf16 x, z, taps; fp32 A) against JAX's Pallas kernel
    in interpret mode."""
    (x, z, a, f), (xt, zt, at, ft) = _pass2_inputs("n128", seed=8)
    with _time_limit(INTERPRET_LIMIT):
        want = jops.ski_fused_pass2(jnp.asarray(x), jnp.asarray(z),
                                    jnp.asarray(a), jnp.asarray(f), False,
                                    use_pallas=True, interpret=True)
    _close(ski_fused.ski_fused_pass2(xt, zt, at, ft, False), want, BF16_TOL,
           "pass 2 vs Pallas interpret")


def test_dense_pass2_fp32_taps_with_bf16_signal():
    """fp32 taps beside a bf16 signal (JAX casts them inside its kernel;
    the port's wrapper widens bf16 taps on the card, so both widths of the
    taps reach the same fp32 sums)."""
    (x, z, a, f), (xt, zt, at, ft) = _pass2_inputs("ragged", seed=9,
                                                   filt_dtype=np.float32)
    got = ski_fused.ski_fused_pass2(xt, zt, at, ft, True)
    assert got.dtype == torch.bfloat16
    want = jops.ski_fused_pass2(jnp.asarray(x), jnp.asarray(z),
                                jnp.asarray(a), jnp.asarray(f), True,
                                use_pallas=False)
    _close(got, want, BF16_TOL, "pass 2, fp32 taps")


@pytest.mark.parametrize("shape", ["path", "ragged"])
def test_gram_grad_bf16_matches_jax(shape):
    """dA = Σ_b gz zᵀ on bf16 gz and z, fp32 out, against JAX's reference
    and its Pallas kernel in interpret mode."""
    b, r, d = {"path": (8, 64, 32), "ragged": (3, 11, 45)}[shape]
    rng = np.random.default_rng(r + d)
    gz, gzt = _bf16(rng, b, r, d)
    z, zt = _bf16(rng, b, r, d)
    got = ski_grad.gram_grad(gzt, zt)
    assert got.dtype == torch.float32 and got.shape == (d, r, r)
    _close(got, jref.gram_grad_ref(jnp.asarray(gz), jnp.asarray(z)), FP32,
           "gram_grad vs JAX ref")
    with _time_limit(INTERPRET_LIMIT):
        want = gram_grad_pallas(jnp.asarray(gz), jnp.asarray(z),
                                interpret=True)
    assert want.dtype == jnp.float32
    _close(got, want, FP32, "gram_grad vs Pallas interpret")


# --------------------------------------------------------------- SKIFusedTNO
def _op_inputs(shape, seed, filt_dtype=np.float32):
    """x bf16 (2, n, d), A fp32 (d, r, r), taps (d, m) × 0.1 in
    ``filt_dtype``, as tests/test_ski_grad.py draws them."""
    n, d, r, m = OP_SHAPES[shape]
    rng = np.random.default_rng(seed)
    x, xt = _bf16(rng, 2, n, d)
    a, at = _f32(rng, d, r, r)
    if filt_dtype == np.float32:
        f, ft = _f32(rng, d, m, scale=0.1)
    else:
        f, ft = _bf16(rng, d, m, scale=0.1)
    return (x, a, f), (xt, at, ft), r


def _port_op_grads(ts, lo_t, w_t, r, causal):
    leaves = [t.clone().requires_grad_() for t in ts]
    y = ops.ski_fused_tno(*leaves, lo_t, w_t, r, causal)
    assert y.dtype == ts[0].dtype
    return torch.autograd.grad(torch.sin(y.float()).sum(), leaves)


def _jax_op_grads(arrs, lo, w_lo, r, causal, **kw):
    return jax.jit(jax.grad(lambda x, a, f: jnp.sum(jnp.sin(
        jops.ski_fused_tno(x, a, f, lo, w_lo, r, causal, **kw).astype(
            jnp.float32))), argnums=(0, 1, 2)))(
                *(jnp.asarray(v) for v in arrs))


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "bidir"])
@pytest.mark.parametrize("shape", list(OP_SHAPES))
def test_ski_fused_tno_bf16_grads_match_jax(shape, causal):
    """The kernel-structured backward in bf16 (interp_reduce twice, pass 2
    with Aᵀ, gram_grad, conv_tap_grad; here over the plain versions)
    against jax.grad of JAX's reference op, 2e-2 relative (JAX's own
    TOL[bf16]); the counters as in fp32."""
    arrs, ts, r = _op_inputs(shape, seed=21)
    n = arrs[0].shape[1]
    lo, w_lo, lo_t, w_t = _geometry(n, r)
    ski_vjp.reset_counters()
    got = _port_op_grads(ts, lo_t, w_t, r, causal)
    assert ski_vjp.counters == {"fwd": 1, "bwd_kernel": 1, "bwd_ref": 0}
    want = _jax_op_grads(arrs, lo, w_lo, r, causal, use_pallas=False)
    for name, p, q in zip(("dx", "dA", "df"), got, want):
        _close(p, q, GRAD_TOL, f"{name} vs jax.grad of the reference")


def test_ski_fused_tno_bf16_grads_match_pallas_vjp():
    """The same against JAX's Pallas custom VJP in interpret mode, at the
    smaller shape, not causal."""
    arrs, ts, r = _op_inputs("n64", seed=22)
    lo, w_lo, lo_t, w_t = _geometry(arrs[0].shape[1], r)
    got = _port_op_grads(ts, lo_t, w_t, r, False)
    with _time_limit(INTERPRET_LIMIT):
        want = _jax_op_grads(arrs, lo, w_lo, r, False, use_pallas=True,
                             interpret=True)
    for name, p, q in zip(("dx", "dA", "df"), got, want):
        _close(p, q, GRAD_TOL, f"{name} vs the Pallas VJP")


@pytest.mark.parametrize("filt_dtype", [np.float32, jnp.bfloat16],
                         ids=["fp32 taps", "bf16 taps"])
def test_fused_tno_grad_dtypes_preserved(filt_dtype):
    """The cotangents land in the primal dtypes (tests/test_ski_grad.py's
    test of the same name): dx bf16, dA fp32, df in the taps' dtype."""
    arrs, ts, r = _op_inputs("n64", seed=23, filt_dtype=filt_dtype)
    lo, w_lo, lo_t, w_t = _geometry(arrs[0].shape[1], r)
    gx, ga, gf = _port_op_grads(ts, lo_t, w_t, r, False)
    assert gx.dtype == torch.bfloat16 and ga.dtype == torch.float32
    assert gf.dtype == ts[2].dtype
    jx, ja, jf = _jax_op_grads(arrs, lo, w_lo, r, False, use_pallas=False)
    assert (jx.dtype, ja.dtype, jf.dtype) == (
        jnp.bfloat16, jnp.float32, jnp.dtype(filt_dtype))


def test_ski_reference_backward_switch_bf16(monkeypatch):
    """REPRO_PALLAS_GRAD=0 in bf16: the forward kept, autograd's cotangents
    through ref.ski_fused_tno_ref counted as bwd_ref, in the primal
    dtypes, within the bf16 gradient tier of the kernel-structured ones."""
    arrs, ts, r = _op_inputs("ragged", seed=24, filt_dtype=jnp.bfloat16)
    lo, w_lo, lo_t, w_t = _geometry(arrs[0].shape[1], r)
    ski_vjp.reset_counters()
    kernel = _port_op_grads(ts, lo_t, w_t, r, True)
    monkeypatch.setenv("REPRO_PALLAS_GRAD", "0")
    reference = _port_op_grads(ts, lo_t, w_t, r, True)
    assert ski_vjp.counters == {"fwd": 2, "bwd_kernel": 1, "bwd_ref": 1}
    for name, p, q in zip(("dx", "dA", "df"), reference, kernel):
        assert p.dtype == q.dtype, name
        _close(p, q, GRAD_TOL, name)


# ------------------------------------------------------------- refusals
def test_bf16_wrappers_off_the_cpu():
    """Off the CPU every bf16 instance's wrapper reaches the device check
    (the card would launch it): the dense route's, and since the windowed,
    expand and interp_expand kernels have bf16 instances too, theirs; the
    CPU path counts no launch."""
    bf = dict(dtype=torch.bfloat16, device="meta")
    x, z = torch.empty(2, 16, 8, **bf), torch.empty(2, 4, 8, **bf)
    a = torch.empty(8, 4, 4, device="meta")
    f = torch.empty(8, 3, **bf)
    coef = torch.empty(8, 7, device="meta")
    lo = torch.zeros(16, dtype=torch.int32)
    for call in (lambda: interp_matvec.interp_reduce(x, None, None, 4),
                 lambda: ski_fused.ski_fused_pass2(x, z, a, f, True),
                 lambda: ski_fused.ski_fused_pass2(x, z, a, f, True,
                                                   transpose_a=True),
                 lambda: ski_grad.gram_grad(z, z)):
        with pytest.raises(ValueError, match="tensor on meta"):
            call()
    for what, call in (
            ("interp_expand", lambda: interp_matvec.interp_expand(
                z, lo, None)),
            ("ski_windowed_pass2", lambda: ski_fused.ski_windowed_pass2(
                x, z, coef, f, True)),
            ("ski_expand_pass2", lambda: ski_fused.ski_expand_pass2(
                x, z, f, True))):
        with pytest.raises(ValueError, match="tensor on meta"):
            call()
    ops.reset_ski_counters()
    ski_fused.ski_fused_pass2(torch.ones(1, 8, 4, dtype=torch.bfloat16),
                              torch.ones(1, 2, 4, dtype=torch.bfloat16),
                              torch.ones(4, 2, 2), torch.ones(4, 3), True)
    counts = ops.ski_counters()
    assert {"interp_reduce_bf16", "interp_expand_bf16",
            "ski_fused_pass2_bf16", "ski_fused_pass2_at_bf16",
            "ski_windowed_pass2_bf16", "ski_expand_pass2_bf16",
            "gram_grad_bf16", "conv_tap_grad_bf16"} <= set(counts)
    assert not any(counts.values())


@pytest.mark.parametrize("variant", ["windowed", "fft", "unfused"])
def test_bf16_plans_without_kernels_refuse_off_the_cpu(variant):
    """A bf16 model's windowed, fft and unfused plans off the CPU go on to
    their bf16 kernels, as the dense plan does: each reaches the device
    check (the card would launch) and counts no launch."""
    cfg = ski.SKIConfig(d=8, rank=4, filter_size=3,
                        fused=variant != "unfused")
    params = cast_params(ski.ski_init(cfg, device="meta"), torch.bfloat16)
    x = torch.empty(2, 16, 8, dtype=torch.bfloat16, device="meta")
    plan = ski.ski_plan(params, cfg, 16, causal=True,
                        variant=None if variant == "unfused" else variant)
    ops.reset_ski_counters()
    with pytest.raises(ValueError, match="tensor on meta"):
        ski.ski_tno_apply(params, cfg, x, causal=True, plan=plan)
    assert not any(ops.ski_counters().values())
    dense = ski.ski_plan(params, cfg, 16, causal=True, variant="dense")
    with pytest.raises(ValueError, match="tensor on meta"):
        ski.ski_tno_apply(params, cfg, x, causal=True, plan=dense)


@pytest.mark.parametrize("variant", ["windowed", "fft", "unfused"])
def test_bf16_plans_run_on_the_cpu(variant):
    """On the CPU the same plans run their plain versions in bf16, as JAX
    does, within the bf16 tier of the dense route."""
    cfg = ski.SKIConfig(d=8, rank=6, filter_size=3,
                        fused=variant != "unfused")
    params = ski.ski_init(cfg, device="cpu")
    torch.manual_seed(0)
    with torch.no_grad():
        for p in params.parameters():
            p.normal_(0.0, 0.5)
    params = cast_params(params, torch.bfloat16)
    x = torch.randn(2, 24, 8).to(torch.bfloat16)
    plan = ski.ski_plan(params, cfg, 24, causal=True,
                        variant=None if variant == "unfused" else variant)
    y = ski.ski_tno_apply(params, cfg, x, causal=True, plan=plan)
    want = ski.ski_tno_apply(params, cfg, x, causal=True, plan=ski.ski_plan(
        params, cfg, 24, causal=True, variant="dense"))
    assert y.dtype == torch.bfloat16
    _close(y, want, 2 * BF16_TOL, f"{variant} vs dense")


# ------------------------------------------------------------ cast_params
def test_cast_params_casts_floating_leaves_only():
    """Every floating parameter and buffer goes to the dtype, an integer
    buffer stays; the model is cast in place and returned."""
    cfg = ski.SKIConfig(d=8, rank=4, filter_size=3)
    params = ski.ski_init(cfg, device="cpu")
    params.register_buffer("cursor", torch.arange(3, dtype=torch.int64))
    params.register_buffer("scale", torch.ones(2))
    out = cast_params(params, torch.bfloat16)
    assert out is params
    assert {p.dtype for p in params.parameters()} == {torch.bfloat16}
    assert params.scale.dtype == torch.bfloat16
    assert params.cursor.dtype == torch.int64
    assert torch.equal(params.cursor, torch.arange(3))


# ---------------------------------------------------- the bf16 smoke model
@pytest.fixture(scope="module")
def smoke():
    """The smoke ski-tnn-lm-wt103 with dtype and param_dtype bf16, JAX's
    parameters through ``cast_params``, bridged into the port's
    ``cast_params``-ed model; a batch; JAX's bf16 loss and gradients, and
    JAX's fp32 ones on the same bf16-valued weights (the noise floor)."""
    bf = dict(dtype="bfloat16", param_dtype="bfloat16")
    jcfg = dataclasses.replace(jreduce(jget_config(ARCH)), **bf)
    jcfg32 = dataclasses.replace(jcfg, dtype="float32", param_dtype="float32")
    cfg = dataclasses.replace(reduce_for_smoke(get_config(ARCH)), **bf)
    params = jcast_params(unbox(jinit_model(jax.random.PRNGKey(0), jcfg))[0],
                          jnp.bfloat16)
    params32 = jax.tree.map(lambda a: a.astype(jnp.float32), params)
    batch = pipeline.batch_at(pipeline.DataConfig(
        vocab=cfg.vocab, seq_len=32, global_batch=2, seed=4), 0)

    def value_and_grad(c):
        return jax.jit(jax.value_and_grad(
            lambda p: jloss_fn(p, c, Ctx(), batch), has_aux=True))
    (jloss, _), jgrads = value_and_grad(jcfg)(params)
    (jloss32, _), jgrads32 = value_and_grad(jcfg32)(params32)
    toks = {"tokens": batch["tokens"]}
    logits, _ = jax.jit(lambda p: jforward(p, jcfg, Ctx(), toks))(params)
    logits32, _ = jax.jit(lambda p: jforward(p, jcfg32, Ctx(), toks))(
        params32)
    tree = jax.tree.map(np.asarray, params)
    model = bridge.params_from_jax(tree, cfg, device="cpu",
                                   dtype=torch.bfloat16)
    return dict(
        cfg=cfg, tree=tree, model=model, batch={
            k: torch.from_numpy(np.asarray(v)).long()
            for k, v in batch.items()},
        jloss=float(jloss), jloss32=float(jloss32),
        logits=np.asarray(logits, np.float32),
        logits32=np.asarray(logits32, np.float32),
        grads=bridge._port_leaves(jax.tree.map(np.asarray, jgrads), cfg),
        grads32=bridge._port_leaves(jax.tree.map(np.asarray, jgrads32), cfg))


def _rel_l2(got, want) -> float:
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.linalg.norm(got - want) / (np.linalg.norm(want) + 1e-30))


def _limit(want, want32, dist=_rel) -> float:
    """The bf16 model's limit: 2e-2 of the scale, or twice JAX's own
    bf16-vs-fp32 distance (``dist``) where that is larger."""
    return max(MODEL_TOL, 2 * dist(want32, want))


def test_bf16_bridge_round_trip(smoke):
    """Every leaf of the cast JAX tree lands in the cast port model in
    bf16 and comes back through ``params_to_jax`` bit for bit; a cast tree
    into an uncast model is refused by the dtype check."""
    model, cfg, tree = smoke["model"], smoke["cfg"], smoke["tree"]
    assert {p.dtype for p in model.parameters()} == {torch.bfloat16}
    back = bridge._port_leaves(jax.tree.map(
        lambda t: t.view(torch.int16).numpy(),
        bridge.params_to_jax(model)), cfg)
    want = bridge._port_leaves(jax.tree.map(
        lambda a: np.asarray(a).view(np.int16), tree), cfg)
    assert set(back) == set(want)
    for k in want:
        np.testing.assert_array_equal(back[k], want[k], err_msg=k)
    with pytest.raises(ValueError, match="dtype"):
        bridge.params_from_jax(tree, cfg, device="cpu")


def test_bf16_smoke_logits_and_loss_match_jax(smoke):
    """The bf16 smoke model's logits (bf16) and loss against JAX's."""
    model, cfg, batch = smoke["model"], smoke["cfg"], smoke["batch"]
    with torch.no_grad():
        logits = forward(model, cfg, batch["tokens"])
        loss, _ = transformer.loss_fn(model, cfg, batch)
    assert logits.dtype == torch.bfloat16
    _close(logits, smoke["logits"],
           _limit(smoke["logits"], smoke["logits32"]), "logits")
    jl, jl32 = smoke["jloss"], smoke["jloss32"]
    tol = max(MODEL_TOL, 2 * abs(jl32 - jl) / abs(jl))
    assert abs(float(loss) - jl) <= tol * abs(jl), (float(loss), jl, tol)


def test_bf16_smoke_grads_match_jax(smoke):
    """Every gradient leaf of the bf16 smoke model (bf16, as JAX's) against
    jax.grad of JAX's loss_fn, each within its leaf's limit in relative L2;
    one kernel backward a layer."""
    model, cfg, batch = smoke["model"], smoke["cfg"], smoke["batch"]
    ski_vjp.reset_counters()
    loss, _, grads = loss_and_grads(model, cfg, batch)
    assert ski_vjp.counters == {"fwd": cfg.n_layers,
                                "bwd_kernel": cfg.n_layers, "bwd_ref": 0}
    assert set(grads) == set(smoke["grads"])
    for k, g in grads.items():
        assert g.dtype == torch.bfloat16, k
        want, want32 = smoke["grads"][k], smoke["grads32"][k]
        err, tol = _rel_l2(g, want), _limit(want, want32, _rel_l2)
        assert err <= tol, f"{k}: relative L2 distance {err:.3e} > {tol:.3e}"



# ----------------------------------------------- mixer_apply, fp32 leaves
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["x fp32", "x bf16"])
@pytest.mark.parametrize("arch", ["ski-tnn-lm-wt103", "fd-tnn-lm-wt103",
                                  "tnn-lm-wt103"])
def test_mixer_apply_fp32_leaves_unchanged(arch, dtype):
    """With fp32 leaves (every registered config) the mixer computes in
    fp32 from a bf16 x, bitwise what ``gtu_apply(..., x.float())`` gives,
    as before ``nn.layers.dense`` promoted."""
    cfg = reduce_for_smoke(get_config(arch))
    model = init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    layer = model.layers[0]
    mixer = cfg.layers_spec[0][0]
    x = torch.randn(2, 24, cfg.d_model,
                    generator=torch.Generator().manual_seed(1)).to(dtype)
    with torch.no_grad():
        got = transformer.mixer_apply(layer.mixer, cfg, mixer, x)
        want = gtu_apply(layer.mixer, transformer._tno_cfg(cfg, mixer, True),
                         x.float()).to(x.dtype)
    assert got.dtype == dtype
    assert torch.equal(got, want)
