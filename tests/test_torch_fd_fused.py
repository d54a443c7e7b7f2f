"""Port parity for the FD-TNO kernels and op (repro_torch.kernels.fd_fused)
against the JAX package: each kernel's CPU path (its plain torch version)
and the op, forward and backward, are held against the Pallas kernels in
interpret mode and against repro.kernels.ref, on the same numpy inputs.

Tolerance: fp32 at 1e-5 relative to the output's max, the fp32 tier of
docs/kernels.md. The kernels are elementwise or a batch sum; the op adds
three FFTs whose summation order differs between pocketfft (torch) and
XLA's CPU FFT. bf16 gradients at 2e-2, the bf16 tier (the op rounds its
inputs and outputs to bf16, at other places in the two frameworks).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import fd_fused as jfd  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import fd_fused, ops, ref  # noqa: E402

torch.set_num_threads(1)
TOL = 1e-5
GRAD_TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _rel(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-12))


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


@pytest.fixture(autouse=True)
def _reset_counters():
    fd_fused.reset_counters()
    yield


@pytest.mark.parametrize("d,n", [(5, 33), (12, 64), (3, 7), (37, 45)])
def test_hilbert_window_matches_jax(d, n):
    kt = np.random.default_rng(n).standard_normal((d, 2 * n), np.float32)
    got = fd_fused.hilbert_window(_t(kt), n).numpy()
    assert _rel(got, jfd.hilbert_window_pallas(jnp.asarray(kt), n,
                                               interpret=True)) <= TOL
    assert _rel(got, jref.hilbert_window_ref(jnp.asarray(kt), n)) <= TOL
    assert np.abs(got[:, n + 1:]).max(initial=0.0) == 0.0


@pytest.mark.parametrize("b,f,d", [(2, 17, 8), (1, 65, 12), (3, 9, 3),
                                   (3, 46, 37)])
def test_spectral_multiply_matches_jax(b, f, d):
    rng = np.random.default_rng(b * f * d)
    xr, xi = (rng.standard_normal((b, f, d), np.float32) for _ in range(2))
    kr, ki = (rng.standard_normal((f, d), np.float32) for _ in range(2))
    yr, yi = fd_fused.fd_spectral_multiply(_t(xr), _t(xi), _t(kr), _t(ki))
    jargs = [jnp.asarray(a) for a in (xr, xi, kr, ki)]
    wr, wi = jfd.fd_spectral_multiply_pallas(*jargs, interpret=True)
    assert _rel(yr, wr) <= TOL and _rel(yi, wi) <= TOL
    rr, ri = jref.fd_spectral_multiply_ref(*jargs)
    assert _rel(yr, rr) <= TOL and _rel(yi, ri) <= TOL


def test_fd_mul_broadcasts_kernel_over_batch_rows():
    """fd_mul on complex64 (the op's channel-major layout): every batch row
    is multiplied by the same k̂, and the planes form agrees exactly."""
    rng = np.random.default_rng(3)
    x = torch.complex(*(_t(rng.standard_normal((3, 5, 9))) for _ in range(2)))
    k = torch.complex(*(_t(rng.standard_normal((5, 9))) for _ in range(2)))
    y = fd_fused.fd_mul(x, k)
    assert y.dtype == torch.complex64 and y.shape == x.shape
    assert torch.allclose(y, x * k[None], rtol=1e-6, atol=1e-6)
    yr, yi = fd_fused.fd_spectral_multiply(x.real, x.imag, k.real, k.imag)
    assert torch.equal(yr, y.real) and torch.equal(yi, y.imag)


@pytest.mark.parametrize("d,n", [(4, 16), (5, 31)])
def test_causal_khat_planes_match_jax(d, n):
    khat = np.random.default_rng(d + n).standard_normal((d, n + 1), np.float32)
    kr, ki = fd_fused.causal_khat_planes(_t(khat))
    wr, wi = jfd.causal_khat_planes(jnp.asarray(khat), interpret=True)
    assert kr.shape == (n + 1, d)
    assert _rel(kr, wr) <= TOL and _rel(ki, wi) <= TOL


@pytest.mark.parametrize("b,n,d", [(2, 32, 8), (1, 33, 5), (2, 45, 37)])
def test_fd_tno_matches_jax(b, n, d):
    rng = np.random.default_rng(n * d)
    x = rng.standard_normal((b, n, d), np.float32)
    khat = rng.standard_normal((d, n + 1), np.float32)
    got = ops.fd_tno(_t(x), _t(khat))
    assert got.shape == (b, n, d) and got.dtype == torch.float32
    want_pl = jfd.fd_tno_pallas(jnp.asarray(x), jnp.asarray(khat), True)
    assert _rel(got, want_pl) <= TOL
    assert _rel(got, jref.fd_tno_ref(jnp.asarray(x), jnp.asarray(khat))) <= TOL
    assert _rel(got, ref.fd_tno_ref(_t(x), _t(khat))) <= TOL
    # the CPU path runs the plain versions: no kernel launch is counted
    assert fd_fused.counters == {"hilbert_window": 0, "causal_spectrum": 0,
                                 "causal_spectrum_adjoint": 0, "fd_mul": 0,
                                 "fd_khat_grad": 0}


@pytest.mark.parametrize("n,s", [(16, 8), (33, 20)])
def test_fd_tno_is_exactly_causal(n, s):
    """Perturbing x at t >= s leaves y[:s] unchanged, within fp32 FFT
    round-off (1e-5 of the output scale): the lag window zeroes negative
    lags exactly, not to FFT-leakage level."""
    rng = np.random.default_rng(n)
    d = 6
    x = _t(rng.standard_normal((1, n, d)))
    khat = _t(rng.standard_normal((d, n + 1)))
    x2 = x.clone()
    x2[:, s:] += _t(rng.standard_normal((1, n - s, d))) * 10
    y, y2 = ops.fd_tno(x, khat), ops.fd_tno(x2, khat)
    scale = max(float(y.abs().max()), 1.0)
    assert float((y[:, :s] - y2[:, :s]).abs().max()) <= 1e-5 * scale
    assert float((y[:, s:] - y2[:, s:]).abs().max()) > 1e-2 * scale


def test_fd_tno_cpu_autograd_matches_jax_grad():
    """On the CPU the op is plain torch, so autograd gives its gradient;
    held against jax.grad of the JAX oracle at the fp32 tier."""
    rng = np.random.default_rng(7)
    b, n, d = 2, 17, 5
    x = rng.standard_normal((b, n, d), np.float32)
    khat = rng.standard_normal((d, n + 1), np.float32)
    xt, kt = _t(x).requires_grad_(), _t(khat).requires_grad_()
    torch.sin(ops.fd_tno(xt, kt)).sum().backward()
    gx, gk = jax.grad(lambda x_, k_: jnp.sum(jnp.sin(jref.fd_tno_ref(x_, k_))),
                      argnums=(0, 1))(jnp.asarray(x), jnp.asarray(khat))
    assert _rel(xt.grad, gx) <= TOL
    assert _rel(kt.grad, gk) <= TOL


def test_wrappers_reject_other_devices():
    """A tensor that is neither on the CPU nor on a card is refused, never
    sent down the plain path."""
    kt = torch.zeros(4, 8, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        fd_fused.hilbert_window(kt, 4)
    x = torch.zeros(2, 5, 3, dtype=torch.complex64, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        fd_fused.fd_mul(x, x[0])


@pytest.mark.parametrize("kernel", ["hilbert_window", "fd_mul",
                                    "fd_khat_grad"])
def test_wrappers_raise_for_inputs_requiring_grad(kernel):
    """Off the CPU, fd_mul and fd_khat_grad on their own are forward-only:
    an input that requires grad while grad is enabled raises, rather than
    leave autograd with a tensor cut off from its graph (gradients go
    through fd_tno). hilbert_window is differentiable (HilbertWindow), so
    its input goes on to the device checks with grad enabled too. Under
    no_grad every input reaches the device checks (a meta tensor is then
    refused as not CUDA)."""
    x = torch.zeros(2, 5, 3, dtype=torch.complex64, device="meta")
    if kernel == "hilbert_window":
        args = (torch.zeros(4, 8, device="meta", requires_grad=True), 4)
    elif kernel == "fd_mul":
        args = (x, x[0].clone().requires_grad_())
    else:
        args = (x, x.clone().requires_grad_())
    fn = getattr(fd_fused, kernel)
    if kernel == "hilbert_window":
        with pytest.raises(ValueError, match="CUDA"):
            fn(*args)
    else:
        with pytest.raises(NotImplementedError, match="forward-only"):
            fn(*args)
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
        fn(*args)


@pytest.mark.parametrize("view", ["conj", "neg"])
def test_wrappers_refuse_conj_and_neg_views(view):
    """torch.conj() and negated views only set a bit: the memory behind
    data_ptr() holds the other sign. A kernel reading it raw would compute
    with the wrong sign silently, so every wrapper refuses such a view off
    the CPU (checked before the device, so a meta tensor shows it)."""
    x = torch.zeros(2, 5, 3, dtype=torch.complex64, device="meta")
    if view == "conj":
        bad = x.conj()
        assert bad.is_conj()
        calls = (lambda: fd_fused.fd_mul(bad, x[0]),
                 lambda: fd_fused.fd_khat_grad(bad, x))
    else:
        bad = x.new_zeros(4, 8).conj().imag     # a negated float32 view
        assert bad.is_neg()
        calls = (lambda: fd_fused.hilbert_window(bad, 4),)
    for call in calls:
        with pytest.raises(ValueError, match="conjugated or negated"):
            call()


@pytest.mark.parametrize("b,f,d", [(2, 17, 8), (1, 65, 12), (3, 9, 3),
                                   (8, 46, 37)])
def test_fd_khat_grad_matches_jax(b, f, d):
    """The planes form against fd_khat_grad_pallas (interpret) and the JAX
    ref; the complex form (the op's channel-major layout) against the
    planes form, exactly (the same real arithmetic)."""
    rng = np.random.default_rng(b + f + d)
    gr, gi, xr, xi = (rng.standard_normal((b, f, d), np.float32)
                      for _ in range(4))
    dr, di = fd_fused.fd_khat_grad_planes(_t(gr), _t(gi), _t(xr), _t(xi))
    assert dr.shape == (f, d) and dr.dtype == torch.float32
    jargs = [jnp.asarray(a) for a in (gr, gi, xr, xi)]
    wr, wi = jfd.fd_khat_grad_pallas(*jargs, interpret=True)
    assert _rel(dr, wr) <= TOL and _rel(di, wi) <= TOL
    rr, ri = jref.fd_khat_grad_ref(*jargs)
    assert _rel(dr, rr) <= TOL and _rel(di, ri) <= TOL
    g = torch.complex(_t(gr), _t(gi))
    x = torch.complex(_t(xr), _t(xi))
    dk = fd_fused.fd_khat_grad(g, x)
    assert dk.dtype == torch.complex64 and dk.shape == (f, d)
    assert torch.equal(dk.real, dr) and torch.equal(dk.imag, di)
    assert torch.allclose(dk, torch.sum(g * x.conj(), dim=0), rtol=1e-5,
                          atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,n,d", [(2, 32, 8), (1, 17, 5)])
def test_fd_tno_grad_matches_jax(b, n, d, dtype):
    """The FDTNO backward (conj-spectrum fd_mul, fd_khat_grad, the window,
    the irfft adjoint) against jax.grad through the Pallas op in interpret
    mode and through the JAX ref, with the loss of
    tests/test_fd_fused.py::test_fd_tno_grad_matches_oracle."""
    rng = np.random.default_rng(b * n + d)
    x = rng.standard_normal((b, n, d), np.float32)
    khat = rng.standard_normal((d, n + 1), np.float32)
    jx = jnp.asarray(x).astype(dtype)
    jk = jnp.asarray(khat).astype(dtype)

    def loss(fn):
        return lambda x_, k_: jnp.sum(jnp.sin(fn(x_, k_).astype(jnp.float32)))

    g_pl = jax.grad(loss(lambda x_, k_: jops.fd_tno(
        x_, k_, use_pallas=True, interpret=True)), argnums=(0, 1))(jx, jk)
    g_rf = jax.grad(loss(jref.fd_tno_ref), argnums=(0, 1))(jx, jk)
    tdt = getattr(torch, dtype)
    xt = _t(x).to(tdt).requires_grad_()
    kt = _t(khat).to(tdt).requires_grad_()
    fd_fused.reset_counters()
    torch.sin(ops.fd_tno(xt, kt).float()).sum().backward()
    assert xt.grad.dtype == tdt and kt.grad.dtype == tdt
    tol = GRAD_TOL[dtype]
    for want in (g_pl, g_rf):
        assert _rel(xt.grad.float(), want[0].astype(jnp.float32)) <= tol
        assert _rel(kt.grad.float(), want[1].astype(jnp.float32)) <= tol
    # the differentiated forward and the FDTNO backward each ran once
    assert fd_fused.op_counters == {"fwd": 1, "bwd_kernel": 1, "bwd_ref": 0}


def test_fd_tno_inference_counts_no_differentiated_forward():
    """Without grad (serving) the op runs its forward only: neither
    counter moves and nothing is kept for a backward."""
    x = _t(np.ones((1, 8, 3))).requires_grad_()
    k = _t(np.ones((3, 9)))
    with torch.inference_mode():
        y = ops.fd_tno(x, k)
    assert y.grad_fn is None
    assert fd_fused.op_counters == {"fwd": 0, "bwd_kernel": 0,
                                    "bwd_ref": 0}


def test_hilbert_window_grad_is_window():
    """Diagonal window ⇒ the gradient is the same window applied to the
    cotangent (self-adjoint), as tests/test_fd_fused.py checks for the
    Pallas kernel's custom VJP."""
    d, n = 4, 12
    rng = np.random.default_rng(0)
    kt = _t(rng.standard_normal((d, 2 * n))).requires_grad_()
    g = _t(rng.standard_normal((d, 2 * n)))
    out = fd_fused.hilbert_window(kt, n)
    assert out.grad_fn is not None
    (dk,) = torch.autograd.grad(out, kt, g)
    assert torch.equal(dk, ref.hilbert_window_ref(g, n))
    assert _rel(dk, jref.hilbert_window_ref(jnp.asarray(g.numpy()), n)) <= TOL


def test_gtu_block_param_grads_match_jax():
    """Gradients through a whole causal FD GTU block at the smoke width
    (d=128, RPE hidden 16): the port's GTU against jax.grad through the
    JAX GTU on the Pallas interpret path, parameter for parameter (the
    training-path gate of tests/test_fd_fused.py). fp32 at 1e-5."""
    from repro.core.block import TNNBlockConfig as JBlockConfig
    from repro.core.block import gtu_apply as jgtu_apply
    from repro.core.block import gtu_init as jgtu_init
    from repro.core.tno import TNOConfig as JTNOConfig
    from repro.nn.params import unbox
    from repro_torch import bridge
    from repro_torch.core.block import TNNBlockConfig, gtu_apply, gtu_init
    from repro_torch.core.tno import TNOConfig

    d, n = 128, 24
    jcfg = JBlockConfig(d, tno=JTNOConfig(d=d, variant="fd", rpe_hidden=16,
                                          use_pallas=True))
    jp = jax.tree.map(np.asarray,
                      unbox(jgtu_init(jax.random.PRNGKey(0), jcfg))[0])
    x = np.random.default_rng(1).standard_normal((2, n, d), np.float32)
    jg = jax.jit(jax.grad(lambda p: jnp.sum(jnp.sin(
        jgtu_apply(p, jcfg, jnp.asarray(x))))))(jp)
    cfg = TNNBlockConfig(d, tno=TNOConfig(d=d, variant="fd", rpe_hidden=16))
    gtu = gtu_init(cfg, device="cpu")
    gtu.load_state_dict({k: torch.from_numpy(np.array(v))
                         for k, v in bridge._flatten(jp)})
    torch.sin(gtu_apply(gtu, cfg, _t(x))).sum().backward()
    want = dict(bridge._flatten(jax.tree.map(np.asarray, jg)))
    assert set(want) == {k for k, _ in gtu.named_parameters()}
    for k, p in gtu.named_parameters():
        assert _rel(p.grad, want[k]) <= TOL, k


def test_hilbert_window_takes_length_2n_only():
    """The window is defined on the length-2n lag axis of the rfft grid;
    any other length is refused on every device."""
    with pytest.raises(ValueError, match="2n"):
        fd_fused.hilbert_window(torch.zeros(3, 9), 4)
