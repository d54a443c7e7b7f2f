"""Port parity for the FD-TNO kernels and op (repro_torch.kernels.fd_fused)
against the JAX package: each kernel's CPU path (its plain torch version)
and the op are held against the Pallas kernels in interpret mode and
against repro.kernels.ref, on the same numpy inputs.

Tolerance: fp32 at 1e-5 relative to the output's max, the fp32 tier of
docs/kernels.md. The kernels are elementwise; the op adds three FFTs whose
summation order differs between pocketfft (torch) and XLA's CPU FFT.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import fd_fused as jfd  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import fd_fused, ops, ref  # noqa: E402

torch.set_num_threads(1)
TOL = 1e-5


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
    assert fd_fused.counters == {"hilbert_window": 0, "fd_mul": 0}


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


@pytest.mark.parametrize("kernel", ["hilbert_window", "fd_mul"])
def test_wrappers_raise_for_inputs_requiring_grad(kernel):
    """Off the CPU each kernel is forward-only: an input that requires grad
    while grad is enabled raises, rather than leave autograd with a tensor
    cut off from its graph. Under no_grad the same input reaches the device
    checks (a meta tensor is then refused as not CUDA)."""
    if kernel == "hilbert_window":
        args = (torch.zeros(4, 8, device="meta", requires_grad=True), 4)
    else:
        x = torch.zeros(2, 5, 3, dtype=torch.complex64, device="meta")
        args = (x, x[0].clone().requires_grad_())
    fn = getattr(fd_fused, kernel)
    with pytest.raises(NotImplementedError, match="forward-only"):
        fn(*args)
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
        fn(*args)


def test_hilbert_window_takes_length_2n_only():
    """The window is defined on the length-2n lag axis of the rfft grid;
    any other length is refused on every device."""
    with pytest.raises(ValueError, match="2n"):
        fd_fused.hilbert_window(torch.zeros(3, 9), 4)
