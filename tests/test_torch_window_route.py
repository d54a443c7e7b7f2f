"""The FD-TNO backward's spectrum cotangent on the window route (every n off
``backend.causal_spectrum_route``'s fused route: 448, odd n, n above 4096),
``fd_fused.window_route_cotangent``, against its plain version and the JAX
package, on the same numpy inputs:

* the closed-form irfft adjoint, (c_s / 2n) · Re rfft(g), c_0 = c_n = 1 and
  c_s = 2 between, equals autograd's irfft VJP in float64 (1e-12 × max);
* the imaginary parts of bins 0 and n of the cotangent are dropped before
  the irfft, as ``ref.causal_spectrum_adjoint_ref``, the fused kernel and
  pocketfft drop them (cuFFT's C2R keeps them at some lengths);
* the port's FD-TNO gradients at n = 8192 (the window route) against
  ``jax.grad`` of the JAX reference, at the fp32 tier (1e-5 relative to the
  max: FFTs of 16,384 points summed in another order).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import backend, fd_fused, ops, ref  # noqa: E402

torch.set_num_threads(1)
TOL = 1e-5
#: window-route lengths: the FD prefill's 448, an odd n, and 8192 (2n =
#: 16384, past the fused route's 4096)
NS = (448, 7, 8192)


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _cotangent(n, d, seed, dtype=torch.complex128):
    """A random (d, n+1) spectrum cotangent whose bins 0 and n have
    imaginary parts of order 1."""
    rng = np.random.default_rng(seed)
    re, im = rng.standard_normal((2, d, n + 1))
    return torch.complex(torch.from_numpy(re), torch.from_numpy(im)).to(dtype)


def _drop_edges(dk, n):
    flat = dk.clone()
    flat.imag[:, 0] = 0
    flat.imag[:, n] = 0
    return flat


@pytest.mark.parametrize("n", NS)
def test_window_route_lengths(n):
    assert backend.causal_spectrum_route(n) == "window"


@pytest.mark.parametrize("n", (448, 8192))
def test_closed_form_equals_autograd_float64(n):
    """window_route_cotangent (the closed form) against autograd's irfft
    VJP on the same windowed cotangent, in float64."""
    d = 3
    dk = _cotangent(n, d, seed=n)
    assert float(dk.imag[:, [0, n]].abs().min()) > 0
    k = torch.zeros(d, n + 1, dtype=torch.float64)
    got = fd_fused.window_route_cotangent(dk, k, n)
    assert got.dtype == torch.float64 and got.shape == (d, n + 1)
    dkt = fd_fused.hilbert_window(
        torch.fft.irfft(_drop_edges(dk, n), n=2 * n, dim=-1), n)
    leaf = k.clone().requires_grad_()
    (want,) = torch.autograd.grad(torch.fft.irfft(leaf, n=2 * n, dim=-1),
                                  leaf, dkt)
    assert _rel(got, want) <= 1e-12
    assert _rel(fd_fused.irfft_adjoint(dkt, n), want) <= 1e-12


@pytest.mark.parametrize("n", NS)
def test_window_route_cotangent_drops_edge_imaginary_parts(n):
    """The result does not see the edge bins' imaginary parts, and equals
    ref.causal_spectrum_adjoint_ref (autograd, edges dropped) in fp32."""
    d = 4
    dk = _cotangent(n, d, seed=3 * n, dtype=torch.complex64)
    k = torch.zeros(d, n + 1)
    got = fd_fused.window_route_cotangent(dk, k, n)
    assert got.dtype == torch.float32
    assert torch.equal(got, fd_fused.window_route_cotangent(
        _drop_edges(dk, n), k, n))
    other = dk.clone()
    other.imag[:, 0] += 5.0
    other.imag[:, n] -= 3.0
    assert torch.equal(got, fd_fused.window_route_cotangent(other, k, n))
    assert _rel(got, ref.causal_spectrum_adjoint_ref(dk, n)) <= TOL
    # the input is not modified
    assert float(dk.imag[:, [0, n]].abs().min()) > 0


def test_fd_tno_grads_at_8192_match_jax():
    """The port's FD-TNO (x (1, 8192, 4), the window route, its kernel
    backward over the plain versions on the CPU) against jax.grad of the
    JAX reference."""
    b, n, d = 1, 8192, 4
    assert backend.causal_spectrum_route(n) == "window"
    rng = np.random.default_rng(26)
    x = rng.standard_normal((b, n, d), np.float32)
    khat = rng.standard_normal((d, n + 1), np.float32)
    xt = torch.from_numpy(x).requires_grad_()
    kt = torch.from_numpy(khat).requires_grad_()
    fd_fused.reset_counters()
    torch.sin(ops.fd_tno(xt, kt)).sum().backward()
    assert fd_fused.op_counters == {"fwd": 1, "bwd_kernel": 1, "bwd_ref": 0}
    gx, gk = jax.grad(lambda x_, k_: jnp.sum(jnp.sin(jref.fd_tno_ref(x_, k_))),
                      argnums=(0, 1))(jnp.asarray(x), jnp.asarray(khat))
    assert _rel(xt.grad, gx) <= TOL
    assert _rel(kt.grad, gk) <= TOL
