"""Port parity for the FD-TNO's causal spectrum and its adjoint
(``repro_torch.kernels.fd_fused.causal_spectrum`` and
``causal_spectrum_adjoint``, and their plain versions in ``kernels/ref.py``)
against the JAX package, on the same numpy inputs:

* the spectrum against ``causal_khat_planes`` (the Pallas window in
  interpret mode between XLA's FFTs), conjugated too;
* the adjoint against the last lines of ``_fd_bwd``
  (``src/repro/kernels/fd_fused.py``): irfft, ``hilbert_window_pallas`` in
  interpret mode, the irfft VJP;
* ``backend.causal_spectrum_route`` at the edges of the fused route;
* the FD-TNO backward on the fused route against the window route and
  ``jax.grad`` (``tests/test_torch_fd_fused.py`` holds both routes against
  ``jax.grad`` at other shapes).

Tolerance: fp32 at 1e-5 relative to the output's max, the fp32 tier of
docs/kernels.md (two FFTs a side, summed in another order by pocketfft and
XLA's CPU FFT).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import fd_fused as jfd  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import backend, fd_fused, ops, ref  # noqa: E402

torch.set_num_threads(1)
TOL = 1e-5
#: the adjoint's lengths: n = 448 (the FD prefill, window route) and 7
#: (odd) beside powers of two
ADJOINT_NS = (1, 2, 7, 64, 448, 512)


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-12))


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _jax_adjoint(dk, n):
    """The end of ``_fd_bwd``: irfft of the spectrum cotangent, the Pallas
    window in interpret mode, the irfft VJP back to a (d, n+1) response."""
    dkt = jfd.hilbert_window_pallas(jnp.fft.irfft(dk, n=2 * n, axis=-1), n,
                                    interpret=True)
    k0 = jnp.zeros(dk.shape, jnp.float32)
    _, vjp = jax.vjp(lambda k: jnp.fft.irfft(k, n=2 * n, axis=-1), k0)
    return vjp(dkt)[0]


def _complex_input(rng, d, n):
    re, im = (rng.standard_normal((d, n + 1), np.float32) for _ in range(2))
    return re, im


@pytest.fixture(autouse=True)
def _reset_counters():
    fd_fused.reset_counters()
    yield


@pytest.mark.parametrize("conj", [False, True])
@pytest.mark.parametrize("d,n", [(3, 1), (5, 2), (4, 7), (6, 64),
                                 (2, 448), (3, 512)])
def test_causal_spectrum_ref_matches_jax(d, n, conj):
    u = np.random.default_rng(d * n).standard_normal((d, n + 1), np.float32)
    got = ref.causal_spectrum_ref(_t(u), conj)
    assert got.shape == (d, n + 1) and got.dtype == torch.complex64
    assert not got.is_conj()
    wr, wi = jfd.causal_khat_planes(jnp.asarray(u), interpret=True)
    sign = -1.0 if conj else 1.0
    assert _rel(got.real, np.asarray(wr).T) <= TOL
    assert _rel(got.imag, sign * np.asarray(wi).T) <= TOL


@pytest.mark.parametrize("conj", [False, True])
@pytest.mark.parametrize("d,n", [(3, 1), (37, 16), (5, 256)])
def test_causal_spectrum_wrapper_on_cpu(d, n, conj):
    """The wrapper's CPU path is its plain version (no launch counted),
    and its real part is the response itself: Re k̂ = u."""
    u = np.random.default_rng(n + d).standard_normal((d, n + 1), np.float32)
    got = fd_fused.causal_spectrum(_t(u), conj=conj)
    assert torch.equal(got, ref.causal_spectrum_ref(_t(u), conj))
    assert _rel(got.real, u) <= TOL
    assert fd_fused.counters["causal_spectrum"] == 0


@pytest.mark.parametrize("n", ADJOINT_NS)
def test_causal_spectrum_adjoint_ref_matches_jax(n):
    d = 5
    rng = np.random.default_rng(n)
    re, im = _complex_input(rng, d, n)
    dk = torch.complex(_t(re), _t(im))
    got = ref.causal_spectrum_adjoint_ref(dk, n)
    assert got.shape == (d, n + 1) and got.dtype == torch.float32
    want = _jax_adjoint(jnp.asarray(re) + 1j * jnp.asarray(im), n)
    assert _rel(got, want) <= TOL


@pytest.mark.parametrize("n", (1, 8, 64))
def test_causal_spectrum_adjoint_drops_edge_imaginary_parts(n):
    """The irfft drops the imaginary parts of bins 0 and n, and the
    adjoint is the closed form (c / 2n) Re rfft(w ⊙ irfft(dk)), c = 1 at
    the edges and 2 between (float64)."""
    rng = np.random.default_rng(3 * n)
    re, im = _complex_input(rng, 4, n)
    dk = torch.complex(_t(re), _t(im))
    flat = dk.clone()
    flat.imag[:, 0] = 0
    flat.imag[:, n] = 0
    got = fd_fused.causal_spectrum_adjoint(dk, n)
    assert torch.equal(got, ref.causal_spectrum_adjoint_ref(flat, n))
    h = ref.hilbert_window_ref(
        torch.fft.irfft(flat.to(torch.complex128), n=2 * n, dim=-1), n)
    c = torch.full((n + 1,), 2.0, dtype=torch.float64)
    c[0] = c[n] = 1.0
    closed = c / (2 * n) * torch.fft.rfft(h, n=2 * n, dim=-1).real
    assert _rel(got, closed) <= TOL


@pytest.mark.parametrize("n,route", [(0, "window"), (1, "fused"),
                                     (2, "fused"), (3, "window"),
                                     (448, "window"), (512, "fused"),
                                     (4096, "fused"), (4097, "window"),
                                     (8192, "window")])
def test_causal_spectrum_route(n, route):
    assert backend.causal_spectrum_route(n) == route


def test_wrappers_refuse_lengths_off_the_fused_route():
    """The fused wrappers take the fused route's lengths only, on every
    device; n must match the cotangent's width."""
    with pytest.raises(ValueError, match="fused route"):
        fd_fused.causal_spectrum(torch.zeros(3, 449))
    dk = torch.zeros(3, 449, dtype=torch.complex64)
    with pytest.raises(ValueError, match="fused route"):
        fd_fused.causal_spectrum_adjoint(dk, 448)
    with pytest.raises(ValueError, match="n = 8"):
        fd_fused.causal_spectrum_adjoint(torch.zeros(3, 5,
                                                     dtype=torch.complex64), 8)
    with pytest.raises(ValueError, match="d >= 1"):
        fd_fused.causal_spectrum(torch.zeros(0, 5))
    with pytest.raises(ValueError, match="d >= 1"):
        fd_fused.causal_spectrum(torch.zeros(5))


def test_wrappers_refuse_other_devices_and_views():
    """Off the CPU a wrapper launches or raises: a meta tensor is not
    CUDA, a negated or conjugated view is refused, and an input that
    requires grad is refused while grad is enabled (forward-only)."""
    u = torch.zeros(3, 9, device="meta")
    dk = torch.zeros(3, 9, dtype=torch.complex64, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        fd_fused.causal_spectrum(u)
    with pytest.raises(ValueError, match="CUDA"):
        fd_fused.causal_spectrum_adjoint(dk, 8)
    with pytest.raises(ValueError, match="conjugated or negated"):
        fd_fused.causal_spectrum(dk.conj().imag)
    with pytest.raises(ValueError, match="conjugated or negated"):
        fd_fused.causal_spectrum_adjoint(dk.conj(), 8)
    with pytest.raises(NotImplementedError, match="forward-only"):
        fd_fused.causal_spectrum(u.clone().requires_grad_())
    with pytest.raises(NotImplementedError, match="forward-only"):
        fd_fused.causal_spectrum_adjoint(dk.clone().requires_grad_(), 8)


@pytest.mark.parametrize("b,n,d", [(2, 64, 6), (1, 1, 3), (2, 2, 4)])
def test_fd_tno_fused_route_matches_window_route_and_jax(b, n, d,
                                                         monkeypatch):
    """On a fused length the op's forward and backward agree with the
    window route's (the route patched to "window") and with jax.grad of
    the JAX reference, and the window route's launch counts stay 0 on
    the CPU."""
    rng = np.random.default_rng(b * n * d)
    x = rng.standard_normal((b, n, d), np.float32)
    khat = rng.standard_normal((d, n + 1), np.float32)
    cot = rng.standard_normal((b, n, d), np.float32)

    def run():
        xt, kt = _t(x).requires_grad_(), _t(khat).requires_grad_()
        y = ops.fd_tno(xt, kt)
        y.backward(_t(cot))
        return y.detach(), xt.grad, kt.grad

    assert backend.causal_spectrum_route(n) == "fused"
    fused = run()
    monkeypatch.setattr(backend, "causal_spectrum_route",
                        lambda n: "window")
    window = run()
    for a, w in zip(fused, window):
        assert _rel(a, w) <= TOL
    _, vjp = jax.vjp(jref.fd_tno_ref, jnp.asarray(x), jnp.asarray(khat))
    gx, gk = vjp(jnp.asarray(cot))
    assert _rel(fused[1], gx) <= TOL and _rel(fused[2], gk) <= TOL
    assert fd_fused.counters == dict.fromkeys(fd_fused.counters, 0)
    assert fd_fused.op_counters == {"fwd": 2, "bwd_kernel": 2, "bwd_ref": 0}
