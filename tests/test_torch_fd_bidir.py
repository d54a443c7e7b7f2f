"""Port parity for the bidirectional FD-TNO (``repro_torch.core.fd`` with
``causal=False``: the 2d-wide RPE models the complex response, its
imaginary part zeroed at DC and Nyquist) against the JAX package, for both
feature maps (``"linear"`` ω/π and ``"cos"`` cos ω), on the same seeded
inputs and bridged parameters. Mirrors tests/test_paper_core.py's
``test_fd_bidirectional_one_fewer_fft`` and ``test_omega_grid_cache_...``.

Tolerances: the RPE grid is bitwise (both build it in fp32 numpy); the
spectrum, the time kernel, y and every gradient within 1e-5 of their
largest magnitude (fp32 matmul and FFT sums in other orders).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import fd as jfd  # noqa: E402
from repro.core import tno as jtno  # noqa: E402
from repro.nn.params import unbox  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.core import fd, tno  # noqa: E402

torch.set_num_threads(1)
TOL = 1e-5
FEATURES = ("linear", "cos")


def _rel(got, want) -> float:
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-30)


def _load(params, tree) -> None:
    """Copy a JAX parameter tree into a port module, leaf for leaf."""
    flat = dict(bridge._flatten(jax.tree.map(np.asarray, tree)))
    assert set(flat) == {k for k, _ in params.named_parameters()}
    with torch.no_grad():
        for k, p in params.named_parameters():
            p.copy_(bridge._as_torch(flat[k]))


def _fd(d=6, feature="linear", causal=False, seed=0):
    """(JAX cfg, JAX params, port cfg, port params), the same values."""
    jcfg = jfd.FDConfig(d=d, causal=causal, rpe_hidden=16, feature=feature)
    jp, _ = unbox(jfd.fd_init(jax.random.PRNGKey(seed), jcfg))
    cfg = fd.FDConfig(d=d, causal=causal, rpe_hidden=16, feature=feature)
    params = fd.fd_init(cfg)
    _load(params, jp)
    return jcfg, jp, cfg, params


def _x(*shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def test_config_fields_in_jax_order():
    """FDConfig's shared fields sit in JAX's order, so a positional call
    means the same in both packages (JAX's extra ``use_pallas`` is a
    backend switch the port's dispatch replaces)."""
    import dataclasses
    want = [f.name for f in dataclasses.fields(jfd.FDConfig)]
    got = [f.name for f in dataclasses.fields(fd.FDConfig)]
    assert got == [n for n in want if n != "use_pallas"]
    assert fd._rpe_cfg(fd.FDConfig(d=5, causal=False)).d_out == 10
    assert fd._rpe_cfg(fd.FDConfig(d=5)).d_out == 5


@pytest.mark.parametrize("n", [1, 7, 16, 512])
@pytest.mark.parametrize("feature", FEATURES)
def test_omega_grid_bitwise(feature, n):
    got = fd._omega_grid(n, feature, "cpu").numpy()
    np.testing.assert_array_equal(got, jfd._omega_grid_host(n, feature))
    assert got.dtype == np.float32


@pytest.mark.parametrize("n", [1, 8, 37, 256])
@pytest.mark.parametrize("feature", FEATURES)
def test_kernel_spectrum_matches_jax(feature, n):
    jcfg, jp, cfg, params = _fd(feature=feature)
    want = np.asarray(jfd.kernel_spectrum(jp, jcfg, n))
    with torch.no_grad():
        got = fd.kernel_spectrum(params, cfg, n)
    assert got.shape == (6, n + 1) and got.dtype == torch.complex64
    assert _rel(got.real, want.real) <= TOL
    assert _rel(got.imag, want.imag) <= TOL


@pytest.mark.parametrize("feature", FEATURES)
def test_imag_zero_at_dc_and_nyquist(feature):
    """A real time kernel: the imaginary part is exactly 0 at bins 0 and
    n, and not elsewhere."""
    _, _, cfg, params = _fd(feature=feature)
    n = 16
    with torch.no_grad():
        k = fd.kernel_spectrum(params, cfg, n)
        raw = fd._rpe_out(params, cfg, n)[:, cfg.d:].T
    assert torch.all(k.imag[:, 0] == 0) and torch.all(k.imag[:, n] == 0)
    assert torch.equal(k.imag[:, 1:n], raw[:, 1:n])
    assert bool((k.imag[:, 1:n] != 0).any())
    with pytest.raises(ValueError, match="causal-only"):
        fd.kernel_spectrum_real(params, cfg, n)


@pytest.mark.parametrize("causal", [False, True],
                         ids=["bidirectional", "causal"])
@pytest.mark.parametrize("feature", FEATURES)
def test_kernel_time_matches_jax(feature, causal):
    jcfg, jp, cfg, params = _fd(feature=feature, causal=causal)
    n = 24
    want = np.asarray(jfd.fd_kernel_time(jp, jcfg, n))
    with torch.no_grad():
        got = fd.fd_kernel_time(params, cfg, n)
    assert got.shape == (6, 2 * n)
    assert _rel(got, want) <= TOL
    if causal:                   # negative lags -(n-1)..-1 vanish
        assert float(got[:, n + 1:].abs().max()) <= 1e-5 * float(
            got.abs().max())
    else:                        # a full-context kernel
        assert float(got[:, n + 1:].abs().max()) > 1e-3 * float(
            got.abs().max())


@pytest.mark.parametrize("shape", [(2, 16, 6), (1, 33, 6), (3, 1, 6)])
@pytest.mark.parametrize("feature", FEATURES)
def test_fd_tno_apply_matches_jax(feature, shape):
    jcfg, jp, cfg, params = _fd(feature=feature)
    x = _x(*shape)
    want = jfd.fd_tno_apply(jp, jcfg, jnp.asarray(x))
    with torch.no_grad():
        got = fd.fd_tno_apply(params, cfg, torch.from_numpy(x))
    assert got.shape == shape and got.dtype == torch.float32
    assert _rel(got, want) <= TOL


@pytest.mark.parametrize("feature", FEATURES)
def test_fd_tno_grads_match_jax(feature):
    """The backward is autograd through ``torch.fft`` against ``jax.grad``
    through ``jnp.fft``: the input and every RPE parameter."""
    jcfg, jp, cfg, params = _fd(feature=feature)
    x, cot = _x(2, 20, 6), _x(2, 20, 6, seed=3)
    jgx, jgp = jax.grad(lambda xx, p: jnp.sum(
        jfd.fd_tno_apply(p, jcfg, xx) * cot), argnums=(0, 1))(
            jnp.asarray(x), jp)
    xt = torch.from_numpy(x).requires_grad_()
    (fd.fd_tno_apply(params, cfg, xt) * torch.from_numpy(cot)).sum().backward()
    assert _rel(xt.grad, jgx) <= TOL
    want = dict(bridge._flatten(jax.tree.map(np.asarray, jgp)))
    for k, p in params.named_parameters():
        assert _rel(p.grad, want[k]) <= TOL, k


def test_tno_plan_and_apply_match_jax():
    """Through ``TNOConfig(variant="fd", causal=False)``: the plan is the
    complex spectrum and ``tno_apply`` with or without it gives JAX's y."""
    jcfg = jtno.TNOConfig(d=6, variant="fd", causal=False, rpe_hidden=16)
    jp, _ = unbox(jtno.tno_init(jax.random.PRNGKey(2), jcfg))
    cfg = tno.TNOConfig(d=6, variant="fd", causal=False, rpe_hidden=16)
    params = tno.tno_init(cfg)
    _load(params, jp)
    x = _x(2, 12, 6)
    want = jtno.tno_apply(jp, jcfg, jnp.asarray(x))
    with torch.no_grad():
        plan = tno.tno_plan(params, cfg, 12)
        got = tno.tno_apply(params, cfg, torch.from_numpy(x), plan=plan)
        bare = tno.tno_apply(params, cfg, torch.from_numpy(x))
    assert set(plan) == {"khat"}
    assert _rel(got, want) <= TOL
    assert torch.equal(got, bare)


def test_bidirectional_is_full_context():
    """Mirrors test_fd_bidirectional_one_fewer_fft: the output at position
    0 depends on the last token, and y keeps x's dtype."""
    _, _, cfg, params = _fd(d=4)
    x1 = torch.from_numpy(_x(1, 32, 4))
    x2 = x1.clone()
    x2[:, -1] += 1.0
    with torch.no_grad():
        y1 = fd.fd_tno_apply(params, cfg, x1)
        y2 = fd.fd_tno_apply(params, cfg, x2)
    assert float((y1[:, 0] - y2[:, 0]).abs().max()) > 1e-6
    assert y1.dtype == x1.dtype
