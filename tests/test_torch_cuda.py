"""Card-only checks of the port's CUDA kernels that ``chip_smoke.py``, which
runs on one card, cannot make. Each test is marked ``cuda`` and skips
without the cards it needs; run them on a machine with two or more cards:

    python -m pytest -q -p no:cacheprovider tests/test_torch_cuda.py

The per-device state of the kernels: a kernel whose dynamic shared memory
exceeds 48 KB needs ``cudaFuncSetAttribute`` on every device it launches
on, and each device has its own SM count. Each kernel is launched on two
cards in turn and held against its plain version on each (fp32 tier,
1e-5 × max|plain|; ``gram_grad`` 1e-6, a sum of b terms).
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ref, ski_fused  # noqa: E402

pytestmark = pytest.mark.cuda


def _two_cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    return [torch.device("cuda", i) for i in (0, 1)]


def _close(got, want, tol):
    err, scale = float((got - want).abs().max()), float(want.abs().max())
    assert err <= tol * scale, f"max abs err {err} > {tol} x {scale}"


def test_pass2_runs_on_each_card():
    """The fused pass 2 at r = 128, d = 512 (59 KB of shared memory a block
    at least) on card 0, then on card 1: the second card needs its own
    shared-memory attribute."""
    b, n, d, r, m = 8, 512, 512, 128, 32
    for dev in _two_cards():
        g = torch.Generator(device=dev).manual_seed(dev.index)
        x = torch.randn(b, n, d, device=dev, generator=g)
        z = torch.randn(b, r, d, device=dev, generator=g)
        a = torch.randn(d, r, r, device=dev, generator=g)
        f = torch.randn(d, m, device=dev, generator=g)
        got = ski_fused.ski_fused_pass2(x, z, a, f, True)
        torch.cuda.synchronize(dev)
        _close(got, ref.ski_fused_pass2_ref(x, z, a, f, True), 1e-5)


def test_grad_kernels_run_on_each_card():
    """gram_grad and conv_tap_grad on card 0, then on card 1, at the SKI
    path's shape and with m = 400 taps (conv_tap_grad's block then needs
    more than 48 KB of shared memory)."""
    from repro_torch.kernels import ski_grad
    b, n, d, r = 8, 512, 512, 64
    for dev in _two_cards():
        g = torch.Generator(device=dev).manual_seed(dev.index)
        gz = torch.randn(b, r, d, device=dev, generator=g)
        z = torch.randn(b, r, d, device=dev, generator=g)
        _close(ski_grad.gram_grad(gz, z), ref.gram_grad_ref(gz, z), 1e-6)
        cot = torch.randn(b, n, d, device=dev, generator=g)
        x = torch.randn(b, n, d, device=dev, generator=g)
        for m, left in ((32, 0), (400, 200)):
            got = ski_grad.conv_tap_grad(cot, x, m, left)
            torch.cuda.synchronize(dev)
            _close(got, ref.conv_tap_grad_ref(cot, x, m, left), 1e-5)
