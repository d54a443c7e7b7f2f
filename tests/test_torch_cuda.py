"""Card-only checks of the port's CUDA kernels that ``chip_smoke.py``, which
runs on one card, cannot make. Each test is marked ``cuda`` and skips
without the cards it needs; run them on a machine with two or more cards:

    python -m pytest -q -p no:cacheprovider tests/test_torch_cuda.py

The per-device state of the kernels: a kernel whose dynamic shared memory
exceeds 48 KB needs ``cudaFuncSetAttribute`` on every device it launches
on, and each device has its own SM count. Each kernel is launched on two
cards in turn and held against its plain version on each (fp32 tier,
1e-5 × max|plain|; ``gram_grad`` and ``interp_expand`` 1e-6, sums of b
and of two terms), at a shape whose block needs more than 48 KB of
dynamic shared memory where the kernel has any (``interp_expand`` has
none). ``ssd_scan`` is held in bf16 within 1e-2 × max|plain|
(``chip_smoke.BF16_TOL``: its products are TF32 and bf16, and y rounds to
bf16 once on each side); ``conv_tap_grad``'s bf16 instance within 1e-5
(bf16 inputs, fp32 sums on both sides).
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
    path's shape and with m = 400 taps: conv_tap_grad's block needs more
    than 48 KB of shared memory, and each card has its own tickets (a
    module variable), which the last block of each tile resets."""
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


def test_short_conv_and_interp_expand_run_on_each_card():
    """short_conv with m = 200 taps (67,456 bytes of shared memory a
    block) and interp_expand at the SKI path's shape, on card 0, then on
    card 1."""
    from repro_torch.core import ski
    from repro_torch.kernels import interp_matvec, short_conv
    b, n, d, r = 8, 512, 512, 64
    for dev in _two_cards():
        g = torch.Generator(device=dev).manual_seed(dev.index)
        x = torch.randn(b, n, d, device=dev, generator=g)
        for m, left in ((32, 0), (200, 100)):
            f = torch.randn(d, m, device=dev, generator=g)
            got = short_conv.short_conv(x, f, left)
            torch.cuda.synchronize(dev)
            _close(got, ref.short_conv_left_ref(x, f, left), 1e-5)
        z = torch.randn(b, r, d, device=dev, generator=g)
        lo, w_lo, _ = ski.make_inducing(n, r, dev)
        got = interp_matvec.interp_expand(z, lo, w_lo)
        torch.cuda.synchronize(dev)
        _close(got, ref.interp_expand_ref(z, lo, w_lo), 1e-6)


def test_window_pass2_runs_on_each_card():
    """ski_windowed_pass2 (r = 512, 105,632 bytes of shared memory a block,
    its Gram on the tensor cores) and ski_expand_pass2 (m = 64, 51,616
    bytes) at x (8, 512, 512), on card
    0, then on card 1: each card needs its own shared-memory attribute."""
    b, n, d, r = 8, 512, 512, 512
    for dev in _two_cards():
        g = torch.Generator(device=dev).manual_seed(dev.index)
        x = torch.randn(b, n, d, device=dev, generator=g)
        z = torch.randn(b, r, d, device=dev, generator=g)
        coef = torch.randn(d, 2 * r - 1, device=dev, generator=g) / r ** 0.5
        f = torch.randn(d, 32, device=dev, generator=g)
        got = ski_fused.ski_windowed_pass2(x, z, coef, f, True)
        torch.cuda.synchronize(dev)
        want = ref.ski_expand_pass2_ref(
            x, ref.toeplitz_gram_matvec_ref(coef, z), f, True)
        _close(got, want, 1e-5)
        f = torch.randn(d, 64, device=dev, generator=g)
        got = ski_fused.ski_expand_pass2(x, z, f, False)
        torch.cuda.synchronize(dev)
        _close(got, ref.ski_expand_pass2_ref(x, z, f, False), 1e-5)


def test_ssd_scan_runs_on_each_card():
    """ssd_scan in bf16 (the tensor-core kernel, 115,712 bytes of shared
    memory a block and the max-shared carveout) and fp32 (218,112 bytes) at
    the Mamba path's widths (p 64, s 128, chunk 128) with two chunks, on
    card 0, then on card 1: each card needs its own attributes."""
    from repro_torch.kernels import ssd_chunked, ssd_scan
    bt, n, h, p, g, s, q = 2, 256, 8, 64, 1, 128, 128
    for dev in _two_cards():
        gen = torch.Generator(device=dev).manual_seed(dev.index)

        def rnd(*shape):
            return torch.randn(*shape, device=dev, generator=gen)
        for dtype, tol in ((torch.bfloat16, 1e-2), (torch.float32, 1e-5)):
            x = rnd(bt, n, h, p).to(dtype)
            dt = torch.nn.functional.softplus(rnd(bt, n, h) - 3.0)
            a = -torch.exp(0.1 * rnd(h))
            b, c = rnd(bt, n, g, s).to(dtype), rnd(bt, n, g, s).to(dtype)
            d = 1.0 + 0.1 * rnd(h)
            got = ssd_scan.ssd_scan(x, dt, a, b, c, d, chunk=q)
            torch.cuda.synchronize(dev)
            want = ssd_chunked.ssd_scan_chunked(x, dt, a, b, c, d, chunk=q)
            assert got.dtype == dtype
            _close(got.float(), want.float(), tol)



def test_conv_tap_grad_bf16_runs_on_each_card():
    """conv_tap_grad's bf16 instance (57,344 bytes of shared memory a
    block) at Mamba's conv width (d 5376, m 4) and at the SKI path's shape
    (m 32, left 16), on card 0, then on card 1, within 1e-5 × max|plain|:
    the inputs are exact in bf16 and both sides sum in fp32."""
    from repro_torch.kernels import ski_grad
    for dev in _two_cards():
        g = torch.Generator(device=dev).manual_seed(dev.index)
        for (b, n, d), m, left in (((2, 2048, 5376), 4, 0),
                                   ((8, 512, 512), 32, 16)):
            cot = torch.randn(b, n, d, device=dev, generator=g).bfloat16()
            x = torch.randn(b, n, d, device=dev, generator=g).bfloat16()
            got = ski_grad.conv_tap_grad(cot, x, m, left)
            torch.cuda.synchronize(dev)
            assert got.dtype == torch.float32
            _close(got, ref.conv_tap_grad_ref(cot, x, m, left), 1e-5)

def test_causal_spectrum_runs_on_each_card():
    """causal_spectrum and causal_spectrum_adjoint at n = 4096 (98,320
    bytes of shared memory a block) and at the FD path's n = 512, on card
    0, then on card 1: each card needs its own shared-memory attribute."""
    from repro_torch.kernels import fd_fused
    for dev in _two_cards():
        g = torch.Generator(device=dev).manual_seed(dev.index)
        for d, n in ((37, 4096), (512, 512)):
            u = torch.randn(d, n + 1, device=dev, generator=g)
            dk = torch.randn(d, n + 1, dtype=torch.complex64, device=dev,
                             generator=g)
            got = fd_fused.causal_spectrum(u, conj=True)
            torch.cuda.synchronize(dev)
            _close(torch.view_as_real(got), torch.view_as_real(
                ref.causal_spectrum_ref(u, conj=True)), 1e-5)
            got = fd_fused.causal_spectrum_adjoint(dk, n)
            torch.cuda.synchronize(dev)
            _close(got, ref.causal_spectrum_adjoint_ref(dk, n), 1e-5)


def test_mesh_train_on_cards(tmp_path):
    """The full-width ski-tnn-lm-wt103 trained 3 steps of 8 × 512 through
    ``StepBuilder`` on one NCCL rank a card (2 cards, or 4 where there
    are 4 or more), on meshes (1, w) and (w/2, 2): FSDP over data, channel
    TP over model, the SKI kernels on each rank's channels. Held to the
    mesh-free run on one card from the same init and batches: losses
    within 1e-5 relative, parameters within 2·Σ lr per element with 99%
    within 1e-5 (``tests/test_torch_train.py``'s Adam rule)."""
    _two_cards()
    import json

    import _mesh_ranks
    w = 4 if torch.cuda.device_count() >= 4 else 2
    for shape in sorted({f"1x{w}", f"{w // 2}x2"}):
        store = tmp_path / f"store_{shape}"
        _mesh_ranks.spawn(lambda r: ("cards", r, w, store, shape, tmp_path),
                          w, timeout=600)
        res = json.loads((tmp_path / f"cards_{shape}.json").read_text())
        print(f"[cards {shape}] {w} ranks: losses {res['losses']}, one "
              f"card {res['ref_losses']}; worst parameter diff "
              f"{max(res['max_diff'].values()):.3e} (bound "
              f"{2 * sum(res['lrs']):.3e}); least share within 1e-5 "
              f"{min(res['within_1e-5'].values()):.4f}")
        data, model = map(int, shape.split("x"))
        assert res["local_wu"] == [512 // data, 512 // model], shape
        for got, want in zip(res["losses"], res["ref_losses"]):
            assert abs(got - want) <= 1e-5 * abs(want), (shape, got, want)
        bound = 2 * sum(res["lrs"])
        for k, d in res["max_diff"].items():
            assert d <= bound, (shape, k, d)
            assert res["within_1e-5"][k] >= 0.99, (shape, k)
