"""The transform plan of the fused causal-spectrum CUDA kernels, on the CPU.

``causal_spectrum`` and ``causal_spectrum_adjoint``
(``src/repro_torch/kernels/csrc/fd_fused.cu``) do two real FFTs of length
2n and the lag window in shared memory, by rules that no CPU run of the
port reaches: the wrappers take the plain versions for CPU tensors. This
file repeats those rules in torch, from the constants of the source
itself, and checks them for every power of two 2 <= 2n <= 8192 and ragged
channel counts d:

* the launch (``cs_launch``): rows a block, threads a block (a multiple of
  32, at most ``kCsMaxThreads``), a grid that covers the d rows, and a
  dynamic shared-memory request that holds the twiddle table and both row
  buffers, within the card's 227 KB; every index a replayed phase reads or
  writes lies inside its buffer;
* the plan: the Stockham passes (a first pass of radix 2^(log2 n mod 3),
  8 when that is 0, then radix-8; each pass a permutation of a row's n
  slots, twiddle indices below 2n), the inverse's first pass reading the
  pack of its real FFT (bins m and n - m, the twiddle exp(+2 pi i m / 2n)),
  the forward's first pass reading the packed samples times the window and
  1/n, and the post-twiddle. Replayed in
  float64 it matches ``torch.fft`` to 1e-12 of the output's max; in float32
  (the table rounded to fp32, as ``sincospif`` gives it) ``ref``'s plain
  versions to 1e-5 × max, for both entry points.
"""
import math
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import backend, ref  # noqa: E402

torch.set_num_threads(1)

SRC = (Path(__file__).resolve().parents[1]
       / "src/repro_torch/kernels/csrc/fd_fused.cu")
TEXT = SRC.read_text()
#: every ``constexpr int`` of the source set to a number, by name
K = {m.group(1): int(m.group(2)) for m in re.finditer(
    r"constexpr int (\w+) = (\d+);", TEXT)}
#: the card's shared memory a block can use (H100, 227 KB)
SMEM_MAX = 232_448
HALVES = [1 << k for k in range(13)]              # n = 1 .. 4096
DS = (1, 3, 37)


def test_constants_found():
    assert {"kCsRowElems", "kCsMaxThreads", "kCsMaxHalf"} <= set(K)
    assert K["kCsMaxHalf"] == backend.CAUSAL_SPECTRUM_NMAX
    # the launch rules replayed below, as the source writes them
    for text in ("8LL * half + 16LL * rows * (half + 1)",
                 "half >= kCsRowElems ? 1 : kCsRowElems / half",
                 "(rows * half / 4 + 31) / 32 * 32"):
        assert text in TEXT, text


def cs_launch(d: int, half: int):
    """(rows a block, threads a block, dynamic shared memory bytes), as the
    source's ``cs_launch``."""
    rows = 1 if half >= K["kCsRowElems"] else K["kCsRowElems"] // half
    rows = min(rows, d)
    threads = (rows * half // 4 + 31) // 32 * 32
    threads = min(max(threads, 32), K["kCsMaxThreads"])
    return rows, threads, 8 * half + 16 * rows * (half + 1)


def plan(half: int):
    """The Stockham passes (radix, ns) of a length-``half`` FFT, as the
    source's ``complex_fft``: a first pass of radix 2^(log2 M mod 3) (8
    when that is 0 and M > 1, 1 at M = 1), then radix-8 passes."""
    lm = half.bit_length() - 1
    r0 = 1 << (lm % 3) if lm % 3 else (1 if lm == 0 else 8)
    passes, ns = [(r0, 1)], r0
    while ns < half:
        passes.append((8, ns))
        ns *= 8
    return passes


class Replay:
    """The kernel's arithmetic on a (rows, half) block of packed rows, with
    its index rules, in ``cdtype``; records each buffer index it touches."""

    def __init__(self, half: int, cdtype):
        self.half, self.cdtype = half, cdtype
        k = np.arange(half, dtype=np.float64) / half
        t = np.cos(np.pi * k) - 1j * np.sin(np.pi * k)
        # the fp32 table: sincospif at an exact argument, rounded to fp32
        self.t = torch.from_numpy(t).to(cdtype)
        self.touched = 0                  # the largest index of a row

    def twiddle(self, k, inverse):
        assert int(k.max()) < 2 * self.half
        lo = self.t[torch.where(k < self.half, k, k - self.half)]
        w = torch.where(k < self.half, lo, -lo)
        return w.conj() if inverse else w

    def _touch(self, idx):
        self.touched = max(self.touched, int(idx.max()))
        return idx

    def dft(self, v, inverse):
        """The in-register DFT of len(v) points, exp(-+2 pi i / R)."""
        r = len(v)
        sign = 1.0 if inverse else -1.0
        return [sum(v[a] * complex(np.exp(sign * 2j * np.pi * a * b / r))
                    for a in range(r)) for b in range(r)]

    def fft(self, load, inverse):
        """The passes of ``plan``; the first reads element m of each row as
        ``load(m)``, the others the previous pass's output."""
        half = self.half
        z = None
        for radix, ns in plan(half):
            q = half // radix
            j = torch.arange(q)
            k = j & (ns - 1)
            step = 2 * half // (ns * radix)
            assert step >= 2 and step * ns * radix == 2 * half
            assert ns == 1 or z is not None
            idx = [self._touch(j + r * q) for r in range(radix)]
            v = [load(i) if z is None else z[:, i] for i in idx]
            for r in range(1, radix):
                v[r] = torch.where(k == 0, v[r],
                                   v[r] * self.twiddle(k * r * step, inverse))
            y = self.dft(v, inverse)
            out = v[0].new_empty(v[0].shape[0], half)
            dst = [self._touch((j - k) * radix + k + r * ns)
                   for r in range(radix)]
            # each pass writes every slot of a row once
            assert torch.equal(torch.sort(torch.cat(dst)).values,
                               torch.arange(half))
            for r in range(radix):
                out[:, dst[r]] = y[r]
            z = out
        return z

    def run(self, x, adjoint: bool, conj: bool = False):
        """x: (rows, half+1) real (forward) or complex (adjoint)."""
        half = self.half
        xs = x.to(self.cdtype).clone()
        if adjoint:                    # bins 0 and M keep their real parts
            xs[:, 0] = xs[:, 0].real.to(self.cdtype)
            xs[:, half] = xs[:, half].real.to(self.cdtype)

        def pack(m):                   # the inverse's first-pass loads
            xm = xs[:, self._touch(m)]
            xc = xs[:, self._touch(half - m)].conj()
            ev, ov = 0.5 * (xm + xc), 0.5 * (xm - xc) * self.t[m].conj()
            return ev + 1j * ov
        z = self.fft(pack, inverse=True)

        def window(m):                 # the forward's first-pass loads
            v = z[:, m]
            return torch.complex(
                v.real * _window_scale(2 * m, half).to(v.real.dtype),
                v.imag * _window_scale(2 * m + 1, half).to(v.real.dtype))
        z = self.fft(window, inverse=False)
        m = torch.arange(half + 1)
        zm = z[:, self._touch(m & (half - 1))]
        zc = z[:, self._touch((half - m) & (half - 1))].conj()
        ev, ov = 0.5 * (zm + zc), -1j * 0.5 * (zm - zc)
        w = torch.where(m < half, self.t[m % half],
                        torch.tensor(-1.0, dtype=self.cdtype))
        out = ev + w * ov
        if adjoint:
            c = torch.where((m == 0) | (m == half), 0.5, 1.0)
            return out.real * c.to(out.real.dtype) / half
        return torch.conj_physical(out) if conj else out


def _window_scale(t, half):
    """w(t) / M, as the source's ``window_scale``."""
    w = torch.where((t == 0) | (t == half), 1.0,
                    torch.where(t < half, 2.0, 0.0))
    return w / half


def _inputs(d, half, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    u = torch.randn(d, half + 1, generator=g, dtype=dtype)
    dk = torch.complex(torch.randn(d, half + 1, generator=g, dtype=dtype),
                       torch.randn(d, half + 1, generator=g, dtype=dtype))
    return u, dk


def _window(h, half):
    """The lag window on (d, 2n) lags, in h's precision."""
    return h * _window_scale(torch.arange(2 * half), half).to(h.dtype) * half


def _fft_spectrum(u, half):
    """rfft(w ⊙ irfft(u, 2n)) in u's precision by torch.fft."""
    h = torch.fft.irfft(u, n=2 * half, dim=-1)
    return torch.fft.rfft(_window(h, half), n=2 * half, dim=-1)


def _fft_adjoint(dk, half):
    """(c / 2n) Re rfft(w ⊙ irfft(dk, 2n)) by torch.fft (the irfft drops
    the edge bins' imaginary parts)."""
    h = _window(torch.fft.irfft(dk, n=2 * half, dim=-1), half)
    c = torch.full((half + 1,), 2.0, dtype=h.dtype)
    c[0] = c[half] = 1.0
    return c / (2 * half) * torch.fft.rfft(h, n=2 * half, dim=-1).real


def _rel(got, want):
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("d", DS)
@pytest.mark.parametrize("half", HALVES)
def test_launch_covers_rows_and_fits_shared_memory(half, d):
    rows, threads, smem = cs_launch(d, half)
    assert 1 <= rows <= d and threads % 32 == 0
    assert 32 <= threads <= K["kCsMaxThreads"]
    grid = -(-d // rows)
    assert (grid - 1) * rows < d <= grid * rows
    assert smem <= SMEM_MAX
    # the replay's largest index of a row, in the buffers the request holds:
    # the table (half float2), then two buffers of rows x (half+1) float2
    rp = Replay(half, torch.complex128)
    rp.run(torch.zeros(rows, half + 1, dtype=torch.complex128), True)
    assert rp.touched <= half
    assert 8 * half + 2 * 8 * ((rows - 1) * (half + 1) + rp.touched + 1) \
        <= smem


@pytest.mark.parametrize("half", HALVES)
def test_plan_passes(half):
    passes = plan(half)
    assert math.prod(r for r, _ in passes) == half
    assert all(r == 8 for r, _ in passes[1:])
    assert len(passes) == max(1, -(-(half.bit_length() - 1) // 3))
    assert [ns for _, ns in passes] == [math.prod(
        r for r, _ in passes[:i]) for i in range(len(passes))]


@pytest.mark.parametrize("d", DS)
@pytest.mark.parametrize("half", HALVES)
def test_replay_float64_matches_torch_fft(half, d):
    u, dk = _inputs(d, half, torch.float64, half + d)
    rp = Replay(half, torch.complex128)
    got = rp.run(u, adjoint=False)
    assert _rel(got, _fft_spectrum(u, half)) <= 1e-12
    assert _rel(rp.run(u, adjoint=False, conj=True),
                _fft_spectrum(u, half).conj()) <= 1e-12
    # the real part of the causal spectrum is the response itself
    assert _rel(got.real, u) <= 1e-12
    assert _rel(rp.run(dk, adjoint=True), _fft_adjoint(dk, half)) <= 1e-12


@pytest.mark.parametrize("d", DS)
@pytest.mark.parametrize("half", HALVES)
def test_replay_float32_matches_ref(half, d):
    u, dk = _inputs(d, half, torch.float32, 7 * half + d)
    rp = Replay(half, torch.complex64)
    for conj in (False, True):
        got = torch.view_as_real(rp.run(u, adjoint=False, conj=conj))
        want = torch.view_as_real(ref.causal_spectrum_ref(u, conj))
        assert _rel(got, want) <= 1e-5
    got = rp.run(dk, adjoint=True)
    assert _rel(got, ref.causal_spectrum_adjoint_ref(dk, half)) <= 1e-5
