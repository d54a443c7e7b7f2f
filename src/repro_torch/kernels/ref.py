"""Plain torch versions of the kernels, function for function with
``repro/kernels/ref.py``. The CPU path of every kernel wrapper runs these;
``chip_smoke.py`` holds each CUDA kernel against them on the card. Nothing
on the CUDA main path calls them. All are differentiable by autograd."""
from __future__ import annotations

import torch


# ------------------------------------------------------- causal FD-TNO
def hilbert_window_ref(kt: torch.Tensor, n: int) -> torch.Tensor:
    """Analytic-signal lag window (paper §3.3.1 Hilbert step in the lag
    variable): keep lag 0 and lag n, double lags 1..n-1, zero the rest.
    kt: (d, T) with T >= n+1 (normally T = 2n). Plain version of the
    ``hilbert_window`` kernel; diagonal ⇒ self-adjoint."""
    t = torch.arange(kt.shape[-1], device=kt.device)
    w = torch.where((t == 0) | (t == n), 1.0,
                    torch.where(t < n, 2.0, 0.0))
    return (kt.float() * w[None]).to(kt.dtype)


def fd_spectral_multiply_ref(xr, xi, kr, ki):
    """Complex spectral multiply on planes: ŷ = x̂ ⊙ k̂ per channel.
    xr, xi: (b, F, d); kr, ki: (F, d). fp32 outputs."""
    xr, xi = xr.float(), xi.float()
    kr, ki = kr.float()[None], ki.float()[None]
    return xr * kr - xi * ki, xr * ki + xi * kr


def fd_mul_ref(xhat: torch.Tensor, khat: torch.Tensor) -> torch.Tensor:
    """Plain version of the ``fd_mul`` kernel on complex64 tensors:
    ŷ[b] = x̂[b] ⊙ k̂, with k̂ shaped like one batch row of x̂. The same
    real arithmetic as the kernel, through :func:`fd_spectral_multiply_ref`."""
    yr, yi = fd_spectral_multiply_ref(xhat.real, xhat.imag,
                                      khat.real, khat.imag)
    return torch.complex(yr, yi)


def fd_khat_grad_planes_ref(gr, gi, xr, xi):
    """Kernel-spectrum cotangent on planes: Σ_b ĝ ⊙ conj(x̂), reduced over
    the leading (batch) axis. gr, gi, xr, xi: (b, F, d) → (dkr, dki) fp32
    (F, d) each, as ``repro/kernels/ref.py:fd_khat_grad_ref``."""
    gr, gi, xr, xi = gr.float(), gi.float(), xr.float(), xi.float()
    return (torch.sum(gr * xr + gi * xi, dim=0),
            torch.sum(gi * xr - gr * xi, dim=0))


def fd_khat_grad_ref(ghat: torch.Tensor, xhat: torch.Tensor) -> torch.Tensor:
    """Plain version of the ``fd_khat_grad`` kernel on complex64 tensors:
    Σ_b ĝ[b] ⊙ conj(x̂[b]) for ĝ, x̂ of one shape (b, ...), e.g. the
    channel-major (b, d, n+1) spectra; returns (...) complex64. The same
    real arithmetic as the kernel, through :func:`fd_khat_grad_planes_ref`."""
    dr, di = fd_khat_grad_planes_ref(ghat.real, ghat.imag,
                                     xhat.real, xhat.imag)
    return torch.complex(dr, di)


def causal_spectrum_ref(khat_real: torch.Tensor) -> torch.Tensor:
    """(d, n+1) real response → complex (d, n+1) causal spectrum
    ``khat - i·H{khat}`` via the lag window (plain version of
    ``core.hilbert.causal_spectrum``)."""
    n = khat_real.shape[-1] - 1
    kt = torch.fft.irfft(khat_real.float(), n=2 * n, dim=-1)
    return torch.fft.rfft(hilbert_window_ref(kt, n), n=2 * n, dim=-1)


def fd_tno_ref(x: torch.Tensor, khat_real: torch.Tensor) -> torch.Tensor:
    """Causal FD-TNO: y = irfft(rfft(x, 2n) ⊙ k̂, 2n)[:n] with
    k̂ = causal_spectrum(khat_real). x: (b, n, d); khat_real: (d, n+1)."""
    b, n, d = x.shape
    khat = causal_spectrum_ref(khat_real)                      # (d, n+1)
    xhat = torch.fft.rfft(x.float(), n=2 * n, dim=1)          # (b, n+1, d)
    y = torch.fft.irfft(xhat * khat.T[None], n=2 * n, dim=1)[:, :n]
    return y.to(x.dtype)
