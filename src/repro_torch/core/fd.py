"""Frequency-domain TNO (paper §3.3, Algorithm 2), counterpart of
``repro/core/fd.py``.

Causal: the RPE MLP models the *real part* of the kernel's DTFT sampled at
ω_m = mπ/n (m = 0..n, the rfft grid of a length-2n signal); the imaginary
part comes from the discrete Hilbert transform, making the time-domain
kernel exactly causal. This form runs through the op ``ops.fd_tno`` (on
the card the ``causal_spectrum``/``hilbert_window`` and ``fd_mul``
kernels).

Bidirectional (``causal=False``): the RPE MLP is 2d wide and models the
complex response directly, its imaginary part pinned to zero at ω ∈ {0, π}
so that the time kernel is real; one fewer FFT than the baseline TNO. The
JAX package runs this form as a plain rfft / multiply / irfft with no
Pallas kernel, and so does the port (``torch.fft``: cuFFT on the card).

``feature`` picks the RPE's input: ``"linear"`` (ω/π, the paper's) or
``"cos"`` (cos ω, the JAX package's periodic feature map).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from repro_torch.core.hilbert import causal_spectrum
from repro_torch.core.rpe import MLPRPEConfig, mlp_rpe_apply, mlp_rpe_init
from repro_torch.kernels import ops


@dataclasses.dataclass(frozen=True)
class FDConfig:
    d: int
    causal: bool = True
    rpe_hidden: int = 64
    rpe_layers: int = 3
    rpe_act: str = "relu"     # decay class knob (Thms 2-4)
    use_layernorm: bool = True
    feature: str = "linear"   # RPE input: "linear" (ω/π) or "cos" (cos ω)


def _rpe_cfg(cfg: FDConfig) -> MLPRPEConfig:
    width = cfg.d if cfg.causal else 2 * cfg.d
    return MLPRPEConfig(width, cfg.rpe_hidden, cfg.rpe_layers, cfg.rpe_act,
                        cfg.use_layernorm)


class FDParams(nn.Module):
    """The FD mixer's parameters: the RPE MLP (JAX leaf ``rpe``)."""

    def __init__(self, cfg: FDConfig, device=None):
        super().__init__()
        self.rpe = mlp_rpe_init(_rpe_cfg(cfg), device=device)


def fd_init(cfg: FDConfig, device=None) -> FDParams:
    return FDParams(cfg, device=device)


def _omega_grid(n: int, feature: str, device) -> torch.Tensor:
    """The RPE's input on the rfft grid, built exactly as the JAX package
    builds it in fp32 numpy: ω/π = ``arange(n+1) / n``, or cos(π · ω/π)
    for ``feature="cos"``."""
    omega = np.arange(n + 1, dtype=np.float32) / n
    if feature == "cos":
        omega = np.cos(np.pi * omega, dtype=np.float32)
    return torch.from_numpy(omega).to(device)


def _rpe_out(params: FDParams, cfg: FDConfig, n: int) -> torch.Tensor:
    """(n+1, width) RPE output on the rfft grid."""
    omega = _omega_grid(int(n), cfg.feature, params.rpe.layers[0].w.device)
    return mlp_rpe_apply(params.rpe, _rpe_cfg(cfg), omega)


def kernel_spectrum_real(params: FDParams, cfg: FDConfig,
                         n: int) -> torch.Tensor:
    """(d, n+1) *raw* real frequency response on the rfft grid — the RPE
    output before the Hilbert completion (the input of ``ops.fd_tno``).
    Causal configs only."""
    if not cfg.causal:
        raise ValueError("kernel_spectrum_real is causal-only; "
                         "bidirectional models the complex response")
    return _rpe_out(params, cfg, n).T


def kernel_spectrum(params: FDParams, cfg: FDConfig, n: int) -> torch.Tensor:
    """The (d, n+1) complex frequency response on the rfft grid: the causal
    completion of the real response, or for a bidirectional config re and
    im from the 2d-wide RPE with im zeroed at DC and Nyquist."""
    if cfg.causal:
        return causal_spectrum(kernel_spectrum_real(params, cfg, n))
    out = _rpe_out(params, cfg, n)                        # (n+1, 2d)
    re, im = out[:, :cfg.d].T, out[:, cfg.d:].T           # (d, n+1)
    mask = torch.ones(n + 1, dtype=torch.float32, device=out.device)
    mask[0] = 0.0
    mask[n] = 0.0
    return torch.complex(re, im * mask)


def fd_tno_apply(params: FDParams, cfg: FDConfig, x: torch.Tensor,
                 khat: torch.Tensor | None = None,
                 khat_real: torch.Tensor | None = None) -> torch.Tensor:
    """x: (b, n, d) -> (b, n, d). Causal configs go through the op
    ``ops.fd_tno`` (``khat_real``: an optional precomputed
    :func:`kernel_spectrum_real`); bidirectional ones (or a given complex
    ``khat``) through a plain length-2n rfft, multiply and irfft in fp32."""
    b, n, d = x.shape
    if cfg.causal and khat is None:
        if khat_real is None:
            khat_real = kernel_spectrum_real(params, cfg, n)
        return ops.fd_tno(x, khat_real)
    if khat is None:
        khat = kernel_spectrum(params, cfg, n)            # (d, n+1)
    xhat = torch.fft.rfft(x.float(), n=2 * n, dim=1)      # (b, n+1, d)
    y = torch.fft.irfft(xhat * khat.T[None], n=2 * n, dim=1)[:, :n]
    return y.to(x.dtype)


def fd_kernel_time(params: FDParams, cfg: FDConfig, n: int) -> torch.Tensor:
    """Time-domain kernel (d, 2n): lags 0..n then -(n-1)..-1 (circular
    layout; a causal config's negative lags are zero). The decode cache's
    kernel."""
    return torch.fft.irfft(kernel_spectrum(params, cfg, n), n=2 * n, dim=-1)
