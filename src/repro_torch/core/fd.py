"""Frequency-domain TNO (paper §3.3, Algorithm 2), causal branch —
counterpart of ``repro/core/fd.py``.

The RPE MLP models the *real part* of the kernel's DTFT sampled at
ω_m = mπ/n (m = 0..n, the rfft grid of a length-2n signal); the imaginary
part comes from the discrete Hilbert transform, making the time-domain
kernel exactly causal. Only this causal form is ported: the JAX package's
bidirectional branch (complex response, ``FDConfig.causal=False``) serves
no decoder LM.
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
    rpe_hidden: int = 64
    rpe_layers: int = 3
    rpe_act: str = "relu"     # decay class knob (Thms 2-4)
    use_layernorm: bool = True


def _rpe_cfg(cfg: FDConfig) -> MLPRPEConfig:
    return MLPRPEConfig(cfg.d, cfg.rpe_hidden, cfg.rpe_layers, cfg.rpe_act,
                        cfg.use_layernorm)


class FDParams(nn.Module):
    """The FD mixer's parameters: the RPE MLP (JAX leaf ``rpe``)."""

    def __init__(self, cfg: FDConfig, device=None):
        super().__init__()
        self.rpe = mlp_rpe_init(_rpe_cfg(cfg), device=device)


def fd_init(cfg: FDConfig, device=None) -> FDParams:
    return FDParams(cfg, device=device)


def _omega_grid(n: int, device) -> torch.Tensor:
    """rfft frequency grid ω/π in [0, 1], built exactly as the JAX package
    builds it (fp32 ``arange(n+1) / n`` in numpy)."""
    return torch.from_numpy(np.arange(n + 1, dtype=np.float32) / n).to(device)


def kernel_spectrum_real(params: FDParams, cfg: FDConfig,
                         n: int) -> torch.Tensor:
    """(d, n+1) *raw* real frequency response on the rfft grid — the RPE
    output before the Hilbert completion (the input of ``ops.fd_tno``)."""
    omega = _omega_grid(int(n), params.rpe.layers[0].w.device)
    return mlp_rpe_apply(params.rpe, _rpe_cfg(cfg), omega).T


def kernel_spectrum(params: FDParams, cfg: FDConfig, n: int) -> torch.Tensor:
    """The (d, n+1) complex causal frequency response on the rfft grid."""
    return causal_spectrum(kernel_spectrum_real(params, cfg, n))


def fd_tno_apply(params: FDParams, cfg: FDConfig, x: torch.Tensor,
                 khat_real: torch.Tensor | None = None) -> torch.Tensor:
    """x: (b, n, d) -> (b, n, d) through the op ``ops.fd_tno``.
    ``khat_real`` — optional precomputed :func:`kernel_spectrum_real`."""
    if khat_real is None:
        khat_real = kernel_spectrum_real(params, cfg, x.shape[1])
    return ops.fd_tno(x, khat_real)


def fd_kernel_time(params: FDParams, cfg: FDConfig, n: int) -> torch.Tensor:
    """Time-domain kernel (d, 2n): lags 0..n then -(n-1)..-1 (circular
    layout; the negative lags are zero). The decode cache's kernel."""
    return torch.fft.irfft(kernel_spectrum(params, cfg, n), n=2 * n, dim=-1)
