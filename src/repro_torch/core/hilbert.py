"""Causal spectrum construction (paper §3.3.1), counterpart of
``repro/core/hilbert.py:causal_spectrum``.

For a length-2n DFT, ``u - i·H{u}`` is exactly the spectrum of the
one-sided (causal) window of ``irfft(u)``: the analytic-signal construction
applied in the frequency variable. The window is the ``hilbert_window``
kernel on a CUDA tensor and its plain version on a CPU tensor.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import fd_fused


def causal_spectrum(khat_real: torch.Tensor) -> torch.Tensor:
    """khat_real: (..., n+1) real samples on the rfft grid of a length-2n
    signal. Returns complex64 (..., n+1) ``khat - i·H{khat}`` whose irfft
    is (exactly) a causal length-2n kernel supported on lags 0..n."""
    n = khat_real.shape[-1] - 1
    lead = khat_real.shape[:-1]
    kt = torch.fft.irfft(khat_real.float(), n=2 * n, dim=-1)
    kc = fd_fused.hilbert_window(kt.reshape(-1, 2 * n).contiguous(), n)
    return torch.fft.rfft(kc, n=2 * n, dim=-1).reshape(*lead, n + 1)
