"""Toeplitz matrix actions via circulant embedding + FFT, counterpart of
``repro/core/toeplitz.py`` (``lags``, ``dense_toeplitz``,
``toeplitz_matvec``, ``toeplitz_matvec_causal``, ``causal_mask_coeffs``).

A length-n Toeplitz matrix ``T_ij = t[i - j]`` is parametrised by its
coefficients at lags ``-(n-1) .. (n-1)``, stored as (..., 2n-1) with
``t[..., k]`` holding lag ``k - (n-1)`` (index n-1 is lag 0).

``toeplitz_matvec`` embeds T in a 2n circulant and applies it with a
length-2n real FFT in fp32 (``torch.fft``: cuFFT on the card, pocketfft on
the CPU). These were never Pallas kernels: the unfused SKI pipeline's
Gram matvec runs on them, and the baseline mixer's will.
"""
from __future__ import annotations

import torch


def lags(n: int, device=None) -> torch.Tensor:
    """Integer lags -(n-1)..(n-1) matching the coefficient layout."""
    return torch.arange(-(n - 1), n, device=device)


def dense_toeplitz(t: torch.Tensor, n: int) -> torch.Tensor:
    """Materialise the (..., n, n) Toeplitz matrix of ``t`` (..., 2n-1)."""
    if t.shape[-1] != 2 * n - 1:
        raise ValueError(f"dense_toeplitz: {t.shape[-1]} coefficients, "
                         f"want 2n-1 = {2 * n - 1}")
    i = torch.arange(n, device=t.device)
    idx = (i[:, None] - i[None, :]) + (n - 1)   # lag -> coefficient index
    return t[..., idx]


def _circulant_coeffs(t: torch.Tensor, n: int) -> torch.Tensor:
    """(..., 2n-1) lag layout -> (..., 2n) first column of the circulant:
    c[k] = t(lag k) for k < n, c[n] = 0, c[2n-k] = t(lag -k)."""
    pad = torch.zeros(t.shape[:-1] + (1,), dtype=t.dtype, device=t.device)
    return torch.cat([t[..., n - 1:], pad, t[..., :n - 1]], dim=-1)


def toeplitz_matvec(t: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """y[..., i] = Σ_j t[i-j] x[..., j] via length-2n rFFTs in fp32.
    t: (..., 2n-1) broadcastable against x's batch dims; x: (..., n).
    Returns x's dtype."""
    n = x.shape[-1]
    if t.shape[-1] != 2 * n - 1:
        raise ValueError(f"toeplitz_matvec: {t.shape[-1]} coefficients for "
                         f"n = {n}, want {2 * n - 1}")
    fc = torch.fft.rfft(_circulant_coeffs(t, n).float(), dim=-1)
    fx = torch.fft.rfft(x.float(), n=2 * n, dim=-1)
    return torch.fft.irfft(fc * fx, n=2 * n, dim=-1)[..., :n].to(x.dtype)


def toeplitz_matvec_causal(t_causal: torch.Tensor,
                           x: torch.Tensor) -> torch.Tensor:
    """Causal Toeplitz action: ``t_causal`` (..., n) holds lags 0..n-1."""
    n = x.shape[-1]
    if t_causal.shape[-1] != n:
        raise ValueError(f"toeplitz_matvec_causal: {t_causal.shape[-1]} "
                         f"coefficients for n = {n}")
    neg = torch.zeros(t_causal.shape[:-1] + (n - 1,), dtype=t_causal.dtype,
                      device=t_causal.device)
    return toeplitz_matvec(torch.cat([neg, t_causal], dim=-1), x)


def causal_mask_coeffs(t: torch.Tensor, n: int) -> torch.Tensor:
    """Zero the negative-lag coefficients (causal masking of T)."""
    return t * (lags(n, t.device) >= 0).to(t.dtype)
