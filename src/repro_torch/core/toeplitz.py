"""Toeplitz coefficient layout and its dense form, counterpart of
``repro/core/toeplitz.py`` (``lags``, ``dense_toeplitz``,
``causal_mask_coeffs``; the FFT ``toeplitz_matvec`` comes with the
baseline mixer, ROADMAP Queue 1).

A length-n Toeplitz matrix ``T_ij = t[i - j]`` is parametrised by its
coefficients at lags ``-(n-1) .. (n-1)``, stored as (..., 2n-1) with
``t[..., k]`` holding lag ``k - (n-1)`` (index n-1 is lag 0).
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


def causal_mask_coeffs(t: torch.Tensor, n: int) -> torch.Tensor:
    """Zero the negative-lag coefficients (causal masking of T)."""
    return t * (lags(n, t.device) >= 0).to(t.dtype)
