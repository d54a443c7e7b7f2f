"""Appendix-B negative result: causal masking negates SKI's benefits,
counterpart of ``repro/core/causal_ski.py``.

The causally masked low-rank action y_i = [W A]_i · s_i with the
cumulative sums s_i = Σ_{j≤i} w_j x_j needs O(n r d) work *and* a
(b, n, r, d) intermediate, against the FFT path's O(n log n). It is kept
to measure that negative result against the causal FD-TNO, as plain
torch ops (no kernel; the JAX package has none either).
"""
from __future__ import annotations

import torch

from repro_torch.core import toeplitz
from repro_torch.core.ski import (SKIConfig, SKIParams, inducing_gram_coeffs,
                                  make_inducing)
from repro_torch.kernels import ref


def causal_ski_lowrank(params: SKIParams, cfg: SKIConfig,
                       x: torch.Tensor) -> torch.Tensor:
    """Causally masked W A Wᵀ action by cumulative sums. x: (b, n, d) ->
    (b, n, d) in x's dtype; A is the unmasked inducing Gram."""
    n = x.shape[1]
    r = min(cfg.rank, n)
    idx_lo, w_lo, h = make_inducing(n, r, x.device)
    w = ref.dense_interp_matrix(idx_lo, w_lo, r)                  # (n, r)
    a = toeplitz.dense_toeplitz(inducing_gram_coeffs(params, cfg, r, h), r)
    # s_i = Σ_{j<=i} w_j x_j: the (b, n, r, d) intermediate (the blow-up)
    s = torch.cumsum(w[None, :, :, None] * x.float()[:, :, None, :], dim=1)
    # y_i = (Aᵀ w_i)ᵀ s_i per channel
    wa = torch.einsum("nr,drs->nds", w, a)                        # (n, d, r)
    return torch.einsum("nds,bnsd->bnd", wa, s).to(x.dtype)
