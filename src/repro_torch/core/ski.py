"""Sparse + low-rank TNO via asymmetric SKI (paper §3.2, Algorithm 1),
counterpart of ``repro/core/ski.py``: the fused pipeline at every rank
variant, and the unfused one.

``T ≈ T_sparse + W A Wᵀ`` where

* ``T_sparse`` (m non-zero diagonals) acts as a per-channel short conv;
* ``A`` is the r × r inducing-point Gram of the warped-interp kernel
  ``k_l(t) = RPE_l(sign(t) λ^|t|)``, Toeplitz because the inducing points
  are uniform: its (d, 2r-1) lag coefficients, materialised dense per
  channel, (d, r, r), for the "dense" variant only;
* ``W`` is the banded linear-interpolation matrix (≤ 2 non-zeros a row).

Two pipelines compute it, forward and backward, on the card and on the
CPU:

* fused (``SKIConfig.fused``, the default): pass 1 ``interp_reduce``
  (z = Wᵀx), then pass 2, one kernel for A z, W z₂ and the short conv with
  a single write. ``backend.ski_rank_variant`` picks how A is applied, as
  in the JAX package: "dense" (``ops.ski_fused_tno``, A as (d, r, r)),
  or at large rank, from its (d, 2r-1) Toeplitz coefficients and never
  dense, "windowed" (each sequence tile computes its window of A z inside
  pass 2) or "fft" (A z by rfft/irfft between the passes), both through
  ``ops.ski_fused_tno_coef``;
* unfused (``fused=False``, the paper's baseline): ``ops.interp_reduce``,
  ``ops.short_conv``, the Gram matvec A z by FFT over the r inducing
  points (``toeplitz.toeplitz_matvec`` of the (d, 2r-1) coefficients) and
  ``ops.interp_expand``, each op differentiable on its own.

Forward-invariant pieces (inducing geometry, warped lag grid, the Gram)
are grouped in a :func:`ski_plan`, built once per layer per forward; the
parameter-independent grids are memoised process-wide as host numpy.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
from torch import nn

from repro_torch.core import toeplitz
from repro_torch.core.rpe import (InterpRPE, InterpRPEConfig,
                                  interp_rpe_apply)
from repro_torch.kernels import backend, ops, ref
from repro_torch.nn.layers import draw_buffer
from repro_torch.nn.params import set_axes

@dataclasses.dataclass(frozen=True)
class SKIConfig:
    d: int                    # channels
    rank: int = 64            # r inducing points
    filter_size: int = 32     # m sparse diagonals
    lam: float = 0.99         # inverse-time-warp decay
    grid_size: int = 129      # interp-RPE grid nodes on [-1, 1]
    fused: bool = True        # two-pass fused pipeline (False: unfused)


@functools.lru_cache(maxsize=128)
def _make_inducing_host(n: int, r: int):
    """Host-numpy body of :func:`make_inducing`. Cached as host numpy, not
    tensors: a cache keyed only on (n, r) that held device tensors would
    pin them to whichever device asked first and hand them to every other
    (the reason ``repro/core/ski.py`` gives for its own host cache)."""
    return ref.hat_geometry(n, r)


def make_inducing(n: int, r: int, device=None):
    """Uniform inducing points on [0, n-1]: (idx_lo (n,) int32, w_lo (n,)
    fp32 on ``device``, h). The geometry depends only on (n, r), so every
    layer and every forward shares one host copy."""
    lo, w_lo, h = _make_inducing_host(int(n), int(r))
    return (torch.from_numpy(lo).to(device, copy=True),
            torch.from_numpy(w_lo).to(device, copy=True), h)


@functools.lru_cache(maxsize=128)
def _warped_lag_grid_host(r: int, h: float, lam: float) -> np.ndarray:
    """Host-numpy warped lags x(t) = sign(t) λ^|t| at the inducing lags
    -(r-1)h..(r-1)h, built as the JAX package builds them."""
    lag = np.arange(-(r - 1), r, dtype=np.float32) * np.float32(h)
    return (np.sign(lag) *
            np.power(np.float32(lam), np.abs(lag))).astype(np.float32)


def _warped_lag_grid(r: int, h: float, lam: float,
                     device=None) -> torch.Tensor:
    """Device copy of the cached host grid (matches
    ``rpe.inverse_time_warp`` on the same lags)."""
    return torch.from_numpy(_warped_lag_grid_host(
        int(r), float(h), float(lam))).to(device, copy=True)


class SKIParams(nn.Module):
    """The SKI mixer's parameters, JAX leaves {rpe: {vals (d, grid)},
    filt (d, m)}, both drawn N(0, 0.02²)."""

    def __init__(self, cfg: SKIConfig, device=None):
        super().__init__()
        self.rpe = InterpRPE(InterpRPEConfig(cfg.d, cfg.grid_size),
                             device=device)
        self.filt = nn.Parameter(torch.empty(cfg.d, cfg.filter_size,
                                             device=device))
        set_axes(self, filt=("tno_channel", None))

    def reset_parameters(self, generator: torch.Generator) -> None:
        v = draw_buffer(self.filt.shape, generator)
        nn.init.normal_(v, 0.0, 0.02, generator=generator)
        with torch.no_grad():
            self.filt.copy_(v)


def ski_init(cfg: SKIConfig, device=None) -> SKIParams:
    """Allocate the parameters; ``nn.layers.reset_parameters`` draws them."""
    return SKIParams(cfg, device=device)


def inducing_gram_coeffs(params: SKIParams, cfg: SKIConfig, r: int,
                         h: float) -> torch.Tensor:
    """(d, 2r-1) Toeplitz coefficients of A at the warped inducing lags."""
    x = _warped_lag_grid(r, h, cfg.lam, params.filt.device)
    vals = interp_rpe_apply(params.rpe, InterpRPEConfig(cfg.d, cfg.grid_size),
                            x)
    return vals.T


def ski_plan(params: SKIParams, cfg: SKIConfig, n: int, causal: bool = False,
             variant: str | None = None) -> dict:
    """Everything invariant across ops within a forward: the inducing
    geometry, the Gram coefficients, the variant ("dense", "windowed",
    "fft" or "unfused") and, for "dense" only, the (d, r, r) Gram.
    ``variant`` overrides ``backend.ski_rank_variant`` (or "unfused" when
    ``cfg.fused`` is False), unchecked as in the JAX package: forcing
    "dense" builds the (d, r, r) Gram whatever its size."""
    r = min(cfg.rank, n)
    device = params.filt.device
    idx_lo, w_lo, h = make_inducing(n, r, device)
    a_coef = inducing_gram_coeffs(params, cfg, r, h)           # (d, 2r-1)
    if causal:
        a_coef = toeplitz.causal_mask_coeffs(a_coef, r)
    if variant is None:
        variant = (backend.ski_rank_variant(r, cfg.d) if cfg.fused
                   else "unfused")
    if variant not in ("dense", "windowed", "fft", "unfused"):
        raise ValueError(f"unknown SKI variant {variant!r}")
    plan = {"r": r, "h": h, "idx_lo": idx_lo, "w_lo": w_lo,
            "causal": causal, "a_coef": a_coef, "variant": variant}
    if variant == "dense":
        plan["a_dense"] = toeplitz.dense_toeplitz(a_coef, r)  # (d, r, r)
    return plan


def ski_tno_apply(params: SKIParams, cfg: SKIConfig, x: torch.Tensor,
                  causal: bool = False, plan: dict | None = None
                  ) -> torch.Tensor:
    """x: (b, n, d) -> (b, n, d) through the fused ``ops.ski_fused_tno``
    ("dense"), ``ops.ski_fused_tno_coef`` ("windowed", "fft") or, for an
    "unfused" plan, the four unfused ops. x fp32 or bf16 on every route,
    on the card through each kernel's instance of x's dtype. The unfused
    route's short conv on the card takes x and the taps in one dtype (its
    bf16 kernel reads bf16 taps): bf16 x beside fp32 taps raises a
    TypeError before any launch, where JAX sums the fp32 taps against the
    bf16 x in fp32. Rounding the taps to bf16 would change that result and
    widening x would run fp32 quietly; the model never meets the case
    (``cast_params`` gives bf16 leaves, and fp32 leaves make the mixer's
    x fp32). Bidirectional by default, as in the JAX package; the decoder
    LM runs it causal. ``plan`` — optional :func:`ski_plan` built with the
    same ``causal`` flag and n; a stale plan raises."""
    n = x.shape[1]
    if plan is None:
        plan = ski_plan(params, cfg, n, causal)
    # a stale plan (wrong masking or sequence length) silently computes a
    # different operator: reject it rather than return wrong numbers
    if plan["causal"] != causal or plan["idx_lo"].shape[0] != n:
        raise ValueError(
            f"plan mismatch: built for causal={plan['causal']}, "
            f"n={plan['idx_lo'].shape[0]}; called with causal={causal}, n={n}")
    r, idx_lo, w_lo = plan["r"], plan["idx_lo"], plan["w_lo"]
    if (plan["variant"] == "unfused" and x.device.type != "cpu"
            and x.dtype != params.filt.dtype):
        raise TypeError(
            f"SKI unfused route: x {x.dtype} and taps {params.filt.dtype} on "
            "the card; the short conv kernel takes both in one dtype (see "
            "ski_tno_apply's docstring)")
    if plan["variant"] == "dense":
        y = ops.ski_fused_tno(x, plan["a_dense"], params.filt, idx_lo, w_lo,
                              r, causal)
        return y.to(x.dtype)
    if plan["variant"] in ("windowed", "fft"):
        y = ops.ski_fused_tno_coef(x, plan["a_coef"], params.filt, idx_lo,
                                   w_lo, r, causal, plan["variant"])
        return y.to(x.dtype)
    # unfused: four ops, each differentiable on its own
    z = ops.interp_reduce(x, idx_lo, w_lo, r)                 # (b, r, d)
    y_sparse = ops.short_conv(x, params.filt, causal)
    z2 = toeplitz.toeplitz_matvec(plan["a_coef"][None], z.transpose(1, 2))
    y_low = ops.interp_expand(z2.transpose(1, 2).contiguous(), idx_lo, w_lo)
    return (y_sparse + y_low).to(x.dtype)


def ski_dense_oracle(params: SKIParams, cfg: SKIConfig,
                     n: int) -> torch.Tensor:
    """T_sparse + W A Wᵀ materialised as dense (d, n, n), bidirectional
    taps (left = m//2) and an unmasked Gram, as the JAX oracle — tests
    only."""
    r = min(cfg.rank, n)
    device = params.filt.device
    idx_lo, w_lo, h = make_inducing(n, r, device)
    w = ref.dense_interp_matrix(idx_lo, w_lo, r)               # (n, r)
    a = toeplitz.dense_toeplitz(inducing_gram_coeffs(params, cfg, r, h), r)
    t_low = torch.einsum("nr,drs,ms->dnm", w, a, w)
    m = cfg.filter_size
    i = torch.arange(n, device=device)
    k_idx = (i[:, None] - i[None, :]) + m // 2                 # tap index
    valid = (k_idx >= 0) & (k_idx < m)
    t_sp = torch.where(valid[None], params.filt[:, k_idx.clamp(0, m - 1)],
                       0.0)
    return t_low + t_sp
