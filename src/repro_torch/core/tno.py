"""Toeplitz Neural Operator — the baseline (Qin et al. 2023) and unified
dispatch over the paper's variants, counterpart of ``repro/core/tno.py``.

The baseline ``tno`` is the paper's floor: an MLP RPE evaluated at all
2n-1 relative positions, times the decay bias λ^|t|, applied per channel
with the FFT Toeplitz matvec (``core/toeplitz.py``: cuFFT on the card, no
hand kernel; its backward is autograd through ``torch.fft``, as JAX's is
``jax.grad`` through ``jnp.fft``). ``fd`` (causal, or with ``causal=False``
the bidirectional complex response) and ``ski`` (fused dense Gram, or the
unfused pipeline with ``fused=False``) are the paper's accelerated
variants behind the same interface.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from repro_torch.core import fd, ski, toeplitz
from repro_torch.core.rpe import (MLPRPEConfig, decay_bias, mlp_rpe_apply,
                                  mlp_rpe_init)

VARIANTS = ("tno", "ski", "fd")


@dataclasses.dataclass(frozen=True)
class TNOConfig:
    d: int
    variant: str = "tno"        # tno | ski | fd
    causal: bool = True
    lam: float = 0.99           # decay bias (tno) / time warp (ski)
    use_decay: bool = True      # baseline decay bias on/off
    # MLP RPE (tno & fd variants)
    rpe_hidden: int = 64
    rpe_layers: int = 3
    rpe_act: str = "relu"
    # SKI
    rank: int = 64
    filter_size: int = 32
    grid_size: int = 129
    fused: bool = True          # SKI: fused two-pass (False: unfused)

    def fd_cfg(self) -> fd.FDConfig:
        return fd.FDConfig(self.d, self.causal, self.rpe_hidden,
                           self.rpe_layers, self.rpe_act)

    def ski_cfg(self) -> ski.SKIConfig:
        return ski.SKIConfig(self.d, self.rank, self.filter_size, self.lam,
                             self.grid_size, self.fused)

    def mlp_cfg(self) -> MLPRPEConfig:
        return MLPRPEConfig(self.d, self.rpe_hidden, self.rpe_layers,
                            self.rpe_act)


class BaselineParams(nn.Module):
    """The baseline mixer's parameters: the RPE MLP (JAX leaf ``rpe``)."""

    def __init__(self, cfg: TNOConfig, device=None):
        super().__init__()
        self.rpe = mlp_rpe_init(cfg.mlp_cfg(), device=device)


def _check_variant(cfg: TNOConfig) -> None:
    if cfg.variant not in VARIANTS:
        raise ValueError(cfg.variant)


def tno_init(cfg: TNOConfig, device=None):
    _check_variant(cfg)
    if cfg.variant == "ski":
        return ski.ski_init(cfg.ski_cfg(), device=device)
    if cfg.variant == "fd":
        return fd.fd_init(cfg.fd_cfg(), device=device)
    return BaselineParams(cfg, device=device)


def baseline_coeffs(params: BaselineParams, cfg: TNOConfig,
                    n: int) -> torch.Tensor:
    """(d, 2n-1) Toeplitz coefficients λ^|t| · RPE(t / n), the negative lags
    zeroed when ``cfg.causal``."""
    t = toeplitz.lags(n, params.rpe.layers[0].w.device).float()
    vals = mlp_rpe_apply(params.rpe, cfg.mlp_cfg(), t / n)     # (2n-1, d)
    if cfg.use_decay:
        vals = vals * decay_bias(t, cfg.lam)[:, None]
    coef = vals.T
    if cfg.causal:
        coef = toeplitz.causal_mask_coeffs(coef, n)
    return coef


def tno_plan(params, cfg: TNOConfig, n: int) -> dict:
    """Forward-invariant precomputation, once per layer per forward: the
    SKI inducing geometry and dense Gram, the FD raw real response (the
    Hilbert completion happens inside ``ops.fd_tno``), or the baseline's
    coefficients."""
    _check_variant(cfg)
    if cfg.variant == "ski":
        return ski.ski_plan(params, cfg.ski_cfg(), n, causal=cfg.causal)
    if cfg.variant == "fd":
        fcfg = cfg.fd_cfg()
        if fcfg.causal:
            return {"khat_real": fd.kernel_spectrum_real(params, fcfg, n)}
        return {"khat": fd.kernel_spectrum(params, fcfg, n)}
    return {"coef": baseline_coeffs(params, cfg, n)}


def tno_apply(params, cfg: TNOConfig, x: torch.Tensor,
              plan: dict | None = None) -> torch.Tensor:
    """Unified TNO: x (b, n, d) -> (b, n, d). ``plan`` — optional
    :func:`tno_plan` for the same (params, cfg, n)."""
    _check_variant(cfg)
    if cfg.variant == "ski":
        return ski.ski_tno_apply(params, cfg.ski_cfg(), x, causal=cfg.causal,
                                 plan=plan)
    if cfg.variant == "fd":
        plan = plan or {}
        return fd.fd_tno_apply(params, cfg.fd_cfg(), x,
                               khat=plan.get("khat"),
                               khat_real=plan.get("khat_real"))
    coef = plan["coef"] if plan else baseline_coeffs(params, cfg, x.shape[1])
    yt = toeplitz.toeplitz_matvec(coef[None], x.transpose(1, 2))  # (b, d, n)
    return yt.transpose(1, 2).to(x.dtype)


def tno_dense_oracle(params: BaselineParams, cfg: TNOConfig,
                     n: int) -> torch.Tensor:
    """Dense (d, n, n) Toeplitz matrices of the baseline — tests only."""
    return toeplitz.dense_toeplitz(baseline_coeffs(params, cfg, n), n)
