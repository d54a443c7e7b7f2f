"""Toeplitz Neural Operator — unified dispatch over the paper's variants,
counterpart of ``repro/core/tno.py``. The ``fd`` (causal) and ``ski``
(fused dense Gram, or the unfused pipeline with ``fused=False``) variants
are ported; ``tno`` (the baseline) raises, naming the ROADMAP item that
ports it."""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import fd, ski

_NOT_PORTED = {
    "tno": "the baseline TNO mixer is not ported yet "
           "(ROADMAP Queue 1: tno baseline, after the SKI slices)",
}


@dataclasses.dataclass(frozen=True)
class TNOConfig:
    d: int
    variant: str = "tno"        # tno | ski | fd
    causal: bool = True
    lam: float = 0.99           # decay bias (tno) / time warp (ski)
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
        if not self.causal:
            raise NotImplementedError("bidirectional FD-TNO is not ported: "
                                      "the port's fd mixer is causal")
        return fd.FDConfig(self.d, self.rpe_hidden, self.rpe_layers,
                           self.rpe_act)

    def ski_cfg(self) -> ski.SKIConfig:
        return ski.SKIConfig(self.d, self.rank, self.filter_size, self.lam,
                             self.grid_size, self.fused)


def _require_ported(cfg: TNOConfig) -> None:
    if cfg.variant not in ("fd", "ski"):
        if cfg.variant in _NOT_PORTED:
            raise NotImplementedError(_NOT_PORTED[cfg.variant])
        raise ValueError(cfg.variant)


def tno_init(cfg: TNOConfig, device=None):
    _require_ported(cfg)
    if cfg.variant == "ski":
        return ski.ski_init(cfg.ski_cfg(), device=device)
    return fd.fd_init(cfg.fd_cfg(), device=device)


def tno_plan(params, cfg: TNOConfig, n: int) -> dict:
    """Forward-invariant precomputation, once per layer per forward: the
    SKI inducing geometry and dense Gram, or the FD raw real response (the
    Hilbert completion happens inside ``ops.fd_tno``)."""
    _require_ported(cfg)
    if cfg.variant == "ski":
        return ski.ski_plan(params, cfg.ski_cfg(), n, causal=cfg.causal)
    return {"khat_real": fd.kernel_spectrum_real(params, cfg.fd_cfg(), n)}


def tno_apply(params, cfg: TNOConfig, x: torch.Tensor,
              plan: dict | None = None) -> torch.Tensor:
    """Unified TNO: x (b, n, d) -> (b, n, d). ``plan`` — optional
    :func:`tno_plan` for the same (params, cfg, n)."""
    _require_ported(cfg)
    if cfg.variant == "ski":
        return ski.ski_tno_apply(params, cfg.ski_cfg(), x, causal=cfg.causal,
                                 plan=plan)
    return fd.fd_tno_apply(params, cfg.fd_cfg(), x,
                           khat_real=plan.get("khat_real") if plan else None)
