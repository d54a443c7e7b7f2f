"""Toeplitz Neural Operator — unified dispatch over the paper's variants,
counterpart of ``repro/core/tno.py``. Only the ``fd`` variant is ported;
``tno`` (the baseline) and ``ski`` raise, naming the ROADMAP item that
ports them."""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import fd

_NOT_PORTED = {
    "tno": "the baseline TNO mixer is not ported yet "
           "(ROADMAP Queue 1: tno baseline, after the training slice)",
    "ski": "the SKI mixer is not ported yet (ROADMAP Queue 1: SKI slice)",
}


@dataclasses.dataclass(frozen=True)
class TNOConfig:
    d: int
    variant: str = "tno"        # tno | ski | fd
    rpe_hidden: int = 64
    rpe_layers: int = 3
    rpe_act: str = "relu"

    def fd_cfg(self) -> fd.FDConfig:
        return fd.FDConfig(self.d, self.rpe_hidden, self.rpe_layers,
                           self.rpe_act)


def _require_fd(cfg: TNOConfig) -> None:
    if cfg.variant != "fd":
        if cfg.variant in _NOT_PORTED:
            raise NotImplementedError(_NOT_PORTED[cfg.variant])
        raise ValueError(cfg.variant)


def tno_init(cfg: TNOConfig, device=None) -> fd.FDParams:
    _require_fd(cfg)
    return fd.fd_init(cfg.fd_cfg(), device=device)


def tno_plan(params, cfg: TNOConfig, n: int) -> dict:
    """Forward-invariant precomputation, once per layer per forward: the
    raw real response; the Hilbert completion happens inside ``ops.fd_tno``."""
    _require_fd(cfg)
    return {"khat_real": fd.kernel_spectrum_real(params, cfg.fd_cfg(), n)}


def tno_apply(params, cfg: TNOConfig, x: torch.Tensor,
              plan: dict | None = None) -> torch.Tensor:
    """Unified TNO: x (b, n, d) -> (b, n, d). ``plan`` — optional
    :func:`tno_plan` for the same (params, cfg, n)."""
    _require_fd(cfg)
    return fd.fd_tno_apply(params, cfg.fd_cfg(), x,
                           khat_real=plan.get("khat_real") if plan else None)
