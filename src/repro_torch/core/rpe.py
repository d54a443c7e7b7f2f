"""Relative positional encoders (paper §3.1-3.3), counterpart of
``repro/core/rpe.py``:

* the MLP RPE: an MLP mapping a scalar relative position (or frequency,
  for FD-TNO) to d channel values;
* the interp RPE of SKI: d learned piecewise-linear functions on [-1, 1]
  (Prop. 1 shows the ReLU MLP is exactly this class), pinned to 0 at
  x = 0, evaluated through the inverse time warp x(t) = sign(t) λ^|t| so
  that extrapolation in t becomes interpolation in x;
* the decay bias λ^|t| of the baseline TNN (Qin et al. 2023), which the
  paper's variants drop.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from repro_torch.nn.layers import MLP, draw_buffer, mlp_apply, mlp_init
from repro_torch.nn.params import set_axes


# ----------------------------------------------------------------- MLP RPE
@dataclasses.dataclass(frozen=True)
class MLPRPEConfig:
    d_out: int              # channels (2*d for bidirectional FD-TNO)
    d_hidden: int = 64
    n_layers: int = 3
    act: str = "relu"
    use_layernorm: bool = True


def mlp_rpe_init(cfg: MLPRPEConfig, device=None) -> MLP:
    return mlp_init(1, cfg.d_hidden, cfg.d_out, cfg.n_layers,
                    use_layernorm=cfg.use_layernorm, device=device)


def mlp_rpe_apply(params: MLP, cfg: MLPRPEConfig,
                  pos: torch.Tensor) -> torch.Tensor:
    """pos: (m,) scalar positions -> (m, d_out)."""
    return mlp_apply(params, pos[:, None].float(), act=cfg.act)


# ------------------------------------------------------------- interp RPE
@dataclasses.dataclass(frozen=True)
class InterpRPEConfig:
    d_out: int
    grid_size: int = 129     # odd => grid contains x = 0 exactly


class InterpRPE(nn.Module):
    """Node values (d_out, grid_size) on a uniform grid over [-1, 1] (JAX
    leaf ``vals``), drawn N(0, 0.02²)."""

    def __init__(self, cfg: InterpRPEConfig, device=None):
        super().__init__()
        self.vals = nn.Parameter(torch.empty(cfg.d_out, cfg.grid_size,
                                             device=device))
        set_axes(self, vals=("tno_channel", None))

    def reset_parameters(self, generator: torch.Generator) -> None:
        v = draw_buffer(self.vals.shape, generator)
        nn.init.normal_(v, 0.0, 0.02, generator=generator)
        with torch.no_grad():
            self.vals.copy_(v)


def interp_rpe_init(cfg: InterpRPEConfig, generator: torch.Generator,
                    device=None) -> InterpRPE:
    """An interp RPE with values drawn on the CPU from ``generator``."""
    rpe = InterpRPE(cfg, device=device)
    rpe.reset_parameters(generator)
    return rpe


def piecewise_linear_eval(vals: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """vals: (d, g) node values on a uniform grid over [-1, 1]; x: (m,)
    query points. Returns (m, d); clamps outside the grid."""
    g = vals.shape[-1]
    xf = (torch.clamp(x, -1.0, 1.0) + 1.0) * 0.5 * (g - 1)
    lo = torch.clamp(torch.floor(xf).long(), 0, g - 2)
    frac = (xf - lo.to(xf.dtype))[:, None]
    vlo = vals[:, lo].T                                        # (m, d)
    vhi = vals[:, lo + 1].T
    return vlo * (1.0 - frac) + vhi * frac


def interp_rpe_apply(params: InterpRPE, cfg: InterpRPEConfig,
                     x: torch.Tensor) -> torch.Tensor:
    """x: (m,) warped positions in [-1, 1] -> (m, d) with RPE(0) == 0."""
    v = piecewise_linear_eval(params.vals, x)
    v0 = piecewise_linear_eval(params.vals,
                               torch.zeros((1,), dtype=x.dtype,
                                           device=x.device))
    return v - v0


# --------------------------------------------------------- inverse time warp
def inverse_time_warp(t: torch.Tensor, lam: float) -> torch.Tensor:
    """x(t) = sign(t) λ^|t|, λ in (0, 1): maps Z onto [-1, 1] with
    x(0) = 0; far lags cluster near 0, near lags near ±1 (paper §3.2.2)."""
    t = t.float()
    return torch.sign(t) * torch.pow(torch.tensor(lam, dtype=torch.float32,
                                                  device=t.device),
                                     torch.abs(t))


def decay_bias(t: torch.Tensor, lam: float) -> torch.Tensor:
    """The baseline TNN's decay bias λ^|t|, taken in fp32 from the Python
    float ``lam``, as the JAX package takes it."""
    t = t.float()
    return torch.pow(torch.tensor(lam, dtype=torch.float32, device=t.device),
                     torch.abs(t))
