"""Relative positional encoder: the MLP RPE (paper §3.1-3.3), counterpart
of the ``MLPRPE`` part of ``repro/core/rpe.py``. The interp RPE of SKI
comes with the SKI slice (ROADMAP Queue 1)."""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.nn.layers import MLP, mlp_apply, mlp_init


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
