"""TNN token mixer (paper Fig. 3): the GTU, counterpart of the GTU part of
``repro/core/block.py``. The model's channel mix is the dense FFN of
``models/transformer.py``, as in the JAX package."""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from repro_torch.core.tno import TNOConfig, tno_apply, tno_init, tno_plan
from repro_torch.nn.layers import ACTS, Dense, dense


@dataclasses.dataclass(frozen=True)
class TNNBlockConfig:
    d_model: int
    tno: TNOConfig = None          # type: ignore[assignment]
    expand: int = 1                # GTU expansion
    act: str = "silu"


class GTU(nn.Module):
    """JAX leaves {wu, wv, wo, tno}."""

    def __init__(self, cfg: TNNBlockConfig, device=None):
        super().__init__()
        de = cfg.d_model * cfg.expand
        self.wu = Dense(cfg.d_model, de, device=device)
        self.wv = Dense(cfg.d_model, de, device=device)
        self.wo = Dense(de, cfg.d_model, device=device)
        self.tno = tno_init(cfg.tno, device=device)


def gtu_init(cfg: TNNBlockConfig, device=None) -> GTU:
    return GTU(cfg, device=device)


def gtu_apply(params: GTU, cfg: TNNBlockConfig,
              x: torch.Tensor) -> torch.Tensor:
    act = ACTS[cfg.act]
    u = act(dense(params.wu.w, x))
    v = act(dense(params.wv.w, x))
    # kernel spectrum once per forward, not per op
    plan = tno_plan(params.tno, cfg.tno, x.shape[1])
    o = tno_apply(params.tno, cfg.tno, u, plan=plan) * v
    return dense(params.wo.w, o)
