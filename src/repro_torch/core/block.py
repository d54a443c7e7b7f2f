"""TNN token mixer (paper Fig. 3): the GTU, counterpart of the GTU part of
``repro/core/block.py``. The model's channel mix is the dense FFN of
``models/transformer.py``, as in the JAX package.

On a mesh (x a DTensor) the GTU is Megatron-style channel TP, as JAX's
rules place its leaves: ``wu``/``wv`` are (embed, tno_channel), so each
rank's u and v are its own channel slice; the TNO mixer (the RPE MLP's
last layer, ``vals`` and ``filt`` are tno_channel-sharded) then runs on
each rank's local batch rows and channels, through the same ops and
kernel wrappers as on one card (:func:`tno_local`); ``wo`` is
(tno_channel, embed), so its product is a partial sum over the model axis
that the caller reduces (``models/transformer.layer_apply``)."""
from __future__ import annotations

import dataclasses

import torch
from torch import nn
from torch.distributed.tensor import DTensor

from repro_torch.core.tno import TNOConfig, tno_apply, tno_init, tno_plan
from repro_torch.models.context import from_local, to_local
from repro_torch.nn.layers import ACTS, Dense, dense
from repro_torch.nn.params import local_params, param_axes


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
        self.wu = Dense(cfg.d_model, de, axes=("embed", "tno_channel"),
                        device=device)
        self.wv = Dense(cfg.d_model, de, axes=("embed", "tno_channel"),
                        device=device)
        self.wo = Dense(de, cfg.d_model, axes=("tno_channel", "embed"),
                        device=device)
        self.tno = tno_init(cfg.tno, device=device)


def gtu_init(cfg: TNNBlockConfig, device=None) -> GTU:
    return GTU(cfg, device=device)


def gtu_apply(params: GTU, cfg: TNNBlockConfig,
              x: torch.Tensor) -> torch.Tensor:
    act = ACTS[cfg.act]
    u = act(dense(params.wu.w, x))
    v = act(dense(params.wv.w, x))
    o = tno_local(params.tno, cfg.tno, u) * v
    return dense(params.wo.w, o)


def tno_local(params, cfg: TNOConfig, u):
    """The TNO mixer on u (b, n, d_e), its plan (kernel spectrum, Gram)
    built once per forward. For a DTensor u (rows over the data axes,
    channels over the model axis) it runs on this rank's local u and its
    own channels' leaves, under the global ``cfg`` (SKI's rank variant is
    chosen for the whole width, as in JAX): the ops and kernel wrappers
    never see a DTensor."""
    if not isinstance(u, DTensor):
        plan = tno_plan(params, cfg, u.shape[1])
        return tno_apply(params, cfg, u, plan=plan)
    _check_channel_shards(params, cfg, u)
    leaves = {k: to_local(p, u.placements)
              for k, p in params.named_parameters()}
    with local_params(params, leaves):
        y = tno_local(params, cfg, to_local(u, u.placements))
    return from_local(y, u)


def _check_channel_shards(params, cfg: TNOConfig, u: DTensor) -> None:
    """The mixer needs each rank's whole sequence, and its channel leaves
    split as u's channels are."""
    axes = param_axes(params)
    mesh = u.device_mesh
    for i, (p, name) in enumerate(zip(u.placements, mesh.mesh_dim_names)):
        if mesh.size(i) == 1:
            continue
        if p.is_shard() and p.dim not in (0, 2):
            raise ValueError(f"TNO input sharded on dim {p.dim} over "
                             f"{name!r}: the mixer needs whole sequences")
        for k, leaf in params.named_parameters():
            if "tno_channel" not in axes[k]:
                continue
            q = leaf.placements[i]
            want = axes[k].index("tno_channel")
            if (p.is_shard() and p.dim == 2) != (q.is_shard()
                                                and q.dim == want):
                raise ValueError(f"TNO leaf {k} is {q} over {name!r} where "
                                 f"the input's channels are {p}")
    if (cfg.variant == "fd" and not cfg.causal
            and any(p.is_shard() and p.dim == 2 and mesh.size(i) > 1
                    for i, p in enumerate(u.placements))):
        # the 2d-wide RPE packs (re, im) side by side: a contiguous channel
        # shard of its last layer is not a channel slice of both halves
        raise NotImplementedError("bidirectional FD-TNO with channels "
                                  "sharded over the model axis")
