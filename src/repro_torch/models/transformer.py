"""Decoder LM assembly for the TNN language model, counterpart of
``repro/models/transformer.py`` restricted to ``kind="decoder"`` with TNN
layers and a dense FFN (the ``fd`` and ``ski`` mixers run; ``tno`` raises
in ``core/tno.py``).

Layers run as a Python loop, eagerly: the JAX package's layer scan,
sharding constraints (``Ctx``/``shard``) and remat have no counterpart on
one card. Parameter names follow the JAX tree, with the scanned
``blocks/sub0`` stack unrolled into ``layers.<i>``. The loss keeps the JAX
package's sequence chunking of the logits (``torch.utils.checkpoint`` in
place of ``jax.checkpoint``).
"""
from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.core.block import TNNBlockConfig, gtu_apply, gtu_init
from repro_torch.core.tno import TNOConfig
from repro_torch.models.config import ArchConfig
from repro_torch.nn.layers import (ACTS, RMSNorm, lecun_normal_,
                                   reset_parameters, rmsnorm)


def _check_supported(cfg: ArchConfig) -> None:
    if cfg.kind != "decoder":
        raise NotImplementedError(f"kind={cfg.kind!r}: the port runs "
                                  "decoder LMs only (ROADMAP Queue 1)")
    for mixer, ffn in cfg.layers_spec:
        if ffn != "dense" or mixer not in ("tno", "ski", "fd"):
            raise NotImplementedError(
                f"layer ({mixer}, {ffn}): the port runs TNN layers with a "
                "dense FFN only (other mixers: ROADMAP Queue 1, model zoo)")


# ------------------------------------------------------------------ pieces
class FFN(nn.Module):
    """JAX leaves {w_gate, w_up, w_down}, each (d_in, d_out)."""

    def __init__(self, d: int, f: int, device=None):
        super().__init__()
        self.w_gate = nn.Parameter(torch.empty(d, f, device=device))
        self.w_up = nn.Parameter(torch.empty(d, f, device=device))
        self.w_down = nn.Parameter(torch.empty(f, d, device=device))

    def reset_parameters(self, generator: torch.Generator) -> None:
        for w in (self.w_gate, self.w_up, self.w_down):
            lecun_normal_(w, generator)


def ffn_apply(params: FFN, cfg: ArchConfig, x):
    act = ACTS[cfg.act]
    h = act(x @ params.w_gate.to(x.dtype)) * (x @ params.w_up.to(x.dtype))
    return h @ params.w_down.to(x.dtype)


def _tno_cfg(cfg: ArchConfig, variant: str) -> TNNBlockConfig:
    # decoder only: every TNO mixer is causal (JAX: mask_kind == "causal")
    tno = TNOConfig(d=cfg.d_model, variant=variant, causal=True,
                    lam=cfg.tno_lam, rpe_hidden=cfg.tno_rpe_hidden,
                    rpe_layers=cfg.tno_rpe_layers, rpe_act=cfg.tno_rpe_act,
                    rank=cfg.tno_rank, filter_size=cfg.tno_filter)
    return TNNBlockConfig(cfg.d_model, tno=tno, act=cfg.act)


class Layer(nn.Module):
    """JAX leaves {norm1, mixer, norm2, ffn}."""

    def __init__(self, cfg: ArchConfig, mixer: str, device=None):
        super().__init__()
        self.norm1 = RMSNorm(cfg.d_model, device=device)
        self.mixer = gtu_init(_tno_cfg(cfg, mixer), device=device)
        self.norm2 = RMSNorm(cfg.d_model, device=device)
        self.ffn = FFN(cfg.d_model, cfg.d_ff, device=device)


def layer_apply(params: Layer, cfg: ArchConfig, mixer: str, x):
    h = rmsnorm(params.norm1.scale, x, cfg.norm_eps)
    # GTU internals run fp32 (FFTs); keep the residual dtype stable
    x = x + gtu_apply(params.mixer, _tno_cfg(cfg, mixer), h).to(x.dtype)
    h = rmsnorm(params.norm2.scale, x, cfg.norm_eps)
    return x + ffn_apply(params.ffn, cfg, h)


# -------------------------------------------------------------- the model
class Model(nn.Module):
    """JAX leaves {embed (V_pad, d), unembed (d, V_pad), blocks/tail…,
    norm_f}; every layer is ``layers.<i>``."""

    def __init__(self, cfg: ArchConfig, device=None):
        super().__init__()
        _check_supported(cfg)
        self.cfg = cfg          # read by bridge/checkpoint for the JAX layout
        d, v = cfg.d_model, cfg.vocab_padded
        self.embed = nn.Parameter(torch.empty(v, d, device=device))
        self.unembed = nn.Parameter(torch.empty(d, v, device=device))
        self.layers = nn.ModuleList(
            Layer(cfg, mixer, device=device) for mixer, _ in cfg.layers_spec)
        self.norm_f = RMSNorm(d, device=device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        v = torch.empty(self.embed.shape, dtype=torch.float32)
        nn.init.normal_(v, 0.0, 0.02, generator=generator)
        with torch.no_grad():
            self.embed.copy_(v)
        lecun_normal_(self.unembed, generator)


def init_model(cfg: ArchConfig, generator: torch.Generator,
               device="cuda") -> Model:
    """Random parameters drawn on the CPU from ``generator`` (so a seed
    gives the same model on every device), then moved to ``device``. The
    values differ from JAX's ``init_model`` for the same seed: use
    ``bridge.params_from_jax`` to run JAX's parameters."""
    model = Model(cfg, device="cpu")
    reset_parameters(model, generator)
    return model.to(device=device, dtype=getattr(torch, cfg.param_dtype))


# ------------------------------------------------------------ forward pass
def embed_tokens(params: Model, cfg: ArchConfig, tokens):
    return params.embed[tokens].to(getattr(torch, cfg.dtype))


def unembed(params: Model, cfg: ArchConfig, x):
    return x @ params.unembed.to(x.dtype)


def backbone(params: Model, cfg: ArchConfig, tokens: torch.Tensor):
    """tokens (b, s) -> hidden (b, s, d) after the final norm."""
    x = embed_tokens(params, cfg, tokens)
    for (mixer, _), layer in zip(cfg.layers_spec, params.layers):
        x = layer_apply(layer, cfg, mixer, x)
    return rmsnorm(params.norm_f.scale, x, cfg.norm_eps)


def forward(params: Model, cfg: ArchConfig, tokens: torch.Tensor):
    """tokens (b, s) -> logits (b, s, V_pad). (The JAX function also
    returns the MoE aux loss, which is 0 for dense FFNs.)"""
    return unembed(params, cfg, backbone(params, cfg, tokens))


def _ce_terms(cfg: ArchConfig, logits, labels):
    """Sum of per-token (lse - ll). logits fp32 (b, c, V_pad); labels
    (b, c). Padded vocab columns are -1e30 before the log-sum-exp."""
    pad_mask = torch.arange(cfg.vocab_padded,
                            device=logits.device) < cfg.vocab
    logits = torch.where(pad_mask, logits, -1e30)
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return torch.sum(lse - ll)


def loss_fn(params: Model, cfg: ArchConfig, batch: dict, *,
            aux_weight: float = 0.01):
    """Mean next-token cross-entropy over batch["tokens"] / batch["labels"]
    (b, s) -> (loss, {"nll", "aux"}). The logits are sequence-chunked
    exactly when the JAX package chunks them (``loss_chunk`` set, s > c and
    s % c == 0): each chunk reduces to a scalar and is recomputed in the
    backward, so at most (b, loss_chunk, V) logits are live. The aux term
    (MoE load balance) is 0 for dense FFNs."""
    x = backbone(params, cfg, batch["tokens"])
    labels = batch["labels"]
    b, s, _ = x.shape

    def chunk_nll(xc, lc):
        return _ce_terms(cfg, unembed(params, cfg, xc).float(), lc)

    c = cfg.loss_chunk
    if c and s > c and s % c == 0:
        total = torch.zeros((), dtype=torch.float32, device=x.device)
        for i in range(0, s, c):
            total = total + checkpoint(chunk_nll, x[:, i:i + c],
                                       labels[:, i:i + c],
                                       use_reentrant=False)
    else:
        total = chunk_nll(x, labels)
    nll = total / (b * s)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return nll + aux_weight * aux, {"nll": nll, "aux": aux}
