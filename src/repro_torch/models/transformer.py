"""Decoder LM assembly, counterpart of ``repro/models/transformer.py``
for ``kind="decoder"``: attention layers (``attention`` and the
sliding-window ``local``, ``models/attention.py``) and TNN layers (the
baseline ``tno``, ``ski`` and ``fd`` mixers), each with a dense or an MoE
FFN (``models/moe.py``), and Mamba-2 layers with none (``("mamba",
"none")``, mamba2) or with a dense or MoE one (the jamba hybrid, whose
period mixes all three kinds with attention). ``mixer_override`` puts the
paper's TNO variants in place of an arch's attention and local mixers
(never its Mamba layers, as in JAX). The encoder-decoder and prefix-VLM
kinds (ROADMAP Queue 1, Step 9c) are not ported.

Layers run as a Python loop, eagerly: the JAX package's layer scan,
sharding constraints (``Ctx``/``shard``) and remat have no counterpart on
one card. Parameter names follow the JAX tree, with the scanned
``blocks/sub<k>`` stack and the ``tail<i>`` layers unrolled into
``layers.<i>``, and each parameter has the dtype JAX gives its leaf:
``param_dtype`` for the embeddings, the matrices (attention's and its QKV
biases and the experts' included) and Mamba's conv taps, fp32 for the norm
scales, the MoE router, the TNN mixer's leaves and Mamba's ``a_log``,
``dt_bias``, ``d_skip`` and ``norm_scale``. A TNN mixer in a bf16 model computes in fp32, as JAX's
``x @ w`` promotes bf16 activations against its fp32 leaves, and casts
back. The loss keeps the JAX package's sequence chunking of the logits
(``torch.utils.checkpoint`` in place of ``jax.checkpoint``) and adds the
MoE layers' load-balancing aux loss, summed over layers, at weight 0.01.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.core.block import TNNBlockConfig, gtu_apply, gtu_init
from repro_torch.core.tno import TNOConfig
from repro_torch.models.attention import Attention, attn_apply
from repro_torch.models.config import ArchConfig
from repro_torch.models.mamba import Mamba, mamba_apply
from repro_torch.models.moe import MoE, moe_apply
from repro_torch.nn.layers import (ACTS, RMSNorm, draw_buffer,
                                   lecun_normal_, reset_parameters, rmsnorm)


def _check_supported(cfg: ArchConfig) -> None:
    if cfg.kind != "decoder":
        raise NotImplementedError(f"kind={cfg.kind!r}: the port runs "
                                  "decoder LMs only (encoder-decoder and "
                                  "prefix-VLM: ROADMAP Queue 1, Step 9c)")
    for mixer, ffn in cfg.layers_spec:
        if mixer == "mamba" and ffn in ("none", "dense", "moe"):
            continue
        if (ffn not in ("dense", "moe")
                or mixer not in ("attention", "local", "tno", "ski", "fd")):
            raise NotImplementedError(
                f"layer ({mixer}, {ffn}): the port runs attention and TNN "
                "layers with a dense or MoE FFN and Mamba layers with "
                "either or none")


# ------------------------------------------------------------------ pieces
class FFN(nn.Module):
    """JAX leaves {w_gate, w_up, w_down}, each (d_in, d_out)."""

    def __init__(self, d: int, f: int, device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.w_gate = nn.Parameter(torch.empty(d, f, **kw))
        self.w_up = nn.Parameter(torch.empty(d, f, **kw))
        self.w_down = nn.Parameter(torch.empty(f, d, **kw))

    def reset_parameters(self, generator: torch.Generator) -> None:
        for w in (self.w_gate, self.w_up, self.w_down):
            lecun_normal_(w, generator)


def ffn_apply(params: FFN, cfg: ArchConfig, x):
    act = ACTS[cfg.act]
    h = act(x @ params.w_gate.to(x.dtype)) * (x @ params.w_up.to(x.dtype))
    return h @ params.w_down.to(x.dtype)


def _tno_cfg(cfg: ArchConfig, variant: str,
             causal: bool = True) -> TNNBlockConfig:
    tno = TNOConfig(d=cfg.d_model, variant=variant, causal=causal,
                    lam=cfg.tno_lam, rpe_hidden=cfg.tno_rpe_hidden,
                    rpe_layers=cfg.tno_rpe_layers, rpe_act=cfg.tno_rpe_act,
                    rank=cfg.tno_rank, filter_size=cfg.tno_filter)
    return TNNBlockConfig(cfg.d_model, tno=tno, act=cfg.act)


class Layer(nn.Module):
    """JAX leaves {norm1, mixer, norm2, ffn} (``ffn`` an :class:`FFN` or,
    for ``ffn == "moe"``, a :class:`~repro_torch.models.moe.MoE`);
    {norm1, mixer} for a layer without an FFN (``ffn == "none"``, Mamba)."""

    def __init__(self, cfg: ArchConfig, mixer: str, ffn: str, device=None):
        super().__init__()
        self.norm1 = RMSNorm(cfg.d_model, device=device)
        if mixer in ("attention", "local"):
            self.mixer = Attention(cfg, device=device)
        elif mixer == "mamba":
            self.mixer = Mamba(cfg, device=device)
        else:
            self.mixer = gtu_init(_tno_cfg(cfg, mixer), device=device)
        if ffn == "dense":
            self.norm2 = RMSNorm(cfg.d_model, device=device)
            self.ffn = FFN(cfg.d_model, cfg.d_ff, device=device,
                           dtype=getattr(torch, cfg.param_dtype))
        elif ffn == "moe":
            self.norm2 = RMSNorm(cfg.d_model, device=device)
            self.ffn = MoE(cfg, device=device)


def mixer_apply(params, cfg: ArchConfig, mixer: str, x, *,
                mask_kind: str = "causal"):
    if mixer in ("attention", "local"):
        mk = "local" if mixer == "local" else mask_kind
        return attn_apply(params, cfg, x, mask_kind=mk)
    if mixer == "mamba":
        return mamba_apply(params, cfg, x)
    causal = mask_kind in ("causal", "local")
    # the GTU's leaves are fp32: JAX's x @ w promotes a bf16 x to fp32, so
    # the mixer computes in fp32; keep the residual dtype stable
    return gtu_apply(params, _tno_cfg(cfg, mixer, causal),
                     x.float()).to(x.dtype)


def layer_apply(params: Layer, cfg: ArchConfig, mixer: str, ffn: str, x, *,
                mask_kind: str = "causal"):
    """x (b, s, d) -> (x, aux): aux is the MoE layer's load-balancing
    loss, 0 for other layers."""
    h = rmsnorm(params.norm1.scale, x, cfg.norm_eps)
    x = x + mixer_apply(params.mixer, cfg, mixer, h, mask_kind=mask_kind)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if ffn == "dense":
        h = rmsnorm(params.norm2.scale, x, cfg.norm_eps)
        x = x + ffn_apply(params.ffn, cfg, h)
    elif ffn == "moe":
        y, aux = moe_apply(params.ffn, cfg,
                           rmsnorm(params.norm2.scale, x, cfg.norm_eps))
        x = x + y
    return x, aux


# -------------------------------------------------------------- the model
class Model(nn.Module):
    """JAX leaves {embed (V_pad, d), unembed (d, V_pad), blocks/tail…,
    norm_f}; every layer is ``layers.<i>``."""

    def __init__(self, cfg: ArchConfig, device=None):
        super().__init__()
        _check_supported(cfg)
        self.cfg = cfg          # read by bridge/checkpoint for the JAX layout
        d, v = cfg.d_model, cfg.vocab_padded
        pdt = getattr(torch, cfg.param_dtype)
        self.embed = nn.Parameter(torch.empty(v, d, dtype=pdt, device=device))
        self.unembed = nn.Parameter(torch.empty(d, v, dtype=pdt,
                                                device=device))
        self.layers = nn.ModuleList(
            Layer(cfg, mixer, ffn, device=device)
            for mixer, ffn in cfg.layers_spec)
        self.norm_f = RMSNorm(d, device=device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        v = draw_buffer(self.embed.shape, generator)
        nn.init.normal_(v, 0.0, 0.02, generator=generator)
        with torch.no_grad():
            self.embed.copy_(v)
        lecun_normal_(self.unembed, generator)


def init_model(cfg: ArchConfig, generator: torch.Generator,
               device="cuda") -> Model:
    """Random parameters drawn from ``generator`` on its device, leaf by
    leaf into a model allocated on ``device`` in its own dtypes: a whole
    fp32 copy of the model never exists. A CPU generator (every caller's
    but the full-width jamba cut's) draws on the host, so a seed gives the
    same model on every device; a CUDA generator draws on its card, with
    no host copy of a leaf (one (16, 8192, 24576) expert leaf is 12.9 GB
    in fp32). The values differ from JAX's ``init_model`` for the same
    seed: use ``bridge.params_from_jax`` to run JAX's parameters."""
    model = Model(cfg, device=device)
    reset_parameters(model, generator)
    return model


# ------------------------------------------------------------ forward pass
def embed_tokens(params: Model, cfg: ArchConfig, tokens):
    return params.embed[tokens].to(getattr(torch, cfg.dtype))


def unembed(params: Model, cfg: ArchConfig, x):
    return x @ params.unembed.to(x.dtype)


def backbone(params: Model, cfg: ArchConfig, tokens: torch.Tensor):
    """tokens (b, s) -> (hidden (b, s, d) after the final norm, the MoE
    aux loss summed over layers). Every layer of a decoder takes the
    causal mask, as in JAX's ``backbone``."""
    x = embed_tokens(params, cfg, tokens)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for (mixer, ffn), layer in zip(cfg.layers_spec, params.layers):
        x, a = layer_apply(layer, cfg, mixer, ffn, x, mask_kind="causal")
        aux = aux + a
    return rmsnorm(params.norm_f.scale, x, cfg.norm_eps), aux


def forward(params: Model, cfg: ArchConfig, tokens: torch.Tensor):
    """tokens (b, s) -> logits (b, s, V_pad). (The JAX function also
    returns the MoE aux loss; :func:`backbone` gives it.)"""
    return unembed(params, cfg, backbone(params, cfg, tokens)[0])


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
    (the MoE layers' load balance, summed) is 0 without MoE FFNs."""
    x, aux = backbone(params, cfg, batch["tokens"])
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
    return nll + aux_weight * aux, {"nll": nll, "aux": aux}
