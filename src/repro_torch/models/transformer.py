"""Model assembly, counterpart of ``repro/models/transformer.py``: decoder
LMs (``kind="decoder"``) of attention layers (``attention`` and the
sliding-window ``local``, ``models/attention.py``) and TNN layers (the
baseline ``tno``, ``ski`` and ``fd`` mixers), each with a dense or an MoE
FFN (``models/moe.py``), and Mamba-2 layers with none (``("mamba",
"none")``, mamba2) or with a dense or MoE one (the jamba hybrid, whose
period mixes all three kinds with attention). ``mixer_override`` puts the
paper's TNO variants in place of an arch's attention and local mixers
(never its Mamba layers, as in JAX).

Two more kinds wrap the decoder. ``encdec`` (whisper) runs an encoder of
``enc_layers`` bidirectional attention + dense layers over the caller's
frame embeddings ``enc_embed`` (the audio frontend is a stub, as in JAX;
always attention, whatever ``mixer_override`` says), and every decoder
layer adds a cross-attention sublayer over the encoder's output between
its mixer and its FFN. ``prefix_vlm`` (paligemma) puts the caller's patch
embeddings ``patches`` in front of the embedded tokens and runs every
layer under the ``prefix`` mask: attention sees the whole prefix from
every position, and a TNO mixer runs bidirectionally over the whole
sequence, text included (JAX builds it with ``causal = mask_kind in
("causal", "local")``). The prefix is stripped after the final norm.

Layers run as a Python loop, eagerly: the JAX package's layer scan and
sharding constraints (``Ctx``/``shard``) have no counterpart on one card.
``remat="full"`` (every bf16 zoo config) checkpoints each layer, decoder
and encoder alike, as JAX's ``_maybe_remat`` does at layer granularity:
under grad a layer runs in non-reentrant ``torch.utils.checkpoint``,
keeps only its inputs and runs again in the backward, so the backward's
working set is one layer's (at full width a Mamba layer at 4 × 2048 would
otherwise keep 2-2.5 GB of activations, 64 layers far more than a card
holds); ``"dots"`` (no config sets it) is refused. Parameter names
follow the JAX tree, with the scanned ``blocks/sub<k>`` stack and the
``tail<i>`` layers unrolled into ``layers.<i>`` and the encoder's stack
``enc_blocks`` into
``enc_layers.<i>``, and each parameter has the dtype JAX gives its leaf:
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

import functools

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
    if cfg.kind not in ("decoder", "encdec", "prefix_vlm"):
        raise NotImplementedError(f"kind={cfg.kind!r}: the port runs the "
                                  "decoder, encdec and prefix_vlm kinds")
    if cfg.kind == "encdec" and cfg.enc_layers < 1:
        # JAX's init_model draws the encoder's stack from
        # jax.random.split(key, enc_layers)[0], which 0 layers lack
        raise ValueError(f"kind='encdec' needs enc_layers >= 1, got "
                         f"{cfg.enc_layers}")
    if cfg.kind == "prefix_vlm" and any(m == "fd"
                                        for m, _ in cfg.layers_spec):
        # JAX builds the FD layers causal and applies them bidirectionally
        # under the prefix mask: its forward fails on the spectrum's shape
        raise NotImplementedError(
            "prefix_vlm with an fd mixer: the prefix mask runs the mixer "
            "bidirectionally over layers built causal, which JAX's forward "
            "cannot run either (its FD spectrum's shapes do not broadcast)")
    if cfg.remat not in ("none", "full"):
        raise NotImplementedError(
            f"remat={cfg.remat!r}: the port checkpoints whole layers "
            "(\"full\") or nothing (\"none\"); JAX's \"dots\" policy "
            "(keep the matmul outputs) has no counterpart")
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
    {norm1, mixer} for a layer without an FFN (``ffn == "none"``, Mamba);
    with ``cross`` (an encdec decoder layer) also {norm_x, cross}, the
    cross-attention's norm and :class:`Attention`."""

    def __init__(self, cfg: ArchConfig, mixer: str, ffn: str, device=None,
                 cross: bool = False):
        super().__init__()
        self.norm1 = RMSNorm(cfg.d_model, device=device)
        if mixer in ("attention", "local"):
            self.mixer = Attention(cfg, device=device)
        elif mixer == "mamba":
            self.mixer = Mamba(cfg, device=device)
        else:
            self.mixer = gtu_init(_tno_cfg(cfg, mixer), device=device)
        if cross:
            self.norm_x = RMSNorm(cfg.d_model, device=device)
            self.cross = Attention(cfg, device=device)
        if ffn == "dense":
            self.norm2 = RMSNorm(cfg.d_model, device=device)
            self.ffn = FFN(cfg.d_model, cfg.d_ff, device=device,
                           dtype=getattr(torch, cfg.param_dtype))
        elif ffn == "moe":
            self.norm2 = RMSNorm(cfg.d_model, device=device)
            self.ffn = MoE(cfg, device=device)


def mixer_apply(params, cfg: ArchConfig, mixer: str, x, *,
                mask_kind: str = "causal", prefix: int = 0):
    if mixer in ("attention", "local"):
        mk = "local" if mixer == "local" else mask_kind
        return attn_apply(params, cfg, x, mask_kind=mk, prefix=prefix)
    if mixer == "mamba":
        return mamba_apply(params, cfg, x)
    causal = mask_kind in ("causal", "local")
    # the GTU computes in the dtype JAX's x @ w promotes x and its leaves to
    # (``nn.layers.dense``): fp32 leaves take a bf16 x to fp32, bf16 leaves
    # (``cast_params``) keep a bf16 x in bf16; keep the residual dtype
    return gtu_apply(params, _tno_cfg(cfg, mixer, causal), x).to(x.dtype)


def layer_apply(params: Layer, cfg: ArchConfig, mixer: str, ffn: str, x, *,
                mask_kind: str = "causal", prefix: int = 0, enc_out=None):
    """x (b, s, d) -> (x, aux): aux is the MoE layer's load-balancing
    loss, 0 for other layers. A layer with a cross sublayer attends over
    ``enc_out`` (b, s_enc, d) after its mixer."""
    h = rmsnorm(params.norm1.scale, x, cfg.norm_eps)
    x = x + mixer_apply(params.mixer, cfg, mixer, h, mask_kind=mask_kind,
                        prefix=prefix)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if hasattr(params, "cross"):
        h = rmsnorm(params.norm_x.scale, x, cfg.norm_eps)
        x = x + attn_apply(params.cross, cfg, h, mask_kind="full",
                           kv_src=enc_out)
    if ffn == "dense":
        h = rmsnorm(params.norm2.scale, x, cfg.norm_eps)
        x = x + ffn_apply(params.ffn, cfg, h)
    elif ffn == "moe":
        y, aux = moe_apply(params.ffn, cfg,
                           rmsnorm(params.norm2.scale, x, cfg.norm_eps))
        x = x + y
    return x, aux


def _layer_fn(cfg: ArchConfig):
    """:func:`layer_apply`, or with ``remat="full"`` and grad enabled
    :func:`layer_apply` under non-reentrant ``torch.utils.checkpoint``
    (JAX's ``jax.checkpoint`` with the ``nothing_saveable`` policy): the
    layer's inputs are kept and the layer runs again in the backward, so
    each autograd Function in it runs its forward twice a step."""
    if cfg.remat == "full" and torch.is_grad_enabled():
        return functools.partial(checkpoint, layer_apply, use_reentrant=False)
    return layer_apply


# -------------------------------------------------------------- the model
class Model(nn.Module):
    """JAX leaves {embed (V_pad, d), unembed (d, V_pad), blocks/tail…,
    norm_f}; every layer is ``layers.<i>``. An encdec model adds the
    encoder, JAX's {enc_blocks, enc_norm_f}: ``enc_layers.<i>``
    (attention + dense layers) and ``enc_norm_f``, and a cross sublayer
    in every decoder layer."""

    def __init__(self, cfg: ArchConfig, device=None):
        super().__init__()
        _check_supported(cfg)
        self.cfg = cfg          # read by bridge/checkpoint for the JAX layout
        d, v = cfg.d_model, cfg.vocab_padded
        pdt = getattr(torch, cfg.param_dtype)
        cross = cfg.kind == "encdec"
        self.embed = nn.Parameter(torch.empty(v, d, dtype=pdt, device=device))
        self.unembed = nn.Parameter(torch.empty(d, v, dtype=pdt,
                                                device=device))
        self.layers = nn.ModuleList(
            Layer(cfg, mixer, ffn, device=device, cross=cross)
            for mixer, ffn in cfg.layers_spec)
        self.norm_f = RMSNorm(d, device=device)
        if cross:
            self.enc_layers = nn.ModuleList(
                Layer(cfg, "attention", "dense", device=device)
                for _ in range(cfg.enc_layers))
            self.enc_norm_f = RMSNorm(d, device=device)

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


def _needs(cfg: ArchConfig, name: str, value) -> None:
    if value is None:
        raise ValueError(f"kind={cfg.kind!r} ({cfg.name}) needs {name}")


def run_encoder(params: Model, cfg: ArchConfig, enc_embed: torch.Tensor):
    """enc_embed (b, s_enc, d) -> the encoder's output (b, s_enc, d) in
    ``cfg.dtype``: every encoder layer is attention + dense under the
    ``full`` mask (RoPE on both sides, as any self-attention), whatever
    ``mixer_override`` says, then ``enc_norm_f`` (JAX's ``_run_encoder``)."""
    x = enc_embed.to(getattr(torch, cfg.dtype))
    apply = _layer_fn(cfg)
    for layer in params.enc_layers:
        x, _ = apply(layer, cfg, "attention", "dense", x, mask_kind="full")
    return rmsnorm(params.enc_norm_f.scale, x, cfg.norm_eps)


def backbone(params: Model, cfg: ArchConfig, tokens: torch.Tensor, *,
             enc_embed=None, patches=None):
    """tokens (b, s) -> (hidden (b, s, d) after the final norm, the MoE
    aux loss summed over layers). A decoder's layers take the causal mask,
    as in JAX's ``backbone``; an encdec's (``enc_embed`` (b, s_enc, d)
    required) attend over the encoded frames too; a prefix_vlm's
    (``patches`` (b, n_prefix, d) required) run under the prefix mask
    over [patches, tokens], and the prefix is stripped after the norm."""
    mask_kind, prefix, enc_out = "causal", 0, None
    x = embed_tokens(params, cfg, tokens)
    if cfg.kind == "prefix_vlm":
        _needs(cfg, "patches", patches)
        x = torch.cat([patches.to(x.dtype), x], dim=1)
        mask_kind, prefix = "prefix", cfg.n_prefix
    elif cfg.kind == "encdec":
        _needs(cfg, "enc_embed", enc_embed)
        enc_out = run_encoder(params, cfg, enc_embed)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    apply = _layer_fn(cfg)
    for (mixer, ffn), layer in zip(cfg.layers_spec, params.layers):
        x, a = apply(layer, cfg, mixer, ffn, x, mask_kind=mask_kind,
                     prefix=prefix, enc_out=enc_out)
        aux = aux + a
    x = rmsnorm(params.norm_f.scale, x, cfg.norm_eps)
    if cfg.kind == "prefix_vlm":
        x = x[:, cfg.n_prefix:]
    return x, aux


def forward(params: Model, cfg: ArchConfig, tokens: torch.Tensor, *,
            enc_embed=None, patches=None):
    """tokens (b, s) -> logits (b, s, V_pad); ``enc_embed`` (encdec) and
    ``patches`` (prefix_vlm) as :func:`backbone` takes them. (The JAX
    function also returns the MoE aux loss; :func:`backbone` gives it.)"""
    return unembed(params, cfg, backbone(params, cfg, tokens,
                                         enc_embed=enc_embed,
                                         patches=patches)[0])


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
    (b, s) -> (loss, {"nll", "aux"}); batch["enc_embed"] (encdec) and
    batch["patches"] (prefix_vlm, the loss over the text alone) are read
    as JAX reads them. The logits are sequence-chunked
    exactly when the JAX package chunks them (``loss_chunk`` set, s > c and
    s % c == 0): each chunk reduces to a scalar and is recomputed in the
    backward, so at most (b, loss_chunk, V) logits are live. The aux term
    (the MoE layers' load balance, summed) is 0 without MoE FFNs."""
    x, aux = backbone(params, cfg, batch["tokens"],
                      enc_embed=batch.get("enc_embed"),
                      patches=batch.get("patches"))
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
