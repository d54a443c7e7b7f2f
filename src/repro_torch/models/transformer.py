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

Layers run as a Python loop, eagerly (no layer scan). On a mesh (a
``models/context.Ctx`` with one, from ``launch/steps.StepBuilder``) the
TNN decoders run sharded at JAX's ``shard(ctx, ...)`` sites: the residual
stream is a DTensor with rows over the data axes and, as JAX's
sequence-parallel residual, positions over the model axis; each norm
gathers the positions, the GTU is channel TP (``core/block.py``) and the
FFN Megatron TP, both reduce-scattered back onto the residual; every
weight is gathered over the data axes at use (FSDP). The embedding is
looked up by id on each rank's d slice, the logits stay vocab-sharded and
the loss is the vocab-parallel cross-entropy. Attention, MoE, Mamba and
the encdec / prefix_vlm kinds have no sharded path yet
(:func:`sharded_path_missing`).
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
import torch.distributed as dist
from torch import nn
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.utils.checkpoint import checkpoint

from repro_torch.core.block import TNNBlockConfig, gtu_apply, gtu_init
from repro_torch.core.tno import TNOConfig
from repro_torch.models.attention import Attention, attn_apply
from repro_torch.models.config import ArchConfig
from repro_torch.models.context import Ctx, shard, to_local
from repro_torch.models.mamba import Mamba, mamba_apply
from repro_torch.models.moe import MoE, moe_apply
from repro_torch.nn.layers import (ACTS, RMSNorm, draw_buffer,
                                   lecun_normal_, reset_parameters, rmsnorm)
from repro_torch.nn.params import gathered, set_axes


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


def sharded_path_missing(cfg: ArchConfig) -> str | None:
    """Why ``cfg`` cannot run sharded over a mesh yet, or None: the
    sharded path covers the decoder kind of TNN layers (``tno``, ``ski``,
    ``fd``) with dense FFNs."""
    if cfg.kind != "decoder":
        return f"kind={cfg.kind!r}"
    for mixer, ffn in cfg.layers_spec:
        if mixer not in ("tno", "ski", "fd"):
            return f"{mixer} layers"
        if ffn != "dense":
            return f"{ffn} FFNs"
    return None


def _meshed(ctx: Ctx | None) -> bool:
    return ctx is not None and ctx.mesh is not None


# ------------------------------------------------------------------ pieces
class FFN(nn.Module):
    """JAX leaves {w_gate, w_up, w_down}, each (d_in, d_out)."""

    def __init__(self, d: int, f: int, device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.w_gate = nn.Parameter(torch.empty(d, f, **kw))
        self.w_up = nn.Parameter(torch.empty(d, f, **kw))
        self.w_down = nn.Parameter(torch.empty(f, d, **kw))
        set_axes(self, w_gate=("embed", "ffn"), w_up=("embed", "ffn"),
                 w_down=("ffn", "embed"))

    def reset_parameters(self, generator: torch.Generator) -> None:
        for w in (self.w_gate, self.w_up, self.w_down):
            lecun_normal_(w, generator)


def ffn_apply(params: FFN, cfg: ArchConfig, x, ctx: Ctx | None = None):
    act = ACTS[cfg.act]
    w_gate, w_up, w_down = (gathered(w) for w in (
        params.w_gate, params.w_up, params.w_down))
    h = act(x @ w_gate.to(x.dtype)) * (x @ w_up.to(x.dtype))
    h = shard(ctx, h, "batch", "seq_any", "ffn")
    return h @ w_down.to(x.dtype)


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


def _gathered_norm(scale, cfg: ArchConfig, ctx: Ctx | None, x):
    """The sequence-parallel gather, then the norm (per position, so the
    two commute; gathering first moves the narrower residual)."""
    return rmsnorm(scale, shard(ctx, x, "batch", "seq_any", "embed"),
                   cfg.norm_eps)


def layer_apply(params: Layer, cfg: ArchConfig, mixer: str, ffn: str, x, *,
                mask_kind: str = "causal", prefix: int = 0, enc_out=None,
                ctx: Ctx | None = None):
    """x (b, s, d) -> (x, aux): aux is the MoE layer's load-balancing
    loss, 0 for other layers. A layer with a cross sublayer attends over
    ``enc_out`` (b, s_enc, d) after its mixer. On a mesh, each sublayer's
    output (a partial sum over the model axis) is reduce-scattered onto
    the sequence-sharded residual before the add, at JAX's sites."""
    x = shard(ctx, x, "batch", "seq", "embed")
    h = _gathered_norm(params.norm1.scale, cfg, ctx, x)
    y = mixer_apply(params.mixer, cfg, mixer, h, mask_kind=mask_kind,
                    prefix=prefix)
    x = x + shard(ctx, y, "batch", "seq", "embed")
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if hasattr(params, "cross"):
        h = rmsnorm(params.norm_x.scale, x, cfg.norm_eps)
        x = x + attn_apply(params.cross, cfg, h, mask_kind="full",
                           kv_src=enc_out)
    if ffn == "dense":
        h = _gathered_norm(params.norm2.scale, cfg, ctx, x)
        x = x + shard(ctx, ffn_apply(params.ffn, cfg, h, ctx),
                      "batch", "seq", "embed")
    elif ffn == "moe":
        y, aux = moe_apply(params.ffn, cfg,
                           rmsnorm(params.norm2.scale, x, cfg.norm_eps))
        x = x + y
    return shard(ctx, x, "batch", "seq", "embed"), aux


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
        set_axes(self, embed=(None, "embed_tp"), unembed=("embed", "vocab"))
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
def embed_tokens(params: Model, cfg: ArchConfig, tokens,
                 ctx: Ctx | None = None):
    """tokens (b, s) -> (b, s, d) in ``cfg.dtype``. On a mesh (tokens a
    DTensor with rows over the data axes) each rank looks its rows up in
    its own d slice of the (None, embed_tp) table, and the result is laid
    out as the residual stream (d gathered, positions sharded)."""
    dt = getattr(torch, cfg.dtype)
    if not _meshed(ctx):
        return params.embed[tokens].to(dt)
    table = gathered(params.embed)
    pl = tuple(Shard(0) if t.is_shard() else Shard(2) if e.is_shard()
               else Replicate()
               for t, e in zip(tokens.placements, table.placements))
    x = to_local(table, pl)[tokens.to_local()].to(dt)
    b, s = tokens.shape
    x = DTensor.from_local(x, ctx.mesh, pl, run_check=False,
                           shape=(b, s, table.shape[1]),
                           stride=(s * table.shape[1], table.shape[1], 1))
    return shard(ctx, x, "batch", "seq", "embed")


def unembed(params: Model, cfg: ArchConfig, x, ctx: Ctx | None = None):
    """x (b, s, d) -> logits (b, s, V_pad); on a mesh vocab-sharded over
    the model axis (the positions gathered first)."""
    x = shard(ctx, x, "batch", "seq_any", "embed")
    return shard(ctx, x @ gathered(params.unembed).to(x.dtype),
                 "batch", "seq_any", "vocab")


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
             enc_embed=None, patches=None, ctx: Ctx | None = None):
    """tokens (b, s) -> (hidden (b, s, d) after the final norm, the MoE
    aux loss summed over layers). A decoder's layers take the causal mask,
    as in JAX's ``backbone``; an encdec's (``enc_embed`` (b, s_enc, d)
    required) attend over the encoded frames too; a prefix_vlm's
    (``patches`` (b, n_prefix, d) required) run under the prefix mask
    over [patches, tokens], and the prefix is stripped after the norm.
    ``ctx`` with a mesh: the sharded path (tokens a DTensor; the hidden
    state comes back a DTensor)."""
    if _meshed(ctx) and sharded_path_missing(cfg):
        raise NotImplementedError(f"{cfg.name}: {sharded_path_missing(cfg)}"
                                  " have no sharded path")
    mask_kind, prefix, enc_out = "causal", 0, None
    x = embed_tokens(params, cfg, tokens, ctx)
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
                     prefix=prefix, enc_out=enc_out, ctx=ctx)
        aux = aux + a
    x = rmsnorm(params.norm_f.scale, x, cfg.norm_eps)
    if cfg.kind == "prefix_vlm":
        x = x[:, cfg.n_prefix:]
    return x, aux


def forward(params: Model, cfg: ArchConfig, tokens: torch.Tensor, *,
            enc_embed=None, patches=None, ctx: Ctx | None = None):
    """tokens (b, s) -> logits (b, s, V_pad); ``enc_embed`` (encdec) and
    ``patches`` (prefix_vlm) as :func:`backbone` takes them. (The JAX
    function also returns the MoE aux loss; :func:`backbone` gives it.)"""
    return unembed(params, cfg, backbone(params, cfg, tokens,
                                         enc_embed=enc_embed,
                                         patches=patches, ctx=ctx)[0], ctx)


def _ce_terms(cfg: ArchConfig, logits, labels):
    """Sum of per-token (lse - ll). logits fp32 (b, c, V_pad); labels
    (b, c). Padded vocab columns are -1e30 before the log-sum-exp."""
    pad_mask = torch.arange(cfg.vocab_padded,
                            device=logits.device) < cfg.vocab
    logits = torch.where(pad_mask, logits, -1e30)
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return torch.sum(lse - ll)


class VocabParallelCE(torch.autograd.Function):
    """Per-token (lse - ll) of fp32 logits sharded on the vocab over a
    process group (each rank's columns ``start .. start + V_l``): a max
    and a sum all-reduce for the log-sum-exp and a sum all-reduce of the
    masked local label gather, every rank ending with the same values.
    The backward needs no collective: softmax minus one-hot on the local
    columns. Padded columns (index >= ``vocab``) are -1e30 as in
    :func:`_ce_terms`."""

    @staticmethod
    def forward(ctx, logits, labels, start: int, vocab: int, group):
        v_l = logits.shape[-1]
        col = torch.arange(start, start + v_l, device=logits.device)
        logits = torch.where(col < vocab, logits, -1e30)
        m = logits.amax(-1)
        dist.all_reduce(m, dist.ReduceOp.MAX, group=group)
        e = torch.exp(logits - m[..., None])
        s = e.sum(-1)
        dist.all_reduce(s, group=group)
        lab = labels.long() - start
        mine = (lab >= 0) & (lab < v_l)
        lab = lab.clamp(0, v_l - 1)
        ll = torch.where(mine, torch.gather(logits, -1, lab[..., None])[..., 0],
                         0.0)
        dist.all_reduce(ll, group=group)
        ctx.save_for_backward(e, s, lab, mine)
        return torch.log(s) + m - ll

    @staticmethod
    def backward(ctx, g):
        e, s, lab, mine = ctx.saved_tensors
        grad = e * (g / s)[..., None]
        grad.scatter_add_(-1, lab[..., None], -(g * mine)[..., None])
        return grad, None, None, None, None


def _sharded_loss(params: Model, cfg: ArchConfig, ctx: Ctx, x, labels):
    """This rank's part of the summed cross-entropy: its rows' tokens over
    its vocab columns (the sequence chunking of :func:`loss_fn`), the same
    on every rank of the model axis."""
    x = shard(ctx, x, "batch", "seq_any", "embed")
    w = gathered(params.unembed)
    pl = tuple(Shard(0) if a.is_shard() else Shard(2) if u.is_shard()
               else Replicate() for a, u in zip(x.placements, w.placements))
    vdims = [i for i, u in enumerate(w.placements)
             if u.is_shard() and ctx.mesh.size(i) > 1]
    xl, wl, lab = to_local(x, pl), to_local(w, pl), labels.to_local()
    if vdims:
        (i,) = vdims
        start = ctx.mesh.get_local_rank(i) * wl.shape[1]
        group = ctx.mesh.get_group(i)

    def chunk_nll(xc, lc):
        logits = (xc @ wl.to(xc.dtype)).float()
        if not vdims:
            return _ce_terms(cfg, logits, lc)
        return VocabParallelCE.apply(logits, lc, start, cfg.vocab,
                                     group).sum()

    return _chunked(cfg, chunk_nll, xl, lab)


def _chunked(cfg: ArchConfig, chunk_nll, x, labels):
    """Sum of ``chunk_nll`` over the sequence, chunked exactly when the JAX
    package chunks it (``loss_chunk`` set, s > c and s % c == 0): each
    chunk reduces to a scalar and is recomputed in the backward, so at most
    (b, loss_chunk, V) logits are live."""
    s = x.shape[1]
    c = cfg.loss_chunk
    if not (c and s > c and s % c == 0):
        return chunk_nll(x, labels)
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(0, s, c):
        total = total + checkpoint(chunk_nll, x[:, i:i + c],
                                   labels[:, i:i + c], use_reentrant=False)
    return total


def loss_fn(params: Model, cfg: ArchConfig, batch: dict, *,
            aux_weight: float = 0.01, ctx: Ctx | None = None):
    """Mean next-token cross-entropy over batch["tokens"] / batch["labels"]
    (b, s) -> (loss, {"nll", "aux"}); batch["enc_embed"] (encdec) and
    batch["patches"] (prefix_vlm, the loss over the text alone) are read
    as JAX reads them. The logits are sequence-chunked as :func:`_chunked`
    says. The aux term (the MoE layers' load balance, summed) is 0 without
    MoE FFNs. ``ctx`` with a mesh (batch values DTensors with rows over
    the data axes): a plain tensor, this rank's part of the loss, which
    the data ranks' parts sum to (``launch/steps.StepBuilder`` reduces
    it); the backward from it is the whole loss's."""
    x, aux = backbone(params, cfg, batch["tokens"],
                      enc_embed=batch.get("enc_embed"),
                      patches=batch.get("patches"), ctx=ctx)
    labels = batch["labels"]
    b, s, _ = x.shape
    if _meshed(ctx):
        total = _sharded_loss(params, cfg, ctx, x, labels)
    else:
        total = _chunked(cfg, lambda xc, lc: _ce_terms(
            cfg, unembed(params, cfg, xc).float(), lc), x, labels)
    nll = total / (b * s)
    return nll + aux_weight * aux, {"nll": nll, "aux": aux}
