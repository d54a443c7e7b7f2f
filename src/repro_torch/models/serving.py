"""Serving: prefill, chunked prefill and single-token decode with per-layer
caches — counterpart of ``repro/models/serving.py`` for the models the
port runs: attention decoders (``attention`` and ``local`` layers), the TNN
LMs (the baseline ``tno`` and ``fd`` mixers, also as ``mixer_override`` of
an attention arch), Mamba-2 and the jamba hybrid, whose Mamba and
attention layers keep their own caches side by side (bf16 KV and conv
leaves beside fp32 SSD state), the encoder-decoder whisper and the
prefix-VLM paligemma. SKI has no decode, as in JAX.

An encdec model's prompt is encoded once (:func:`encode`), and every
decode step takes the encoder's output ``enc_out``: each decoder layer's
cross sublayer projects its k and v from all of ``enc_out`` again at every
step, as JAX's does (no cross cache; the caches are the decoder's own). A
prefix_vlm decodes the text alone: JAX's ``decode_step`` never sees the
patches, so neither does the port's (its decode matches the forward with
the prefix cut to 0, not the prefixed forward).

The cache is a list with one cache per layer:

* an ``attention`` or ``local`` layer gets the KV cache ``{"k", "v"}``,
  each (b, max_len, kvh, hd) in the cache dtype; a step writes the row's
  rotated k and v at its position and attends over the positions up to it
  (for ``local``, the last ``window`` of them). Its prompt goes token by
  token, as JAX's ``generate`` feeds every cache but the FD stream;
* an ``fd`` layer given the parameters gets the overlap-save streaming
  cache (``kernels/fd_stream.py``), built from the layer's causal kernel,
  realised once per (layer, ``max_len``) through the FD spectrum (on the
  card the ``hilbert_window`` kernel);
* a ``tno`` layer, and an ``fd`` layer under ``REPRO_FD_STREAM=0`` or
  without parameters, gets the hist-replay cache: the mixer inputs
  ``hist`` (b, max_len, d), replayed against the causal taps each step
  (O(n·d) a token). With the parameters the taps are realised once per
  layer into ``kcoef`` (d, max_len); without them every step realises them
  again. :data:`PLAN_EVALS` counts the realisations. The baseline's RPE
  reads t / n, so its taps depend on ``max_len``: decode matches the
  forward run at n = ``max_len``;
* a ``mamba`` layer's is O(1) in the length: the conv window and the fp32
  SSD state (``models/mamba.mamba_cache_init``).

An MoE FFN keeps no cache: a step routes its b rows through
``models/moe.moe_apply`` as one batch of b tokens. A Mamba layer with an
FFN (jamba) runs the Mamba step, then its dense or MoE FFN; its prompt
goes token by token, as JAX feeds it (no chunked prefill).

``decode_step`` takes one int position (every row in lockstep) or per-row
host positions (the continuous-batching engine, ``repro_torch.
serving_engine``): the scalar case is the per-row case broadcast, so
lockstep and ragged decode give the same bits per row.
"""
from __future__ import annotations

import torch

from repro_torch.core import fd as fd_mod
from repro_torch.core import tno as tno_mod
from repro_torch.kernels import backend, fd_stream
from repro_torch.models.attention import (attn_apply, attn_decode,
                                          decode_cache_init)
from repro_torch.models.config import ArchConfig
from repro_torch.models.mamba import mamba_cache_init, mamba_decode
from repro_torch.models.moe import moe_apply
from repro_torch.models.transformer import (Model, _tno_cfg, embed_tokens,
                                            ffn_apply, forward, run_encoder,
                                            unembed)
from repro_torch.nn.layers import ACTS, dense, rmsnorm

#: realisations of a layer's decode kernel (the FD spectrum or the
#: baseline's coefficients), by mixer: one per layer at ``init_cache``
#: with parameters, one per layer and step for a params-less hist cache
PLAN_EVALS: dict = {"fd": 0, "tno": 0}


# ------------------------------------------------------------- cache init
def _realise_kcoef(cfg: ArchConfig, mixer: str, layer_params,
                   max_len: int) -> torch.Tensor:
    """(d, max_len) causal kernel taps of a tno or fd layer, lags
    0..max_len-1: what the hist replay uses at s = max_len."""
    PLAN_EVALS[mixer] = PLAN_EVALS.get(mixer, 0) + 1
    tcfg = _tno_cfg(cfg, mixer).tno
    if mixer == "fd":
        kt = fd_mod.fd_kernel_time(layer_params.tno, tcfg.fd_cfg(), max_len)
        return kt[:, :max_len]
    return tno_mod.baseline_coeffs(layer_params.tno, tcfg,
                                   max_len)[:, max_len - 1:]


def is_hist_cache(cache) -> bool:
    return isinstance(cache, dict) and "hist" in cache


def is_kv_cache(cache) -> bool:
    return isinstance(cache, dict) and "k" in cache


def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               params: Model | None = None, dtype=None,
               device=None) -> list:
    """One cache per layer (see the module docstring), on ``device``, else
    on the parameters' device (without them, on the CPU; ``"meta"``
    allocates nothing). ``dtype`` (a torch dtype; default the activation
    dtype ``cfg.dtype``) is the hist and Mamba caches' dtype, as in the
    JAX package."""
    mixers = {mixer for mixer, _ in cfg.layers_spec}
    if "ski" in mixers:          # as repro/models/serving.py:99 raises
        raise NotImplementedError("decode for mixer ski (ski: Appendix "
                                  "B); score prompts with "
                                  "launch.steps.make_forward")
    if mixers - {"attention", "local", "tno", "fd", "mamba"}:
        raise NotImplementedError(f"decode for mixers {sorted(mixers)}: "
                                  "only attention, local, tno, fd and mamba "
                                  "are ported")
    if device is None and params is not None:
        device = params.embed.device
    dtype = dtype or getattr(torch, cfg.dtype)
    cache = []
    for i, (mixer, _) in enumerate(cfg.layers_spec):
        if mixer in ("attention", "local"):
            cache.append(decode_cache_init(cfg, batch, max_len, dtype,
                                           device))
            continue
        if mixer == "mamba":
            cache.append(mamba_cache_init(cfg, batch, dtype, device))
            continue
        lp = None if params is None else params.layers[i].mixer
        if mixer == "fd" and lp is not None and backend.fd_stream_enabled():
            kt = _realise_kcoef(cfg, mixer, lp, max_len)
            cache.append(fd_stream.fd_stream_cache(
                kt, batch, max_len, backend.fd_stream_block()))
            continue
        lc = {"hist": torch.zeros(batch, max_len, cfg.d_model, dtype=dtype,
                                  device=device)}
        if lp is not None:
            lc["kcoef"] = _realise_kcoef(cfg, mixer, lp, max_len)
        cache.append(lc)
    return cache


def cache_capacity(cache) -> int | None:
    """Slot capacity (max positions a slot can hold) of a model cache:
    the min over its streaming layers' ``cap`` markers and its hist and KV
    layers' lengths (a hybrid's attention layers bound it), None when no
    layer is length-bounded (an all-mamba model). The serving engine
    gates admission on it."""
    caps = [fd_stream.stream_capacity(lc) for lc in cache
            if fd_stream.is_stream_cache(lc)]
    caps += [lc["hist"].shape[-2] for lc in cache if is_hist_cache(lc)]
    caps += [lc["k"].shape[-3] for lc in cache if is_kv_cache(lc)]
    return min(caps) if caps else None


# ------------------------------------------------------- tno decode mixer
def _hist_replay(params, cfg: ArchConfig, mixer: str, u, cache,
                 pos: fd_stream.Positions):
    """The hist-replay step: write u (b, 1, d) at each row's position,
    then y_t = Σ_{τ=0..t} k[τ] u_{t-τ} over the history, summed in fp32.
    Returns (y (b, d) fp32, new cache)."""
    hist = cache["hist"]
    s = hist.shape[1]
    cur = pos.dev
    idx = torch.arange(s, device=hist.device)
    wsel = (idx[None, :] == cur[:, None])[..., None]       # (b, s, 1)
    hist = torch.where(wsel, u.to(hist.dtype), hist)
    k_causal = cache.get("kcoef")
    if k_causal is None:         # params-less cache: realise every step
        k_causal = _realise_kcoef(cfg, mixer, params, s)
    # history index j holds lag τ = cur - j; a future index is masked
    tau = cur[:, None] - idx[None, :]                      # (b, s)
    kmat = torch.where(tau[None] >= 0, k_causal[:, tau.clamp(0, s - 1)],
                       0.0)                                # (d, b, s)
    y = torch.einsum("bsd,dbs->bd", hist.float(), kmat.float())
    return y, dict(cache, hist=hist)


def _tno_decode(params, cfg: ArchConfig, mixer: str, x, cache, cur_len):
    """GTU decode: x (b, 1, d) at ``cur_len`` (an int, or
    ``fd_stream.Positions`` for a hist cache) through the overlap-save
    step or the hist replay. u and v are fp32 (JAX's ``x @ w`` promotes a
    bf16 x against the fp32 leaves); the mixer output is cast to x's dtype
    before the gate, as in JAX."""
    act = ACTS[_tno_cfg(cfg, mixer).act]
    xf = x.float()
    u = act(dense(params.wu.w, xf))                    # (b, 1, d)
    v = act(dense(params.wv.w, xf))
    if fd_stream.is_stream_cache(cache):
        y, cache = fd_stream.stream_step(cache, u[:, 0, :], cur_len)
    else:
        y, cache = _hist_replay(params, cfg, mixer, u, cache, cur_len)
    o = y[:, None, :].to(x.dtype)
    # GTU internals run fp32: keep the residual dtype stable
    return dense(params.wo.w, o * v).to(x.dtype), cache


# ------------------------------------------------------------- layer step
def _layer_decode(params, cfg: ArchConfig, mixer: str, ffn: str, x, cache,
                  cur_len, enc_out=None):
    h = rmsnorm(params.norm1.scale, x, cfg.norm_eps)
    if mixer in ("attention", "local"):
        y, cache = attn_decode(params.mixer, cfg, h, cache, cur_len.dev,
                               mask_kind="local" if mixer == "local"
                               else "causal", window=cfg.window)
    elif mixer == "mamba":
        y, cache = mamba_decode(params.mixer, cfg, h, cache)
    else:
        y, cache = _tno_decode(params.mixer, cfg, mixer, h, cache, cur_len)
    x = x + y
    if hasattr(params, "cross"):
        h = rmsnorm(params.norm_x.scale, x, cfg.norm_eps)
        x = x + attn_apply(params.cross, cfg, h, mask_kind="full",
                           kv_src=enc_out)
    if ffn == "dense":
        x = x + ffn_apply(params.ffn, cfg,
                          rmsnorm(params.norm2.scale, x, cfg.norm_eps))
    elif ffn == "moe":
        # the aux loss is discarded, as in JAX; capacity counts the step's
        # rows (parked engine slots included), so a step of at most 4 rows
        # never drops
        y, _ = moe_apply(params.ffn, cfg,
                         rmsnorm(params.norm2.scale, x, cfg.norm_eps))
        x = x + y
    return x, cache


def decode_step(params: Model, cfg: ArchConfig, tokens, cache, cur_len,
                enc_out=None):
    """One new token: tokens (b, 1) at position ``cur_len``: an int (every
    row at the same position) or per-row host positions (a list, numpy
    array or CPU tensor of b ints, or ``fd_stream.Positions``; the
    continuous-batching engine). Attention and TNN layers take them, moved
    to the card once for all layers; Mamba layers ignore them, as in JAX.
    An encdec model needs ``enc_out`` (b, s_enc, d), :func:`encode`'s
    output, which every layer's cross sublayer attends over (JAX's
    ``kv_src=None`` would quietly turn it into self-attention over the new
    token; the port raises instead). Returns (logits (b, 1, V_pad), new
    cache)."""
    if cfg.kind == "encdec" and enc_out is None:
        raise ValueError(f"{cfg.name}: an encdec decode_step needs enc_out "
                         "(serving.encode of the source frames)")
    if any(fd_stream.is_stream_cache(lc) or is_hist_cache(lc)
           or is_kv_cache(lc) for lc in cache):
        cur_len = fd_stream.positions(cur_len, tokens.shape[0],
                                      tokens.device)
    x = embed_tokens(params, cfg, tokens)
    new_cache = []
    for (mixer, ffn), layer, lc in zip(cfg.layers_spec, params.layers,
                                       cache):
        x, lc = _layer_decode(layer, cfg, mixer, ffn, x, lc, cur_len,
                              enc_out)
        new_cache.append(lc)
    x = rmsnorm(params.norm_f.scale, x, cfg.norm_eps)
    return unembed(params, cfg, x), new_cache


# ------------------------------------------------------- chunked prefill
def supports_chunked_prefill(cfg: ArchConfig, cache) -> bool:
    """Chunked prefill rides the FD streaming block machinery: every layer
    must be a streaming ``fd`` layer with a dense FFN (so not mamba, as in
    the JAX package). A hist cache takes its prompt token by token."""
    if cfg.kind != "decoder":
        return False
    if not all(m == "fd" and f == "dense" for m, f in cfg.layers_spec):
        return False
    return stream_block_of(cache) is not None


def stream_block_of(cache) -> int | None:
    """C of the streaming caches in a model cache (None if none)."""
    for lc in cache:
        if fd_stream.is_stream_cache(lc):
            return fd_stream.stream_block_size(lc)
    return None


def _layer_chunk(params, cfg: ArchConfig, x, cache, cur_len: int):
    """One fd+dense layer over a full C-token chunk at positions
    [cur_len, cur_len+C), cur_len ≡ 0 mod C."""
    act = ACTS[_tno_cfg(cfg, "fd").act]
    h = rmsnorm(params.norm1.scale, x, cfg.norm_eps).float()
    mp = params.mixer
    u = act(dense(mp.wu.w, h))                         # (b, C, d)
    v = act(dense(mp.wv.w, h))
    y, cache = fd_stream.stream_push_block(cache, u, cur_len)
    x = x + dense(mp.wo.w, y.to(x.dtype) * v).to(x.dtype)
    x = x + ffn_apply(params.ffn, cfg,
                      rmsnorm(params.norm2.scale, x, cfg.norm_eps))
    return x, cache


def decode_chunk(params: Model, cfg: ArchConfig, tokens, cache,
                 cur_len: int):
    """Chunked prefill step: tokens (b, C), C the streaming block size,
    cur_len ≡ 0 (mod C). Returns (logits (b, C, V_pad), new cache); the
    cache afterwards equals that of C decode_step calls."""
    x = embed_tokens(params, cfg, tokens)
    new_cache = []
    for layer, lc in zip(params.layers, cache):
        x, lc = _layer_chunk(layer, cfg, x, lc, cur_len)
        new_cache.append(lc)
    x = rmsnorm(params.norm_f.scale, x, cfg.norm_eps)
    return unembed(params, cfg, x), new_cache


def prefill(params: Model, cfg: ArchConfig, tokens, *, enc_embed=None,
            patches=None):
    """Score a prompt with the full-sequence forward (on the card the
    FD-TNO op runs ``hilbert_window`` and ``fd_mul`` once per layer, a
    Mamba layer ``short_conv`` and ``ssd_scan``); ``enc_embed`` and
    ``patches`` as ``transformer.forward`` takes them. Returns logits (b,
    s, V_pad)."""
    return forward(params, cfg, tokens, enc_embed=enc_embed, patches=patches)


def encode(params: Model, cfg: ArchConfig, enc_embed):
    """An encdec model's encoder over the source frames ``enc_embed`` (b,
    s_enc, d) -> ``enc_out`` (b, s_enc, d) in ``cfg.dtype``, which every
    :func:`decode_step` of the request takes."""
    return run_encoder(params, cfg, enc_embed)
