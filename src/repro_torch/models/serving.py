"""Serving: prefill, chunked prefill and single-token decode with per-layer
streaming caches — counterpart of ``repro/models/serving.py`` for the FD
TNN LM.

The cache is a list with one overlap-save streaming cache per layer
(``kernels/fd_stream.py``), built from the layer's causal kernel, which is
realised once per (layer, ``max_len``) through the FD spectrum and so runs
the ``hilbert_window`` kernel on the card. The JAX package's hist-replay
fallback (``REPRO_FD_STREAM=0``, or an ``init_cache`` without params) is
not ported and raises.
"""
from __future__ import annotations

import torch

from repro_torch.core import fd as fd_mod
from repro_torch.kernels import backend, fd_stream
from repro_torch.models.config import ArchConfig
from repro_torch.models.transformer import (Model, _tno_cfg, embed_tokens,
                                            ffn_apply, forward, unembed)
from repro_torch.nn.layers import ACTS, dense, rmsnorm

_HIST_NOT_PORTED = ("the hist-replay decode cache is not ported yet "
                    "(ROADMAP Queue 1: hist decode fallback)")


# ------------------------------------------------------------- cache init
def _realise_kcoef(cfg: ArchConfig, mixer: str, layer_params,
                   max_len: int) -> torch.Tensor:
    """(d, max_len) causal kernel taps of an fd layer, lags 0..max_len-1."""
    bcfg = _tno_cfg(cfg, mixer)
    kt = fd_mod.fd_kernel_time(layer_params.tno, bcfg.tno.fd_cfg(), max_len)
    return kt[:, :max_len]


def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               params: Model | None = None) -> list:
    """One streaming cache per layer, on the parameters' device."""
    for mixer, _ in cfg.layers_spec:
        if mixer == "ski":       # as repro/models/serving.py:99 raises
            raise NotImplementedError("decode for mixer ski (ski: Appendix "
                                      "B); score prompts with "
                                      "launch.steps.make_forward")
        if mixer != "fd":
            raise NotImplementedError(f"decode for mixer {mixer}: only fd "
                                      "is ported")
    if params is None or not backend.fd_stream_enabled():
        raise NotImplementedError(_HIST_NOT_PORTED)
    cache = []
    for (mixer, _), layer in zip(cfg.layers_spec, params.layers):
        kt = _realise_kcoef(cfg, mixer, layer.mixer, max_len)
        cache.append(fd_stream.fd_stream_cache(kt, batch, max_len,
                                               backend.fd_stream_block()))
    return cache


# ------------------------------------------------------- tno decode mixer
def _tno_decode(params, cfg: ArchConfig, mixer: str, x, cache, cur_len):
    """GTU decode through the overlap-save step: x (b, 1, d)."""
    act = ACTS[_tno_cfg(cfg, mixer).act]
    u = act(dense(params.wu.w, x))                     # (b, 1, d)
    v = act(dense(params.wv.w, x))
    y, cache = fd_stream.stream_step(cache, u[:, 0, :], cur_len)
    o = y[:, None, :].to(x.dtype)
    # GTU internals run fp32: keep the residual dtype stable
    return dense(params.wo.w, o * v).to(x.dtype), cache


# ------------------------------------------------------------- layer step
def _layer_decode(params, cfg: ArchConfig, mixer: str, x, cache, cur_len):
    h = rmsnorm(params.norm1.scale, x, cfg.norm_eps)
    y, cache = _tno_decode(params.mixer, cfg, mixer, h, cache, cur_len)
    x = x + y
    x = x + ffn_apply(params.ffn, cfg,
                      rmsnorm(params.norm2.scale, x, cfg.norm_eps))
    return x, cache


def decode_step(params: Model, cfg: ArchConfig, tokens, cache, cur_len):
    """One new token: tokens (b, 1) at position ``cur_len`` (an int, the
    same in every row). Returns (logits (b, 1, V_pad), new cache)."""
    x = embed_tokens(params, cfg, tokens)
    new_cache = []
    for (mixer, _), layer, lc in zip(cfg.layers_spec, params.layers, cache):
        x, lc = _layer_decode(layer, cfg, mixer, x, lc, cur_len)
        new_cache.append(lc)
    x = rmsnorm(params.norm_f.scale, x, cfg.norm_eps)
    return unembed(params, cfg, x), new_cache


# ------------------------------------------------------- chunked prefill
def supports_chunked_prefill(cfg: ArchConfig, cache) -> bool:
    """Chunked prefill rides the FD streaming block machinery: every layer
    must be a streaming ``fd`` layer with a dense FFN."""
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
    h = rmsnorm(params.norm1.scale, x, cfg.norm_eps)
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


def prefill(params: Model, cfg: ArchConfig, tokens):
    """Score a prompt with the full-sequence forward (the FD-TNO op, so
    both ``hilbert_window`` and ``fd_mul`` run once per layer on the
    card). Returns logits (b, s, V_pad)."""
    return forward(params, cfg, tokens)
