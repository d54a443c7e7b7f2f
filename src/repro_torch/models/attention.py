"""GQA attention, counterpart of ``repro/models/attention.py``: RoPE,
optional QKV bias, the causal / local (sliding-window) / prefix / full
masks, the q-chunked softmax of training and prefill, and the KV cache of
decode.

Written in plain torch to the JAX package's formulas, so that the bf16
tier against JAX holds: the logits are fp32 products of the
activation-dtype q and k, masked with -1e30, and the softmax and the second
product run in fp32 before one cast back. GQA repeats k and v to full
heads in the forward and groups q by kv head in decode, as JAX does. A
fused attention (``scaled_dot_product_attention``) would round
differently. No TPU kernel lives here: attention was plain jnp in JAX.

Cross-attention (``kv_src``, the encoder-decoder archs' decoder layers)
takes q from x and k, v from the source, rotates neither, and attends over
every source position (the ``full`` mask), as JAX's ``attn_apply`` does.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.models.config import ArchConfig
from repro_torch.nn.layers import lecun_normal_
from repro_torch.nn.params import set_axes

class Attention(nn.Module):
    """JAX leaves {wq, wk, wv, wo}, and {bq, bk, bv} with ``qkv_bias``, each
    matrix (d_in, d_out), all in ``param_dtype``."""

    def __init__(self, cfg: ArchConfig, device=None):
        super().__init__()
        d, h, kvh, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        kw = {"device": device, "dtype": getattr(torch, cfg.param_dtype)}
        self.wq = nn.Parameter(torch.empty(d, h * hd, **kw))
        self.wk = nn.Parameter(torch.empty(d, kvh * hd, **kw))
        self.wv = nn.Parameter(torch.empty(d, kvh * hd, **kw))
        self.wo = nn.Parameter(torch.empty(h * hd, d, **kw))
        if cfg.qkv_bias:
            self.bq = nn.Parameter(torch.empty(h * hd, **kw))
            self.bk = nn.Parameter(torch.empty(kvh * hd, **kw))
            self.bv = nn.Parameter(torch.empty(kvh * hd, **kw))
        else:
            self.bq = self.bk = self.bv = None
        set_axes(self, wq=("embed", "heads"), wk=("embed", "kv_proj"),
                 wv=("embed", "kv_proj"), wo=("heads", "embed"),
                 bq=("heads",), bk=("kv_proj",), bv=("kv_proj",))

    def reset_parameters(self, generator: torch.Generator) -> None:
        for w in (self.wq, self.wk, self.wv, self.wo):
            lecun_normal_(w, generator)
        for b in (self.bq, self.bk, self.bv):
            if b is not None:
                nn.init.zeros_(b)


def attn_init(cfg: ArchConfig, device=None) -> Attention:
    return Attention(cfg, device=device)


# ------------------------------------------------------------------- RoPE
def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """x: (b, s, h, hd); positions: (s,) or (b, s). The frequencies and
    angles are fp32, as JAX builds them; the rotation promotes x to fp32
    and casts back."""
    half = x.shape[-1] // 2
    # filled on the device: a host tensor's copy would wait for the stream
    log_theta = torch.log(torch.full((), theta, dtype=torch.float32,
                                     device=x.device))
    freqs = torch.exp(-log_theta * torch.arange(
        0, half, dtype=torch.float32, device=x.device) / half)
    if positions.dim() == 1:
        ang = positions[:, None].float() * freqs[None, :]
        ang = ang[None, :, None, :]                      # (1, s, 1, half)
    else:
        ang = positions[..., None].float() * freqs
        ang = ang[:, :, None, :]                         # (b, s, 1, half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ----------------------------------------------------------------- masking
def mask_for(kind: str, q_pos: torch.Tensor, k_pos: torch.Tensor, *,
             window: int = 0, prefix: int = 0) -> torch.Tensor:
    """Boolean (…, q, k) mask. kinds: causal | local | prefix | full."""
    qp = q_pos[..., :, None]
    kp = k_pos[..., None, :]
    if kind == "full":
        return torch.ones(torch.broadcast_shapes(qp.shape, kp.shape),
                          dtype=torch.bool, device=qp.device)
    causal = kp <= qp
    if kind == "causal":
        return causal
    if kind == "local":
        return causal & (qp - kp < window)
    if kind == "prefix":
        return causal | (kp < prefix)
    raise ValueError(kind)


# --------------------------------------------------- core attention (train)
def _scale(hd: int) -> float:
    """1 / sqrt(hd) rounded to fp32, as JAX takes it (IEEE sqrt and
    division round correctly, so numpy's fp32 gives the same value)."""
    return float(np.float32(1.0) / np.sqrt(np.float32(hd)))


def _sdpa_chunk(q, k, v, mask, scale):
    """q (b, h, qc, hd), k/v (b, h, s, hd) full-head; mask (qc, s) or
    (b, 1, qc, s). Returns (b, h, qc, hd) fp32."""
    logits = torch.einsum("bhqd,bhsd->bhqs", q.float(), k.float()) * scale
    logits = torch.where(mask, logits, -1e30)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqs,bhsd->bhqd", probs, v.float())


def attention(q, k, v, *, mask_kind: str, window: int = 0, prefix: int = 0,
              q_offset: int = 0, chunk: int = 1024) -> torch.Tensor:
    """q: (b, sq, h, hd); k, v: (b, sk, kvh, hd) -> (b, sq, h, hd) in q's
    dtype. The queries go in chunks of ``chunk`` when sq is a multiple of
    it (else in one), each chunk under ``torch.utils.checkpoint`` when
    autograd records, so that its (chunk, sk) logits are recomputed in the
    backward rather than kept, as ``jax.checkpoint`` does in JAX."""
    b, sq, h, hd = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    if kvh != h:                      # GQA: repeat kv to full heads
        k = torch.repeat_interleave(k, h // kvh, dim=2)
        v = torch.repeat_interleave(v, h // kvh, dim=2)
    scale = _scale(hd)
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    k_pos = torch.arange(sk, device=q.device)
    qc = min(chunk, sq)
    if sq % qc != 0:
        qc = sq                        # fallback: no chunking

    def chunk_compute(qi, start: int):
        q_pos = q_offset + start + torch.arange(qi.shape[2], device=q.device)
        m = mask_for(mask_kind, q_pos, k_pos, window=window, prefix=prefix)
        return _sdpa_chunk(qi, kt, vt, m, scale)

    if qc == sq:
        out = chunk_compute(qt, 0)
    else:
        recompute = torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k, v))
        outs = []
        for start in range(0, sq, qc):
            qi = qt[:, :, start:start + qc]
            outs.append(checkpoint(chunk_compute, qi, start,
                                   use_reentrant=False) if recompute
                        else chunk_compute(qi, start))
        out = torch.cat(outs, dim=2)
    return out.transpose(1, 2).to(q.dtype)


def _project(params: Attention, x, name: str):
    y = x @ getattr(params, f"w{name}").to(x.dtype)
    bias = getattr(params, f"b{name}")
    if bias is not None:
        y = y + bias.to(x.dtype)
    return y


def attn_apply(params: Attention, cfg: ArchConfig, x: torch.Tensor, *,
               mask_kind: str = "causal", prefix: int = 0, kv_src=None,
               positions=None) -> torch.Tensor:
    """Attention sublayer on x (b, s, d) -> (b, s, d): self-attention, or
    with ``kv_src`` (b, s_src, d) cross-attention, k and v projected from
    the source and no RoPE on either side (JAX rotates only when kv_src is
    None)."""
    b, s, _ = x.shape
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    src = x if kv_src is None else kv_src.to(x.dtype)
    sk = src.shape[1]
    q = _project(params, x, "q").reshape(b, s, h, hd)
    k = _project(params, src, "k").reshape(b, sk, kvh, hd)
    v = _project(params, src, "v").reshape(b, sk, kvh, hd)
    if kv_src is None:                      # self-attention: rotate both
        if positions is None:
            positions = torch.arange(s, device=x.device)
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, torch.arange(s, device=x.device), cfg.rope_theta)
    o = attention(q, k, v, mask_kind=mask_kind, window=cfg.window,
                  prefix=prefix, chunk=cfg.attn_chunk)
    return o.reshape(b, s, h * hd) @ params.wo.to(x.dtype)


# -------------------------------------------------------------- decode path
def decode_cache_init(cfg: ArchConfig, batch: int, max_len: int, dtype,
                      device=None) -> dict:
    hd, kvh = cfg.head_dim, cfg.n_kv_heads
    return {"k": torch.zeros(batch, max_len, kvh, hd, dtype=dtype,
                             device=device),
            "v": torch.zeros(batch, max_len, kvh, hd, dtype=dtype,
                             device=device)}


def attn_decode(params: Attention, cfg: ArchConfig, x: torch.Tensor,
                cache: dict, cur: torch.Tensor, *, mask_kind: str = "causal",
                window: int = 0):
    """One-token decode. x: (b, 1, d); cache k/v (b, S, kvh, hd); ``cur``
    (b,) int64 per-row positions on x's device (the lockstep case is the
    per-row case broadcast, so both give the same bits per row): the
    row's RoPE angle, its KV write position and its causal (or local)
    validity. Returns (y (b, 1, d), new cache)."""
    b = x.shape[0]
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = _project(params, x, "q").reshape(b, 1, h, hd)
    k_new = _project(params, x, "k").reshape(b, 1, kvh, hd)
    v_new = _project(params, x, "v").reshape(b, 1, kvh, hd)
    pos = cur[:, None]                                     # (b, 1)
    q = rope(q, pos, cfg.rope_theta)
    k_new = rope(k_new, pos, cfg.rope_theta)
    ck, cv = cache["k"], cache["v"]
    k_pos = torch.arange(ck.shape[1], device=x.device)
    wsel = (k_pos[None, :] == cur[:, None])[..., None, None]  # (b, S, 1, 1)
    ck = torch.where(wsel, k_new.to(ck.dtype), ck)
    cv = torch.where(wsel, v_new.to(cv.dtype), cv)
    valid = k_pos[None, :] <= cur[:, None]                 # (b, S)
    if mask_kind == "local" and window:
        valid = valid & (cur[:, None] - k_pos[None, :] < window)
    g = h // kvh
    qg = q.reshape(b, 1, kvh, g, hd)
    logits = torch.einsum("bqkgh,bskh->bkgqs", qg.float(),
                          ck.float()) * _scale(hd)
    logits = torch.where(valid[:, None, None, None, :], logits, -1e30)
    probs = torch.softmax(logits, dim=-1)
    o = torch.einsum("bkgqs,bskh->bqkgh", probs, cv.float())
    o = o.reshape(b, 1, h * hd).to(x.dtype)
    return o @ params.wo.to(x.dtype), {"k": ck, "v": cv}

