"""Mamba-2 (SSD, state-space duality) mixer, counterpart of
``repro/models/mamba.py``.

in_proj -> [z | x | B | C | dt]; the short causal conv over (x, B, C)
(``ops.short_conv``: the CUDA kernel in bf16 on the card), then the
chunked SSD scan (``ops.ssd_scan``: the CUDA kernel on the card, the
chunked plain version on the CPU), a gated RMSNorm and the output
projection. Both ops are differentiable on both devices (``ShortConv``:
the bf16 ``short_conv`` and ``conv_tap_grad_bf16`` kernels in the
backward; ``SSDScan``: autograd through the chunked scan), and every
tensor a kernel reads is a contiguous copy, never a view of the split.
Decode keeps (conv window, SSD state) as the cache and runs the
recurrence in plain torch, as the JAX package does.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels import ops
from repro_torch.kernels.ssd_chunked import ssd_decode_step
from repro_torch.models.config import ArchConfig
from repro_torch.nn.layers import draw_buffer, lecun_normal_
from repro_torch.nn.params import set_axes


def _dims(cfg: ArchConfig):
    di = cfg.d_inner
    h = cfg.ssm_heads
    g, s = cfg.ssm_groups, cfg.ssm_state
    conv_dim = di + 2 * g * s
    return di, h, g, s, conv_dim


class Mamba(nn.Module):
    """JAX leaves {in_proj (d, 2di + 2gs + h), conv_w (conv_dim, cw),
    a_log, dt_bias, d_skip (h,), norm_scale (di,), out_proj (di, d)}: the
    matrices and the conv taps in ``param_dtype``, the rest fp32 whatever
    ``param_dtype`` is, as ``mamba_init`` makes them."""

    def __init__(self, cfg: ArchConfig, device=None):
        super().__init__()
        d = cfg.d_model
        di, h, g, s, conv_dim = _dims(cfg)
        pdt = getattr(torch, cfg.param_dtype)

        def param(*shape, dtype=torch.float32):
            return nn.Parameter(torch.empty(shape, dtype=dtype,
                                            device=device))
        self.in_proj = param(d, 2 * di + 2 * g * s + h, dtype=pdt)
        self.conv_w = param(conv_dim, cfg.conv_width, dtype=pdt)
        self.a_log = param(h)
        self.dt_bias = param(h)
        self.d_skip = param(h)
        self.norm_scale = param(di)
        self.out_proj = param(di, d, dtype=pdt)
        set_axes(self, in_proj=("embed", "ssm_inner"),
                 conv_w=("ssm_inner", None), a_log=("ssm_heads",),
                 dt_bias=("ssm_heads",), d_skip=("ssm_heads",),
                 norm_scale=("ssm_inner",), out_proj=("ssm_inner", "embed"))

    def reset_parameters(self, generator: torch.Generator) -> None:
        """lecun, normal × 0.3, zeros, zeros, ones, ones, lecun."""
        lecun_normal_(self.in_proj, generator)
        v = draw_buffer(self.conv_w.shape, generator)
        nn.init.normal_(v, 0.0, 1.0, generator=generator)
        with torch.no_grad():
            self.conv_w.copy_(0.3 * v)
        nn.init.zeros_(self.a_log)
        nn.init.zeros_(self.dt_bias)
        nn.init.ones_(self.d_skip)
        nn.init.ones_(self.norm_scale)
        lecun_normal_(self.out_proj, generator)


def _split_proj(cfg: ArchConfig, proj):
    di, h, g, s, _ = _dims(cfg)
    return torch.split(proj, [di, di + 2 * g * s, h], dim=-1)


def _softplus(x):
    """log(1 + e^x) as JAX's ``softplus`` (``logaddexp(x, 0)``), with no
    switch to the identity above a threshold as ``F.softplus`` has."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def _gated_norm(scale, x, z, eps):
    dtp = x.dtype
    x = x.float() * F.silu(z.float())
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps) * scale).to(dtp)


def mamba_apply(params: Mamba, cfg: ArchConfig, x):
    """x: (b, n, d) -> (b, n, d)."""
    b, n, d = x.shape
    di, h, g, s, conv_dim = _dims(cfg)
    p = cfg.ssm_head_dim

    proj = x @ params.in_proj.to(x.dtype)
    z, xbc, dt = _split_proj(cfg, proj)
    # the kernels read raw memory: a contiguous copy of the split
    xbc = ops.short_conv(xbc.contiguous(), params.conv_w.to(x.dtype),
                         causal=True)
    xbc = F.silu(xbc)
    xs, bmat, cmat = torch.split(xbc, [di, g * s, g * s], dim=-1)

    xs = xs.reshape(b, n, h, p).contiguous()
    bmat = bmat.reshape(b, n, g, s).contiguous()
    cmat = cmat.reshape(b, n, g, s).contiguous()
    dt_full = _softplus(dt.float() + params.dt_bias[None, None, :])
    a = -torch.exp(params.a_log)
    y = ops.ssd_scan(xs, dt_full.contiguous(), a, bmat, cmat, params.d_skip,
                     chunk=cfg.ssd_chunk)
    y = y.reshape(b, n, di)
    y = _gated_norm(params.norm_scale, y, z, cfg.norm_eps)
    return y @ params.out_proj.to(x.dtype)


# ---------------------------------------------------------------- decode
def mamba_cache_init(cfg: ArchConfig, batch: int, dtype, device) -> dict:
    """{"conv": (batch, cw - 1, conv_dim) in the activation dtype, "state":
    (batch, h, p, s) fp32}, zeros."""
    di, h, g, s, conv_dim = _dims(cfg)
    return {
        "conv": torch.zeros(batch, cfg.conv_width - 1, conv_dim, dtype=dtype,
                            device=device),
        "state": torch.zeros(batch, h, cfg.ssm_head_dim, s,
                             dtype=torch.float32, device=device),
    }


def mamba_decode(params: Mamba, cfg: ArchConfig, x, cache: dict):
    """x: (b, 1, d). The recurrent single-token step; the cache is O(1) in
    n. Returns (y (b, 1, d), new cache)."""
    b, _, d = x.shape
    di, h, g, s, conv_dim = _dims(cfg)
    p = cfg.ssm_head_dim

    proj = x @ params.in_proj.to(x.dtype)
    z, xbc, dt = _split_proj(cfg, proj)                   # (b, 1, ·)
    window = torch.cat([cache["conv"], xbc], dim=1)       # (b, cw, conv_dim)
    w = params.conv_w.to(x.dtype)                         # f[k] = lag k
    conv_out = torch.einsum("bkc,ck->bc", window.flip(1), w)[:, None, :]
    xbc_t = F.silu(conv_out)
    xs, bmat, cmat = torch.split(xbc_t[:, 0], [di, g * s, g * s], dim=-1)
    dt_full = _softplus(dt[:, 0].float() + params.dt_bias[None, :])
    a = -torch.exp(params.a_log)
    state, y = ssd_decode_step(cache["state"], xs.reshape(b, h, p), dt_full,
                               a, bmat.reshape(b, g, s),
                               cmat.reshape(b, g, s), params.d_skip)
    y = y.reshape(b, 1, di).to(x.dtype)
    y = _gated_norm(params.norm_scale, y, z, cfg.norm_eps)
    y = y @ params.out_proj.to(x.dtype)
    return y, {"conv": window[:, 1:], "state": state}
