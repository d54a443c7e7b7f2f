"""Mamba-2 SSD by the chunked (state-space dual) algorithm in plain torch,
counterpart of ``repro/kernels/ssd_chunked.py``.

Within a chunk of q positions the recurrence is a masked, decay-weighted
quadratic form; across chunks a short loop carries the (h, p, s) state.
:func:`ssd_scan_chunked` is the plain version beside the CUDA kernel of
``kernels/ssd_scan.py`` (the CPU path of ``ops.ssd_scan``, as the JAX
``ops.ssd_scan`` takes it when Pallas is off) and
:func:`ssd_decode_step` the serving recurrence. The JAX function's
``hshard`` (head-axis sharding of the chunk states) has no counterpart
on one card.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def ssd_scan_chunked(x, dt, a, b, c, d_skip, *, chunk: int = 64):
    """Shapes as ``ref.ssd_scan_ref``: x (bt, n, h, p), dt (bt, n, h),
    a (h,), b/c (bt, n, g, s), d_skip (h,) → y (bt, n, h, p) in x's
    dtype. A ragged tail is zero-padded to a whole chunk (dt = 0 there:
    no decay, no input) and cut off again."""
    bt, n, h, p = x.shape
    g, s = b.shape[2], b.shape[3]
    q = min(chunk, n)
    pad = (-n) % q
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        b = F.pad(b, (0, 0, 0, 0, 0, pad))
        c = F.pad(c, (0, 0, 0, 0, 0, pad))
    nc = x.shape[1] // q
    f32 = torch.float32
    xq = x.reshape(bt, nc, q, h, p).to(f32)
    dtq = dt.reshape(bt, nc, q, h).to(f32)
    bq = b.reshape(bt, nc, q, g, s).to(f32)
    cq = c.reshape(bt, nc, q, g, s).to(f32)
    hpg = h // g

    loga = dtq * a[None, None, None, :]                   # (bt,nc,q,h) <= 0
    cum = torch.cumsum(loga, dim=2)                       # inclusive
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]   # (bt,nc,qi,qj,h)
    tri = torch.tril(torch.ones(q, q, dtype=torch.bool, device=x.device))
    # masked before the exp: seg > 0 above the diagonal may overflow
    l_mat = torch.exp(torch.where(tri[None, None, :, :, None], seg,
                                  float("-inf")))

    # intra-chunk: scores[i, j] = (C_i . B_j) * L[i, j] * dt[j]
    cb = torch.einsum("bnigs,bnjgs->bnijg", cq, bq)       # (bt,nc,q,q,g)
    cb = cb.repeat_interleave(hpg, dim=4)                 # -> h
    scores = cb * l_mat * dtq[:, :, None, :, :]
    y_intra = torch.einsum("bnijh,bnjhp->bnihp", scores, xq)

    # chunk-final states: S_k = sum_j exp(cum_last - cum_j) dt_j B_j (x) x_j
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)     # (bt,nc,q,h)
    bj = bq.repeat_interleave(hpg, dim=3)                 # (bt,nc,q,h,s)
    w = decay_to_end * dtq
    s_chunk = torch.einsum("bnjhs,bnjhp->bnhps", w[..., None] * bj, xq)

    # inter-chunk recurrence; prev[k] is the state before chunk k
    chunk_decay = torch.exp(cum[:, :, -1, :])             # (bt,nc,h)
    carry = torch.zeros(bt, h, p, s, dtype=f32, device=x.device)
    prev = []
    for k in range(nc):
        prev.append(carry)
        carry = carry * chunk_decay[:, k, :, None, None] + s_chunk[:, k]
    prev = torch.stack(prev, dim=1)                       # (bt,nc,h,p,s)

    # inter contribution: C_i . (prev_state * exp(cum_i))
    cj = cq.repeat_interleave(hpg, dim=3)                 # (bt,nc,q,h,s)
    y_inter = torch.einsum("bnihs,bnhps->bnihp", cj, prev) * torch.exp(
        cum)[..., None]

    y = (y_intra + y_inter).reshape(bt, nc * q, h, p)[:, :n]
    y = y + x.reshape(bt, nc * q, h, p)[:, :n].to(f32) * d_skip[
        None, None, :, None]
    return y.to(x.dtype)


def ssd_decode_step(state, x_t, dt_t, a, b_t, c_t, d_skip):
    """One token of the recurrence, for serving. state (bt, h, p, s) fp32;
    x_t (bt, h, p); dt_t (bt, h); b_t/c_t (bt, g, s). Returns
    (new_state, y_t (bt, h, p)) in the promoted type of the state and the
    inputs (fp32 for bf16 inputs, as JAX promotes them)."""
    wt = torch.promote_types(state.dtype, x_t.dtype)
    x_t, dt_t, a, d_skip = (t.to(wt) for t in (x_t, dt_t, a, d_skip))
    hpg = x_t.shape[1] // b_t.shape[1]
    bx = b_t.to(wt).repeat_interleave(hpg, dim=1)         # (bt, h, s)
    cx = c_t.to(wt).repeat_interleave(hpg, dim=1)
    da = torch.exp(dt_t * a[None, :])                     # (bt, h)
    new = state * da[..., None, None] + (
        (dt_t[..., None] * x_t)[..., :, None] * bx[..., None, :])
    y = torch.einsum("bhps,bhs->bhp", new, cx) + x_t * d_skip[None, :, None]
    return new, y
