"""Mixture-of-Experts FFN, counterpart of ``repro/models/moe.py`` on one
device: top-k routing with the Switch load-balancing aux loss, and two
dispatches of the routed rows through the experts' SwiGLU FFNs.

* ``capacity`` (the configs' default) — GShard's fixed expert capacity
  ``cap = max(ceil(T·k·cf / E), 4)``: each (token, k) assignment takes
  the next slot of its expert in the flattened (token, k) order, one past
  the capacity goes to a sink row and is dropped; the (E, cap, d) buffer
  gathered from the tokens (each slot names its token, an empty one a
  zero row), three batched GEMMs over (E, cap, ·), a gather with a zero
  row, and the combine Σ_k w·keep·y in the model dtype. Token counts that
  are a multiple of 8192 and larger run in 8192-token chunks, each
  recomputed in the backward (``torch.utils.checkpoint``, as
  ``jax.checkpoint``). An expert takes at most one slot a token and
  ``cap ≥ 4``, so a step of at most 4 tokens never drops; ``cf = E / k``
  gives ``cap ≥ T`` and drops nothing either.
* ``ragged`` — dropless: a stable sort of the flat expert ids, one
  ``torch.matmul`` per non-empty expert over its contiguous rows (the
  group sizes are read on the host: one sync a layer), and the weighted
  combine summed per token in (token, k) order, so two runs give the
  same bits on the card (no atomics). ``jax.lax.ragged_dot`` is an XLA
  op, not a Pallas kernel; autograd gives the ragged cotangents that
  ``ragged_matmul``'s custom VJP writes by hand, since nothing here
  densifies.

Any other ``moe_impl`` (``"ep"``) takes the capacity path, as JAX's
``_moe_local`` does without a mesh. Top-k ties go to the lower index (a
stable descending sort), as in ``jax.lax.top_k``; ``torch.topk`` promises
no order for ties on the card. The expert-parallel and sharded paths
(``_ep_moe``, ``_shard_moe``) are multi-device (ROADMAP Step 12, item
12). MoE has no pallas_call, so no hand-written kernel.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.models.config import ArchConfig
from repro_torch.nn.layers import ACTS, lecun_normal_
from repro_torch.nn.params import set_axes

#: tokens a capacity chunk holds (JAX ``_moe_local``)
CHUNK = 8192


class MoE(nn.Module):
    """JAX leaves {router (d, E) fp32, w_gate and w_up (E, d, f), w_down
    (E, f, d) in ``param_dtype``}, lecun-initialised."""

    def __init__(self, cfg: ArchConfig, device=None):
        super().__init__()
        d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
        kw = {"device": device, "dtype": getattr(torch, cfg.param_dtype)}
        self.router = nn.Parameter(torch.empty(d, e, device=device,
                                               dtype=torch.float32))
        self.w_gate = nn.Parameter(torch.empty(e, d, f, **kw))
        self.w_up = nn.Parameter(torch.empty(e, d, f, **kw))
        self.w_down = nn.Parameter(torch.empty(e, f, d, **kw))
        set_axes(self, router=("embed", "expert"),
                 w_gate=("expert", "embed", "ffn"),
                 w_up=("expert", "embed", "ffn"),
                 w_down=("expert", "ffn", "embed"))

    def reset_parameters(self, generator: torch.Generator) -> None:
        for w in (self.router, self.w_gate, self.w_up, self.w_down):
            lecun_normal_(w, generator)


def top_k(probs: torch.Tensor, k: int):
    """(values, indices) of the k largest along the last dim, ties to the
    lower index (``jax.lax.top_k``'s order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(x2d: torch.Tensor, router: torch.Tensor, k: int):
    """x2d (T, d) -> (weights (T, k) fp32, ids (T, k), aux loss). The
    logits are taken in the activation dtype and the softmax in fp32; the
    aux loss is E · Σ_e mean(p_e) · f_e, f_e the share of assignments."""
    logits = (x2d @ router.to(x2d.dtype)).float()
    probs = torch.softmax(logits, dim=-1)
    w, ids = top_k(probs, k)
    w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
    e = router.shape[-1]
    # counts by an add of ones, exact in fp32 (bincount on the card reads
    # the largest id back to the host: a sync a layer)
    flat = ids.reshape(-1)
    ce = torch.zeros(e, device=flat.device).index_add_(
        0, flat, torch.ones(flat.shape, device=flat.device))
    ce = ce / torch.clamp(ce.sum(), min=1.0)
    aux = e * torch.sum(probs.mean(0) * ce)
    return w, ids, aux


def capacity(t: int, k: int, cf: float, e: int) -> int:
    """Slots an expert has for t tokens: ceil(t·k·cf / E), at least 4."""
    return max(int(-(-t * k * cf // e)), 4)


def slot_positions(flat_ids: torch.Tensor, e: int) -> torch.Tensor:
    """Each assignment's slot in its expert: how many earlier assignments
    of the flat (token, k) order chose the same expert. The one-hot is
    laid out (E, T·k) so that its cumsum runs along the innermost dim
    (down a (T·k, E) one-hot the card scans each column alone, 6 ms a
    layer at 8 × 512 tokens)."""
    onehot = (flat_ids == torch.arange(e, device=flat_ids.device)[:, None]
              ).long()
    return torch.sum((torch.cumsum(onehot, 1) - onehot) * onehot, dim=0)


def _swiglu(x, w_gate, w_up, w_down, act):
    return torch.matmul(act(torch.matmul(x, w_gate))
                        * torch.matmul(x, w_up), w_down)


def _capacity_chunk(xc, wc, idc, w_gate, w_up, w_down, k: int, act,
                    cf: float):
    ck, d = xc.shape
    e = w_gate.shape[0]
    cap = capacity(ck, k, cf, e)
    flat_ids = idc.reshape(-1)                           # (ck·k,)
    pos = slot_positions(flat_ids, e)
    keep = pos < cap
    slot = torch.where(keep, flat_ids * cap + pos, e * cap)
    # the token each slot holds (ck: none, the zero row): the buffer is a
    # gather of JAX's scatter-add, with no (ck·k, d) copy of the repeated
    # tokens and no atomics onto the sink, where every dropped row lands
    tok = torch.full((e * cap + 1,), ck, dtype=slot.dtype, device=xc.device)
    tok = tok.index_put((slot,), torch.arange(
        ck * k, device=xc.device) // k)
    xz = torch.cat([xc, xc.new_zeros(1, d)]).to(w_gate.dtype)
    ye = _swiglu(xz[tok[:-1]].view(e, cap, d), w_gate, w_up, w_down, act)
    ye = torch.cat([ye.reshape(e * cap, d), ye.new_zeros(1, d)])
    gathered = ye[slot]                                  # (ck·k, d)
    wflat = (wc.reshape(-1) * keep).to(gathered.dtype)
    return torch.sum((gathered * wflat[:, None]).view(ck, k, d), dim=1)


def _capacity_moe(x2d, w, ids, w_gate, w_up, w_down, k: int, act,
                  cf: float):
    t = x2d.shape[0]
    nck = t // CHUNK if (t % CHUNK == 0 and t > CHUNK) else 1
    if nck == 1:
        return _capacity_chunk(x2d, w, ids, w_gate, w_up, w_down, k, act,
                               cf)
    ck = t // nck
    return torch.cat([
        checkpoint(_capacity_chunk, x2d[i:i + ck], w[i:i + ck],
                   ids[i:i + ck], w_gate, w_up, w_down, k, act, cf,
                   use_reentrant=False)
        for i in range(0, t, ck)])


def _ragged_moe(x2d, w, ids, w_gate, w_up, w_down, k: int, act):
    t, d = x2d.shape
    flat_ids = ids.reshape(-1)
    order = torch.sort(flat_ids, stable=True).indices
    xs = x2d[order // k].to(w_gate.dtype)                # (T·k, d)
    sizes = torch.bincount(flat_ids, minlength=w_gate.shape[0]).tolist()
    ys, start = [], 0
    for ex, n in enumerate(sizes):
        if n:
            ys.append(_swiglu(xs[start:start + n], w_gate[ex], w_up[ex],
                              w_down[ex], act))
        start += n
    ys = torch.cat(ys)
    # back to (token, k) order: each token sums its k rows in one place
    ys = ys[torch.argsort(order)]
    return torch.sum((ys * w.reshape(-1, 1).to(ys.dtype)).view(t, k, d),
                     dim=1)


def moe_apply(params: MoE, cfg: ArchConfig, x: torch.Tensor):
    """x (b, s, d) -> (out (b, s, d) in x's dtype, aux loss fp32)."""
    b, s, d = x.shape
    x2d = x.reshape(b * s, d)
    w, ids, aux = route(x2d, params.router, cfg.top_k)
    args = (x2d, w, ids, params.w_gate, params.w_up, params.w_down,
            cfg.top_k, ACTS[cfg.act])
    if cfg.moe_impl == "ragged":
        out = _ragged_moe(*args)
    else:
        out = _capacity_moe(*args, cfg.moe_capacity_factor)
    return out.reshape(b, s, d).to(x.dtype), aux
