"""AdamW with warmup-cosine schedule, global-norm clipping, optional bf16
moments and optional int8 gradient compression with error feedback —
counterpart of ``repro/optim/adamw.py``, formula for formula.

What ``torch.optim.AdamW`` does differently, and this module does not: the
schedule is evaluated at ``count = step + 1``; eps is added outside
``sqrt(vhat)``; decoupled weight decay applies to every parameter (norm
scales and the RPE included, no parameter groups); clipping uses the global
norm over all leaves; moments may be stored in bf16 (computed in fp32).

State mirrors the parameters as dicts keyed by parameter name
(``dict(model.named_parameters())``). Unlike the JAX package, which is
functional, :func:`step` updates the parameters and the moment (and
error-feedback) tensors in place under ``torch.no_grad()`` and returns the
state with the new step count; a caller that may need the pre-step state
back (``runtime/trainer.py``'s retry) clones it first.

Sharded parameters (DTensors, ``launch/steps.StepBuilder``) keep their
moments with the same placements, and the update runs on each rank's
local shards (elementwise, so it is the whole update's restriction); the
clipping norm is taken over the whole of every gradient with one
all-reduce (:func:`global_norm`).
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.parallel.sharding import local as _local


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    min_lr_frac: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    moments_dtype: str = "float32"   # "bfloat16" halves optimizer memory
    compress_grads: bool = False     # int8 + error feedback


class OptState(NamedTuple):
    step: torch.Tensor    # () int32 on the parameters' device
    mu: dict
    nu: dict
    err: dict   # error-feedback residual (() zeros unless compress_grads)


def schedule(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup -> cosine decay to min_lr_frac·lr (fp32, on step's
    device)."""
    step = torch.as_tensor(step).float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * t))
    frac = cfg.min_lr_frac + (1.0 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def init(cfg: OptConfig, params: dict) -> OptState:
    """Zero moments like the parameters (a DTensor's with its
    placements)."""
    mdt = getattr(torch, cfg.moments_dtype)
    device = next(iter(params.values())).device
    mu = {k: torch.zeros_like(p, dtype=mdt) for k, p in params.items()}
    nu = {k: torch.zeros_like(p, dtype=mdt) for k, p in params.items()}
    err = {k: (torch.zeros_like(p, dtype=torch.float32)
               if cfg.compress_grads
               else torch.zeros((), dtype=torch.float32, device=p.device))
           for k, p in params.items()}
    return OptState(torch.zeros((), dtype=torch.int32, device=device),
                    mu, nu, err)


# -------------------------------------------------- int8 compression (EF)
def _quantize_int8(g: torch.Tensor):
    """Per-tensor symmetric int8. Returns (q, scale)."""
    amax = torch.max(torch.abs(g))
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compress_with_feedback(g: torch.Tensor, err: torch.Tensor):
    """Error-feedback int8: quantize (g + carried residual), carry the
    quantization error to the next step. Returns (dequantized, new_err)."""
    target = g.float() + err
    q, scale = _quantize_int8(target)
    deq = _dequantize(q, scale)
    return deq, target - deq


# ---------------------------------------------------------------- update
def _sq(g: torch.Tensor) -> torch.Tensor:
    """Sum of squares of ``g``'s local values; for a DTensor divided by
    the number of ranks holding each copy, so that the sum over all ranks
    counts every element of the whole gradient once."""
    sq = torch.sum(torch.square(_local(g).float()))
    if isinstance(g, DTensor):
        mesh = g.device_mesh
        if any(p.is_partial() and mesh.size(i) > 1
               for i, p in enumerate(g.placements)):
            raise ValueError(f"partial gradient {g.placements}: "
                             "redistribute it to its parameter's placements")
        copies = math.prod(mesh.size(i) for i, p in enumerate(g.placements)
                           if not p.is_shard())
        if copies > 1:
            sq = sq / copies
    return sq


def global_norm(grads: dict) -> torch.Tensor:
    """The L2 norm over every leaf of ``grads``; with DTensor leaves (their
    mesh spanning the process group) one all-reduce of the local sums."""
    sq = sum(_sq(g) for g in grads.values())
    if any(isinstance(g, DTensor) for g in grads.values()):
        dist.all_reduce(sq)
    return torch.sqrt(sq)


def _clip_scale(gnorm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(gnorm, min=1e-12), max=1.0)


def clip_by_global_norm(grads: dict, max_norm: float):
    gnorm = global_norm(grads)
    scale = _clip_scale(gnorm, max_norm)
    return {k: (g * scale).to(g.dtype) for k, g in grads.items()}, gnorm


@torch.no_grad()
def step(cfg: OptConfig, state: OptState, grads: dict, params: dict):
    """One AdamW step: updates ``params`` (and the state's moment and
    error tensors) in place. Returns (new_state, {"grad_norm", "lr"}).
    DTensor parameters take gradients with their placements."""
    if cfg.compress_grads:
        if any(isinstance(g, DTensor) for g in grads.values()):
            raise NotImplementedError(
                "compress_grads on a mesh: the int8 scale is per tensor, "
                "which a shard's own max is not")
        deq = {}
        for k, g in grads.items():
            deq[k], new_err = compress_with_feedback(g, state.err[k])
            state.err[k].copy_(new_err)
        grads = deq

    gnorm = global_norm(grads)
    scale = _clip_scale(gnorm, cfg.clip_norm)
    count = state.step + 1
    lr = schedule(cfg, count)
    b1, b2 = cfg.b1, cfg.b2
    c1 = 1.0 - b1 ** count.float()
    c2 = 1.0 - b2 ** count.float()

    for k, p in params.items():
        m, v, p = _local(state.mu[k]), _local(state.nu[k]), _local(p)
        g = _local(grads[k])
        g32 = (g * scale).to(g.dtype).float()
        m32 = b1 * m.float() + (1 - b1) * g32
        v32 = b2 * v.float() + (1 - b2) * torch.square(g32)
        mhat = m32 / c1
        vhat = v32 / c2
        delta = (mhat / (torch.sqrt(vhat) + cfg.eps)
                 + cfg.weight_decay * p.float())
        p.copy_(p.float() - lr * delta)
        m.copy_(m32)
        v.copy_(v32)
    return (OptState(count, state.mu, state.nu, state.err),
            {"grad_norm": gnorm, "lr": lr})
