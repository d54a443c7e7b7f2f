"""Seeded temperature / top-k sampling for decode, shared by the solo
``launch/serve.generate`` and the continuous-batching engine.

The JAX package draws with ``jax.random.categorical``, whose bits torch
cannot reproduce, so the port has its own sampler with the same
distribution: Gumbel-max, ``argmax(logits / T + g)`` with ``g = -log(-log
u)``, which picks token v with probability softmax(logits / T)[v]. The
uniforms come from a counter-based hash of (row key, draw counter, token
id) computed with int64 tensor ops on the logits' device: no generator
state, no host loop over the vocabulary, and the same bits on the CPU and
the card. A row's key derives from its request seed alone (:func:`seed_key`)
and its counter counts that request's draws, so a stream depends only on
(params, prompt, seed, temperature, top_k), never on the row it runs in.
"""
from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF


def _mix32(x):
    """A bijective 32-bit integer mix (xorshift-multiply rounds). Works
    on Python ints and on int64 tensors holding values in [0, 2^32): each
    multiplier is below 2^31, so no product leaves int64."""
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x1B873593) & _M32
    return x ^ (x >> 16)


def seed_key(seed: int) -> int:
    """The sampling key of a request seed (any Python int)."""
    return _mix32((int(seed) & _M32) ^ 0x9E3779B9)


def uniforms(keys: torch.Tensor, counters: torch.Tensor,
             n: int) -> torch.Tensor:
    """(b, n) float32 uniforms in (0, 1) for draw ``counters[i]`` of key
    ``keys[i]`` over token ids 0..n-1: 23 hash bits, centred (with 24 the
    top value would round to 1.0 in fp32)."""
    row = _mix32(keys ^ _mix32((counters + 0x632BE5AB) & _M32))     # (b,)
    v = torch.arange(n, dtype=torch.long, device=keys.device)
    h = _mix32(_mix32((row[:, None] + v * 0x9E3779B9) & _M32))      # (b, n)
    return ((h >> 9).float() + 0.5) * 2.0 ** -23


def sample(logits: torch.Tensor, keys: torch.Tensor, counters: torch.Tensor,
           *, temperature: float, top_k: int, vocab: int) -> torch.Tensor:
    """One token per row from ``logits`` (b, V_pad): softmax(logits / T)
    over the ``vocab`` real ids (the padding masked), truncated to the
    ``top_k`` largest when 0 < top_k < vocab (ties with the k-th kept, as
    the JAX engine's ``_sample_last``). ``keys``/``counters`` (b,) int64
    select each row's uniforms. Returns (b,) int64."""
    x = logits.float() / temperature
    ids = torch.arange(x.shape[-1], device=x.device)
    x = torch.where(ids < vocab, x, -torch.inf)
    if 0 < top_k < vocab:
        kth = torch.topk(x, top_k, dim=-1).values[..., -1:]
        x = torch.where(x >= kth, x, -torch.inf)
    g = -torch.log(-torch.log(uniforms(keys, counters, x.shape[-1])))
    return torch.argmax(x + g, dim=-1)
