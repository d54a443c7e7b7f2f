"""Serving launcher: chunked prefill + greedy or sampled decode loop,
counterpart of ``repro/launch/serve.py`` (solo path; the
continuous-batching engine is ``repro_torch.serving_engine``, and the
``--engine`` front end that drives it through a scheduler is a later
slice).

``python -m repro_torch.launch.serve --arch fd-tnn-lm-wt103`` (or
``--arch mamba2-2.7b``) serves a randomly initialised full-width model on
the card; ``--smoke --device cpu`` runs the CPU smoke size with the plain
kernels.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.models import sampling, serving
from repro_torch.models.transformer import init_model


def generate(params, cfg, prompt: torch.Tensor, gen_len: int, *,
             temperature: float = 0.0, seed: int = 0,
             chunked_prefill: bool | None = None,
             max_len: int | None = None) -> torch.Tensor:
    """prompt: (b, p) int64 on the parameters' device. Greedy (temperature
    0) or sampled decode of gen_len tokens; returns (b, p + gen_len).

    Sampling draws through ``models/sampling.sample`` (top_k 0): row i's
    stream is keyed by ``seed + i`` and its k-th new token is draw k, so
    a batch-1 prompt with seed s draws what the engine draws for that
    request with seed s. The port's bits are its own: JAX's
    ``jax.random.categorical`` stream cannot be reproduced.

    Prefill: an all-FD model takes the prompt in whole C-token blocks
    through the overlap-save machinery (``serving.decode_chunk``); the
    remainder, and a Mamba model's whole prompt, is teacher-forced token
    by token, as in the JAX package. ``None`` auto-detects; False forces
    token-by-token. ``max_len`` sizes the decode cache (default exactly
    p + gen_len); the FD kernel is realised on the rfft grid of that
    length, so token parity with another run needs the same ``max_len``.
    Call under ``torch.inference_mode()`` on the card (the FD op and the
    SSD kernel are forward-only there)."""
    if temperature < 0:
        raise ValueError(f"temperature={temperature} must be >= 0")
    b, p = prompt.shape
    if max_len is None:
        max_len = p + gen_len
    elif max_len < p + gen_len:
        raise ValueError(f"max_len={max_len} < prompt {p} + gen {gen_len}")
    cache = serving.init_cache(cfg, b, max_len, params=params)
    out = [prompt]

    if temperature > 0:
        keys = torch.tensor([sampling.seed_key(seed + i) for i in range(b)],
                            device=prompt.device)
    draws = 0

    def pick(logits):
        nonlocal draws
        if temperature > 0:
            counters = torch.full_like(keys, draws)
            draws += 1
            nxt = sampling.sample(logits[:, -1], keys, counters,
                                  temperature=temperature, top_k=0,
                                  vocab=cfg.vocab)
        else:
            # argmax over the padded vocab, clamped to a real token id
            nxt = torch.clamp(torch.argmax(logits[:, -1], dim=-1),
                              max=cfg.vocab - 1)
        return nxt[:, None].to(prompt.dtype)

    pos = 0
    logits = None
    supported = serving.supports_chunked_prefill(cfg, cache)
    if chunked_prefill and not supported:
        raise ValueError(
            "chunked_prefill=True but the arch/cache does not support it "
            f"(arch {cfg.name}: all mixers must be streaming fd layers)")
    if chunked_prefill is None:
        chunked_prefill = supported
    if chunked_prefill:
        c = serving.stream_block_of(cache)
        while pos + c <= p:                       # whole prompt blocks
            logits, cache = serving.decode_chunk(
                params, cfg, prompt[:, pos:pos + c], cache, pos)
            pos += c
    end = p + gen_len
    while pos < end - 1:
        if pos < p:
            tok = prompt[:, pos:pos + 1]          # teacher-forced prefill
        else:
            tok = pick(logits)
            out.append(tok)
        logits, cache = serving.decode_step(params, cfg, tok, cache, pos)
        pos += 1
    if gen_len > 0:
        out.append(pick(logits))
    return torch.cat(out, dim=1)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-len", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="0 = greedy decode (the default); > 0 samples, "
                         "seeded by --seed")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = reduce_for_smoke(cfg)
    device = torch.device(args.device)
    params = init_model(cfg, torch.Generator().manual_seed(args.seed),
                        device=device)
    rng = np.random.default_rng(args.seed)
    prompt = torch.from_numpy(
        rng.integers(0, cfg.vocab, (args.batch, args.prompt_len))).to(device)
    with torch.inference_mode():
        t0 = time.perf_counter()
        toks = generate(params, cfg, prompt, args.gen_len,
                        temperature=args.temperature, seed=args.seed)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        dt = time.perf_counter() - t0
    n_new = args.batch * args.gen_len
    print(f"[serve] {cfg.name} on {device}: generated {n_new} tokens in "
          f"{dt:.2f}s ({n_new / dt:.1f} tok/s); sample row: "
          f"{toks[0, :16].tolist()}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
