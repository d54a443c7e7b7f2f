"""Serving launcher: chunked prefill + greedy or sampled decode loop,
counterpart of ``repro/launch/serve.py``.

``python -m repro_torch.launch.serve --arch fd-tnn-lm-wt103`` serves a
randomly initialised full-width model on the card; so do ``--arch
tnn-lm-wt103`` (the baseline), ``mamba2-2.7b``, the attention decoders
``gemma3-4b``, ``stablelm-3b``, ``phi3-medium-14b`` and ``qwen2-72b``,
the MoE decoders ``granite-moe-3b-a800m`` and ``grok-1-314b``, and the
hybrid ``jamba-1.5-large-398b`` (Mamba layers with dense and MoE FFNs,
Mamba and KV caches in one model), the encoder-decoder ``whisper-medium``
(stub encoder frames drawn from ``--seed``, encoded once, and every
decode step's cross-attention over them) and the prefix-VLM
``paligemma-3b`` (the text alone, as JAX's decode sees it)
(``qwen2-72b`` holds 144 GB in bf16,
``grok-1-314b`` 632 GB and ``jamba-1.5-large-398b`` 797 GB, more than
one card: serve them with ``--smoke``). ``--smoke --device cpu`` runs the CPU smoke size with the
plain kernels. The baseline decodes through the hist-replay cache, as FD
does under ``REPRO_FD_STREAM=0``; attention layers through their KV cache.
``--mixer fd|tno`` puts a paper mixer in place of an attention arch's
attention and local mixers, never a Mamba layer (jamba keeps its Mamba
layers; ``--mixer ski`` builds, but SKI has no decode, as in JAX); the
JAX launcher has no such flag, its trainer has.
``--engine`` serves ``--batch`` requests through the continuous-batching
engine's supervised scheduler
(``repro_torch.serving_engine``: ``--slots`` decode slots, ``--chaos
SEED`` seeded fault injection, ``--deadline``, ``--queue-cap``,
``--trace-file`` request spans); ``--metrics-file`` dumps the metrics
registry on exit. The flags, their refusals and the ``[serve]
engine(...)`` line are the JAX launcher's; its ``--production-mesh`` is
not ported.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.models import sampling, serving
from repro_torch.models.transformer import init_model
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import tracing as obs_tracing


def generate(params, cfg, prompt: torch.Tensor, gen_len: int, *,
             temperature: float = 0.0, seed: int = 0,
             chunked_prefill: bool | None = None,
             max_len: int | None = None, enc_out=None) -> torch.Tensor:
    """prompt: (b, p) int64 on the parameters' device. Greedy (temperature
    0) or sampled decode of gen_len tokens; returns (b, p + gen_len).
    ``enc_out`` (an encdec model's ``serving.encode`` output, b rows) goes
    to every decode step. (JAX's ``generate`` passes none, so its encdec
    decode runs the cross sublayer as self-attention; the port's
    ``decode_step`` refuses an encdec step without it.)

    Sampling draws through ``models/sampling.sample`` (top_k 0): row i's
    stream is keyed by ``seed + i`` and its k-th new token is draw k, so
    a batch-1 prompt with seed s draws what the engine draws for that
    request with seed s. The port's bits are its own: JAX's
    ``jax.random.categorical`` stream cannot be reproduced.

    Prefill: an all-FD model with streaming caches takes the prompt in
    whole C-token blocks through the overlap-save machinery
    (``serving.decode_chunk``); the remainder, and the whole prompt of an
    attention, hist-replay or Mamba model, is teacher-forced token by
    token, as in the JAX package. ``None`` auto-detects; False forces
    token-by-token. ``max_len`` sizes the decode cache (default exactly
    p + gen_len); the FD kernel is realised on the rfft grid of that
    length and the baseline's RPE at t / max_len, so token parity with
    another run needs the same ``max_len``.
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
        logits, cache = serving.decode_step(params, cfg, tok, cache, pos,
                                            enc_out)
        pos += 1
    if gen_len > 0:
        out.append(pick(logits))
    return torch.cat(out, dim=1)


def enc_frames(cfg, batch: int, seed: int, max_len: int,
               device) -> torch.Tensor:
    """Stub source frames of an encdec model (its audio frontend is a stub,
    as in JAX): (batch, min(max_len, 4096), d) standard normals drawn from
    ``seed`` with numpy, in ``cfg.dtype``. The length is JAX's rule for
    the decode's ``enc_out`` (``StepBuilder.input_specs``)."""
    frames = np.random.default_rng(seed).standard_normal(
        (batch, min(max_len, 4096), cfg.d_model), dtype=np.float32)
    return torch.from_numpy(frames).to(device=device,
                                       dtype=getattr(torch, cfg.dtype))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-len", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="0 = greedy decode (the default); > 0 samples, "
                         "seeded by --seed — both modes work solo and with "
                         "--engine (per-slot lanes)")
    ap.add_argument("--top-k", type=int, default=0,
                    help="engine mode: truncate sampling to the k most "
                         "likely tokens (0 = full distribution; requires "
                         "--temperature > 0)")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--mixer", default="",
                    choices=["", "tno", "ski", "fd"],
                    help="override the token mixer with a paper variant")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--engine", action="store_true",
                    help="continuous-batching engine: --batch requests "
                         "through S decode slots (repro_torch.serving_engine)")
    ap.add_argument("--slots", type=int, default=None,
                    help="engine decode slots (default REPRO_ENGINE_SLOTS)")
    ap.add_argument("--chaos", type=int, default=None, metavar="SEED",
                    help="engine mode: seeded FaultInjector chaos run "
                         "(deterministic prefill/decode/callback faults; "
                         "faulted requests end in explicit error outcomes, "
                         "the rest are unaffected)")
    ap.add_argument("--deadline", type=float, default=None, metavar="SEC",
                    help="engine mode: per-request TTL in seconds "
                         "(watchdog evicts expired slots)")
    ap.add_argument("--queue-cap", type=int, default=None,
                    help="engine mode: bounded request queue "
                         "(admission rejects with QueueFull when full)")
    ap.add_argument("--metrics-file", default=None, metavar="PATH",
                    help="dump the obs metrics registry on exit "
                         "(.json = JSON dump, anything else = Prometheus "
                         "text exposition); also installs the registry as "
                         "the process default")
    ap.add_argument("--trace-file", default=None, metavar="PATH",
                    help="engine mode: stream request span events to PATH "
                         "as JSONL and write a Chrome trace_event export "
                         "(PATH + '.chrome.json', Perfetto-loadable) on "
                         "exit")
    args = ap.parse_args(argv)
    if not args.engine and (args.chaos is not None
                            or args.deadline is not None
                            or args.queue_cap is not None):
        ap.error("--chaos/--deadline/--queue-cap require --engine "
                 "(the supervised scheduler owns those knobs)")
    if args.trace_file is not None and not args.engine:
        ap.error("--trace-file requires --engine (request spans are "
                 "emitted by the supervised scheduler)")
    if args.temperature < 0:
        ap.error(f"--temperature {args.temperature} must be >= 0")
    if args.top_k < 0:
        ap.error(f"--top-k {args.top_k} must be >= 0")
    if args.top_k > 0 and args.temperature <= 0:
        # greedy decode ignores top-k; a silently inert knob is worse
        # than a loud one
        ap.error("--top-k requires --temperature > 0 "
                 "(greedy decode never consults it)")
    if args.top_k > 0 and not args.engine:
        ap.error("--top-k requires --engine (the solo path samples the "
                 "full distribution)")

    reg = None
    if args.metrics_file is not None:
        reg = obs_metrics.Registry()
        # process default too: an engine built without an explicit
        # registry reports into the same dump
        obs_metrics.set_default_registry(reg)
    tracer = (obs_tracing.Tracer(args.trace_file)
              if args.trace_file is not None else None)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = reduce_for_smoke(cfg)
    if args.mixer:
        cfg = dataclasses.replace(cfg, mixer_override=args.mixer)
    device = torch.device(args.device)
    params = init_model(cfg, torch.Generator().manual_seed(args.seed),
                        device=device)
    rng = np.random.default_rng(args.seed)
    prompt_np = rng.integers(0, cfg.vocab, (args.batch, args.prompt_len))
    if args.engine:
        return _serve_engine(args, cfg, params, prompt_np, reg, tracer)
    prompt = torch.from_numpy(prompt_np).to(device)
    with torch.inference_mode():
        t0 = time.perf_counter()
        enc_out = None
        if cfg.kind == "encdec":
            enc_out = serving.encode(params, cfg,
                                     enc_frames(cfg, args.batch, args.seed,
                                                args.prompt_len
                                                + args.gen_len, device))
        toks = generate(params, cfg, prompt, args.gen_len,
                        temperature=args.temperature, seed=args.seed,
                        enc_out=enc_out)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        dt = time.perf_counter() - t0
    n_new = args.batch * args.gen_len
    print(f"[serve] {cfg.name} on {device}: generated {n_new} tokens in "
          f"{dt:.2f}s ({n_new / dt:.1f} tok/s); sample row: "
          f"{toks[0, :16].tolist()}")
    _dump_metrics(reg, args.metrics_file)
    return 0


def _serve_engine(args, cfg, params, prompt_np, reg, tracer) -> int:
    """``--engine``: every prompt row as one request through the
    supervised scheduler; prints the JAX launcher's ``[serve]
    engine(...)`` line (and the chaos line under ``--chaos``)."""
    from repro_torch.serving_engine import (Engine, FaultInjector, Request,
                                            Scheduler)
    eng = Engine(cfg, params, slots=args.slots,
                 max_len=args.prompt_len + args.gen_len,
                 temperature=args.temperature, top_k=args.top_k)
    injector = None
    if args.chaos is not None:
        injector = FaultInjector(seed=args.chaos, rates={
            "prefill": 0.15, "decode": 0.02, "callback": 0.1})
    sched = Scheduler(eng, injector=injector,
                      default_deadline=args.deadline,
                      queue_cap=args.queue_cap,
                      metrics=reg, tracer=tracer,
                      log=print if args.chaos is not None else None)
    for i in range(args.batch):
        sched.submit(Request(uid=f"req{i}", prompt=prompt_np[i],
                             max_new=args.gen_len, seed=args.seed + i))
    t0 = time.perf_counter()
    results, _ = sched.run()
    dt = time.perf_counter() - t0
    n_new = sum(len(v) for v in results.values())
    by_status = {}
    for out in sched.outcomes.values():
        by_status[out.status] = by_status.get(out.status, 0) + 1
    ok_uid = next((u for u, o in sched.outcomes.items()
                   if o.status == "ok"), None)
    mode = ("greedy" if args.temperature == 0 else
            f"T={args.temperature}"
            + (f"/top{args.top_k}" if args.top_k else ""))
    print(f"[serve] engine({eng.slots} slots, {mode}) generated "
          f"{n_new} tokens in {dt:.2f}s ({n_new / dt:.1f} tok/s); "
          f"steps={sched.steps} prefills={sched.prefills} "
          f"(packed={sched.packed_prefills}) "
          f"retries={sched.retries}; outcomes={by_status}; "
          f"sample: "
          f"{results[ok_uid][:16] if ok_uid else '(none ok)'}")
    if injector is not None:
        print(f"[serve] chaos(seed={args.chaos}): "
              f"{injector.fired} faults fired; log={injector.log}")
    if tracer is not None:
        tracer.close()
        chrome = args.trace_file + ".chrome.json"
        obs_tracing.write_chrome(tracer.events, chrome)
        print(f"[serve] trace: {args.trace_file} (JSONL), "
              f"{chrome} (Perfetto)")
    _dump_metrics(reg, args.metrics_file)
    return 0


def _dump_metrics(reg, path):
    if reg is None or path is None:
        return
    if path.endswith(".json"):
        reg.dump_json(path)
    else:
        reg.dump_prometheus(path)
    print(f"[serve] metrics: {path}")


if __name__ == "__main__":
    raise SystemExit(main())
