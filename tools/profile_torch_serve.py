#!/usr/bin/env python3
"""Where the time goes in the PyTorch port's serving path, on one card.

    python3 tools/profile_torch_serve.py [--out profile_serve.json]

Builds the full-width fd-tnn-lm-wt103 (random weights, seed 0) at the
``chip_smoke.py`` workload (8 prompts x 448 tokens, 64 new, max_len 512),
warms up, then traces three regions with ``torch.profiler``:

* ``prefill``: one ``serving.prefill`` of the 8 x 448 prompts;
* ``chunk``: ``init_cache`` plus the 7 chunked-prefill blocks of C = 64;
* ``decode``: 16 lockstep ``decode_step`` calls (positions 448..463, no
  block boundary among them).

For each region it prints the host wall time (ending in a synchronise),
the device busy time (union of the traced kernels' intervals), the idle
share, the kernel launch count, the top kernels by device time and the
device time of the repository's own kernels. Needs a CUDA card; exits
non-zero without one.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def _busy_us(events) -> float:
    """Union of the device intervals (µs)."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy


#: the repository's own CUDA kernels (csrc/*.cu), by the prefix of their
#: function names (the dense pass 2 of ``ski_fused_pass2`` is
#: ``ski_dense_pass2_kernel``, the large-rank ones ``ski_window_pass2_kernel``;
#: ``tap_grad_reduce`` is the second kernel of conv_tap_grad before PR 23)
PORT_KERNELS = ("hilbert_window", "fd_mul", "fd_khat_grad", "interp_reduce",
                "interp_expand", "ski_dense_pass2", "ski_window_pass2",
                "short_conv", "gram_grad", "conv_tap_grad", "tap_grad_reduce",
                "ssd_scan")


def trace(name: str, fn, top: int = 12) -> dict:
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = _busy_us(dev)
    by_name: dict[str, list] = {}
    for e in dev:
        acc = by_name.setdefault(e.name, [0, 0.0])
        acc[0] += 1
        acc[1] += e.time_range.end - e.time_range.start
    kernels = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]
    out = {"region": name, "wall_ms": wall_us / 1e3,
           "device_busy_ms": busy / 1e3,
           "idle_share": 1.0 - busy / wall_us if wall_us else None,
           "device_events": len(dev),
           "top": [{"kernel": k[:120], "calls": c, "ms": t / 1e3,
                    "share_of_busy": t / busy if busy else None}
                   for k, (c, t) in kernels]}
    port = {}
    for k, (c, t) in by_name.items():
        for prefix in PORT_KERNELS:
            if f"{prefix}_" in k:
                acc = port.setdefault(prefix, {"calls": 0, "ms": 0.0})
                acc["calls"] += c
                acc["ms"] += t / 1e3
    out["port_kernels"] = port
    print(f"[{name}] wall {out['wall_ms']:.3f} ms, device busy "
          f"{out['device_busy_ms']:.3f} ms, idle share "
          f"{out['idle_share']:.3f}, {len(dev)} device events")
    for row in out["top"]:
        print(f"    {row['ms']:9.3f} ms {row['calls']:5d}x "
              f"{row['share_of_busy']:6.1%}  {row['kernel']}")
    if port:
        print("    port kernels: " + "; ".join(
            f"{k} {v['ms']:.3f} ms x{v['calls']}" for k, v in port.items()))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None, help="write the regions as JSON")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_torch_serve: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import generate
    from repro_torch.models import serving
    from repro_torch.models.transformer import init_model
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config("fd-tnn-lm-wt103")
    b, p, gen = 8, 448, 64
    max_len = p + gen
    model = init_model(cfg, torch.Generator().manual_seed(0), device="cuda")
    prompt = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (b, p))).cuda()
    state = {}

    def chunk():
        cache = serving.init_cache(cfg, b, max_len, params=model)
        c = serving.stream_block_of(cache)
        for pos in range(0, p, c):
            logits, cache = serving.decode_chunk(
                model, cfg, prompt[:, pos:pos + c], cache, pos)
        state["cache"], state["logits"] = cache, logits

    def decode():
        cache, logits = state["cache"], state["logits"]
        for pos in range(p, p + 16):
            tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
            logits, cache = serving.decode_step(model, cfg, tok, cache, pos)

    with torch.inference_mode():
        serving.prefill(model, cfg, prompt)               # warm-up
        generate(model, cfg, prompt, 2, max_len=max_len)
        chunk()
        decode()
        regions = [trace("prefill", lambda: serving.prefill(model, cfg,
                                                            prompt)),
                   trace("chunk", chunk), trace("decode", decode)]
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(
            {"device": torch.cuda.get_device_name(0), "regions": regions},
            indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
