#!/usr/bin/env python3
"""Drive the PyTorch port's serving path on one NVIDIA card and check it.

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` and ``nvidia-smi``; exits non-zero without a
card or outside a checkout of this repository. Phases, one line each:

1. device: the card's name and power limit (nvidia-smi), torch and CUDA
   versions; TF32 is switched off for matmuls and cuDNN;
2. build: compile the CUDA kernels from ``src/repro_torch/kernels/csrc``;
3. kernels: each kernel against its plain torch version on the card, at
   the serving shapes and one ragged shape, and its time (CUDA events,
   median of 50 runs, L2 evicted before each) beside the plain version's,
   one PyTorch library call's, and the bound (bytes or operations over the
   card's published peak rate); each wrapper refuses an input that
   requires grad;
4. serve: the full-width fd-tnn-lm-wt103 (6 layers, d=512, vocab 50265,
   fp32, random weights from seed 0) scores 8 prompts of 448 tokens with
   ``prefill`` and greedily generates 64 tokens each (max_len 512) with
   ``generate``; the kernels' launch counts are read from this phase;
5. check: the kernel-path forward over the generated sequences reproduces
   every decoded token whose top-2 logit margin exceeds 1e-3, and the
   smoke-size model gives the same logits on the card as on the CPU;
6. a JSON line with each kernel's numbers, then the card's name and power
   limit, then ``{"ok": true, "device": ...}`` as the last line.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

#: NVIDIA data-sheet peaks (bytes/s of device memory, dense fp32 FLOP/s
#: outside the tensor cores), by the name nvidia-smi reports; "H100" alone
#: is the SXM part.
PEAKS = {"H100 PCIe": (2.0e12, 51e12), "H100 NVL": (3.9e12, 60e12),
         "H100": (3.35e12, 67e12)}
PROMPTS, PROMPT_LEN, GEN_LEN = 8, 448, 64
MARGIN = 1e-3


def _peaks(name: str):
    for key, val in PEAKS.items():
        if key in name:
            return key, val
    raise RuntimeError(f"no published peaks for {name!r}")


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def time_ms(fn, reps: int = 50) -> float:
    """Median device time of ``fn`` over ``reps`` runs, with the 50 MB L2
    evicted before each run (inputs come from device memory, as the
    bound assumes). The eviction reads a 256 MB buffer, so L2 holds clean
    lines afterwards and the timed call pays no write-back for it."""
    flush = torch.ones(64 << 20, dtype=torch.float32, device="cuda")
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        flush.sum()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# ------------------------------------------------------------- phase 1-2
def phase_device() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(smi)
    print(f"[device] {torch.cuda.get_device_name(0)} x"
          f"{torch.cuda.device_count()}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}; allow_tf32 matmul="
          f"{torch.backends.cuda.matmul.allow_tf32} cudnn="
          f"{torch.backends.cudnn.allow_tf32}", flush=True)
    return smi


def phase_build() -> None:
    from repro_torch.kernels import backend
    t0 = time.perf_counter()
    path = backend.build()
    print(f"[build] {path.name} built in {time.perf_counter() - t0:.2f} s",
          flush=True)


# --------------------------------------------------------------- phase 3
def _kernel_entry(name, replaces, got, want, fn, plain, library, nbytes,
                  nops, peaks):
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    if not err <= 1e-6 * scale:
        raise AssertionError(f"{name}: max abs err {err} > 1e-6 x {scale}")
    bw, flops = peaks
    t_bytes, t_ops = nbytes / bw * 1e3, nops / flops * 1e3
    return {"name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/fd_fused.cu",
            "replaces": replaces, "max_abs_err": err,
            "ms": time_ms(fn), "plain_ms": time_ms(plain),
            "library_ms": time_ms(library),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def phase_kernels(peaks) -> dict:
    from repro_torch.kernels import fd_fused, ref
    g = torch.Generator(device="cuda").manual_seed(0)
    out = {}
    # hilbert_window at the serving shape (d=512, n=512) and a ragged one.
    # The function reads lags 0..n (the rest are zero whatever kt holds)
    # and writes all 2n: 4·d(n+1) + 4·2dn bytes, d(n+1) multiplies.
    for d, n in ((512, 512), (37, 45)):          # odd n: scalar path
        kt = torch.randn(d, 2 * n, device="cuda", generator=g)
        w = ref.hilbert_window_ref(torch.ones(1, 2 * n, device="cuda"), n)[0]
        e = _kernel_entry(
            "hilbert_window", "src/repro/kernels/fd_fused.py:80",
            fd_fused.hilbert_window(kt, n), ref.hilbert_window_ref(kt, n),
            lambda: fd_fused.hilbert_window(kt, n),
            lambda: ref.hilbert_window_ref(kt, n), lambda: kt * w,
            nbytes=4 * d * (n + 1) + 4 * kt.numel(), nops=d * (n + 1),
            peaks=peaks)
        print(f"[kernel] hilbert_window kt ({d}, {2 * n}): {e}", flush=True)
        out.setdefault("hilbert_window", e)
    # fd_mul at the serving shape: 8 rows of the channel-major (d, n+1)
    # spectrum, d=512, n=512; and a ragged one
    for b, d, f in ((8, 512, 513), (3, 37, 45)):  # odd row: scalar path
        x = torch.randn(b, d, f, dtype=torch.complex64, device="cuda",
                        generator=g)
        k = torch.randn(d, f, dtype=torch.complex64, device="cuda",
                        generator=g)
        got, want = fd_fused.fd_mul(x, k), ref.fd_mul_ref(x, k)
        e = _kernel_entry(
            "fd_mul", "src/repro/kernels/fd_fused.py:162",
            torch.view_as_real(got), torch.view_as_real(want),
            lambda: fd_fused.fd_mul(x, k), lambda: ref.fd_mul_ref(x, k),
            lambda: torch.mul(x, k),
            nbytes=8 * (2 * x.numel() + k.numel()), nops=6 * x.numel(),
            peaks=peaks)
        print(f"[kernel] fd_mul x̂ ({b}, {d}, {f}) complex64: {e}", flush=True)
        out.setdefault("fd_mul", e)
    # forward-only: an input that requires grad is refused, not detached
    kt = torch.randn(4, 8, device="cuda", requires_grad=True)
    x = torch.randn(2, 4, 5, dtype=torch.complex64, device="cuda")
    calls = {"hilbert_window": lambda: fd_fused.hilbert_window(kt, 4),
             "fd_mul": lambda: fd_fused.fd_mul(
                 x, x[0].clone().requires_grad_())}
    for name, call in calls.items():
        try:
            call()
        except NotImplementedError:
            print(f"[kernel] {name} refuses an input that requires grad",
                  flush=True)
        else:
            raise AssertionError(f"{name} accepted an input requiring grad")
    return out


# --------------------------------------------------------------- phase 4
def phase_serve(cfg, device, prompts: int, prompt_len: int, gen_len: int):
    """Returns (model, prompt tokens, generated sequences, launch counts)."""
    from repro_torch.kernels import fd_fused
    from repro_torch.launch.serve import generate
    from repro_torch.models.serving import prefill
    from repro_torch.models.transformer import init_model
    t0 = time.perf_counter()
    model = init_model(cfg, torch.Generator().manual_seed(0), device=device)
    n_params = sum(p.numel() for p in model.parameters())
    prompt = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (prompts, prompt_len))).to(device)
    max_len = prompt_len + gen_len
    print(f"[serve] {cfg.name}: {cfg.n_layers} layers, d={cfg.d_model}, "
          f"vocab {cfg.vocab} (padded {cfg.vocab_padded}), {n_params} "
          f"parameters, built in {time.perf_counter() - t0:.2f} s; "
          f"{prompts} prompts x {prompt_len} tokens + {gen_len} new, "
          f"max_len {max_len}", flush=True)
    with torch.inference_mode():
        # warm-up (cuFFT plans, cuBLAS handles); its launches are not counted
        prefill(model, cfg, prompt)
        generate(model, cfg, prompt, 2, max_len=max_len)
        _sync(device)

        fd_fused.reset_counters()
        t_wall = time.perf_counter()
        logits = prefill(model, cfg, prompt)
        _sync(device)
        t_prefill = time.perf_counter() - t_wall
        in_prefill = dict(fd_fused.counters)
        t0 = time.perf_counter()
        generate(model, cfg, prompt, 1, max_len=max_len)
        _sync(device)
        t_ingest = time.perf_counter() - t0
        t0 = time.perf_counter()
        seqs = generate(model, cfg, prompt, gen_len, max_len=max_len)
        _sync(device)
        t_gen = time.perf_counter() - t0
        launches = dict(fd_fused.counters)
        wall = time.perf_counter() - t_wall
    if not (logits.shape == (prompts, prompt_len, cfg.vocab_padded)
            and bool(torch.isfinite(logits).all())):
        raise AssertionError(f"prefill logits {tuple(logits.shape)} "
                             "not finite or of the wrong shape")
    if seqs.shape != (prompts, max_len) or not torch.equal(
            seqs[:, :prompt_len], prompt):
        raise AssertionError(f"generate returned {tuple(seqs.shape)}")
    decode_tps = prompts * (gen_len - 1) / (t_gen - t_ingest)
    print(f"[serve] prefill {prompts}x{prompt_len}: {t_prefill * 1e3:.3f} ms "
          f"({prompts * prompt_len / t_prefill:.0f} tok/s); generate "
          f"{gen_len} new: {t_gen:.3f} s ({prompts * gen_len / t_gen:.1f} "
          f"new tok/s incl. chunked prefill {t_ingest:.3f} s); decode "
          f"{decode_tps:.1f} tok/s; wall {wall:.3f} s", flush=True)
    print(f"[serve] kernel launches: prefill {in_prefill}, prefill + "
          f"generate {launches}", flush=True)
    for name, count in in_prefill.items():
        if count < cfg.n_layers:
            raise AssertionError(f"{name} launched {count} times in prefill,"
                                 f" < one per layer ({cfg.n_layers})")
    return model, prompt_len, seqs, launches


# --------------------------------------------------------------- phase 5
def phase_check(cfg, model, prompt_len: int, seqs, device) -> None:
    from repro_torch.configs import reduce_for_smoke
    from repro_torch.models.transformer import forward, init_model
    with torch.inference_mode():
        logits = forward(model, cfg, seqs)                 # (b, max_len, V)
        if not bool(torch.isfinite(logits).all()):
            raise AssertionError("forward logits not finite")
        lg = logits[:, prompt_len - 1:seqs.shape[1] - 1]
        top2 = torch.topk(lg, 2, dim=-1).values
        checked = (top2[..., 0] - top2[..., 1]) > MARGIN
        pred = torch.clamp(torch.argmax(lg, dim=-1), max=cfg.vocab - 1)
        wrong = (pred != seqs[:, prompt_len:]) & checked
        n_checked, n_wrong = int(checked.sum()), int(wrong.sum())
    print(f"[check] forward over generated {tuple(seqs.shape)}: "
          f"{n_checked} positions checked, {checked.numel() - n_checked} "
          f"skipped (top-2 margin <= {MARGIN}), {n_wrong} mismatches",
          flush=True)
    if n_wrong:
        raise AssertionError(f"{n_wrong} decoded tokens disagree with the "
                             "kernel-path forward")
    # the smoke model on the card (kernels) vs on the CPU (plain versions)
    small = reduce_for_smoke(cfg)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, small.vocab, (2, 37)))
    with torch.inference_mode():
        want = forward(init_model(small, torch.Generator().manual_seed(1),
                                  device="cpu"), small, toks)
        got = forward(init_model(small, torch.Generator().manual_seed(1),
                                 device=device), small, toks.to(device))
    err = float((got.cpu() - want).abs().max())
    print(f"[check] smoke model {tuple(want.shape)} card vs CPU: max abs "
          f"err {err:.3e} (limit 1e-4)", flush=True)
    if not err <= 1e-4:
        raise AssertionError(f"card logits differ from CPU by {err}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.configs import get_config
    smi = phase_device()
    peak_name, peaks = _peaks(smi)
    phase_build()
    kernels = phase_kernels(peaks)
    cfg = get_config("fd-tnn-lm-wt103")
    model, prompt_len, seqs, launches = phase_serve(
        cfg, "cuda", PROMPTS, PROMPT_LEN, GEN_LEN)
    phase_check(cfg, model, prompt_len, seqs, "cuda")
    for name, e in kernels.items():
        e["launches"] = launches[name]
    print(f"[peaks] {peak_name} data sheet: {peaks[0] / 1e12} TB/s, "
          f"{peaks[1] / 1e12} TFLOP/s fp32")
    print(json.dumps({"kernels": list(kernels.values())}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
