#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths on one NVIDIA card
and check them.

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` and ``nvidia-smi``; exits non-zero without a
card or outside a checkout of this repository. Phases:

1. device: the card's name and power limit (nvidia-smi), torch and CUDA
   versions; TF32 is switched off for matmuls and cuDNN;
2. build: compile the CUDA kernels from ``src/repro_torch/kernels/csrc``;
3. kernels: each kernel against its plain torch version on the card, at
   the main paths' shapes and one ragged shape, and its time (CUDA events,
   median of 50 runs, L2 evicted before each) beside the plain version's,
   one PyTorch library call's, and the bound (bytes or operations over the
   card's published peak rate); the whole FD-TNO backward against autograd
   through the plain ``ref.fd_tno_ref``; ``hilbert_window`` is
   differentiable, standalone ``fd_mul`` and ``fd_khat_grad`` refuse an
   input that requires grad;
4. serve: the full-width fd-tnn-lm-wt103 (6 layers, d=512, vocab 50265,
   fp32, random weights from seed 0) scores 8 prompts of 448 tokens with
   ``prefill`` and greedily generates 64 tokens each (max_len 512) with
   ``generate``; the serving launch counts are read from this phase;
5. train: the same model, from seed 0, takes 30 AdamW steps through the
   port's ``Trainer`` on the synthetic pipeline (8 × 512 tokens a step):
   5 warm-up steps, then a resume whose wall over the other 25 gives the
   tokens/s; the training launch counts are read from this phase;
6. check: the kernel-path forward over the generated sequences reproduces
   every decoded token whose top-2 logit margin exceeds 1e-3; the
   smoke-size model gives the same logits, step-0 gradients and three
   training losses on the card as on the CPU; a run stopped at step 2 and
   restored from its checkpoint into a fresh model ends bitwise where an
   uninterrupted run ends;
7. a JSON line with each kernel's numbers, then the card's name and power
   limit, then ``{"ok": true, "device": ...}`` as the last line.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import tempfile
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
TRAIN_STEPS, TRAIN_SEQ, TRAIN_BATCH, TRAIN_WARMUP = 30, 512, 8, 5


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
    # fd_khat_grad at the training shape: ĝ, x̂ (8, 512, 513) complex64,
    # d=512, n=512; and a ragged one. Reads ĝ and x̂ once, writes (d, n+1):
    # 8·(2·b·d·f + d·f) bytes; 8 flops per complex product-add.
    for b, d, f in ((8, 512, 513), (3, 37, 45)):  # odd row: scalar path
        gh = torch.randn(b, d, f, dtype=torch.complex64, device="cuda",
                         generator=g)
        xh = torch.randn(b, d, f, dtype=torch.complex64, device="cuda",
                         generator=g)
        got, want = fd_fused.fd_khat_grad(gh, xh), ref.fd_khat_grad_ref(gh, xh)
        e = _kernel_entry(
            "fd_khat_grad", "src/repro/kernels/fd_fused.py:238",
            torch.view_as_real(got), torch.view_as_real(want),
            lambda: fd_fused.fd_khat_grad(gh, xh),
            lambda: ref.fd_khat_grad_ref(gh, xh),
            lambda: torch.einsum("bdf,bdf->df", gh, xh.conj()),
            nbytes=8 * (2 * gh.numel() + d * f), nops=8 * gh.numel(),
            peaks=peaks)
        print(f"[kernel] fd_khat_grad ĝ, x̂ ({b}, {d}, {f}) complex64: {e}",
              flush=True)
        out.setdefault("fd_khat_grad", e)
    check_fd_tno_backward(g)
    # hilbert_window is differentiable (self-adjoint: its gradient is the
    # window of the cotangent); standalone fd_mul and fd_khat_grad are
    # forward-only and refuse an input that requires grad, not detach it
    kt = torch.randn(4, 8, device="cuda", requires_grad=True)
    win = fd_fused.hilbert_window(kt, 4)
    cot = torch.randn(4, 8, device="cuda", generator=g)
    (dkt,) = torch.autograd.grad(win, kt, cot)
    if win.grad_fn is None or not torch.equal(
            dkt, ref.hilbert_window_ref(cot, 4)):
        raise AssertionError("hilbert_window's gradient is not the window "
                             "of the cotangent")
    print("[kernel] hilbert_window is differentiable: gradient = window of "
          "the cotangent", flush=True)
    x = torch.randn(2, 4, 5, dtype=torch.complex64, device="cuda")
    calls = {"fd_mul": lambda: fd_fused.fd_mul(
                 x, x[0].clone().requires_grad_()),
             "fd_khat_grad": lambda: fd_fused.fd_khat_grad(
                 x, x.clone().requires_grad_())}
    for name, call in calls.items():
        try:
            call()
        except NotImplementedError:
            print(f"[kernel] {name} refuses an input that requires grad",
                  flush=True)
        else:
            raise AssertionError(f"{name} accepted an input requiring grad")
    return out


def check_fd_tno_backward(g) -> None:
    """The whole FDTNO backward (conj-spectrum fd_mul, fd_khat_grad, the
    window twice, the irfft adjoint) at the training shape, x (8, 512, 512)
    fp32 and khat_real (512, 513), against torch.autograd through the plain
    ref.fd_tno_ref on the card: dx and dkhat_real within 1e-5 × max (the
    fp32 tier: the batch sums run in another order)."""
    from repro_torch.kernels import fd_fused, ops, ref
    b, n, d = 8, 512, 512
    x = torch.randn(b, n, d, device="cuda", generator=g, requires_grad=True)
    k = torch.randn(d, n + 1, device="cuda", generator=g, requires_grad=True)
    cot = torch.randn(b, n, d, device="cuda", generator=g)
    fd_fused.reset_counters()
    got = torch.autograd.grad(ops.fd_tno(x, k), (x, k), cot)
    ran = dict(fd_fused.counters, **fd_fused.op_counters)
    want = torch.autograd.grad(ref.fd_tno_ref(x, k), (x, k), cot)
    errs = []
    for name, a, w in zip(("dx", "dkhat_real"), got, want):
        err, scale = float((a - w).abs().max()), float(w.abs().max())
        errs.append(f"{name} max abs err {err:.3e} (scale {scale:.3e})")
        if not err <= 1e-5 * scale:
            raise AssertionError(f"FDTNO backward {name}: {err} > 1e-5 x "
                                 f"{scale}")
    if ran != {"hilbert_window": 3, "fd_mul": 2, "fd_khat_grad": 1,
               "fwd": 1, "bwd": 1}:
        raise AssertionError(f"FDTNO forward + backward launched {ran}")
    print(f"[kernel] FDTNO backward x ({b}, {n}, {d}) vs autograd through "
          f"ref.fd_tno_ref: {'; '.join(errs)} (limit 1e-5 x scale); "
          f"launches {ran}", flush=True)


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
    for name in ("hilbert_window", "fd_mul"):
        count = in_prefill[name]
        if count < cfg.n_layers:
            raise AssertionError(f"{name} launched {count} times in prefill,"
                                 f" < one per layer ({cfg.n_layers})")
    return model, prompt_len, seqs, launches


# --------------------------------------------------------------- phase 5
def _train_setup(cfg, device, seed: int, steps: int, warmup: int):
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.transformer import init_model
    from repro_torch.optim import adamw
    model = init_model(cfg, torch.Generator().manual_seed(seed),
                       device=device)
    ocfg = adamw.OptConfig(lr=3e-4, warmup_steps=warmup, total_steps=steps)
    opt = adamw.init(ocfg, dict(model.named_parameters()))
    return model, opt, make_train_step(cfg, ocfg)


def phase_train(cfg, device, steps: int, seq: int, batch: int) -> dict:
    """Returns the launch counts of the training run. The run is two
    ``Trainer.run`` calls on one model: steps 0..TRAIN_WARMUP-1, then a
    resume to ``steps``, whose wall (data, pre-step clone, step and
    logging, to a synchronise) gives the throughput."""
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.kernels import fd_fused
    from repro_torch.runtime.trainer import Trainer, TrainerConfig
    model, opt, step_fn = _train_setup(cfg, device, 0, steps, warmup=5)
    data = DataConfig(vocab=cfg.vocab, seq_len=seq, global_batch=batch, seed=0)

    def trainer(total):
        return Trainer(TrainerConfig(total_steps=total, log_every=10), step_fn,
                       data, log=lambda line: print(line, flush=True))
    warm, timed = trainer(TRAIN_WARMUP), trainer(steps)
    torch.cuda.reset_peak_memory_stats(device)
    fd_fused.reset_counters()
    t0 = time.perf_counter()
    opt, _ = warm.run(model, opt)
    _sync(device)
    t1 = time.perf_counter()
    opt, end = timed.run(model, opt, TRAIN_WARMUP)
    _sync(device)
    t2 = time.perf_counter()
    launches = dict(fd_fused.counters)
    bwd = fd_fused.op_counters["bwd"]
    peak = torch.cuda.max_memory_allocated(device)
    losses = [float(m["loss"])
              for m in warm.metrics_history + timed.metrics_history]
    step_ms = statistics.median(timed.step_seconds) * 1e3
    window = t2 - t1
    tok_s = (end - TRAIN_WARMUP) * batch * seq / window
    first_ms = [round(t * 1e3, 3) for t in warm.step_seconds]
    print(f"[train] {cfg.name}: {end} AdamW steps of {batch} x {seq} tokens "
          f"in {t2 - t0:.3f} s (steps 0-{TRAIN_WARMUP - 1}: {t1 - t0:.3f} s, "
          f"train_step ms {first_ms}); steps {TRAIN_WARMUP}-{end - 1}: "
          f"{window:.3f} s, {window / (end - TRAIN_WARMUP) * 1e3:.3f} ms a "
          f"step, {tok_s:.0f} tokens/s (median train_step {step_ms:.3f} ms, "
          f"max {max(timed.step_seconds) * 1e3:.3f} ms); loss step 0 "
          f"{losses[0]:.6f}, step {end - 1} {losses[-1]:.6f} (mean of the "
          f"last 5 {statistics.mean(losses[-5:]):.6f}); "
          f"max_memory_allocated {peak} bytes ({peak / 2**30:.3f} GiB)",
          flush=True)
    print(f"[train] kernel launches per step "
          f"{ {k: v / steps for k, v in launches.items()} }; FDTNO "
          f"backwards {bwd} ({bwd / steps} per step)", flush=True)
    if not all(math.isfinite(v) for v in losses) or len(losses) != steps:
        raise AssertionError(f"training losses {losses}")
    if not statistics.mean(losses[-5:]) < losses[0]:
        raise AssertionError(f"loss did not fall: {losses}")
    if not launches["fd_khat_grad"] == bwd == cfg.n_layers * steps:
        raise AssertionError(f"fd_khat_grad launched {launches['fd_khat_grad']}"
                             f" times with {bwd} FDTNO backwards in {steps} "
                             f"steps of {cfg.n_layers} layers")
    return launches


# --------------------------------------------------------------- phase 6
def check_train_card_vs_cpu(small, device) -> None:
    """Same init and batches on the card and on the CPU: step-0 gradients
    within 1e-4 × max|g| per leaf and three training losses within 1e-4
    relative (the fp32 matmul sums run in another order in cuBLAS)."""
    from repro_torch.data.pipeline import DataConfig, batch_at
    from repro_torch.launch.steps import loss_and_grads
    dcfg = DataConfig(vocab=small.vocab, seq_len=64, global_batch=2, seed=1)
    runs = {}
    for dev in ("cpu", device):
        model, opt, step_fn = _train_setup(small, dev, 3, 3, warmup=1)
        batches = [{k: torch.from_numpy(v).to(dev, torch.long)
                    for k, v in batch_at(dcfg, i).items()} for i in range(3)]
        _, _, grads = loss_and_grads(model, small, batches[0])
        losses = []
        for bt in batches:
            opt, m = step_fn(model, opt, bt)
            losses.append(float(m["loss"]))
        runs[dev] = ({k: v.cpu() for k, v in grads.items()}, losses)
    (g_cpu, l_cpu), (g_dev, l_dev) = runs["cpu"], runs[device]
    worst = max(float((g_dev[k] - g_cpu[k]).abs().max())
                / float(g_cpu[k].abs().max()) for k in g_cpu)
    lerr = max(abs(a - b) / abs(b) for a, b in zip(l_dev, l_cpu))
    print(f"[check] smoke training card vs CPU: step-0 grads worst leaf "
          f"{worst:.3e} x max|g| (limit 1e-4), losses {l_dev} vs {l_cpu}, "
          f"max rel err {lerr:.3e} (limit 1e-4)", flush=True)
    if not (worst <= 1e-4 and lerr <= 1e-4):
        raise AssertionError("card training differs from the CPU's")


def check_checkpoint_resume(small, device) -> None:
    """A run checkpointed at step 2 and restored into a fresh model and
    optimizer ends, after one more step, bitwise where an uninterrupted
    three-step run ends."""
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.runtime.trainer import Trainer, TrainerConfig
    dcfg = DataConfig(vocab=small.vocab, seq_len=64, global_batch=2, seed=2)

    def run(total, ckpt_dir, seed):
        model, opt, step_fn = _train_setup(small, device, seed, 3, warmup=1)
        tr = Trainer(TrainerConfig(total_steps=total, ckpt_dir=ckpt_dir,
                                   ckpt_every=2, log_every=0), step_fn, dcfg)
        opt, start = tr.try_restore(model, opt)
        opt, end = tr.run(model, opt, start)
        return model, opt, start, end

    whole, whole_opt, _, _ = run(3, None, seed=4)
    with tempfile.TemporaryDirectory() as d:
        run(2, d, seed=4)
        resumed, res_opt, start, end = run(3, d, seed=5)   # other init
    same = all(torch.equal(a, b) for a, b in
               zip(whole.parameters(), resumed.parameters()))
    same_opt = all(torch.equal(whole_opt.mu[k], res_opt.mu[k])
                   and torch.equal(whole_opt.nu[k], res_opt.nu[k])
                   for k in whole_opt.mu)
    print(f"[check] checkpoint at step 2, restored into a fresh model "
          f"(resumed at {start}, ended at {end}): parameters bitwise equal "
          f"to an uninterrupted run: {same}; moments: {same_opt}", flush=True)
    if not (start == 2 and end == 3 and same and same_opt):
        raise AssertionError("the resumed run differs from the uninterrupted")


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
    check_train_card_vs_cpu(small, device)
    check_checkpoint_resume(small, device)


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
    model, prompt_len, seqs, serve_launches = phase_serve(
        cfg, "cuda", PROMPTS, PROMPT_LEN, GEN_LEN)
    train_launches = phase_train(cfg, "cuda", TRAIN_STEPS, TRAIN_SEQ,
                                 TRAIN_BATCH)
    phase_check(cfg, model, prompt_len, seqs, "cuda")
    # each path must have gone through each of its kernels
    paths = {"serve": (serve_launches, ("hilbert_window", "fd_mul")),
             "train": (train_launches, tuple(kernels))}
    for path, (counts, names) in paths.items():
        for name in names:
            if not counts[name] > 0:
                raise AssertionError(f"{name} not launched on the {path} "
                                     "path")
    for name, e in kernels.items():
        e["launches"] = serve_launches[name] + train_launches[name]
        e["launches_by_path"] = {"serve": serve_launches[name],
                                 "train": train_launches[name]}
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
