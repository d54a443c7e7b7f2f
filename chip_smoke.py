#!/usr/bin/env python3
"""Drive the PyTorch port's serving, training, SKI scoring, SKI training,
unfused SKI, large-rank SKI and Mamba-2 serving paths on one NVIDIA card
and check them.

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` and ``nvidia-smi``; exits non-zero without a
card or outside a checkout of this repository. Phases:

1. device: the card's name and power limit (nvidia-smi), torch and CUDA
   versions; TF32 is switched off for matmuls and cuDNN;
2. build: compile the CUDA kernels from ``src/repro_torch/kernels/csrc``,
   one ``nvcc`` per source, all started together;
3. kernels: each kernel against its plain torch version on the card, at
   the main paths' shapes and ragged ones, and its time (CUDA events,
   median of 50 runs, L2 evicted before each) beside the plain version's,
   one PyTorch library call's (where one computes the same function), and
   the bound (bytes or operations over the card's published peak rate);
   the whole FD-TNO backward against autograd through the plain
   ``ref.fd_tno_ref``, and under ``REPRO_PALLAS_GRAD=0``;
   ``hilbert_window`` is differentiable, standalone ``fd_mul`` and
   ``fd_khat_grad`` refuse an input that requires grad; the SKI kernels
   ``interp_reduce``, ``interp_expand``, ``short_conv``,
   ``ski_fused_pass2``, ``gram_grad`` and ``conv_tap_grad`` at the SKI
   path's shape (causal and bidirectional taps, and the mirrored offsets
   of the backward), ragged, n < m, r = n and m = 1, the interp pair also
   at r = 2 and as adjoints on the card; pass 2 at the dense-rank ceiling
   (r = 181 at d = 512, r = 512 at d = 64) in the forward orientation and
   the backward's (A transposed, taps flipped, left mirrored); ``gram_grad``
   also at both ceilings (dA of 67 MB) and ``conv_tap_grad`` also with
   m = 400 taps and with b = 12, both also bitwise against a second call;
   the whole
   SKIFusedTNO backward against autograd through ``ref.ski_fused_tno_ref``
   (causal, bidirectional, r = 181), and under ``REPRO_PALLAS_GRAD=0``;
   the large-rank ``ski_windowed_pass2`` and ``ski_expand_pass2`` at the
   large-r path's shape (x (8, 512, 512), r = 512, the four offsets), at
   r = 513 and 4096 (n = 4096, d = 16), ragged, n < m, r = n, r = 2 and
   m = 1, the windowed one also under ``REPRO_SKI_BAND_MAX=16``, against
   a float64 version and against itself (two calls, the same bits; its
   Gram runs on the tensor cores in 3xTF32 and its bound prices it at
   three TF32 products), the expand one also at n = r = 8192; the
   whole SKIFusedTNOCoef backward, both variants, causal and
   bidirectional, against autograd through ``ref.ski_fused_tno_coef_ref``
   and under ``REPRO_PALLAS_GRAD=0``;
4. serve: the full-width fd-tnn-lm-wt103 (6 layers, d=512, vocab 50265,
   fp32, random weights from seed 0) scores 8 prompts of 448 tokens with
   ``prefill`` and greedily generates 64 tokens each (max_len 512) with
   ``generate``; the serving launch counts are read from this phase;
5. train: the same model, from seed 0, takes 30 AdamW steps through the
   port's ``Trainer`` on the synthetic pipeline (8 × 512 tokens a step):
   5 warm-up steps, then a resume whose wall over the other 25 gives the
   tokens/s; the training launch counts are read from this phase;
6. score: the full-width ski-tnn-lm-wt103 (random weights from seed 0)
   scores 8 × 512 tokens through ``launch.steps.make_forward`` and the
   evaluation ``loss_fn`` under ``torch.no_grad()``: 6 ``interp_reduce``
   and 6 ``ski_fused_pass2`` launches a forward, card vs CPU logits and
   loss on 1 × 512 tokens, peak memory; the six standalone SKI kernel
   wrappers refuse an input that requires grad on the card; one op-level
   line times ``ops.ski_fused_tno`` against ``ops.fd_tno`` at
   (8, 512, 512);
7. ski train: the full-width ski-tnn-lm-wt103 from seed 0 takes 30 AdamW
   steps as in phase 5: 18 ``interp_reduce``, 12 ``ski_fused_pass2``, 6
   ``gram_grad`` and 6 ``conv_tap_grad`` launches and 6 kernel backwards
   a step;
8. ski unfused: the unfused SKI-TNO (``TNOConfig(variant="ski",
   fused=False)`` through ``tno_plan``/``tno_apply``) at x (8, 512, 512)
   and the SKI model's width (d=512, r=64, m=32, seed 0), causal and
   bidirectional, forward and backward: y and the gradients for x, the
   taps and the RPE values against the fused op (1e-4 × max) and autograd
   through the plain versions (1e-5 × max), y against the CPU (1e-5 ×
   max), 1 ``interp_reduce`` / ``short_conv`` / ``interp_expand`` launch
   forward and one more each plus one ``conv_tap_grad`` backward, and
   ``REPRO_PALLAS_GRAD=0``; then, recorded and not claimed, the fused and
   unfused forward and grad times and Figure 11's component times at the
   SKI benchmark's shapes (b=4, d=64, n 2048 and 8192), and the Appendix-B
   ``causal_ski_lowrank`` against its masked dense oracle, timed beside
   the causal FD-TNO;
9. large-r: ski-tnn-lm-wt103 at tno_rank 512 (full width, seed 0; the
   policy routes it "windowed") scores 8 × 512 tokens (6 ``interp_reduce``
   + 6 ``ski_windowed_pass2`` a forward, card vs CPU logits on 1 × 512)
   and trains 30 steps (18 / 12 / 6 ``interp_reduce`` /
   ``ski_windowed_pass2`` / ``conv_tap_grad`` launches and 6 kernel
   backwards of SKIFusedTNOCoef a step); then, under
   ``REPRO_SKI_WINDOWED_RMAX=256`` (the "fft" route), the same scoring and
   10 steps with ``ski_expand_pass2`` in its place; recorded, not
   claimed, the forward and grad times at ``bench_ski_components.py``'s
   large-r shapes (r 64 to 8192, the dense op beside where it fits) and
   dense against windowed at r = 181 and 182, d = 512;
10. check: the kernel-path forward over the generated sequences reproduces
   every decoded token whose top-2 logit margin exceeds 1e-3; the
   smoke-size model gives the same logits, step-0 gradients and three
   training losses on the card as on the CPU; a run stopped at step 2 and
   restored from its checkpoint into a fresh model ends bitwise where an
   uninterrupted run ends; the same gradients, losses and resume for the
   smoke-size SKI model;
11. mamba: ``ssd_scan`` against ``ssd_chunked.ssd_scan_chunked`` in bf16
   (BF16_TOL × max) and fp32 (1e-5 × max, and against the float64
   ``ref.ssd_scan_ref``) at the path shape x (8, 2048, 80, 64), B and C (8,
   2048, 1, 128), chunk 128, at n = 2000, 100 and 1, at g = 2 and 4 and at
   the smoke shape; both instances timed at the path shape (the bf16 one,
   on the tensor cores, against the TF32 peak); the bf16 ``short_conv`` at
   Mamba's conv shape (8, 2048, 5376), m = 4, and at the SKI path's shape
   with its four offsets; the full-width mamba2-2.7b (64 layers, d=2560,
   bf16, 2,831,730,176 parameters, random weights from seed 0) scores 8 ×
   2048 tokens through ``make_forward`` (64 ``ssd_scan`` + 64
   ``short_conv`` launches a forward, median of 5, peak memory, the
   kernels' device time by the profiler), ``prefill``s 8 prompts of 128
   tokens and greedily generates 32 tokens each (max_len 160, the prompt
   token by token); the decode path teacher-forced over the generated
   sequences against the kernel-path forward (0 mismatches where the
   forward's top-2 margin exceeds twice their largest logit difference);
   the kernel-path bf16 forward no farther from the same forward through
   the plain ``ssd_scan`` and ``short_conv`` than that plain forward is
   from the fp32 one; and the same in fp32 on the same weights, where that
   margin is small enough that positions are checked (at least one must
   be); the smoke mamba model card vs CPU (logits 1e-4 × max in fp32,
   2e-2 × max in bf16; fp32 greedy generate token-exact);
12. a JSON line with each kernel's numbers, then the card's name and power
    limit, then ``{"ok": true, "device": ...}`` as the last line.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from unittest import mock

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

#: NVIDIA data-sheet peaks (bytes/s of device memory, dense FLOP/s: fp32
#: outside the tensor cores, TF32 and bf16 on them, without sparsity), by
#: the name nvidia-smi reports; "H100" alone is the SXM part.
PEAKS = {"H100 PCIe": (2.0e12, 51e12, 378e12, 756e12),
         "H100 NVL": (3.9e12, 60e12, 417.5e12, 835.5e12),
         "H100": (3.35e12, 67e12, 495e12, 989e12)}
PROMPTS, PROMPT_LEN, GEN_LEN = 8, 448, 64
MARGIN = 1e-3
TRAIN_STEPS, TRAIN_SEQ, TRAIN_BATCH, TRAIN_WARMUP = 30, 512, 8, 5
SCORE_BATCH, SCORE_SEQ, SCORE_REPS = 8, 512, 20
FD_SRC = "src/repro_torch/kernels/csrc/fd_fused.cu"
SKI_SRC = "src/repro_torch/kernels/csrc/ski.cu"
SKI_GRAD_SRC = "src/repro_torch/kernels/csrc/ski_grad.cu"
SHORT_CONV_SRC = "src/repro_torch/kernels/csrc/short_conv.cu"
SSD_SRC = "src/repro_torch/kernels/csrc/ssd_scan.cu"
MAMBA = "mamba2-2.7b"
MAMBA_BATCH, MAMBA_SEQ, MAMBA_REPS = 8, 2048, 5
MAMBA_PROMPTS, MAMBA_PROMPT_LEN, MAMBA_GEN = 8, 128, 32
#: a kernel with a bf16 output against its plain version on the same bf16
#: inputs: both sum in fp32 and round once, so they differ by at most one
#: bf16 ulp (2^-8 relative) where the two fp32 sums straddle a rounding
BF16_TOL = 1e-2


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
    paths = backend.build()
    print(f"[build] {', '.join(p.name for p in paths)} built in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)


# --------------------------------------------------------------- phase 3
def _bound(nbytes, nops, peaks):
    """(bound ms, "bytes" or "operations"): the bytes over ``peaks[0]`` or
    the operations, whichever take longer. ``nops`` runs at ``peaks[1]``
    (fp32 on the CUDA cores), or is triples (operations, peak FLOP/s,
    unit), one for each type the kernel computes in. Work on one unit adds
    up; the tensor cores and the CUDA cores run side by side, so the
    operations take the busiest unit's time."""
    if not isinstance(nops, tuple):
        nops = ((nops, peaks[1], "cuda cores"),)
    t_bytes = nbytes / peaks[0] * 1e3
    per_unit = {}
    for ops, flops, unit in nops:
        per_unit[unit] = per_unit.get(unit, 0.0) + ops / flops * 1e3
    t_ops = max(per_unit.values())
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def _kernel_entry(name, replaces, got, want, fn, plain, library, nbytes,
                  nops, peaks, tol=1e-6, source=FD_SRC, reps=50):
    """Check ``got`` within ``tol`` × max|want| and time the kernel, its
    plain version and the library call (None: there is none), each the
    median of ``reps`` runs; the bound is ``_bound``'s."""
    err = float((got.float() - want.float()).abs().max())
    scale = float(want.float().abs().max())
    if not err <= tol * scale:
        raise AssertionError(f"{name}: max abs err {err} > {tol} x {scale}")
    bound_ms, bound_by = _bound(nbytes, nops, peaks)
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "max_abs_err": err, "tolerance": tol,
            "scale": scale, "limit": tol * scale, "ms": time_ms(fn, reps),
            "plain_ms": time_ms(plain, reps),
            "library_ms": None if library is None else time_ms(library,
                                                               reps),
            "bound_ms": bound_ms, "bound_by": bound_by}


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


def reference_grad():
    """``REPRO_PALLAS_GRAD=0`` for the duration of a ``with``: the autograd
    Functions keep their kernel forwards and return autograd's cotangents
    through the plain version."""
    return mock.patch.dict(os.environ, {"REPRO_PALLAS_GRAD": "0"})


def _grads_close(what, got, want, names, tol=1e-5) -> str:
    """Each of ``got`` within ``tol`` × max|want|; returns the report."""
    errs = []
    for name, a, w in zip(names, got, want):
        err, scale = float((a - w).abs().max()), float(w.abs().max())
        errs.append(f"{name} max abs err {err:.3e} (scale {scale:.3e}, limit "
                    f"{tol * scale:.3e})")
        if not err <= tol * scale:
            raise AssertionError(f"{what} {name}: {err} > {tol} x {scale}")
    return "; ".join(errs)


def check_fd_tno_backward(g) -> None:
    """The whole FDTNO backward (conj-spectrum fd_mul, fd_khat_grad, the
    window twice, the irfft adjoint) at the training shape, x (8, 512, 512)
    fp32 and khat_real (512, 513), against torch.autograd through the plain
    ref.fd_tno_ref on the card: dx and dkhat_real within 1e-5 × max (the
    fp32 tier: the batch sums run in another order). Under
    REPRO_PALLAS_GRAD=0 the backward is that autograd, counted as bwd_ref,
    with no backward kernel launched."""
    from repro_torch.kernels import fd_fused, ops, ref
    b, n, d = 8, 512, 512
    x = torch.randn(b, n, d, device="cuda", generator=g, requires_grad=True)
    k = torch.randn(d, n + 1, device="cuda", generator=g, requires_grad=True)
    cot = torch.randn(b, n, d, device="cuda", generator=g)
    fd_fused.reset_counters()
    got = torch.autograd.grad(ops.fd_tno(x, k), (x, k), cot)
    ran = dict(fd_fused.counters, **fd_fused.op_counters)
    want = torch.autograd.grad(ref.fd_tno_ref(x, k), (x, k), cot)
    names = ("dx", "dkhat_real")
    report = _grads_close("FDTNO backward", got, want, names)
    if ran != {"hilbert_window": 3, "fd_mul": 2, "fd_khat_grad": 1,
               "fwd": 1, "bwd_kernel": 1, "bwd_ref": 0}:
        raise AssertionError(f"FDTNO forward + backward launched {ran}")
    print(f"[kernel] FDTNO backward x ({b}, {n}, {d}) vs autograd through "
          f"ref.fd_tno_ref: {report}; launches {ran}", flush=True)
    fd_fused.reset_counters()
    with reference_grad():
        ref_got = torch.autograd.grad(ops.fd_tno(x, k), (x, k), cot)
    ran = dict(fd_fused.counters, **fd_fused.op_counters)
    report = _grads_close("FDTNO REPRO_PALLAS_GRAD=0 backward", ref_got, got,
                          names)
    if ran != {"hilbert_window": 1, "fd_mul": 1, "fd_khat_grad": 0,
               "fwd": 1, "bwd_kernel": 0, "bwd_ref": 1}:
        raise AssertionError(f"FDTNO under REPRO_PALLAS_GRAD=0 launched {ran}")
    print(f"[kernel] FDTNO under REPRO_PALLAS_GRAD=0 vs the kernel backward: "
          f"{report}; launches {ran}", flush=True)


#: SKI kernel shapes (label, b, n, d, r, m, left): the SKI path with
#: causal and bidirectional taps and the offsets the backward mirrors them
#: to, ragged, n < m, r = n (h = 1), one tap
SKI_SHAPES = (("path", 8, 512, 512, 64, 32, 0),
              ("path bidirectional", 8, 512, 512, 64, 32, 16),
              ("path mirrored", 8, 512, 512, 64, 32, 31),
              ("path bidirectional mirrored", 8, 512, 512, 64, 32, 15),
              ("ragged", 3, 37, 45, 11, 4, 2), ("n<m", 2, 3, 5, 3, 4, 0),
              ("r=n", 2, 64, 40, 64, 8, 3), ("m=1", 2, 40, 33, 7, 1, 0))
#: interp_expand and interp_reduce with the fewest inducing points
#: (label, b, n, d, r)
INTERP_R2 = ("r=2", 2, 40, 33, 2)
#: pass 2 at the ceiling of ``backend.ski_rank_variant``'s dense variant
#: (d·r²·4 <= 64 MB, r <= 512): (label, b, n, d, r, m)
PASS2_CEILING = (("r=181", 8, 512, 512, 181, 32), ("r=512", 8, 512, 64, 512,
                                                    32))


def _tap_pairs(n: int, m: int, left: int) -> int:
    """(j, k) pairs of one batch row and channel whose x row j-k+left lies
    in [0, n): the multiply-adds the tap gradient needs."""
    return sum(max(0, min(n, n + k - left) - max(0, k - left))
               for k in range(m))


def _pass2_entry(label, x, z, a, f, left, peaks, transpose_a=False):
    """ski_fused_pass2 at one shape and offset, 1e-5 × max|plain| (the
    Gram and the conv sum in another order than the plain einsum and
    shift-adds); ``transpose_a`` applies Aᵀ read in place, as the signal
    backward does."""
    from repro_torch.kernels import ref, ski_fused
    b, n, d = x.shape
    r, m = z.shape[1], f.shape[1]

    def kernel():
        return ski_fused.ski_fused_pass2(x, z, a, f, True, left=left,
                                         transpose_a=transpose_a)

    def plain():
        return ref.ski_fused_pass2_ref(x, z, a, f, True, left=left,
                                       transpose_a=transpose_a)
    # conv 2·b·n·d·m, Gram 2·b·d·r², expansion 2·2·b·n·d flops; x, z, A, f
    # read once, y written once
    e = _kernel_entry(
        "ski_fused_pass2", "src/repro/kernels/ski_fused.py:143", kernel(),
        plain(), kernel, plain, None,
        nbytes=4 * (2 * x.numel() + z.numel() + a.numel() + f.numel()),
        nops=2 * b * d * (n * m + r * r + 2 * n), peaks=peaks, tol=1e-5,
        source=SKI_SRC)
    print(f"[kernel] ski_fused_pass2 {label} x ({b}, {n}, {d}), r={r}, m={m}, "
          f"left={left}{', A transposed in place' if transpose_a else ''}: "
          f"{e}", flush=True)
    return e


def _interp_entries(label, x, z, lo, w_lo, peaks) -> dict:
    """interp_reduce and interp_expand at one (n, r), each within 1e-6 ×
    max|plain| (sums of at most 2h+1 terms; two)."""
    from repro_torch.kernels import interp_matvec, ref
    b, n, d = x.shape
    r = z.shape[1]
    w = ref.dense_interp_matrix(lo, w_lo, r)
    nnz_w = int((w != 0).sum())           # W's non-zeros at this (n, r)
    out = {}
    # x read once and z written once (reduce), or the other way (expand);
    # 2 flops a non-zero of W for each (batch row, channel)
    out["interp_reduce"] = _kernel_entry(
        "interp_reduce", "src/repro/kernels/interp_matvec.py:65",
        interp_matvec.interp_reduce(x, lo, w_lo, r),
        ref.interp_reduce_ref(x, lo, w_lo, r),
        lambda: interp_matvec.interp_reduce(x, lo, w_lo, r),
        lambda: ref.interp_reduce_ref(x, lo, w_lo, r),
        lambda: torch.einsum("nr,bnd->brd", w, x),
        nbytes=4 * (x.numel() + z.numel()), nops=2 * b * d * nnz_w,
        peaks=peaks, tol=1e-6, source=SKI_SRC)
    print(f"[kernel] interp_reduce {label} x ({b}, {n}, {d}), r={r}: "
          f"{out['interp_reduce']}", flush=True)
    out["interp_expand"] = _kernel_entry(
        "interp_expand", "src/repro/kernels/interp_matvec.py:154",
        interp_matvec.interp_expand(z, lo, w_lo),
        ref.interp_expand_ref(z, lo, w_lo),
        lambda: interp_matvec.interp_expand(z, lo, w_lo),
        lambda: ref.interp_expand_ref(z, lo, w_lo),
        lambda: torch.einsum("nr,brd->bnd", w, z),
        nbytes=4 * (x.numel() + z.numel()), nops=2 * b * d * nnz_w,
        peaks=peaks, tol=1e-6, source=SKI_SRC)
    print(f"[kernel] interp_expand {label} z ({b}, {r}, {d}), n={n}: "
          f"{out['interp_expand']}", flush=True)
    return out


def _short_conv_entry(label, x, f, left, peaks, tol=1e-5,
                      name="short_conv") -> dict:
    """short_conv at one shape and offset, within 1e-5 × max|plain| in fp32
    (m-term sums with fused multiply-adds against the plain shift-adds;
    ``tol`` BF16_TOL for bf16 x and taps). The library yardstick is
    cuDNN's depthwise conv1d (TF32 off) in x's dtype on a channel-major
    copy of x padded by the taps' reach, made outside the timed call, with
    the taps reversed."""
    from repro_torch.kernels import ref, short_conv
    b, n, d = x.shape
    m = f.shape[1]
    xp = torch.nn.functional.pad(x, (0, 0, m - 1 - left, left))
    xp = xp.transpose(1, 2).contiguous()
    wt = f.flip(-1)[:, None, :].contiguous()

    def library():
        return torch.nn.functional.conv1d(xp, wt, groups=d)
    want = ref.short_conv_left_ref(x, f, left)
    lib_err = float((library().transpose(1, 2).float()
                     - want.float()).abs().max())
    if not lib_err <= tol * float(want.float().abs().max()):
        raise AssertionError(f"conv1d is not the short conv: {lib_err}")
    # x and the taps read once, y written once; 2 flops a (j, k) pair whose
    # x row is in range
    e = _kernel_entry(
        name, "src/repro/kernels/short_conv.py:69",
        short_conv.short_conv(x, f, left), want,
        lambda: short_conv.short_conv(x, f, left),
        lambda: ref.short_conv_left_ref(x, f, left), library,
        nbytes=x.element_size() * (2 * x.numel() + f.numel()),
        nops=2 * b * d * _tap_pairs(n, m, left), peaks=peaks, tol=tol,
        source=SHORT_CONV_SRC)
    print(f"[kernel] {name} {label} x ({b}, {n}, {d}) {x.dtype}, m={m}, "
          f"left={left}: {e} (conv1d max abs err {lib_err:.3e})", flush=True)
    return e


def check_interp_adjoint(device="cuda") -> None:
    """The card's interp pair are adjoints: <Wᵀx, z> = <x, W z> within 1e-6
    relative, at the path shape, on positive inputs (no cancellation in
    the inner products, taken in fp64 of the kernels' fp32 outputs)."""
    from repro_torch.core import ski
    from repro_torch.kernels import interp_matvec
    g = torch.Generator(device=device).manual_seed(3)
    b, n, d, r = 8, 512, 512, 64
    x = torch.rand(b, n, d, device=device, generator=g)
    z = torch.rand(b, r, d, device=device, generator=g)
    lo, w_lo, _ = ski.make_inducing(n, r, device)
    lhs = float((interp_matvec.interp_reduce(x, lo, w_lo, r).double()
                 * z.double()).sum())
    rhs = float((x.double()
                 * interp_matvec.interp_expand(z, lo, w_lo).double()).sum())
    rel = abs(lhs - rhs) / abs(rhs)
    print(f"[kernel] adjoint x ({b}, {n}, {d}), r={r}: <W^T x, z> {lhs!r}, "
          f"<x, W z> {rhs!r}, relative difference {rel:.3e} (limit 1e-6)",
          flush=True)
    if not rel <= 1e-6:
        raise AssertionError(f"interp_reduce and interp_expand are not "
                             f"adjoint on the card: {rel}")


def phase_ski_kernels(peaks, device="cuda") -> dict:
    """The dense forward's four SKI kernels against their plain versions at
    SKI_SHAPES: interp_reduce and interp_expand within 1e-6 × max|plain|
    (sums of at most 2h+1 and two terms), ski_fused_pass2 and short_conv
    within 1e-5 × max|plain|; the interp pair also at r = 2 and as
    adjoints; then pass 2 at PASS2_CEILING in both orientations. Returns
    the entries at the path's shape."""
    from repro_torch.core import ski
    g = torch.Generator(device=device).manual_seed(1)
    out = {}
    for label, b, n, d, r, m, left in SKI_SHAPES:
        x = torch.randn(b, n, d, device=device, generator=g)
        z = torch.randn(b, r, d, device=device, generator=g)
        a = torch.randn(d, r, r, device=device, generator=g)
        f = torch.randn(d, m, device=device, generator=g)
        lo, w_lo, _ = ski.make_inducing(n, r, device)
        entries = _interp_entries(label, x, z, lo, w_lo, peaks)
        entries["short_conv"] = _short_conv_entry(label, x, f, left, peaks)
        entries["ski_fused_pass2"] = _pass2_entry(label, x, z, a, f, left,
                                                  peaks)
        if label == "path":
            out.update(entries)
    label, b, n, d, r = INTERP_R2
    lo, w_lo, _ = ski.make_inducing(n, r, device)
    _interp_entries(label, torch.randn(b, n, d, device=device, generator=g),
                    torch.randn(b, r, d, device=device, generator=g), lo,
                    w_lo, peaks)
    check_interp_adjoint(device)
    for label, b, n, d, r, m in PASS2_CEILING:
        x = torch.randn(b, n, d, device=device, generator=g)
        z = torch.randn(b, r, d, device=device, generator=g)
        a = torch.randn(d, r, r, device=device, generator=g)
        f = torch.randn(d, m, device=device, generator=g)
        f_t = f.flip(-1).contiguous()
        for left in (0, m // 2):
            _pass2_entry(f"ceiling {label}", x, z, a, f, left, peaks)
            _pass2_entry(f"ceiling {label} backward orientation", x, z, a,
                         f_t, m - 1 - left, peaks, transpose_a=True)
    return out


def _repeat_equal(name, label, fn) -> torch.Tensor:
    """``fn()`` twice on the same inputs gives the same bits (the kernels
    sum in a fixed order, with no atomics)."""
    got = fn()
    if not torch.equal(got, fn()):
        raise AssertionError(f"{name} {label}: two calls differ")
    return got


def _gram_grad_entry(label, gz, z, peaks) -> dict:
    """gram_grad within 1e-6 × max|plain| (sums of b terms) and bitwise
    the same over two calls; gz, z read once, dA written once; 2·b·d·r²
    flops. The library yardstick: the plain version's one einsum."""
    from repro_torch.kernels import ref, ski_grad
    b, r, d = z.shape
    e = _kernel_entry(
        "gram_grad", "src/repro/kernels/ski_grad.py:149",
        _repeat_equal("gram_grad", label,
                      lambda: ski_grad.gram_grad(gz, z)),
        ref.gram_grad_ref(gz, z), lambda: ski_grad.gram_grad(gz, z),
        lambda: ref.gram_grad_ref(gz, z),
        lambda: torch.einsum("bsc,btc->cst", gz, z),
        nbytes=4 * (2 * z.numel() + d * r * r), nops=2 * b * d * r * r,
        peaks=peaks, tol=1e-6, source=SKI_GRAD_SRC)
    print(f"[kernel] gram_grad {label} gz, z ({b}, {r}, {d}), two calls "
          f"bitwise equal: {e}", flush=True)
    return e


def _conv_tap_grad_entry(label, cot, x, m, left, peaks) -> dict:
    """conv_tap_grad within 1e-5 × max|plain| (4,096 terms at the path
    shape, in another order) and bitwise the same over two calls; g, x read
    once, df written once; 2 flops a (j, k) pair in range. The library
    yardstick: cuDNN's depthwise conv1d weight gradient (TF32 off) on
    channel-major copies of g and of x padded by the taps' reach, made
    outside the timed call; it gives the taps in reverse order."""
    from repro_torch.kernels import ref, ski_grad
    b, n, d = x.shape
    xp = torch.nn.functional.pad(x, (0, 0, m - 1 - left, left))
    xp = xp.transpose(1, 2).contiguous()
    gt = cot.transpose(1, 2).contiguous()

    def library():
        return torch.nn.grad.conv1d_weight(xp, (d, 1, m), gt, groups=d)
    want = ref.conv_tap_grad_ref(cot, x, m, left)
    lib_err = float((library()[:, 0].flip(-1) - want).abs().max())
    if not lib_err <= 1e-5 * float(want.abs().max()):
        raise AssertionError(f"conv1d_weight is not the tap gradient: "
                             f"{lib_err}")
    e = _kernel_entry(
        "conv_tap_grad", "src/repro/kernels/ski_grad.py:71",
        _repeat_equal("conv_tap_grad", label,
                      lambda: ski_grad.conv_tap_grad(cot, x, m, left)),
        want, lambda: ski_grad.conv_tap_grad(cot, x, m, left),
        lambda: ref.conv_tap_grad_ref(cot, x, m, left), library,
        nbytes=4 * (2 * x.numel() + d * m),
        nops=2 * b * d * _tap_pairs(n, m, left), peaks=peaks, tol=1e-5,
        source=SKI_GRAD_SRC)
    print(f"[kernel] conv_tap_grad {label} g, x ({b}, {n}, {d}), m={m}, "
          f"left={left}, two calls bitwise equal: {e} (conv1d_weight max "
          f"abs err {lib_err:.3e})", flush=True)
    return e


#: conv_tap_grad beyond SKI_SHAPES (label, b, n, d, m, left): more taps
#: than a tap pass (13 passes), and more batch rows than a tile's blocks
#: (a block takes two, its x ring carried from one to the next)
TAP_GRAD_SHAPES = (("m=400", 8, 512, 512, 400, 200),
                   ("b=12", 12, 300, 40, 32, 16))


def phase_grad_kernels(peaks, device="cuda") -> dict:
    """The dense backward's two parameter-cotangent kernels against their
    plain versions, each also bitwise against a second call: gram_grad and
    conv_tap_grad at SKI_SHAPES, gram_grad at PASS2_CEILING (dA of 67 MB,
    the dense route's largest), conv_tap_grad at TAP_GRAD_SHAPES; then the
    whole SKIFusedTNO backward. Returns the entries at the path's shape."""
    g = torch.Generator(device=device).manual_seed(2)
    out = {}
    for label, b, n, d, r, m, left in SKI_SHAPES:
        x = torch.randn(b, n, d, device=device, generator=g)
        cot = torch.randn(b, n, d, device=device, generator=g)
        z = torch.randn(b, r, d, device=device, generator=g)
        gz = torch.randn(b, r, d, device=device, generator=g)
        entries = {"gram_grad": _gram_grad_entry(label, gz, z, peaks),
                   "conv_tap_grad": _conv_tap_grad_entry(label, cot, x, m,
                                                         left, peaks)}
        if label == "path":
            out.update(entries)
    for label, b, n, d, r, m in PASS2_CEILING:
        _gram_grad_entry(f"ceiling {label}",
                         torch.randn(b, r, d, device=device, generator=g),
                         torch.randn(b, r, d, device=device, generator=g),
                         peaks)
    for label, b, n, d, m, left in TAP_GRAD_SHAPES:
        _conv_tap_grad_entry(label,
                             torch.randn(b, n, d, device=device, generator=g),
                             torch.randn(b, n, d, device=device, generator=g),
                             m, left, peaks)
    check_ski_backward(g)
    return out


#: the launch count of every SKI kernel at 0, for the exact-count checks
NO_SKI_LAUNCHES = {"interp_reduce": 0, "interp_expand": 0, "short_conv": 0,
                   "ski_fused_pass2": 0, "ski_windowed_pass2": 0,
                   "ski_expand_pass2": 0, "gram_grad": 0, "conv_tap_grad": 0}
#: SKIFusedTNO backward checks (label, r, d, causal), b = 8, n = 512, m = 32
SKI_BACKWARD = (("causal", 64, 512, True), ("bidirectional", 64, 512, False),
                ("causal r=181", 181, 512, True))


def check_ski_backward(g) -> None:
    """The whole SKIFusedTNO backward (interp_reduce twice, the transposed
    pass 2, gram_grad, conv_tap_grad) against torch.autograd through the
    plain ref.ski_fused_tno_ref on the card: dx, dA and df within 1e-5 ×
    max (the fp32 tier), with 3 / 2 / 1 / 1 launches and one kernel
    backward. Then the same under REPRO_PALLAS_GRAD=0: one reference
    backward, no gram_grad or conv_tap_grad launch, and the same gradients
    within the same tolerance."""
    from repro_torch.core import ski
    from repro_torch.kernels import ops, ref, ski_vjp
    b, n, m = 8, 512, 32
    names = ("dx", "dA", "df")
    for label, r, d, causal in SKI_BACKWARD:
        x = torch.randn(b, n, d, device="cuda", generator=g,
                        requires_grad=True)
        a = torch.randn(d, r, r, device="cuda", generator=g,
                        requires_grad=True)
        f = torch.randn(d, m, device="cuda", generator=g, requires_grad=True)
        cot = torch.randn(b, n, d, device="cuda", generator=g)
        lo, w_lo, _ = ski.make_inducing(n, r, "cuda")

        def grads():
            ops.reset_ski_counters()
            out = torch.autograd.grad(
                ops.ski_fused_tno(x, a, f, lo, w_lo, r, causal), (x, a, f),
                cot)
            return out, dict(ops.ski_counters(), **ski_vjp.counters)
        got, ran = grads()
        want = torch.autograd.grad(
            ref.ski_fused_tno_ref(x, a, f, lo, w_lo, r, causal), (x, a, f),
            cot)
        report = _grads_close(f"SKIFusedTNO backward ({label})", got, want,
                              names)
        if ran != {**NO_SKI_LAUNCHES, "interp_reduce": 3,
                   "ski_fused_pass2": 2, "gram_grad": 1, "conv_tap_grad": 1,
                   "fwd": 1, "bwd_kernel": 1, "bwd_ref": 0}:
            raise AssertionError(f"SKIFusedTNO ({label}) launched {ran}")
        print(f"[kernel] SKIFusedTNO backward ({label}) x ({b}, {n}, {d}), "
              f"r={r}, m={m} vs autograd through ref.ski_fused_tno_ref: "
              f"{report}; launches {ran}", flush=True)
        with reference_grad():
            ref_got, ran = grads()
        report = _grads_close(f"SKIFusedTNO REPRO_PALLAS_GRAD=0 ({label})",
                              ref_got, got, names)
        if ran != {**NO_SKI_LAUNCHES, "interp_reduce": 1,
                   "ski_fused_pass2": 1, "fwd": 1, "bwd_kernel": 0,
                   "bwd_ref": 1}:
            raise AssertionError(f"SKIFusedTNO under REPRO_PALLAS_GRAD=0 "
                                 f"({label}) launched {ran}")
        print(f"[kernel] SKIFusedTNO under REPRO_PALLAS_GRAD=0 ({label}) vs "
              f"the kernel backward: {report}; launches {ran}", flush=True)


#: windowed pass-2 shapes (label, b, n, d, r, m, left): the large-rank
#: path (ski-tnn-lm-wt103 at tno_rank 512) with causal and bidirectional
#: taps and their mirrors, r just past the dense ceiling and at the
#: windowed one, odd r (r % 4 != 0) with the 16-byte x copies (8 batch
#: rows, d % 4 == 0) and without, ragged, n < m, r = n, r = 2, one tap
WINDOW_SHAPES = (("path", 8, 512, 512, 512, 32, 0),
                 ("path bidirectional", 8, 512, 512, 512, 32, 16),
                 ("path mirrored", 8, 512, 512, 512, 32, 31),
                 ("path bidirectional mirrored", 8, 512, 512, 512, 32, 15),
                 ("r=513", 2, 4096, 16, 513, 32, 0),
                 ("r=4096", 2, 4096, 16, 4096, 32, 16),
                 ("r=181", 8, 512, 64, 181, 32, 16),
                 ("r=4097", 2, 4099, 16, 4097, 32, 3),
                 ("ragged", 3, 37, 45, 11, 4, 2), ("n<m", 2, 3, 5, 3, 4, 0),
                 ("r=n", 2, 64, 40, 64, 8, 3), ("r=2", 2, 40, 33, 2, 8, 3),
                 ("m=1", 2, 40, 33, 7, 1, 0))
WINDOWED_REPLACES = "src/repro/kernels/ski_fused.py:296"


def _window_tol(r: int) -> float:
    """1e-5 × max|plain| to r = 512, 1e-4 beyond, as the JAX package's
    tests/test_ski_large_r.py gates (sums of r terms in another order)."""
    return 1e-5 if r <= 512 else 1e-4


def _windowed_cost(b, n, d, r, m):
    """(bytes, Gram flops, conv and expansion flops) of ski_windowed_pass2:
    x, z, the (d, 2r - 1) coefficients and f read once, y written once;
    the Gram 2·b·d·r², the conv 2·b·n·d·m, the expansion 2·2·b·n·d."""
    nbytes = 4 * (2 * b * n * d + b * r * d + d * (2 * r - 1) + d * m)
    return nbytes, 2 * b * d * r * r, 2 * b * d * (n * m + 2 * n)


def _windowed_entry(label, x, z, coef, f, left, peaks):
    """ski_windowed_pass2 against the plain rfft Gram and expansion, and
    against itself: two calls give the same bits. The Gram is 2·b·d·r²
    flops (the windows of neighbouring tiles overlap by a few rows more),
    run on the tensor cores as three TF32 products (3xTF32), so it is
    priced at three times that over the TF32 peak; the conv (2·b·n·d·m)
    and the expansion (2·2·b·n·d) at the fp32 peak on the CUDA cores,
    which run beside the tensor cores. x, z, the coefficients and f read
    once, y written once. The printed line keeps each term of the bound and
    the all-CUDA-core figure (every flop at the fp32 peak, the bound
    before the Gram moved to the tensor cores) for the record."""
    from repro_torch.kernels import ref, ski_fused
    b, n, d = x.shape
    r, m = z.shape[1], f.shape[1]

    def plain():
        return ref.ski_expand_pass2_ref(
            x, ref.toeplitz_gram_matvec_ref(coef, z), f, True, left=left)

    def kernel():
        return ski_fused.ski_windowed_pass2(x, z, coef, f, True, left=left)
    got = kernel()
    if not torch.equal(got, kernel()):
        raise AssertionError(f"ski_windowed_pass2 {label}: two calls differ")
    nbytes, gram, rest = _windowed_cost(b, n, d, r, m)
    e = _kernel_entry(
        "ski_windowed_pass2", WINDOWED_REPLACES, got, plain(), kernel, plain,
        None, nbytes=nbytes, nops=((3 * gram, peaks[2], "tensor cores"),
                                   (rest, peaks[1], "cuda cores")),
        peaks=peaks, tol=_window_tol(r), source=SKI_SRC)
    print(f"[kernel] ski_windowed_pass2 {label} x ({b}, {n}, {d}), r={r}, "
          f"m={m}, left={left}, band_max "
          f"{os.environ.get('REPRO_SKI_BAND_MAX') or 'default'}: {e}; "
          f"beside the bound: bytes {nbytes / peaks[0] * 1e3:.5f} ms, "
          f"Gram on the tensor cores {3 * gram / peaks[2] * 1e3:.5f} ms, "
          f"conv and expansion on the CUDA cores "
          f"{rest / peaks[1] * 1e3:.5f} ms, all at the fp32 peak "
          f"{(gram + rest) / peaks[1] * 1e3:.5f} ms", flush=True)
    return e


def _expand_entry(label, x, z2, f, left, peaks):
    """ski_expand_pass2 against the plain expansion: x, z2, f read once, y
    written once; 2·b·n·d·m conv and 2·2·b·n·d expansion flops."""
    from repro_torch.kernels import ref, ski_fused
    b, n, d = x.shape
    r, m = z2.shape[1], f.shape[1]
    e = _kernel_entry(
        "ski_expand_pass2", WINDOWED_REPLACES,
        ski_fused.ski_expand_pass2(x, z2, f, True, left=left),
        ref.ski_expand_pass2_ref(x, z2, f, True, left=left),
        lambda: ski_fused.ski_expand_pass2(x, z2, f, True, left=left),
        lambda: ref.ski_expand_pass2_ref(x, z2, f, True, left=left), None,
        nbytes=4 * (2 * x.numel() + z2.numel() + f.numel()),
        nops=2 * b * d * (n * m + 2 * n), peaks=peaks, tol=_window_tol(r),
        source=SKI_SRC)
    print(f"[kernel] ski_expand_pass2 {label} x ({b}, {n}, {d}), r={r}, "
          f"m={m}, left={left}: {e}", flush=True)
    return e


def _windowed_vs_fp64(x, z, coef, f, left) -> None:
    """The windowed kernel and the fp32 plain version (rfft Gram) against a
    float64 version (dense Gram, dense W, shifted adds), so that the
    kernel's own error shows apart from the FFT's round-off: the kernel
    within 1e-5 × max."""
    from repro_torch.core import ski, toeplitz
    from repro_torch.kernels import ref, ski_fused
    b, n, d = x.shape
    r, m = z.shape[1], f.shape[1]
    z2 = torch.einsum("dst,btd->bsd",
                      toeplitz.dense_toeplitz(coef.double(), r), z.double())
    lo, w_lo, _ = ski.make_inducing(n, r, x.device)
    want = torch.einsum("nr,brd->bnd",
                        ref.dense_interp_matrix(lo, w_lo, r).double(), z2)
    xp = torch.nn.functional.pad(x.double(), (0, 0, m - 1 - left, left))
    for k in range(m):
        want += xp[:, m - 1 - k:m - 1 - k + n] * f[:, k].double()
    scale = float(want.abs().max())
    got = ski_fused.ski_windowed_pass2(x, z, coef, f, True, left=left)
    plain = ref.ski_expand_pass2_ref(
        x, ref.toeplitz_gram_matvec_ref(coef, z), f, True, left=left)
    err = float((got.double() - want).abs().max())
    perr = float((plain.double() - want).abs().max())
    print(f"[kernel] ski_windowed_pass2 x ({b}, {n}, {d}), r={r}, left={left} "
          f"vs float64: kernel max abs err {err:.3e}, fp32 plain (rfft) "
          f"{perr:.3e} (scale {scale:.3e}, limit {1e-5 * scale:.3e})",
          flush=True)
    if not err <= 1e-5 * scale:
        raise AssertionError(f"ski_windowed_pass2 vs float64: {err}")


def phase_window_kernels(peaks, device="cuda") -> dict:
    """ski_windowed_pass2 and ski_expand_pass2 against their plain versions
    at WINDOW_SHAPES; the windowed one also under REPRO_SKI_BAND_MAX=16
    (a tile then takes a window of 16 rows: many tiles, many chunks) and
    against float64, the expand one also at n = r = 8192. Returns the
    entries at the path's shape."""
    g = torch.Generator(device=device).manual_seed(7)
    out = {}
    for label, b, n, d, r, m, left in WINDOW_SHAPES:
        x = torch.randn(b, n, d, device=device, generator=g)
        z = torch.randn(b, r, d, device=device, generator=g)
        coef = torch.randn(d, 2 * r - 1, device=device,
                           generator=g) / math.sqrt(r)
        f = torch.randn(d, m, device=device, generator=g)
        entries = {"ski_windowed_pass2": _windowed_entry(label, x, z, coef, f,
                                                         left, peaks),
                   "ski_expand_pass2": _expand_entry(label, x, z, f, left,
                                                     peaks)}
        if label == "path":
            out.update(entries)
            _windowed_vs_fp64(x, z, coef, f, left)
        if label in ("path", "r=4096"):
            with mock.patch.dict(os.environ, {"REPRO_SKI_BAND_MAX": "16"}):
                _windowed_entry(label, x, z, coef, f, left, peaks)
    b, n, d, r, m = 2, 8192, 16, 8192, 32
    _expand_entry("n=r=8192", torch.randn(b, n, d, device=device, generator=g),
                  torch.randn(b, r, d, device=device, generator=g),
                  torch.randn(d, m, device=device, generator=g), m // 2,
                  peaks)
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


def _fd_counts():
    from repro_torch.kernels import fd_fused
    return dict(fd_fused.counters), dict(fd_fused.op_counters)


def _ski_counts(coef: bool = False):
    """SKI launches and the counts of SKIFusedTNO (dense Gram) or, with
    ``coef``, SKIFusedTNOCoef."""
    from repro_torch.kernels import ops, ski_vjp
    return ops.ski_counters(), dict(ski_vjp.coef_counters if coef
                                    else ski_vjp.counters)


#: kernel launches a layer makes in one training step (forward + backward):
#: the FD model, the SKI model on the dense Gram, and on the large-rank
#: "windowed" and "fft" routes
TRAIN_LAUNCHES = {"fd": {"hilbert_window": 3, "fd_mul": 2, "fd_khat_grad": 1},
                  "ski": {"interp_reduce": 3, "ski_fused_pass2": 2,
                          "gram_grad": 1, "conv_tap_grad": 1},
                  "ski_windowed": {"interp_reduce": 3,
                                   "ski_windowed_pass2": 2,
                                   "conv_tap_grad": 1},
                  "ski_fft": {"interp_reduce": 3, "ski_expand_pass2": 2,
                              "conv_tap_grad": 1}}
TRAIN_TAGS = {"fd": "[train]", "ski": "[ski-train]",
              "ski_windowed": "[large-r train]",
              "ski_fft": "[large-r fft train]"}


def phase_train(cfg, device, steps: int, seq: int, batch: int,
                mixer: str = "fd") -> dict:
    """Returns the launch counts of the training run. The run is two
    ``Trainer.run`` calls on one model: steps 0..TRAIN_WARMUP-1, then a
    resume to ``steps``, whose wall (data, pre-step clone, step and
    logging, to a synchronise) gives the throughput. Every step must make
    TRAIN_LAUNCHES[mixer] launches a layer and one kernel backward a layer
    (none through the reference)."""
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.kernels import fd_fused, ops
    from repro_torch.runtime.trainer import Trainer, TrainerConfig
    model, opt, step_fn = _train_setup(cfg, device, 0, steps, warmup=5)
    data = DataConfig(vocab=cfg.vocab, seq_len=seq, global_batch=batch, seed=0)
    tag = TRAIN_TAGS[mixer]

    def trainer(total):
        return Trainer(TrainerConfig(total_steps=total, log_every=10), step_fn,
                       data, log=lambda line: print(line, flush=True))
    warm, timed = trainer(TRAIN_WARMUP), trainer(steps)
    torch.cuda.reset_peak_memory_stats(device)
    fd_fused.reset_counters()
    ops.reset_ski_counters()
    t0 = time.perf_counter()
    opt, _ = warm.run(model, opt)
    _sync(device)
    t1 = time.perf_counter()
    opt, end = timed.run(model, opt, TRAIN_WARMUP)
    _sync(device)
    t2 = time.perf_counter()
    launches, op_counts = (_fd_counts() if mixer == "fd"
                           else _ski_counts(coef=mixer != "ski"))
    peak = torch.cuda.max_memory_allocated(device)
    losses = [float(m["loss"])
              for m in warm.metrics_history + timed.metrics_history]
    step_ms = statistics.median(timed.step_seconds) * 1e3
    window = t2 - t1
    tok_s = (end - TRAIN_WARMUP) * batch * seq / window
    first_ms = [round(t * 1e3, 3) for t in warm.step_seconds]
    print(f"{tag} {cfg.name}: {end} AdamW steps of {batch} x {seq} tokens "
          f"in {t2 - t0:.3f} s (steps 0-{TRAIN_WARMUP - 1}: {t1 - t0:.3f} s, "
          f"train_step ms {first_ms}); steps {TRAIN_WARMUP}-{end - 1}: "
          f"{window:.3f} s, {window / (end - TRAIN_WARMUP) * 1e3:.3f} ms a "
          f"step, {tok_s:.0f} tokens/s (median train_step {step_ms:.3f} ms, "
          f"max {max(timed.step_seconds) * 1e3:.3f} ms); loss step 0 "
          f"{losses[0]:.6f}, step {end - 1} {losses[-1]:.6f} (mean of the "
          f"last 5 {statistics.mean(losses[-5:]):.6f}); "
          f"max_memory_allocated {peak} bytes ({peak / 2**30:.3f} GiB)",
          flush=True)
    per_step = {k: v / steps for k, v in launches.items()}
    ops_per_step = {k: v / steps for k, v in op_counts.items()}
    print(f"{tag} kernel launches per step {per_step}; differentiated "
          f"forwards and backwards per step {ops_per_step}", flush=True)
    if not all(math.isfinite(v) for v in losses) or len(losses) != steps:
        raise AssertionError(f"training losses {losses}")
    if not (statistics.mean(losses[-5:]) < losses[0]
            and losses[-1] < losses[0]):
        raise AssertionError(f"loss did not fall: {losses}")
    want = {k: TRAIN_LAUNCHES[mixer].get(k, 0) * cfg.n_layers
            for k in launches}
    want_ops = {"fwd": cfg.n_layers, "bwd_kernel": cfg.n_layers,
                "bwd_ref": 0}
    if end != steps or per_step != want or ops_per_step != want_ops:
        raise AssertionError(f"{steps} steps of {cfg.n_layers} layers made "
                             f"{per_step} launches and {ops_per_step} "
                             f"forwards/backwards a step, not {want} and "
                             f"{want_ops}")
    return launches


# ------------------------------------------------------------ SKI scoring
def _ski_batch(cfg, b: int, s: int, device):
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (b, s + 1))).to(device)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _standalone_wrappers_refuse_grad(device) -> None:
    """Each of the eight SKI kernel wrappers called on its own writes a
    tensor autograd cannot see, so on the card it refuses an input that
    requires grad (gradients go through the ops entries), before any
    launch."""
    from repro_torch.kernels import (interp_matvec, ops, short_conv,
                                     ski_fused, ski_grad)
    x = torch.randn(2, 16, 8, device=device)
    z = torch.randn(2, 4, 8, device=device)
    a = torch.randn(8, 4, 4, device=device)
    f = torch.randn(8, 3, device=device)
    req = lambda t: t.clone().requires_grad_()
    lo = torch.zeros(16, dtype=torch.int32, device=device)
    calls = {"interp_reduce": lambda: interp_matvec.interp_reduce(
                 req(x), None, None, 4),
             "interp_expand": lambda: interp_matvec.interp_expand(
                 req(z), lo, None),
             "short_conv": lambda: short_conv.short_conv(x, req(f), 1),
             "ski_fused_pass2": lambda: ski_fused.ski_fused_pass2(
                 x, z, req(a), f, True),
             "ski_windowed_pass2": lambda: ski_fused.ski_windowed_pass2(
                 x, z, req(torch.randn(8, 7, device=device)), f, True),
             "ski_expand_pass2": lambda: ski_fused.ski_expand_pass2(
                 req(x), z, f, False),
             "gram_grad": lambda: ski_grad.gram_grad(z, req(z)),
             "conv_tap_grad": lambda: ski_grad.conv_tap_grad(req(x), x, 3, 0)}
    ops.reset_ski_counters()
    for name, call in calls.items():
        try:
            call()
        except NotImplementedError:
            pass
        else:
            raise AssertionError(f"{name} accepted an input requiring grad")
    if any(ops.ski_counters().values()):
        raise AssertionError(f"a refused call launched {ops.ski_counters()}")
    print(f"[score] standalone {', '.join(calls)} refuse an input that "
          "requires grad on the card, no kernel launched", flush=True)


def _profile_forward(fwd, model, tokens, device, reps: int = 3,
                     tag: str = "[score]", kernels_of=()) -> dict:
    """Where a scoring forward's time goes: ``torch.profiler`` over
    ``reps`` forwards (traced, so the wall is inflated), the device-busy
    share of the wall and the kernels with the most device time. Returns
    the device ms a forward of the kernels whose names hold each of
    ``kernels_of``."""
    from torch.profiler import ProfilerActivity, profile
    _sync(device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fwd(model, tokens)
        _sync(device)
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3   # ms
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    print(f"{tag} traced: {reps} forwards, wall {wall * 1e3:.3f} ms, "
          f"device busy {busy:.3f} ms, idle share "
          f"{1 - busy / (wall * 1e3):.3f}; top kernels by device time: "
          + "; ".join(f"{e.key[:60]} {e.self_device_time_total / 1e3:.3f} "
                      f"ms x{e.count}" for e in top), flush=True)
    return {name: sum(e.self_device_time_total for e in kernels
                      if name in e.key) / 1e3 / reps
            for name in kernels_of}


def phase_ski_score(device, cfg=None, pass2: str = "ski_fused_pass2",
                    tag: str = "[score]") -> dict:
    """A full-width SKI scoring path: ``cfg`` (default ski-tnn-lm-wt103)
    must launch one ``interp_reduce`` and one ``pass2`` a layer and no
    other SKI kernel a forward. The default path also profiles a forward
    and checks the standalone wrappers' refusals. Returns its launch
    counts (one forward)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import make_forward
    from repro_torch.models.transformer import init_model, loss_fn
    default = cfg is None
    cfg = cfg or get_config("ski-tnn-lm-wt103")
    model = init_model(cfg, torch.Generator().manual_seed(0), device=device)
    batch = _ski_batch(cfg, SCORE_BATCH, SCORE_SEQ, device)
    fwd = make_forward(cfg)
    print(f"{tag} {cfg.name}: {cfg.n_layers} layers, d={cfg.d_model}, "
          f"r={cfg.tno_rank}, m={cfg.tno_filter}, vocab {cfg.vocab}, "
          f"{sum(p.numel() for p in model.parameters())} parameters; "
          f"{SCORE_BATCH} x {SCORE_SEQ} tokens", flush=True)
    fwd(model, batch["tokens"])                        # warm-up
    _sync(device)
    torch.cuda.reset_peak_memory_stats(device)
    ops.reset_ski_counters()
    logits = fwd(model, batch["tokens"])
    _sync(device)
    launches = ops.ski_counters()
    peak = torch.cuda.max_memory_allocated(device)
    if launches != {**NO_SKI_LAUNCHES, "interp_reduce": cfg.n_layers,
                    pass2: cfg.n_layers}:
        raise AssertionError(f"one SKI forward launched {launches}")
    if not (logits.shape == (SCORE_BATCH, SCORE_SEQ, cfg.vocab_padded)
            and bool(torch.isfinite(logits).all())):
        raise AssertionError(f"SKI logits {tuple(logits.shape)} not finite "
                             "or of the wrong shape")
    walls = []
    for _ in range(SCORE_REPS):
        t0 = time.perf_counter()
        fwd(model, batch["tokens"])
        _sync(device)
        walls.append(time.perf_counter() - t0)
    ms = statistics.median(walls) * 1e3
    with torch.no_grad():
        loss, _ = loss_fn(model, cfg, batch)
    if not math.isfinite(float(loss)):
        raise AssertionError(f"SKI eval loss {float(loss)}")
    print(f"{tag} make_forward {SCORE_BATCH}x{SCORE_SEQ}: median {ms:.3f} "
          f"ms of {SCORE_REPS} (min {min(walls) * 1e3:.3f}, max "
          f"{max(walls) * 1e3:.3f}), {SCORE_BATCH * SCORE_SEQ / ms * 1e3:.0f} "
          f"tokens/s; eval loss {float(loss):.6f}; launches per forward "
          f"{launches}; max_memory_allocated {peak} bytes "
          f"({peak / 2**30:.3f} GiB)", flush=True)
    if default:
        _profile_forward(fwd, model, batch["tokens"], device)
    # card vs CPU at full width on 1 x 512 tokens
    one = {k: v[:1] for k, v in batch.items()}
    cpu_model = init_model(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    want = fwd(cpu_model, one["tokens"].cpu())
    got = fwd(model, one["tokens"]).cpu()
    with torch.no_grad():
        want_loss = float(loss_fn(cpu_model, cfg,
                                  {k: v.cpu() for k, v in one.items()})[0])
        got_loss = float(loss_fn(model, cfg, one)[0])
    err, scale = float((got - want).abs().max()), float(want.abs().max())
    lerr = abs(got_loss - want_loss)
    print(f"{tag} card vs CPU, 1 x {SCORE_SEQ} tokens: logits max abs err "
          f"{err:.3e} (scale {scale:.3e}, limit 1e-4 x scale); loss "
          f"{got_loss:.6f} vs {want_loss:.6f}, err {lerr:.3e} (limit 1e-4)",
          flush=True)
    if not (err <= 1e-4 * scale and lerr <= 1e-4):
        raise AssertionError("card SKI scoring differs from the CPU's")
    if default:
        _standalone_wrappers_refuse_grad(device)
    return launches


def ski_vs_fd_op(device="cuda") -> None:
    """The paper's SKI-vs-FD comparison at the op level on this card:
    ``ops.ski_fused_tno`` against ``ops.fd_tno`` at x (8, 512, 512),
    forward only (recorded, not claimed)."""
    from repro_torch.core import ski, toeplitz
    from repro_torch.kernels import ops
    g = torch.Generator(device=device).manual_seed(2)
    b, n, d, r, m = 8, 512, 512, 64, 32
    x = torch.randn(b, n, d, device=device, generator=g)
    coef = toeplitz.causal_mask_coeffs(
        torch.randn(d, 2 * r - 1, device=device, generator=g), r)
    a = toeplitz.dense_toeplitz(coef, r).contiguous()
    f = torch.randn(d, m, device=device, generator=g)
    lo, w_lo, _ = ski.make_inducing(n, r, device)
    khat = torch.randn(d, n + 1, device=device, generator=g)
    with torch.inference_mode():
        t_ski = time_ms(lambda: ops.ski_fused_tno(x, a, f, lo, w_lo, r, True))
        t_fd = time_ms(lambda: ops.fd_tno(x, khat))
    print(f"[op] forward at x ({b}, {n}, {d}), r={r}, m={m}: ski_fused_tno "
          f"{t_ski:.5f} ms, fd_tno {t_fd:.5f} ms (ratio fd/ski "
          f"{t_fd / t_ski:.3f})", flush=True)


# ---------------------------------------------------------- ski unfused
#: the unfused SKI op's launches: forward, and forward + backward
UNFUSED_FWD = {**NO_SKI_LAUNCHES, "interp_reduce": 1, "interp_expand": 1,
               "short_conv": 1}
UNFUSED_STEP = {**NO_SKI_LAUNCHES, "interp_reduce": 2, "interp_expand": 2,
                "short_conv": 2, "conv_tap_grad": 1}
_UNFUSED_FUNCTIONS = ("ShortConv", "InterpReduce", "InterpExpand")


def _ski_tno(d, r, m, causal, device, seed=0, lam=0.99):
    """(TNOConfig with fused=False, SKI parameters drawn from ``seed``)."""
    from repro_torch.core import tno
    from repro_torch.nn.layers import reset_parameters
    cfg = tno.TNOConfig(d=d, variant="ski", causal=causal, lam=lam, rank=r,
                        filter_size=m, fused=False)
    params = tno.tno_init(cfg, device=device)
    reset_parameters(params, torch.Generator().manual_seed(seed))
    return cfg, params


def _unfused_plain(params, cfg, x):
    """The unfused SKI op through the kernels' plain versions (autograd
    differentiates it): reduce, short conv, FFT Gram, expand."""
    from repro_torch.core import tno, toeplitz
    from repro_torch.kernels import ref
    plan = tno.tno_plan(params, cfg, x.shape[1])
    lo, w_lo, r = plan["idx_lo"], plan["w_lo"], plan["r"]
    z = ref.interp_reduce_ref(x, lo, w_lo, r)
    z2 = toeplitz.toeplitz_matvec(plan["a_coef"][None], z.transpose(1, 2))
    return (ref.short_conv_ref(x, params.filt, cfg.causal)
            + ref.interp_expand_ref(z2.transpose(1, 2), lo, w_lo))


def _ski_grads(params, cfg, x, cot, fn=None):
    """(y, dx, dfilt, dvals) of Σ y·cot, y = ``fn`` (default: the op through
    ``tno_plan``/``tno_apply``, as a TNN block calls it)."""
    from repro_torch.core import tno
    if fn is None:
        y = tno.tno_apply(params, cfg, x,
                          plan=tno.tno_plan(params, cfg, x.shape[1]))
    else:
        y = fn(params, cfg, x)
    return (y.detach(), *torch.autograd.grad(
        y, (x, params.filt, params.rpe.vals), cot))


def phase_ski_unfused(device="cuda") -> dict:
    """The unfused SKI-TNO (``TNOConfig(variant="ski", fused=False)``)
    forward and backward at x (8, 512, 512) and ski-tnn-lm-wt103's SKI
    width (d=512, r=64, m=32, parameters from seed 0), causal and
    bidirectional: y and the gradients of Σ y·g for x, the taps and the
    RPE values against the fused op within 1e-4 × max (the fused-vs-unfused
    tier of tests/test_ski_fused.py: dense Gram against FFT Gram) and
    against autograd through the plain versions within 1e-5 × max (the
    fp32 tier); y against the same call on the CPU within 1e-5 × max|y|;
    the launches exactly UNFUSED_FWD / UNFUSED_STEP and one kernel backward
    each of ShortConv, InterpReduce and InterpExpand; under
    REPRO_PALLAS_GRAD=0 one reference backward each, no kernel launched
    in the backward and the same gradients. Returns the launches of the
    two forward + backward runs (the path's counts)."""
    import copy
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.core import tno
    from repro_torch.kernels import ops
    arch = get_config("ski-tnn-lm-wt103")
    b, n, d, r, m = 8, 512, arch.d_model, arch.tno_rank, arch.tno_filter
    g = torch.Generator(device=device).manual_seed(4)
    x = torch.randn(b, n, d, device=device, generator=g, requires_grad=True)
    cot = torch.randn(b, n, d, device=device, generator=g)
    names = ("y", "dx", "dfilt", "dvals")
    path = {k: 0 for k in UNFUSED_STEP}
    for causal in (True, False):
        tag = "causal" if causal else "bidirectional"
        cfg, params = _ski_tno(d, r, m, causal, device, lam=arch.tno_lam)
        ops.reset_ski_counters()
        plan = tno.tno_plan(params, cfg, n)
        y = tno.tno_apply(params, cfg, x, plan=plan)
        fwd = ops.ski_counters()
        grads = torch.autograd.grad(y, (x, params.filt, params.rpe.vals), cot)
        step, op_counts = ops.ski_counters(), ops.ski_op_counters()
        got = (y.detach(), *grads)
        for k, v in step.items():
            path[k] += v
        want_ops = {name: {"fwd": 1, "bwd_kernel": 1, "bwd_ref": 0}
                    for name in _UNFUSED_FUNCTIONS}
        want_ops["SKIFusedTNO"] = want_ops["SKIFusedTNOCoef"] = {
            "fwd": 0, "bwd_kernel": 0, "bwd_ref": 0}
        if fwd != UNFUSED_FWD or step != UNFUSED_STEP or op_counts != want_ops:
            raise AssertionError(f"unfused SKI ({tag}) launched {fwd} forward,"
                                 f" {step} in all, Functions {op_counts}")
        print(f"[unfused] {tag} x ({b}, {n}, {d}), r={r}, m={m}: launches "
              f"forward {fwd}, forward + backward {step}; Functions "
              f"{op_counts}", flush=True)
        fused = _ski_grads(params, dataclasses.replace(cfg, fused=True), x,
                           cot)
        report = _grads_close(f"unfused vs fused ({tag})", got, fused, names,
                              tol=1e-4)
        print(f"[unfused] {tag} vs the fused op: {report}", flush=True)
        plain = _ski_grads(params, cfg, x, cot, fn=_unfused_plain)
        report = _grads_close(f"unfused vs plain ({tag})", got, plain, names)
        print(f"[unfused] {tag} vs autograd through the plain versions: "
              f"{report}", flush=True)
        with torch.no_grad():
            cpu_params = copy.deepcopy(params).cpu()
            want = tno.tno_apply(cpu_params, cfg, x.detach().cpu())
        report = _grads_close(f"unfused card vs CPU ({tag})",
                              (y.detach().cpu(),),
                              (want,), ("y",))
        print(f"[unfused] {tag} card vs CPU: {report}", flush=True)
        ops.reset_ski_counters()
        with reference_grad():
            ref_got = _ski_grads(params, cfg, x, cot)
        step, op_counts = ops.ski_counters(), ops.ski_op_counters()
        want_ops = {name: {"fwd": 1, "bwd_kernel": 0, "bwd_ref": 1}
                    for name in _UNFUSED_FUNCTIONS}
        want_ops["SKIFusedTNO"] = want_ops["SKIFusedTNOCoef"] = {
            "fwd": 0, "bwd_kernel": 0, "bwd_ref": 0}
        if step != UNFUSED_FWD or op_counts != want_ops:
            raise AssertionError(f"unfused SKI ({tag}) under "
                                 f"REPRO_PALLAS_GRAD=0 launched {step}, "
                                 f"Functions {op_counts}")
        report = _grads_close(f"unfused REPRO_PALLAS_GRAD=0 ({tag})",
                              ref_got, got, names)
        print(f"[unfused] {tag} under REPRO_PALLAS_GRAD=0 vs the kernel "
              f"backward: {report}; launches {step} (the forward's only)",
              flush=True)
    return path


def ski_unfused_times(device="cuda") -> None:
    """The repo's SKI benchmark shapes (benchmarks/bench_ski_components.py:
    b=4, d=64, r=64, m=32, bidirectional): fused and unfused forward (plan
    built beforehand) and grad of Σy for x, the taps and the RPE values
    (plan built inside) at n = 2048 and 8192; Figure 11's three forwards
    at n = 2048 (both components through the unfused op, low rank only:
    reduce, FFT Gram, expand; sparse only: short_conv). Recorded, not
    claimed."""
    import dataclasses
    from repro_torch.core import ski, tno, toeplitz
    from repro_torch.kernels import ops
    b, d, r, m = 4, 64, 64, 32
    g = torch.Generator(device=device).manual_seed(5)
    cfg_u, params = _ski_tno(d, r, m, False, device)
    cfg_f = dataclasses.replace(cfg_u, fused=True)
    leaves = (params.filt, params.rpe.vals)
    times = {}
    for n in (2048, 8192):
        x = torch.randn(b, n, d, device=device, generator=g)
        xg = x.clone().requires_grad_()
        for name, cfg in (("fused", cfg_f), ("unfused", cfg_u)):
            with torch.inference_mode():
                plan = tno.tno_plan(params, cfg, n)
                times[f"n{n}/{name}_fwd"] = time_ms(
                    lambda: tno.tno_apply(params, cfg, x, plan=plan))

            def grad():
                y = tno.tno_apply(params, cfg, xg,
                                  plan=tno.tno_plan(params, cfg, n))
                return torch.autograd.grad(y.sum(), (xg, *leaves))
            times[f"n{n}/{name}_grad"] = time_ms(grad)
    n = 2048
    x = torch.randn(b, n, d, device=device, generator=g)
    lo, w_lo, h = ski.make_inducing(n, r, device)
    scfg = cfg_u.ski_cfg()

    def low_only():
        z = ops.interp_reduce(x, lo, w_lo, r)
        a_coef = ski.inducing_gram_coeffs(params, scfg, r, h)
        z2 = toeplitz.toeplitz_matvec(a_coef[None], z.transpose(1, 2))
        return ops.interp_expand(z2.transpose(1, 2).contiguous(), lo, w_lo)
    with torch.inference_mode():
        times["fig11/both"] = time_ms(lambda: tno.tno_apply(params, cfg_u, x))
        times["fig11/low_rank_only"] = time_ms(low_only)
        times["fig11/sparse_only"] = time_ms(
            lambda: ops.short_conv(x, params.filt, False))
    print(f"[unfused] times ms (b={b}, d={d}, r={r}, m={m}, bidirectional, "
          f"CUDA-event medians of 50, L2 evicted): {json.dumps(times)}",
          flush=True)


def causal_ski_vs_fd(device="cuda") -> None:
    """Appendix B at benchmarks/bench_appendix_b.py's shape (b=2, d=32,
    m=16, r=64, n=2048): ``causal_ski_lowrank`` against the masked dense
    oracle tril(W A Wᵀ) x in fp64 within 1e-5 × max (a cumulative sum of
    2,048 fp32 rows), timed beside the causal FD-TNO (its RPE included, as
    the benchmark times it). Recorded, not claimed."""
    from repro_torch.core import fd, ski, toeplitz
    from repro_torch.core.causal_ski import causal_ski_lowrank
    from repro_torch.kernels import ref
    from repro_torch.nn.layers import reset_parameters
    b, n, d, r, m = 2, 2048, 32, 64, 16
    scfg = ski.SKIConfig(d, rank=r, filter_size=m)
    sparams = ski.ski_init(scfg, device=device)
    reset_parameters(sparams, torch.Generator().manual_seed(0))
    fcfg = fd.FDConfig(d)
    fparams = fd.fd_init(fcfg, device=device)
    reset_parameters(fparams, torch.Generator().manual_seed(0))
    x = torch.randn(b, n, d, device=device,
                    generator=torch.Generator(device=device).manual_seed(6))
    with torch.inference_mode():
        y = causal_ski_lowrank(sparams, scfg, x)
        lo, w_lo, h = ski.make_inducing(n, r, device)
        w = ref.dense_interp_matrix(lo, w_lo, r).double()
        a = toeplitz.dense_toeplitz(
            ski.inducing_gram_coeffs(sparams, scfg, r, h), r).double()
        t_masked = torch.tril(torch.einsum("nr,drs,ms->dnm", w, a, w))
        want = torch.einsum("dnm,bmd->bnd", t_masked, x.double())
        report = _grads_close("causal_ski_lowrank vs the masked oracle",
                              (y.double(),), (want,), ("y",))
        t_ski = time_ms(lambda: causal_ski_lowrank(sparams, scfg, x))
        t_fd = time_ms(lambda: fd.fd_tno_apply(fparams, fcfg, x))
    print(f"[unfused] Appendix B x ({b}, {n}, {d}), r={r}: "
          f"causal_ski_lowrank vs tril(W A W^T) x: {report}; "
          f"causal_ski_lowrank {t_ski:.5f} ms, causal fd_tno_apply "
          f"{t_fd:.5f} ms (ratio {t_ski / t_fd:.3f})", flush=True)


# ------------------------------------------------------------ ski large-r
LARGE_RANK = 512
LARGE_FFT_STEPS = 10                  # the "fft" route's training steps


def _large_r_cfg():
    """ski-tnn-lm-wt103 at tno_rank 512: at d = 512 its (d, r, r) Gram is
    512 MB, over the dense route's 64 MB, so backend.ski_rank_variant sends
    it to "windowed" (and to "fft" under REPRO_SKI_WINDOWED_RMAX=256)."""
    import dataclasses
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("ski-tnn-lm-wt103"),
                               tno_rank=LARGE_RANK)


def phase_large_r(device="cuda") -> dict:
    """The full-width ski-tnn-lm-wt103 at tno_rank 512 through the model's
    entry points: scoring 8 × 512 tokens (6 interp_reduce + 6
    ski_windowed_pass2 a forward, card vs CPU on 1 × 512) and 30 training
    steps (18 / 12 / 6 launches and 6 kernel backwards of SKIFusedTNOCoef
    a step); then the same scoring and LARGE_FFT_STEPS steps on the "fft"
    route, ski_expand_pass2 in place of ski_windowed_pass2. Returns the
    four paths' launch counts."""
    from repro_torch.kernels import backend
    cfg = _large_r_cfg()
    r = min(cfg.tno_rank, SCORE_SEQ)
    paths = {}
    if backend.ski_rank_variant(r, cfg.d_model) != "windowed":
        raise AssertionError(f"r={r}, d={cfg.d_model} is not routed windowed")
    paths["large_r_score"] = phase_ski_score(
        device, cfg, "ski_windowed_pass2", "[large-r score]")
    paths["large_r_train"] = phase_train(cfg, device, TRAIN_STEPS, TRAIN_SEQ,
                                         TRAIN_BATCH, mixer="ski_windowed")
    with mock.patch.dict(os.environ, {"REPRO_SKI_WINDOWED_RMAX": "256"}):
        if backend.ski_rank_variant(r, cfg.d_model) != "fft":
            raise AssertionError(f"r={r} is not routed to fft")
        paths["large_r_fft_score"] = phase_ski_score(
            device, cfg, "ski_expand_pass2", "[large-r fft score]")
        paths["large_r_fft_train"] = phase_train(
            cfg, device, LARGE_FFT_STEPS, TRAIN_SEQ, TRAIN_BATCH,
            mixer="ski_fft")
    return paths


def check_coef_backward(device="cuda") -> None:
    """SKIFusedTNOCoef at x (8, 512, 512), r = 512, m = 32, both variants,
    causal and bidirectional taps: (dx, dcoef, df) against autograd through
    ref.ski_fused_tno_coef_ref within 1e-5 × max (the fp32 tier), with 3
    interp_reduce, 2 pass-2 and 1 conv_tap_grad launches and one kernel
    backward; under REPRO_PALLAS_GRAD=0 one reference backward, the
    forward's launches only and the same gradients."""
    from repro_torch.core import ski
    from repro_torch.kernels import ops, ref, ski_vjp
    g = torch.Generator(device=device).manual_seed(8)
    b, n, d, r, m = 8, 512, 512, LARGE_RANK, 32
    names = ("dx", "dcoef", "df")
    lo, w_lo, _ = ski.make_inducing(n, r, device)
    for variant, pass2 in (("windowed", "ski_windowed_pass2"),
                           ("fft", "ski_expand_pass2")):
        for causal in (True, False):
            tag = f"{variant}, {'causal' if causal else 'bidirectional'}"
            x = torch.randn(b, n, d, device=device, generator=g,
                            requires_grad=True)
            coef = (torch.randn(d, 2 * r - 1, device=device, generator=g)
                    / math.sqrt(r)).requires_grad_()
            f = torch.randn(d, m, device=device, generator=g,
                            requires_grad=True)
            cot = torch.randn(b, n, d, device=device, generator=g)

            def grads():
                ops.reset_ski_counters()
                out = torch.autograd.grad(ops.ski_fused_tno_coef(
                    x, coef, f, lo, w_lo, r, causal, variant), (x, coef, f),
                    cot)
                return out, dict(ops.ski_counters(), **ski_vjp.coef_counters)
            got, ran = grads()
            want = torch.autograd.grad(ref.ski_fused_tno_coef_ref(
                x, coef, f, lo, w_lo, r, causal), (x, coef, f), cot)
            report = _grads_close(f"SKIFusedTNOCoef backward ({tag})", got,
                                  want, names)
            if ran != {**NO_SKI_LAUNCHES, "interp_reduce": 3, pass2: 2,
                       "conv_tap_grad": 1, "fwd": 1, "bwd_kernel": 1,
                       "bwd_ref": 0}:
                raise AssertionError(f"SKIFusedTNOCoef ({tag}) launched {ran}")
            print(f"[large-r] SKIFusedTNOCoef backward ({tag}) x ({b}, {n}, "
                  f"{d}), r={r}, m={m} vs autograd through "
                  f"ref.ski_fused_tno_coef_ref: {report}; launches {ran}",
                  flush=True)
            with reference_grad():
                ref_got, ran = grads()
            report = _grads_close(f"SKIFusedTNOCoef REPRO_PALLAS_GRAD=0 "
                                  f"({tag})", ref_got, got, names)
            if ran != {**NO_SKI_LAUNCHES, "interp_reduce": 1, pass2: 1,
                       "fwd": 1, "bwd_kernel": 0, "bwd_ref": 1}:
                raise AssertionError(f"SKIFusedTNOCoef under "
                                     f"REPRO_PALLAS_GRAD=0 ({tag}) launched "
                                     f"{ran}")
            print(f"[large-r] SKIFusedTNOCoef under REPRO_PALLAS_GRAD=0 "
                  f"({tag}) vs the kernel backward: {report}; launches {ran}",
                  flush=True)


def _ski_op_times(d, r, n, b, variants, device, seed) -> dict:
    """Forward (plan built inside, under inference mode) and grad of Σy for
    the RPE values and the taps of the bidirectional SKI op on each of
    ``variants``, as benchmarks/bench_ski_components.py:_large_r times
    them: SKIConfig(d, rank r, filter_size 32), x (b, n, d) from ``seed``."""
    from repro_torch.core import ski
    from repro_torch.nn.layers import reset_parameters
    cfg = ski.SKIConfig(d, rank=r, filter_size=32)
    params = ski.ski_init(cfg, device=device)
    reset_parameters(params, torch.Generator().manual_seed(0))
    x = torch.randn(b, n, d, device=device,
                    generator=torch.Generator(device=device).manual_seed(seed))
    times = {}
    for v in variants:
        def fwd():
            return ski.ski_tno_apply(params, cfg, x, plan=ski.ski_plan(
                params, cfg, n, variant=v)).sum()
        with torch.inference_mode():
            times[f"{v}_fwd"] = time_ms(fwd)
        times[f"{v}_grad"] = time_ms(lambda: torch.autograd.grad(
            fwd(), (params.rpe.vals, params.filt)))
    return times


def large_r_times(device="cuda") -> None:
    """Recorded, not claimed: at bench_ski_components.py:_large_r's shapes
    (b=2, d=16, n=8192, m=32, bidirectional) the coefficient op on the
    policy's route (windowed to r = 4096, fft beyond) beside the dense op
    up to the dense route's rank ceiling; then dense and
    windowed at the dense ceiling of d = 512 (r = 181, the last dense
    rank, and 182; b = 8, n = 512), the op and its pass-2 kernels."""
    from repro_torch.core import toeplitz
    from repro_torch.kernels import backend, ski_fused
    times = {}
    for r in (64, 512, 2048, 8192):
        coef = "windowed" if r <= backend.ski_windowed_rank_max() else "fft"
        dense = r <= backend.ski_dense_rank_max()
        times[f"r{r}"] = _ski_op_times(16, r, 8192, 2, (coef,) + (
            ("dense",) if dense else ()), device, seed=9)
        if not dense:
            times[f"r{r}"]["dense"] = (
                f"not run: past the dense route's rank ceiling "
                f"({backend.ski_dense_rank_max()}); its Gram alone would be "
                f"{16 * r * r * 4} bytes")
    g = torch.Generator(device=device).manual_seed(11)
    b, n, d, m = 8, 512, 512, 32
    x = torch.randn(b, n, d, device=device, generator=g)
    f = torch.randn(d, m, device=device, generator=g)
    for r in (181, 182):
        times[f"d512 r{r}"] = _ski_op_times(d, r, n, b, ("dense", "windowed"),
                                            device, seed=10)
        # the two pass-2 kernels alone, the dense one past the policy's
        # ceiling too
        z = torch.randn(b, r, d, device=device, generator=g)
        coef = torch.randn(d, 2 * r - 1, device=device,
                           generator=g) / math.sqrt(r)
        a = toeplitz.dense_toeplitz(coef, r).contiguous()
        times[f"d512 r{r}"]["kernel ski_fused_pass2"] = time_ms(
            lambda: ski_fused.ski_fused_pass2(x, z, a, f, True))
        times[f"d512 r{r}"]["kernel ski_windowed_pass2"] = time_ms(
            lambda: ski_fused.ski_windowed_pass2(x, z, coef, f, True))
    print(f"[large-r] times ms (CUDA-event medians of 50, L2 evicted; "
          f"forward with the plan, grad of sum(y) for the RPE values and "
          f"taps; the pass-2 kernels alone at x (8, 512, 512)): "
          f"{json.dumps(times)}", flush=True)


# --------------------------------------------------------------- phase 7
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
    print(f"[check] smoke {small.name} training card vs CPU: step-0 grads "
          f"worst leaf "
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
    print(f"[check] {small.name}: checkpoint at step 2, restored into a "
          f"fresh model "
          f"(resumed at {start}, ended at {end}): parameters bitwise equal "
          f"to an uninterrupted run: {same}; moments: {same_opt}", flush=True)
    if not (start == 2 and end == 3 and same and same_opt):
        raise AssertionError("the resumed run differs from the uninterrupted")


def phase_check(cfg, model, prompt_len: int, seqs, device) -> None:
    from repro_torch.configs import get_config, reduce_for_smoke
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
    ski_small = reduce_for_smoke(get_config("ski-tnn-lm-wt103"))
    print(f"[check] smoke SKI model: {ski_small.n_layers} layers, "
          f"d={ski_small.d_model}, r={ski_small.tno_rank}, "
          f"m={ski_small.tno_filter}", flush=True)
    check_train_card_vs_cpu(ski_small, device)
    check_checkpoint_resume(ski_small, device)


# ------------------------------------------------------------ mamba phases
#: ssd_scan checks: (label, bt, n, h, p, g, s, chunk), the path shape first
SSD_SHAPES = (("path", 8, 2048, 80, 64, 1, 128, 128),
              ("ragged n=2000", 2, 2000, 80, 64, 1, 128, 128),
              ("n<q n=100", 2, 100, 80, 64, 1, 128, 128),
              ("n=1", 2, 1, 80, 64, 1, 128, 128),
              ("g=2", 2, 128, 4, 16, 2, 16, 32),
              ("g=4 ragged", 1, 96, 4, 8, 4, 8, 32),
              ("smoke", 2, 37, 8, 32, 1, 16, 16),
              # rows of 12 and 24 bytes: the bf16 kernel's element loads
              ("p=6 s=12", 1, 70, 4, 6, 2, 12, 32))


def _ssd_inputs(bt, n, h, p, g, s, dtype, gen, device="cuda"):
    """x, B, C ~ N(0, 1) in ``dtype``; dt = softplus(N(0, 1) - 3) (a decay
    that reaches across chunks), a = -exp(0.1 N(0, 1)), D = 1 + 0.1 N(0, 1),
    fp32."""
    def rnd(*shape):
        return torch.randn(*shape, device=device, generator=gen)
    x = rnd(bt, n, h, p).to(dtype)
    dt = torch.nn.functional.softplus(rnd(bt, n, h) - 3.0)
    a = -torch.exp(0.1 * rnd(h))
    b, c = rnd(bt, n, g, s).to(dtype), rnd(bt, n, g, s).to(dtype)
    return x, dt, a, b, c, 1.0 + 0.1 * rnd(h)


def _ssd_cost(bt, n, h, p, g, s, q, elem):
    """(bytes, chunked flops of the three products with an fp32 operand,
    chunked flops of C Bᵀ, the fewer of chunked and sequential flops) of
    the SSD scan: x, dt, a, B, C, D read once and y written once.
    Chunked: per head and chunk of r rows, r (r + 1) p for the
    lower-triangular scores · X, 2 r s p for C Sᵀ and 2 p r s for the state
    update (TF32 on the tensor cores), plus r (r + 1) s for the lower
    triangle of C Bᵀ once a group (bf16): matrix products, the bound on
    tensor cores. Sequential: 5 p s per position and head (decay, outer
    product and add into S, then C S): rank-1 updates, the fewer on the
    CUDA cores."""
    nbytes = (elem * (2 * bt * n * h * p + 2 * bt * n * g * s)
              + 4 * (bt * n * h + 2 * h))
    rows = [min(q, n - i) for i in range(0, n, q)]
    fp32_operand = sum((r * (r + 1) * p + 4 * r * s * p) * bt * h
                       for r in rows)
    cb = sum(r * (r + 1) * s * bt * g for r in rows)
    return (nbytes, fp32_operand, cb,
            min(fp32_operand + cb, 5 * p * s * n * bt * h))


def check_ssd_scan(peaks, device="cuda", g=None, reps=10) -> dict:
    """ssd_scan against ``ssd_chunked.ssd_scan_chunked`` on the same inputs
    at SSD_SHAPES, fp32 within 1e-5 × max|plain| (fp32 sums in another
    order) and bf16 within BF16_TOL × max|plain| (TF32 products, then one
    rounding to bf16 on each side: at most one bf16 ulp, 2^-7 × max, plus
    about 5e-4 × max; ``tests/test_torch_ssd_scan.py``), fp32 also against
    ``ref.ssd_scan_ref`` in float64 (1e-5 × max); both instances timed at
    the path shape (median of ``reps``), the bf16 one against the tensor
    cores' peaks (C Bᵀ in bf16, the other products in TF32) and the fp32
    one against the CUDA cores' fp32 peak. Returns the path shape's
    entries, ``ssd_scan`` (bf16) and ``ssd_scan_f32``. Inputs come from
    ``g`` (a generator seeded 3 when None)."""
    from repro_torch.kernels import ref, ssd_chunked, ssd_scan
    if g is None:
        g = torch.Generator(device=device).manual_seed(3)
    out = {}
    for label, bt, n, h, p, gr, s, q in SSD_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            args = _ssd_inputs(bt, n, h, p, gr, s, dtype, g, device)
            tol = BF16_TOL if dtype == torch.bfloat16 else 1e-5
            got = ssd_scan.ssd_scan(*args, chunk=q)
            want = ssd_chunked.ssd_scan_chunked(*args, chunk=q)
            if got.dtype != dtype or got.shape != (bt, n, h, p):
                raise AssertionError(f"ssd_scan gave {got.dtype} "
                                     f"{tuple(got.shape)}")
            if label == "path" and dtype == torch.bfloat16:
                nbytes, tf32_ops, bf16_ops, _ = _ssd_cost(bt, n, h, p, gr, s,
                                                          q, 2)
                out["ssd_scan"] = _kernel_entry(
                    "ssd_scan", "src/repro/kernels/ssd_scan.py:82", got,
                    want, lambda: ssd_scan.ssd_scan(*args, chunk=q),
                    lambda: ssd_chunked.ssd_scan_chunked(*args, chunk=q),
                    None, nbytes=nbytes,
                    nops=((tf32_ops, peaks[2], "tensor cores"),
                          (bf16_ops, peaks[3], "tensor cores")),
                    peaks=peaks, tol=tol, source=SSD_SRC, reps=reps)
                report = f"{out['ssd_scan']}"
            elif label == "path":
                nbytes, _, _, fewer = _ssd_cost(bt, n, h, p, gr, s, q, 4)
                e = out["ssd_scan_f32"] = _kernel_entry(
                    "ssd_scan_f32", "src/repro/kernels/ssd_scan.py:82", got,
                    want, lambda: ssd_scan.ssd_scan(*args, chunk=q),
                    lambda: ssd_chunked.ssd_scan_chunked(*args, chunk=q),
                    None, nbytes=nbytes, nops=fewer, peaks=peaks, tol=tol,
                    source=SSD_SRC, reps=reps)
                report = (f"fp32 {e['ms']:.4f} ms (plain {e['plain_ms']:.4f}"
                          f"; bound {e['bound_ms']:.4f} by {e['bound_by']} "
                          f"at fp32 on the CUDA cores); max abs err "
                          f"{e['max_abs_err']:.3e} at {e['scale']:.3f}")
            else:
                report = _grads_close(f"ssd_scan {label} {dtype}",
                                      [got.double()], [want.double()],
                                      ["y"], tol)
            if dtype == torch.float32:
                f64 = ref.ssd_scan_ref(*(t.double() for t in args))
                report += "; vs float64 ssd_scan_ref " + _grads_close(
                    f"ssd_scan {label} vs float64", [got.double()], [f64],
                    ["y"], 1e-5)
            print(f"[mamba kernel] ssd_scan {label} x ({bt}, {n}, {h}, {p}) "
                  f"{dtype}, g={gr}, s={s}, chunk={q}: {report}", flush=True)
    return out


def phase_mamba_kernels(peaks, device="cuda") -> dict:
    """:func:`check_ssd_scan`; the bf16 short_conv at Mamba's conv shape
    and at the SKI path's shape with its four offsets; the kernels'
    refusals. Returns the entries at the path shapes (bf16, the model's
    dtype)."""
    from repro_torch.kernels import ssd_scan
    g = torch.Generator(device=device).manual_seed(3)
    out = {"ssd_scan": check_ssd_scan(peaks, device, g)["ssd_scan"]}
    ssd_scan.reset_counters()
    # the bf16 short conv: Mamba's conv, then the SKI path's offsets
    x = torch.randn(MAMBA_BATCH, MAMBA_SEQ, 5376, device=device,
                    generator=g).bfloat16()
    f = (0.3 * torch.randn(5376, 4, device=device, generator=g)).bfloat16()
    out["short_conv_bf16"] = _short_conv_entry(
        "mamba", x, f, 0, peaks, tol=BF16_TOL, name="short_conv_bf16")
    x = torch.randn(8, 512, 512, device=device, generator=g).bfloat16()
    f = torch.randn(512, 32, device=device, generator=g).bfloat16()
    for left in (0, 16, 31, 15):
        _short_conv_entry("ski path", x, f, left, peaks, tol=BF16_TOL,
                          name="short_conv_bf16")
    _mamba_kernels_refuse(device)
    return out


def _mamba_kernels_refuse(device) -> None:
    """On the card ssd_scan refuses an input that requires grad (the kernel
    is forward-only, as the JAX one), and the ShortConv backward refuses
    bf16 (conv_tap_grad takes fp32): nothing launches."""
    from repro_torch.kernels import ops, ssd_scan
    g = torch.Generator(device=device).manual_seed(4)
    x, dt, a, b, c, d = _ssd_inputs(1, 8, 2, 8, 1, 8, torch.float32, g,
                                    device)
    try:
        ssd_scan.ssd_scan(x.requires_grad_(), dt, a, b, c, d, chunk=4)
    except NotImplementedError:
        pass
    else:
        raise AssertionError("ssd_scan accepted an input requiring grad")
    xb = torch.randn(1, 8, 16, device=device).bfloat16().requires_grad_()
    fb = torch.randn(16, 4, device=device).bfloat16()
    y = ops.short_conv(xb, fb, causal=True)
    try:
        y.float().sum().backward()
    except (TypeError, RuntimeError) as e:
        if "the kernel takes torch.float32" not in str(e):
            raise
    else:
        raise AssertionError("the bf16 ShortConv backward ran")
    if ssd_scan.counters["ssd_scan"]:
        raise AssertionError("a refused ssd_scan call launched")
    print("[mamba kernel] ssd_scan refuses an input that requires grad on "
          "the card; the bf16 ShortConv backward raises (conv_tap_grad is "
          "fp32 only)", flush=True)


def _mamba_counts():
    from repro_torch.kernels import ops, ssd_scan
    counts = ops.ski_counters()
    return {"ssd_scan": ssd_scan.counters["ssd_scan"],
            "short_conv_bf16": counts.pop("short_conv"),
            "other": sum(counts.values())}


def _reset_mamba_counts() -> None:
    from repro_torch.kernels import ops, ssd_scan
    ops.reset_ski_counters()
    ssd_scan.reset_counters()


def _expect_mamba_launches(what, counts, n_layers) -> None:
    want = {"ssd_scan": n_layers, "short_conv_bf16": n_layers, "other": 0}
    if counts != want:
        raise AssertionError(f"{what} launched {counts}, want {want}")


def phase_mamba_score(device="cuda"):
    """The full-width mamba2-2.7b (bf16, random weights from seed 0) scores
    MAMBA_BATCH × MAMBA_SEQ tokens through ``launch.steps.make_forward``:
    one ``ssd_scan`` and one bf16 ``short_conv`` a layer, nothing else of
    the port's kernels. Returns (cfg, model, launch counts of a forward)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_forward
    from repro_torch.models.transformer import init_model
    cfg = get_config(MAMBA)
    t0 = time.perf_counter()
    model = init_model(cfg, torch.Generator().manual_seed(0), device=device)
    _sync(device)
    t_init = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (MAMBA_BATCH, MAMBA_SEQ))).to(device)
    fwd = make_forward(cfg)
    print(f"[mamba score] {cfg.name}: {cfg.n_layers} layers, d={cfg.d_model},"
          f" {cfg.ssm_heads} heads x {cfg.ssm_head_dim}, state "
          f"{cfg.ssm_state}, chunk {cfg.ssd_chunk}, vocab {cfg.vocab} "
          f"(padded {cfg.vocab_padded}), {cfg.param_dtype}, {n_params} "
          f"parameters; init_model {t_init:.3f} s; {MAMBA_BATCH} x "
          f"{MAMBA_SEQ} tokens", flush=True)
    fwd(model, toks)                                   # warm-up
    _sync(device)
    torch.cuda.reset_peak_memory_stats(device)
    _reset_mamba_counts()
    logits = fwd(model, toks)
    _sync(device)
    launches = _mamba_counts()
    peak = torch.cuda.max_memory_allocated(device)
    _expect_mamba_launches("one mamba forward", launches, cfg.n_layers)
    if not (logits.shape == (MAMBA_BATCH, MAMBA_SEQ, cfg.vocab_padded)
            and logits.dtype == torch.bfloat16
            and bool(torch.isfinite(logits).all())):
        raise AssertionError(f"mamba logits {logits.dtype} "
                             f"{tuple(logits.shape)} not finite or of the "
                             "wrong shape")
    del logits
    walls = []
    for _ in range(MAMBA_REPS):
        t0 = time.perf_counter()
        fwd(model, toks)
        _sync(device)
        walls.append(time.perf_counter() - t0)
    ms = statistics.median(walls) * 1e3
    print(f"[mamba score] make_forward {MAMBA_BATCH}x{MAMBA_SEQ}: median "
          f"{ms:.3f} ms of {MAMBA_REPS} (min {min(walls) * 1e3:.3f}, max "
          f"{max(walls) * 1e3:.3f}), {MAMBA_BATCH * MAMBA_SEQ / ms * 1e3:.0f} "
          f"tokens/s; launches per forward {launches}; max_memory_allocated "
          f"{peak} bytes ({peak / 2**30:.3f} GiB)", flush=True)
    dev_ms = _profile_forward(fwd, model, toks, device, reps=1,
                              tag="[mamba score]",
                              kernels_of=("ssd_scan_bf16_kernel",
                                          "short_conv_kernel"))
    print(f"[mamba score] device ms a forward: ssd_scan "
          f"{dev_ms['ssd_scan_bf16_kernel']:.3f} ({cfg.n_layers} launches), "
          f"short_conv {dev_ms['short_conv_kernel']:.3f}", flush=True)
    return cfg, model, launches


def phase_mamba_serve(cfg, model, device="cuda"):
    """``serving.prefill`` of MAMBA_PROMPTS × MAMBA_PROMPT_LEN prompts (the
    kernels), then greedy ``generate`` of MAMBA_GEN tokens each (the prompt
    token by token, as in the JAX package; max_len 160); then the decode
    path teacher-forced over the generated sequences against the
    kernel-path forward over them: the generated tokens are the decode
    path's argmax, none disagrees with the forward's where its top-2
    margin exceeds twice the two paths' largest logit difference, and the
    decode path is no farther from the fp32 forward of the same weights
    than twice the bf16 forward is (bf16 rounds at other places in the
    two paths, over 64 layers); the kernel-path forward is no farther from
    the same bf16 forward through the plain ``ssd_scan`` and
    ``short_conv`` than that is from the fp32 forward
    (:func:`check_kernel_vs_plain_bf16`). The same weights in fp32 then
    take both paths, where they differ only by fp32 sums in another order:
    the fp32 decode picks the fp32 forward's token at every teacher-forced
    position whose top-2 margin exceeds twice their largest logit
    difference, and at least one position is checked. Returns the launch
    counts."""
    from repro_torch.launch.serve import generate
    from repro_torch.models import serving
    from repro_torch.models.transformer import Model
    prompt = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (MAMBA_PROMPTS, MAMBA_PROMPT_LEN))).to(device)
    max_len = MAMBA_PROMPT_LEN + MAMBA_GEN
    with torch.inference_mode():
        generate(model, cfg, prompt[:, :4], 2)         # warm-up
        _sync(device)
        _reset_mamba_counts()
        t0 = time.perf_counter()
        logits = serving.prefill(model, cfg, prompt)
        _sync(device)
        t_prefill = time.perf_counter() - t0
        launches = _mamba_counts()
        _expect_mamba_launches("mamba prefill", launches, cfg.n_layers)
        if not bool(torch.isfinite(logits).all()):
            raise AssertionError("mamba prefill logits not finite")
        t0 = time.perf_counter()
        seqs = generate(model, cfg, prompt, MAMBA_GEN, max_len=max_len)
        _sync(device)
        t_gen = time.perf_counter() - t0
        if _mamba_counts() != launches:
            raise AssertionError(f"mamba decode launched {_mamba_counts()}")
        if seqs.shape != (MAMBA_PROMPTS, max_len) or not torch.equal(
                seqs[:, :MAMBA_PROMPT_LEN], prompt):
            raise AssertionError(f"generate returned {tuple(seqs.shape)}")
        # every position but the last goes through one decode step (the
        # prompt too, token by token): the decode path's rate is over all
        # of them, from one timed call
        steps = MAMBA_PROMPTS * (max_len - 1)
        print(f"[mamba serve] prefill {MAMBA_PROMPTS}x{MAMBA_PROMPT_LEN}: "
              f"{t_prefill * 1e3:.3f} ms; generate {MAMBA_GEN} new: "
              f"{t_gen:.3f} s for {steps} decode steps (the prompt token by "
              f"token); {steps / t_gen:.1f} steps/s (prompt included); "
              f"prefill launches {launches}", flush=True)
        dec = _teacher_forced(model, cfg, seqs)
        fwd = serving.prefill(model, cfg, seqs)[:, :-1].float()
        # the same bf16 forward with the plain ssd_scan and short_conv
        _reset_mamba_counts()
        with _plain_mamba_kernels():
            fwd_plain = serving.prefill(model, cfg, seqs)[:, :-1].float()
        if _mamba_counts() != {"ssd_scan": 0, "short_conv_bf16": 0,
                               "other": 0}:
            raise AssertionError("the plain mamba forward launched "
                                 f"{_mamba_counts()}")
        # the bf16 noise floor: the same weights in fp32, fp32 activations
        cfg32 = dataclasses.replace(cfg, dtype="float32",
                                    param_dtype="float32")
        model32 = Model(cfg32, device=device)
        model32.load_state_dict({k: v.float() for k, v
                                 in model.state_dict().items()})
        _reset_mamba_counts()
        fwd32 = serving.prefill(model32, cfg32, seqs)[:, :-1].float()
        _expect_mamba_launches("the fp32 mamba forward", _mamba_counts(),
                               cfg.n_layers)
        dec32 = _teacher_forced(model32, cfg32, seqs)
        del model32
    gen = slice(MAMBA_PROMPT_LEN - 1, None)       # positions that picked
    diff = float((dec - fwd).abs().max())
    diff_prompt = float((dec[:, :gen.start] - fwd[:, :gen.start]).abs().max())
    noise_fwd = float((fwd - fwd32).abs().max())
    noise_dec = float((dec - fwd32).abs().max())

    def pick(lg):                                 # as generate picks
        return torch.clamp(torch.argmax(lg, dim=-1), max=cfg.vocab - 1)
    # a token the decode path picked can differ from the forward's argmax
    # only where the forward's top-2 margin is at most twice the largest
    # logit difference between the two paths
    margin = 2 * diff
    top2 = torch.topk(fwd[:, gen], 2, dim=-1).values
    gaps = top2[..., 0] - top2[..., 1]
    checked = gaps > margin
    agree = pick(fwd[:, gen]) == seqs[:, MAMBA_PROMPT_LEN:]
    wrong = ~agree & checked
    same = torch.equal(pick(dec[:, gen]), seqs[:, MAMBA_PROMPT_LEN:])
    print(f"[mamba check] decode path vs kernel-path forward over "
          f"{tuple(seqs.shape)}: largest logit difference {diff:.4f} "
          f"(prompt positions {diff_prompt:.4f}, logit scale "
          f"{float(fwd.abs().max()):.3f}); against the fp32 forward of the "
          f"same weights: bf16 forward {noise_fwd:.4f}, decode "
          f"{noise_dec:.4f} (limit 2 x {noise_fwd:.4f}); margin 2 x "
          f"{diff:.4f} = {margin:.4f} (largest top-2 margin at a generated "
          f"position {float(gaps.max()):.4f}): "
          f"{int(checked.sum())} generated positions checked, "
          f"{int(wrong.sum())} mismatches; {int(agree.sum())} of "
          f"{agree.numel()} generated tokens are the forward's argmax; "
          f"teacher-forced decode reproduces the generated tokens: {same}",
          flush=True)
    if int(wrong.sum()) or not same:
        raise AssertionError("decoded tokens disagree with the kernel-path "
                             "forward")
    check_kernel_vs_plain_bf16(fwd, fwd_plain, fwd32)
    # bf16 over 64 layers: the decode path need not match the forward, but
    # it must be no farther from the fp32 forward than the bf16 forward is
    if not noise_dec <= 2 * noise_fwd:
        raise AssertionError(f"the decode path is {noise_dec} from the fp32 "
                             f"forward, over twice the bf16 forward's "
                             f"{noise_fwd}")
    # in fp32 the two paths differ by sums in another order only, so the
    # margin is small and the positions are really checked
    diff32 = float((dec32 - fwd32).abs().max())
    margin32 = 2 * diff32
    top2 = torch.topk(fwd32, 2, dim=-1).values
    checked32 = top2[..., 0] - top2[..., 1] > margin32
    wrong32 = (pick(dec32) != pick(fwd32)) & checked32
    print(f"[mamba check] fp32 decode path vs fp32 kernel-path forward, the "
          f"same weights, over {tuple(seqs.shape)}: largest logit difference "
          f"{diff32:.3e} (logit scale {float(fwd32.abs().max()):.3f}); margin "
          f"2 x {diff32:.3e} = {margin32:.3e}: {int(checked32.sum())} of "
          f"{checked32.numel()} teacher-forced positions checked "
          f"({int(checked32[:, gen].sum())} of {checked32[:, gen].numel()} "
          f"generated), {int(wrong32.sum())} mismatches", flush=True)
    if int(wrong32.sum()) or not int(checked32.sum()):
        raise AssertionError("the fp32 decode path disagrees with the fp32 "
                             "kernel-path forward, or no position was "
                             "checked")
    return launches


def _plain_mamba_kernels():
    """Inside the block the Mamba layers call the plain versions of their
    kernels on the card too: ``ssd_chunked.ssd_scan_chunked`` for
    ``ops.ssd_scan`` and ``ref.short_conv_left_ref`` for
    ``ops.short_conv`` (the wrappers take them only for CPU tensors)."""
    from repro_torch.kernels import ops, ref, ssd_chunked

    def short_conv(x, filt, causal, left=None):
        if left is None:
            left = 0 if causal else filt.shape[-1] // 2
        return ref.short_conv_left_ref(x, filt, left)
    stack = contextlib.ExitStack()
    stack.enter_context(mock.patch.object(ops, "ssd_scan",
                                          ssd_chunked.ssd_scan_chunked))
    stack.enter_context(mock.patch.object(ops, "short_conv", short_conv))
    return stack


def check_kernel_vs_plain_bf16(kernel, plain, fp32) -> dict:
    """The bf16 logits of the kernel path against those of the plain path
    (the same weights, tokens and dtype, the plain ``ssd_scan`` and
    ``short_conv``): their largest difference may not exceed the plain
    path's own largest difference from the fp32 forward. bf16 rounding
    over the layers sets that distance; a kernel whose error outgrows it
    fails the run. Prints the three distances and returns them."""
    got = {"kernel_vs_plain": float((kernel - plain).abs().max()),
           "plain_vs_fp32": float((plain - fp32).abs().max()),
           "kernel_vs_fp32": float((kernel - fp32).abs().max())}
    print(f"[mamba check] bf16 kernel-path forward vs the plain-path bf16 "
          f"forward: {got['kernel_vs_plain']:.4f} (limit: the plain path's "
          f"distance from the fp32 forward, {got['plain_vs_fp32']:.4f}; the "
          f"kernel path's own {got['kernel_vs_fp32']:.4f})", flush=True)
    if not got["kernel_vs_plain"] <= got["plain_vs_fp32"]:
        raise AssertionError(
            f"the bf16 kernel path is {got['kernel_vs_plain']} from the "
            f"plain path, over the plain path's {got['plain_vs_fp32']} from "
            "fp32")
    return got


def _teacher_forced(model, cfg, seqs):
    """The decode path's logits (fp32) over ``seqs`` fed token by token:
    (b, n - 1, V), position t predicting token t + 1."""
    from repro_torch.models import serving
    b, n = seqs.shape
    cache = serving.init_cache(cfg, b, n, params=model)
    dec = []
    for t in range(n - 1):
        lg, cache = serving.decode_step(model, cfg, seqs[:, t:t + 1], cache, t)
        dec.append(lg[:, 0].float())
    return torch.stack(dec, 1)


def check_mamba_card_vs_cpu(device="cuda") -> None:
    """The smoke mamba2-2.7b (2 layers, d 128, state 16, chunk 16) from
    seed 1: logits on 2 × 37 tokens (a ragged last chunk) card vs CPU in
    fp32 (1e-4 × max: fp32 sums in another order over two layers) and in
    bf16 (2e-2 × max, the bf16 tier: cuBLAS and the CPU round bf16
    products differently); greedy generate token-exact in fp32."""
    from repro_torch.configs import get_config, reduce_for_smoke
    from repro_torch.launch.serve import generate
    from repro_torch.models.transformer import forward, init_model
    toks = torch.from_numpy(np.random.default_rng(2).integers(0, 512,
                                                              (2, 37)))
    for dtype, tol in (("float32", 1e-4), ("bfloat16", 2e-2)):
        small = reduce_for_smoke(get_config(MAMBA), dtype=dtype,
                                 param_dtype=dtype)
        cpu = init_model(small, torch.Generator().manual_seed(1), "cpu")
        card = init_model(small, torch.Generator().manual_seed(1), device)
        with torch.inference_mode():
            want = forward(cpu, small, toks)
            _reset_mamba_counts()
            got = forward(card, small, toks.to(device)).cpu()
            launches = _mamba_counts()
            report = _grads_close(f"smoke mamba {dtype} card vs CPU",
                                  [got.double()], [want.double()],
                                  ["logits"], tol)
            tokens = ""
            if dtype == "float32":
                a = generate(cpu, small, toks[:, :9], 7)
                b = generate(card, small, toks[:, :9].to(device), 7).cpu()
                if not torch.equal(a, b):
                    raise AssertionError("smoke greedy generate differs card "
                                         "vs CPU")
                tokens = "; greedy generate 2 x (9 + 7) token-exact"
        if launches["ssd_scan"] != small.n_layers:
            raise AssertionError(f"smoke mamba launched {launches}")
        shape = tuple(want.shape)
        print(f"[mamba check] smoke {small.name} {dtype} logits {shape} "
              f"card vs CPU: {report}{tokens}", flush=True)


def phase_mamba(peaks, device="cuda") -> tuple[dict, dict]:
    """The Mamba-2 serving path (PR 19): kernels, score, serve, card vs
    CPU. Returns (kernel entries, launches by path); frees the model."""
    t0 = time.perf_counter()
    kernels = phase_mamba_kernels(peaks, device)
    cfg, model, score_launches = phase_mamba_score(device)
    serve_launches = phase_mamba_serve(cfg, model, device)
    del model
    torch.cuda.empty_cache()
    check_mamba_card_vs_cpu(device)
    print(f"[mamba] phase took {time.perf_counter() - t0:.1f} s", flush=True)
    return kernels, {"mamba_score": score_launches,
                     "mamba_serve": serve_launches}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.configs import get_config
    smi = phase_device()
    peak_name, peaks = _peaks(smi)
    phase_build()
    kernels = phase_kernels(peaks)
    kernels.update(phase_ski_kernels(peaks))
    kernels.update(phase_grad_kernels(peaks))
    kernels.update(phase_window_kernels(peaks))
    check_coef_backward()
    cfg = get_config("fd-tnn-lm-wt103")
    model, prompt_len, seqs, serve_launches = phase_serve(
        cfg, "cuda", PROMPTS, PROMPT_LEN, GEN_LEN)
    train_launches = phase_train(cfg, "cuda", TRAIN_STEPS, TRAIN_SEQ,
                                 TRAIN_BATCH)
    score_launches = phase_ski_score("cuda")
    ski_train_launches = phase_train(get_config("ski-tnn-lm-wt103"), "cuda",
                                     TRAIN_STEPS, TRAIN_SEQ, TRAIN_BATCH,
                                     mixer="ski")
    ski_vs_fd_op()
    unfused_launches = phase_ski_unfused()
    ski_unfused_times()
    causal_ski_vs_fd()
    large_r = phase_large_r()
    large_r_times()
    phase_check(cfg, model, prompt_len, seqs, "cuda")
    del model
    mamba_kernels, mamba_launches = phase_mamba(peaks)
    kernels.update(mamba_kernels)
    # each path must have gone through each of its kernels
    paths = {"serve": (serve_launches, ("hilbert_window", "fd_mul")),
             "train": (train_launches, tuple(TRAIN_LAUNCHES["fd"])),
             "score": (score_launches, ("interp_reduce", "ski_fused_pass2")),
             "ski_train": (ski_train_launches,
                           tuple(TRAIN_LAUNCHES["ski"])),
             "ski_unfused": (unfused_launches,
                             tuple(k for k, v in UNFUSED_STEP.items() if v)),
             "large_r_score": (large_r["large_r_score"],
                               ("interp_reduce", "ski_windowed_pass2")),
             "large_r_train": (large_r["large_r_train"],
                               tuple(TRAIN_LAUNCHES["ski_windowed"])),
             "large_r_fft_score": (large_r["large_r_fft_score"],
                                   ("interp_reduce", "ski_expand_pass2")),
             "large_r_fft_train": (large_r["large_r_fft_train"],
                                   tuple(TRAIN_LAUNCHES["ski_fft"])),
             **{path: (counts, ("ssd_scan", "short_conv_bf16"))
                for path, counts in mamba_launches.items()}}
    for path, (counts, names) in paths.items():
        for name in names:
            if not counts[name] > 0:
                raise AssertionError(f"{name} not launched on the {path} "
                                     "path")
    for name, e in kernels.items():
        by_path = {path: counts[name] for path, (counts, names)
                   in paths.items() if name in counts}
        e["launches"] = sum(by_path.values())
        e["launches_by_path"] = by_path
    print(f"[peaks] {peak_name} data sheet: {peaks[0] / 1e12} TB/s, "
          f"{peaks[1] / 1e12} TFLOP/s fp32, {peaks[2] / 1e12} TF32, "
          f"{peaks[3] / 1e12} bf16 (dense)")
    print(json.dumps({"kernels": list(kernels.values())}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
