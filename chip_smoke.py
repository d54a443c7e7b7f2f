#!/usr/bin/env python3
"""Drive the PyTorch port's serving, training, SKI scoring and SKI training
paths on one NVIDIA card and check them.

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
   ``interp_reduce``, ``ski_fused_pass2``, ``gram_grad`` and
   ``conv_tap_grad`` at the SKI path's shape (causal and bidirectional
   taps, and the mirrored offsets of the backward), ragged, n < m, r = n
   and m = 1; pass 2 at the dense-rank ceiling (r = 181 at d = 512, r =
   512 at d = 64) in the forward orientation and the backward's (A
   transposed, taps flipped, left mirrored); the whole SKIFusedTNO
   backward against autograd through ``ref.ski_fused_tno_ref`` (causal,
   bidirectional, r = 181), and under ``REPRO_PALLAS_GRAD=0``;
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
   loss on 1 × 512 tokens, peak memory; the four standalone SKI kernel
   wrappers refuse an input that requires grad on the card; one op-level
   line times ``ops.ski_fused_tno`` against ``ops.fd_tno`` at
   (8, 512, 512);
7. ski train: the full-width ski-tnn-lm-wt103 from seed 0 takes 30 AdamW
   steps as in phase 5: 18 ``interp_reduce``, 12 ``ski_fused_pass2``, 6
   ``gram_grad`` and 6 ``conv_tap_grad`` launches and 6 kernel backwards
   a step;
8. check: the kernel-path forward over the generated sequences reproduces
   every decoded token whose top-2 logit margin exceeds 1e-3; the
   smoke-size model gives the same logits, step-0 gradients and three
   training losses on the card as on the CPU; a run stopped at step 2 and
   restored from its checkpoint into a fresh model ends bitwise where an
   uninterrupted run ends; the same gradients, losses and resume for the
   smoke-size SKI model;
9. a JSON line with each kernel's numbers, then the card's name and power
   limit, then ``{"ok": true, "device": ...}`` as the last line.
"""
from __future__ import annotations

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

#: NVIDIA data-sheet peaks (bytes/s of device memory, dense fp32 FLOP/s
#: outside the tensor cores), by the name nvidia-smi reports; "H100" alone
#: is the SXM part.
PEAKS = {"H100 PCIe": (2.0e12, 51e12), "H100 NVL": (3.9e12, 60e12),
         "H100": (3.35e12, 67e12)}
PROMPTS, PROMPT_LEN, GEN_LEN = 8, 448, 64
MARGIN = 1e-3
TRAIN_STEPS, TRAIN_SEQ, TRAIN_BATCH, TRAIN_WARMUP = 30, 512, 8, 5
SCORE_BATCH, SCORE_SEQ, SCORE_REPS = 8, 512, 20
FD_SRC = "src/repro_torch/kernels/csrc/fd_fused.cu"
SKI_SRC = "src/repro_torch/kernels/csrc/ski.cu"
SKI_GRAD_SRC = "src/repro_torch/kernels/csrc/ski_grad.cu"


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
def _kernel_entry(name, replaces, got, want, fn, plain, library, nbytes,
                  nops, peaks, tol=1e-6, source=FD_SRC):
    """Check ``got`` within ``tol`` × max|want| and time the kernel, its
    plain version and the library call (None: there is none)."""
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    if not err <= tol * scale:
        raise AssertionError(f"{name}: max abs err {err} > {tol} x {scale}")
    bw, flops = peaks
    t_bytes, t_ops = nbytes / bw * 1e3, nops / flops * 1e3
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "max_abs_err": err, "tolerance": tol,
            "scale": scale, "limit": tol * scale, "ms": time_ms(fn),
            "plain_ms": time_ms(plain),
            "library_ms": None if library is None else time_ms(library),
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
#: pass 2 at the ceiling of ``backend.ski_rank_variant``'s dense variant
#: (d·r²·4 <= 64 MB, r <= 512): (label, b, n, d, r, m)
PASS2_CEILING = (("r=181", 8, 512, 512, 181, 32), ("r=512", 8, 512, 64, 512,
                                                    32))


def _tap_pairs(n: int, m: int, left: int) -> int:
    """(j, k) pairs of one batch row and channel whose x row j-k+left lies
    in [0, n): the multiply-adds the tap gradient needs."""
    return sum(max(0, min(n, n + k - left) - max(0, k - left))
               for k in range(m))


def _pass2_entry(label, x, z, a, f, left, peaks):
    """ski_fused_pass2 at one shape and offset, 1e-5 × max|plain| (the
    Gram and the conv sum in another order than the plain einsum and
    shift-adds)."""
    from repro_torch.kernels import ref, ski_fused
    b, n, d = x.shape
    r, m = z.shape[1], f.shape[1]
    # conv 2·b·n·d·m, Gram 2·b·d·r², expansion 2·2·b·n·d flops; x, z, A, f
    # read once, y written once
    e = _kernel_entry(
        "ski_fused_pass2", "src/repro/kernels/ski_fused.py:143",
        ski_fused.ski_fused_pass2(x, z, a, f, True, left=left),
        ref.ski_fused_pass2_ref(x, z, a, f, True, left=left),
        lambda: ski_fused.ski_fused_pass2(x, z, a, f, True, left=left),
        lambda: ref.ski_fused_pass2_ref(x, z, a, f, True, left=left),
        None, nbytes=4 * (2 * x.numel() + z.numel() + a.numel() + f.numel()),
        nops=2 * b * d * (n * m + r * r + 2 * n), peaks=peaks, tol=1e-5,
        source=SKI_SRC)
    print(f"[kernel] ski_fused_pass2 {label} x ({b}, {n}, {d}), r={r}, m={m}, "
          f"left={left}: {e}", flush=True)
    return e


def phase_ski_kernels(peaks, device="cuda") -> dict:
    """The four SKI kernels against their plain versions at SKI_SHAPES:
    interp_reduce and gram_grad within 1e-6 × max|plain| (sums of at most
    2h+1 and of b terms), ski_fused_pass2 within 1e-5 × max|plain|,
    conv_tap_grad within 1e-5 × max|plain| (4,096 terms at the path
    shape, in another order); then pass 2 at PASS2_CEILING in both
    orientations. Returns the entries at the path's shape."""
    from repro_torch.core import ski
    from repro_torch.kernels import interp_matvec, ref, ski_grad
    g = torch.Generator(device=device).manual_seed(1)
    out = {}
    for label, b, n, d, r, m, left in SKI_SHAPES:
        x = torch.randn(b, n, d, device=device, generator=g)
        z = torch.randn(b, r, d, device=device, generator=g)
        a = torch.randn(d, r, r, device=device, generator=g)
        f = torch.randn(d, m, device=device, generator=g)
        cot = torch.randn(b, n, d, device=device, generator=g)
        gz = torch.randn(b, r, d, device=device, generator=g)
        lo, w_lo, _ = ski.make_inducing(n, r, device)
        w = ref.dense_interp_matrix(lo, w_lo, r)
        nnz_w = int((w != 0).sum())           # W's non-zeros at this (n, r)
        entries = {}
        entries["interp_reduce"] = _kernel_entry(
            "interp_reduce", "src/repro/kernels/interp_matvec.py:65",
            interp_matvec.interp_reduce(x, lo, w_lo, r),
            ref.interp_reduce_ref(x, lo, w_lo, r),
            lambda: interp_matvec.interp_reduce(x, lo, w_lo, r),
            lambda: ref.interp_reduce_ref(x, lo, w_lo, r),
            lambda: torch.einsum("nr,bnd->brd", w, x),
            nbytes=4 * (x.numel() + z.numel()), nops=2 * b * d * nnz_w,
            peaks=peaks, tol=1e-6, source=SKI_SRC)
        print(f"[kernel] interp_reduce {label} x ({b}, {n}, {d}), r={r}: "
              f"{entries['interp_reduce']}", flush=True)
        entries["ski_fused_pass2"] = _pass2_entry(label, x, z, a, f, left,
                                                  peaks)
        # gz, z read once, dA written once; 2·b·d·r² flops
        entries["gram_grad"] = _kernel_entry(
            "gram_grad", "src/repro/kernels/ski_grad.py:149",
            ski_grad.gram_grad(gz, z), ref.gram_grad_ref(gz, z),
            lambda: ski_grad.gram_grad(gz, z),
            lambda: ref.gram_grad_ref(gz, z),
            lambda: torch.einsum("bsc,btc->cst", gz, z),
            nbytes=4 * (2 * z.numel() + d * r * r), nops=2 * b * d * r * r,
            peaks=peaks, tol=1e-6, source=SKI_GRAD_SRC)
        print(f"[kernel] gram_grad {label} gz, z ({b}, {r}, {d}): "
              f"{entries['gram_grad']}", flush=True)
        # the library yardstick: cuDNN's depthwise conv1d weight gradient
        # (TF32 off) on channel-major copies of g and of x padded by the
        # taps' reach, made outside the timed call; it gives the taps in
        # reverse order
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
        # g, x read once, df written once; 2 flops a (j, k) pair in range
        entries["conv_tap_grad"] = _kernel_entry(
            "conv_tap_grad", "src/repro/kernels/ski_grad.py:71",
            ski_grad.conv_tap_grad(cot, x, m, left), want,
            lambda: ski_grad.conv_tap_grad(cot, x, m, left),
            lambda: ref.conv_tap_grad_ref(cot, x, m, left), library,
            nbytes=4 * (2 * x.numel() + d * m),
            nops=2 * b * d * _tap_pairs(n, m, left), peaks=peaks, tol=1e-5,
            source=SKI_GRAD_SRC)
        print(f"[kernel] conv_tap_grad {label} g, x ({b}, {n}, {d}), m={m}, "
              f"left={left}: {entries['conv_tap_grad']} (conv1d_weight max "
              f"abs err {lib_err:.3e})", flush=True)
        if label == "path":
            out.update(entries)
    for label, b, n, d, r, m in PASS2_CEILING:
        x = torch.randn(b, n, d, device=device, generator=g)
        z = torch.randn(b, r, d, device=device, generator=g)
        a = torch.randn(d, r, r, device=device, generator=g)
        f = torch.randn(d, m, device=device, generator=g)
        a_t, f_t = a.transpose(1, 2).contiguous(), f.flip(-1).contiguous()
        for left in (0, m // 2):
            _pass2_entry(f"ceiling {label}", x, z, a, f, left, peaks)
            _pass2_entry(f"ceiling {label} backward orientation", x, z, a_t,
                         f_t, m - 1 - left, peaks)
    check_ski_backward(g)
    return out


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
        if ran != {"interp_reduce": 3, "ski_fused_pass2": 2, "gram_grad": 1,
                   "conv_tap_grad": 1, "fwd": 1, "bwd_kernel": 1,
                   "bwd_ref": 0}:
            raise AssertionError(f"SKIFusedTNO ({label}) launched {ran}")
        print(f"[kernel] SKIFusedTNO backward ({label}) x ({b}, {n}, {d}), "
              f"r={r}, m={m} vs autograd through ref.ski_fused_tno_ref: "
              f"{report}; launches {ran}", flush=True)
        with reference_grad():
            ref_got, ran = grads()
        report = _grads_close(f"SKIFusedTNO REPRO_PALLAS_GRAD=0 ({label})",
                              ref_got, got, names)
        if ran != {"interp_reduce": 1, "ski_fused_pass2": 1, "gram_grad": 0,
                   "conv_tap_grad": 0, "fwd": 1, "bwd_kernel": 0,
                   "bwd_ref": 1}:
            raise AssertionError(f"SKIFusedTNO under REPRO_PALLAS_GRAD=0 "
                                 f"({label}) launched {ran}")
        print(f"[kernel] SKIFusedTNO under REPRO_PALLAS_GRAD=0 ({label}) vs "
              f"the kernel backward: {report}; launches {ran}", flush=True)


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


def _ski_counts():
    from repro_torch.kernels import ops, ski_vjp
    return ops.ski_counters(), dict(ski_vjp.counters)


#: kernel launches a layer makes in one training step (forward + backward)
TRAIN_LAUNCHES = {"fd": {"hilbert_window": 3, "fd_mul": 2, "fd_khat_grad": 1},
                  "ski": {"interp_reduce": 3, "ski_fused_pass2": 2,
                          "gram_grad": 1, "conv_tap_grad": 1}}


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
    tag = "[train]" if mixer == "fd" else "[ski-train]"

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
    launches, op_counts = (_fd_counts if mixer == "fd" else _ski_counts)()
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
    want = {k: v * cfg.n_layers for k, v in TRAIN_LAUNCHES[mixer].items()}
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
    """Each SKI kernel wrapper called on its own writes a tensor autograd
    cannot see, so on the card it refuses an input that requires grad
    (gradients go through ops.ski_fused_tno), before any launch."""
    from repro_torch.kernels import interp_matvec, ops, ski_fused, ski_grad
    x = torch.randn(2, 16, 8, device=device)
    z = torch.randn(2, 4, 8, device=device)
    a = torch.randn(8, 4, 4, device=device)
    f = torch.randn(8, 3, device=device)
    req = lambda t: t.clone().requires_grad_()
    calls = {"interp_reduce": lambda: interp_matvec.interp_reduce(
                 req(x), None, None, 4),
             "ski_fused_pass2": lambda: ski_fused.ski_fused_pass2(
                 x, z, req(a), f, True),
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


def _profile_forward(fwd, model, tokens, device, reps: int = 3) -> None:
    """Where a scoring forward's time goes: ``torch.profiler`` over
    ``reps`` forwards (traced, so the wall is inflated), the device-busy
    share of the wall and the kernels with the most device time."""
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
    print(f"[score] traced: {reps} forwards, wall {wall * 1e3:.3f} ms, "
          f"device busy {busy:.3f} ms, idle share "
          f"{1 - busy / (wall * 1e3):.3f}; top kernels by device time: "
          + "; ".join(f"{e.key[:60]} {e.self_device_time_total / 1e3:.3f} "
                      f"ms x{e.count}" for e in top), flush=True)


def phase_ski_score(device) -> dict:
    """The full-width SKI scoring path. Returns its launch counts (one
    forward)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import make_forward
    from repro_torch.models.transformer import init_model, loss_fn
    cfg = get_config("ski-tnn-lm-wt103")
    model = init_model(cfg, torch.Generator().manual_seed(0), device=device)
    batch = _ski_batch(cfg, SCORE_BATCH, SCORE_SEQ, device)
    fwd = make_forward(cfg)
    print(f"[score] {cfg.name}: {cfg.n_layers} layers, d={cfg.d_model}, "
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
    if launches != {"interp_reduce": cfg.n_layers,
                    "ski_fused_pass2": cfg.n_layers, "gram_grad": 0,
                    "conv_tap_grad": 0}:
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
    print(f"[score] make_forward {SCORE_BATCH}x{SCORE_SEQ}: median {ms:.3f} "
          f"ms of {SCORE_REPS} (min {min(walls) * 1e3:.3f}, max "
          f"{max(walls) * 1e3:.3f}), {SCORE_BATCH * SCORE_SEQ / ms * 1e3:.0f} "
          f"tokens/s; eval loss {float(loss):.6f}; launches per forward "
          f"{launches}; max_memory_allocated {peak} bytes "
          f"({peak / 2**30:.3f} GiB)", flush=True)
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
    print(f"[score] card vs CPU, 1 x {SCORE_SEQ} tokens: logits max abs err "
          f"{err:.3e} (scale {scale:.3e}, limit 1e-4 x scale); loss "
          f"{got_loss:.6f} vs {want_loss:.6f}, err {lerr:.3e} (limit 1e-4)",
          flush=True)
    if not (err <= 1e-4 * scale and lerr <= 1e-4):
        raise AssertionError("card SKI scoring differs from the CPU's")
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
    phase_check(cfg, model, prompt_len, seqs, "cuda")
    # each path must have gone through each of its kernels
    paths = {"serve": (serve_launches, ("hilbert_window", "fd_mul")),
             "train": (train_launches, tuple(TRAIN_LAUNCHES["fd"])),
             "score": (score_launches, ("interp_reduce", "ski_fused_pass2")),
             "ski_train": (ski_train_launches,
                           tuple(TRAIN_LAUNCHES["ski"]))}
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
          f"{peaks[1] / 1e12} TFLOP/s fp32")
    print(json.dumps({"kernels": list(kernels.values())}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
