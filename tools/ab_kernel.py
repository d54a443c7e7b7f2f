#!/usr/bin/env python3
"""Two builds of one kernel library's source, side by side on one card.

    python3 tools/ab_kernel.py NAME [--old OTHER.cu ...]
                               [--out chiprun_out/ab_NAME.json]

``NAME`` is a key of ``repro_torch.kernels.backend.SOURCES`` that
:data:`CHECKS` has a check for (``fd_fused``: its two causal-spectrum
kernels; ``ssd_scan``, ``ski``, ``ski_grad``, ``short_conv``). Each
``--old`` is another version of that source with the same C interface, for
example an earlier commit's file (``git show
<rev>:src/repro_torch/kernels/csrc/ssd_scan.cu > build/ab/ssd_scan_v2.cu``),
built with the backend's ``nvcc`` flags into ``build/ab/`` and named by
its file's stem. Then:

* prints ``ptxas -v`` (registers, spills, shared memory) of the current
  source, and what each library's exported ``*_blocks_per_sm`` entry
  points return;
* counts the tensor-core instructions (HMMA, HGMMA) of each kernel in each
  library's SASS (``cuobjdump --dump-sass``);
* runs ``chip_smoke.py``'s check of the library's kernels (:data:`CHECKS`:
  every shape and tolerance of the smoke run, and its timings, CUDA events
  with L2 evicted) with the port's wrappers loading each build in turn, in
  the order old, new, new, old for each old build; for ``ski`` and
  ``short_conv`` every kernel is timed at every shape of the check, not
  only the path's.

With ``--time-only`` the checks are skipped and each build times only
the kernels of :data:`TIMERS` at the main path's shape: for builds that do
not compute the function (an ablation that drops one phase of a kernel, to
see what that phase costs). For ``ski`` the interp pair is also timed as
``ms_run`` (``chip_smoke.time_ms_run``: 64 launches an event pair, cold),
``interp_expand`` at ``chip_smoke.EXPAND_RUN_SHAPES`` beside the write
floor (``y.zero_()`` of the path's y); ``--only interp`` (or ``dense``,
``windowed``, ``bf16``: the bf16 instances at the path; repeatable) times
those groups of :data:`SKI_TIMERS` alone.
Where :data:`OUTPUTS` has the library, each build's outputs on the same
fixed inputs are compared with the current build's (max |build - new|,
printed and kept in the report).

Prints one JSON object as its last line and writes it to ``--out``. Needs a
CUDA card and ``nvcc``; exits non-zero without them or if a check fails.
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path
from unittest import mock

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke  # noqa: E402

AB_DIR = ROOT / "build" / "ab"


def _every(shapes: dict, *names: str) -> dict:
    """{"<kernel> <label>": entry} of a chip_smoke check's {label: {kernel:
    entry}}, for the kernels in ``names`` (all when none)."""
    return {f"{kernel} {label}": e for label, entries in shapes.items()
            for kernel, e in entries.items() if not names or kernel in names}


def _check_short_conv(peaks) -> dict:
    """chip_smoke's short_conv checks, each shape kept: fp32 at every
    SKI_SHAPES shape and offset (in ``phase_ski_kernels``, 1e-5 ×
    max|plain|), bf16 at Mamba's conv and the SKI path's four offsets
    (BF16_TOL)."""
    g = torch.Generator(device="cuda").manual_seed(3)
    return {**_every(chip_smoke.phase_ski_kernels(peaks), "short_conv"),
            **{f"short_conv_bf16 {label}": e for label, e in
               chip_smoke.check_short_conv_bf16(peaks, g).items()}}


#: library name -> the chip_smoke.py check of its kernels at their shapes;
#: each takes the card's peaks and returns {kernel: entry with "ms"}
CHECKS = {
    "fd_fused": chip_smoke.phase_causal_spectrum,
    "ski": lambda peaks: {
        **_every(chip_smoke.phase_ski_kernels(peaks)),
        **_every(chip_smoke.phase_window_kernels(peaks))},
    "ski_grad": chip_smoke.phase_grad_kernels,
    "ssd_scan": chip_smoke.check_ssd_scan,
    "short_conv": _check_short_conv,
}


#: dense pass-2 shapes of the ski timing and outputs (label, b, n, d, r,
#: m): the SKI path and the dense route's ceilings (chip_smoke's
#: PASS2_CEILING)
DENSE_SHAPES = (("path", 8, 512, 512, 64, 32),
                *chip_smoke.PASS2_CEILING)


def _dense_inputs(b, n, d, r, m, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return (torch.randn(b, n, d, device="cuda", generator=g),
            torch.randn(b, r, d, device="cuda", generator=g),
            torch.randn(d, r, r, device="cuda", generator=g),
            torch.randn(d, m, device="cuda", generator=g))


def _expand_shapes():
    """ski_expand_pass2's shapes in the smoke run (label, b, n, d, r, m,
    left): chip_smoke's WINDOW_SHAPES and EXPAND_SHAPES."""
    return (*chip_smoke.WINDOW_SHAPES, *chip_smoke.EXPAND_SHAPES)


def _expand_inputs(b, n, d, r, m, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return (torch.randn(b, n, d, device="cuda", generator=g),
            torch.randn(b, r, d, device="cuda", generator=g),
            torch.randn(d, m, device="cuda", generator=g))


def _time_interp(peaks) -> dict:
    """interp_reduce at the SKI path's shape (x (8, 512, 512), r = 64) and
    interp_expand at chip_smoke's EXPAND_RUN_SHAPES, each as ``ms`` (one
    launch an event pair) and ``ms_run`` (64 launches an event pair, cold),
    and the write floor (``y.zero_()`` on the path's y, timed the same
    way: a control that no build changes), under "interp_expand run
    <label>"; interp_expand also as ``ms`` at SKI_SHAPES and INTERP_R2 (the
    first label of each shape)."""
    from repro_torch.core import ski
    from repro_torch.kernels import interp_matvec
    g = torch.Generator(device="cuda").manual_seed(5)
    _, b, n, d, r, _, _ = chip_smoke.SKI_SHAPES[0]
    lo, w_lo, _ = ski.make_inducing(n, r, "cuda")
    xs = [torch.randn(b, n, d, device="cuda", generator=g) for _ in
          range(chip_smoke._run_sets(4 * (b * n * d + b * r * d)))]
    calls = [lambda x=x: interp_matvec.interp_reduce(x, lo, w_lo, r)
             for x in xs]
    out = {"interp_reduce": {
        "ms": chip_smoke.time_ms(calls[0]),
        "ms_run": chip_smoke.time_ms_run(calls)["ms_run"],
        "bound_ms": 4 * (b * n * d + b * r * d) / peaks[0] * 1e3}}
    del xs, calls
    seen = set()
    for label, z, n in _expand_output_inputs(seed=5)[:-1]:
        if label.startswith("run ") or (z.shape, n) in seen:
            continue
        seen.add((z.shape, n))
        lo, w_lo, _ = ski.make_inducing(n, z.shape[1], "cuda")
        out[f"interp_expand {label}"] = {
            "ms": chip_smoke.time_ms(
                lambda: interp_matvec.interp_expand(z, lo, w_lo)),
            "bound_ms": 4 * (z.numel() + z.shape[0] * n * z.shape[2])
            / peaks[0] * 1e3}
    for label, e in chip_smoke.expand_runs(peaks, "cuda", g).items():
        name = "write floor" if label == "write floor" else (
            f"interp_expand run {label}")
        out[name] = {k: e[k] for k in ("ms", "ms_run", "bound_ms")}
    return out


def _time_dense(peaks) -> dict:
    """ski_fused_pass2 (causal) at DENSE_SHAPES and, at the path's shape,
    in the signal backward's orientation (Aᵀ, left m - 1)."""
    from repro_torch.kernels import ski_fused
    out = {}
    for label, b, n, d, r, m in DENSE_SHAPES:
        x, z, a, f = _dense_inputs(b, n, d, r, m, seed=5)
        key = "ski_fused_pass2" + ("" if label == "path" else f" {label}")
        bound = 4 * (2 * x.numel() + z.numel() + a.numel()
                     + f.numel()) / peaks[0] * 1e3
        out[key] = {
            "ms": chip_smoke.time_ms(
                lambda: ski_fused.ski_fused_pass2(x, z, a, f, True)),
            "bound_ms": bound}
        if label == "path":               # the signal backward's launch
            out[key + " backward"] = {
                "ms": chip_smoke.time_ms(
                    lambda: ski_fused.ski_fused_pass2(
                        x, z, a, f, True, left=m - 1, transpose_a=True)),
                "bound_ms": bound}
    return out


def _time_windowed(peaks) -> dict:
    """ski_windowed_pass2 at the large-rank path's shape (x (8, 512, 512),
    r = 512, m = 32, causal) and ski_expand_pass2 at every shape of
    ``_expand_shapes``."""
    from repro_torch.kernels import ski_fused
    g = torch.Generator(device="cuda").manual_seed(7)
    b, n, d, r, m = 8, 512, 512, 512, 32
    x = torch.randn(b, n, d, device="cuda", generator=g)
    z = torch.randn(b, r, d, device="cuda", generator=g)
    coef = torch.randn(d, 2 * r - 1, device="cuda", generator=g) / r ** 0.5
    f = torch.randn(d, m, device="cuda", generator=g)
    ms = chip_smoke.time_ms(
        lambda: ski_fused.ski_windowed_pass2(x, z, coef, f, True))
    nbytes, gram, rest = chip_smoke._windowed_cost(b, n, d, r, m)
    bound = max(nbytes / peaks[0], 3 * gram / peaks[2] + rest / peaks[1])
    out = {"ski_windowed_pass2": {"ms": ms, "bound_ms": bound * 1e3}}
    for label, b, n, d, r, m, left in _expand_shapes():
        x, z2, f = _expand_inputs(b, n, d, r, m, seed=8)
        out[f"ski_expand_pass2 {label}"] = {
            "ms": chip_smoke.time_ms(lambda: ski_fused.ski_expand_pass2(
                x, z2, f, True, left=left)),
            "bound_ms": 4 * (2 * x.numel() + z2.numel() + f.numel())
            / peaks[0] * 1e3}
    return out


def _time_bf16(peaks) -> dict:
    """The bf16 instances: the dense route's at the SKI path's shape (x (8,
    512, 512) bf16, r = 64, m = 32): ``interp_reduce_bf16``, and
    ``ski_fused_pass2_bf16`` (left 0) and ``ski_fused_pass2_at_bf16`` (Aᵀ,
    left 31) with z bf16, A fp32 and bf16 taps; then those of the other
    routes (:func:`_time_bf16_routes`), with their bounds. A build without
    a bf16 entry (an earlier ``ski.cu``) times none of its kernels."""
    from repro_torch.core import ski
    from repro_torch.kernels import interp_matvec, ski_fused
    if not hasattr(ski_fused._lib(), "ski_fused_pass2_bf16"):
        return {}
    b, n, d, r, m = 8, 512, 512, 64, 32
    x, z, a, f = _dense_inputs(b, n, d, r, m, seed=12)
    x, z, f = x.bfloat16(), z.bfloat16(), f.bfloat16()
    f_t = f.flip(-1).contiguous()
    f32, f32_t = f.float(), f_t.float()
    lo, w_lo, _ = ski.make_inducing(n, r, "cuda")
    pass2 = (2 * (2 * x.numel() + z.numel()) + 4 * a.numel()
             + 2 * f.numel()) / peaks[0] * 1e3
    return {
        "interp_reduce_bf16": {
            "ms": chip_smoke.time_ms(
                lambda: interp_matvec.interp_reduce(x, lo, w_lo, r)),
            "bound_ms": 2 * (x.numel() + z.numel()) / peaks[0] * 1e3},
        "ski_fused_pass2_bf16": {
            "ms": chip_smoke.time_ms(
                lambda: ski_fused.ski_fused_pass2(x, z, a, f, True)),
            "bound_ms": pass2},
        "ski_fused_pass2_at_bf16": {
            "ms": chip_smoke.time_ms(lambda: ski_fused.ski_fused_pass2(
                x, z, a, f_t, True, left=m - 1, transpose_a=True)),
            "bound_ms": pass2},
        # the same two with the taps widened beforehand: the wrapper's
        # widening launch out of the timed call
        "ski_fused_pass2_bf16 fp32 taps": {
            "ms": chip_smoke.time_ms(
                lambda: ski_fused.ski_fused_pass2(x, z, a, f32, True)),
            "bound_ms": pass2},
        "ski_fused_pass2_at_bf16 fp32 taps": {
            "ms": chip_smoke.time_ms(lambda: ski_fused.ski_fused_pass2(
                x, z, a, f32_t, True, left=m - 1, transpose_a=True)),
            "bound_ms": pass2},
        **_time_bf16_routes(peaks)}


def _large_inputs(seed, dtype=torch.float32):
    """x, z (8, 512, 512), coefficients (512, 1023) / sqrt(512) fp32 and
    taps (512, 32) at the large-rank path; x, z and the taps in
    ``dtype``."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    b, n, d, r, m = 8, 512, 512, 512, 32
    x = torch.randn(b, n, d, device="cuda", generator=g)
    z = torch.randn(b, r, d, device="cuda", generator=g)
    coef = torch.randn(d, 2 * r - 1, device="cuda", generator=g) / r ** 0.5
    f = torch.randn(d, m, device="cuda", generator=g)
    return x.to(dtype), z.to(dtype), coef, f.to(dtype)


def _time_bf16_routes(peaks) -> dict:
    """``ski_windowed_pass2_bf16`` (left 0, and the backward's orientation:
    coefficients and taps flipped, left 31) and ``ski_expand_pass2_bf16``
    at the large-rank path (x, z (8, 512, 512) bf16, r = 512, m = 32, fp32
    coefficients, the taps' bf16 values as the fp32 the kernel reads, so
    that no widening launch sits in the timed call), and
    ``interp_expand_bf16`` at the unfused path (z (8, 64, 512) bf16 -> y
    (8, 512, 512)), each with its bound (the windowed one's Gram as two
    TF32 products). A build without these entries times none."""
    from repro_torch.core import ski
    from repro_torch.kernels import interp_matvec, ski_fused
    if not hasattr(ski_fused._lib(), "ski_windowed_pass2_bf16"):
        return {}
    x, z, coef, f = _large_inputs(13, torch.bfloat16)
    f = f.float()                # the taps as the kernel reads them
    b, n, d = x.shape
    r, m = z.shape[1], f.shape[1]
    coef_t, f_t = coef.flip(-1).contiguous(), f.flip(-1).contiguous()
    nbytes, gram, rest = chip_smoke._windowed_cost(b, n, d, r, m)
    nbytes = 2 * (2 * x.numel() + z.numel()) + 4 * (coef.numel() + f.numel())
    windowed, _ = chip_smoke._bound(
        nbytes, ((2 * gram, peaks[2], "tensor cores"),
                 (rest, peaks[1], "cuda cores")), peaks)
    zu = z[:, :64].contiguous()
    lo, w_lo, _ = ski.make_inducing(n, 64, "cuda")
    return {
        "ski_windowed_pass2_bf16": {
            "ms": chip_smoke.time_ms(lambda: ski_fused.ski_windowed_pass2(
                x, z, coef, f, True)),
            "bound_ms": windowed},
        "ski_windowed_pass2_bf16 backward": {
            "ms": chip_smoke.time_ms(lambda: ski_fused.ski_windowed_pass2(
                x, z, coef_t, f_t, True, left=m - 1)),
            "bound_ms": windowed},
        "ski_expand_pass2_bf16": {
            "ms": chip_smoke.time_ms(lambda: ski_fused.ski_expand_pass2(
                x, z, f, True)),
            "bound_ms": (2 * (2 * x.numel() + z.numel()) + 4 * f.numel())
            / peaks[0] * 1e3},
        "interp_expand_bf16": {
            "ms": chip_smoke.time_ms(lambda: interp_matvec.interp_expand(
                zu, lo, w_lo)),
            "bound_ms": 2 * (zu.numel() + b * n * d) / peaks[0] * 1e3}}


#: the groups of the ski timing (``--only`` picks some)
SKI_TIMERS = {"interp": _time_interp, "dense": _time_dense,
              "windowed": _time_windowed, "bf16": _time_bf16}


def _time_ski(peaks, only=None) -> dict:
    """Unchecked, timed as chip_smoke times them: each group of
    SKI_TIMERS (all, or those named in ``only``)."""
    out = {}
    for name, timer in SKI_TIMERS.items():
        if not only or name in only:
            out.update(timer(peaks))
    return out


def _expand_output_inputs(seed):
    """interp_expand's compared calls (label, z, n): every SKI_SHAPES shape,
    INTERP_R2, EXPAND_RUN_SHAPES, and z and y one float past 16-byte
    alignment at the path (the scalar path, as d = 33 and 45)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    shapes = [(label, b, n, d, r) for label, b, n, d, r, _, _
              in chip_smoke.SKI_SHAPES]
    shapes += [chip_smoke.INTERP_R2, *(
        (f"run {label}", *rest) for label, *rest
        in chip_smoke.EXPAND_RUN_SHAPES)]
    out = [(label, torch.randn(b, r, d, device="cuda", generator=g), n)
           for label, b, n, d, r in shapes]
    _, b, n, d, r = chip_smoke.EXPAND_RUN_SHAPES[0]
    flat = torch.randn(b * r * d + 1, device="cuda", generator=g)
    out.append(("unaligned", flat[1:].view(b, r, d), n))
    return out


def _expand_outputs(seed) -> dict:
    """interp_expand at every call of ``_expand_output_inputs``; the
    unaligned call also writes a y one float past alignment."""
    from repro_torch.core import ski
    from repro_torch.kernels import interp_matvec
    out = {}
    for label, z, n in _expand_output_inputs(seed):
        lo, w_lo, _ = ski.make_inducing(n, z.shape[1], "cuda")
        y = interp_matvec.interp_expand(z, lo, w_lo)
        if label == "unaligned":
            assert z.data_ptr() % 16 != 0
            buf = torch.empty(y.numel() + 1, device="cuda")
            with mock.patch.object(torch, "empty",
                                   lambda *a, **k: buf[1:].view(y.shape)):
                y = interp_matvec.interp_expand(z, lo, w_lo)
            assert y.data_ptr() % 16 != 0
        out[f"interp_expand {label}"] = y
    return out


def _ski_outputs() -> dict:
    """The SKI kernels on fixed inputs, for max |new - old|: interp_reduce
    and ski_fused_pass2 at DENSE_SHAPES (causal), and the backward's pass 2
    (Aᵀ, taps flipped, left m - 1); ski_expand_pass2 at every shape of
    ``_expand_shapes``; interp_expand at every call of
    ``_expand_output_inputs``; ski_windowed_pass2 at the large-rank path's
    shape (x (8, 512, 512), r = 512, m = 32), causal, and at every
    WINDOW_SHAPES shape and offset in both orientations (coefficients and
    taps flipped, left mirrored); the bf16 instances, where the build has
    them, at the large-rank path (pass 2 both ways) and interp_expand_bf16
    at the unfused path and every SKI_SHAPES shape."""
    from repro_torch.core import ski
    from repro_torch.kernels import interp_matvec, ski_fused
    out = _expand_outputs(seed=10)
    x, z, coef, f = _large_inputs(11)
    out["ski_windowed_pass2 path"] = ski_fused.ski_windowed_pass2(
        x, z, coef, f, True)
    g = torch.Generator(device="cuda").manual_seed(12)
    for label, b, n, d, r, m, left in chip_smoke.WINDOW_SHAPES:
        x = torch.randn(b, n, d, device="cuda", generator=g)
        z = torch.randn(b, r, d, device="cuda", generator=g)
        coef = torch.randn(d, 2 * r - 1, device="cuda", generator=g) / r ** 0.5
        f = torch.randn(d, m, device="cuda", generator=g)
        out[f"ski_windowed_pass2 {label}"] = ski_fused.ski_windowed_pass2(
            x, z, coef, f, True, left=left)
        out[f"ski_windowed_pass2 {label} backward"] = (
            ski_fused.ski_windowed_pass2(
                x, z, coef.flip(-1).contiguous(), f.flip(-1).contiguous(),
                True, left=m - 1 - left))
    if hasattr(ski_fused._lib(), "ski_windowed_pass2_bf16"):
        x, z, coef, f = _large_inputs(14, torch.bfloat16)
        out["ski_windowed_pass2_bf16 path"] = ski_fused.ski_windowed_pass2(
            x, z, coef, f, True)
        out["ski_windowed_pass2_bf16 path backward"] = (
            ski_fused.ski_windowed_pass2(x, z, coef.flip(-1).contiguous(),
                                         f.flip(-1).contiguous(), True,
                                         left=31))
        out["ski_expand_pass2_bf16 path"] = ski_fused.ski_expand_pass2(
            x, z, f, True)
        for label, zz, n in _expand_output_inputs(seed=15):
            lo, w_lo, _ = ski.make_inducing(n, zz.shape[1], "cuda")
            out[f"interp_expand_bf16 {label}"] = interp_matvec.interp_expand(
                zz.bfloat16(), lo, w_lo)
    for label, b, n, d, r, m in DENSE_SHAPES:
        x, z, a, f = _dense_inputs(b, n, d, r, m, seed=6)
        lo, w_lo, _ = ski.make_inducing(n, r, "cuda")
        out[f"interp_reduce {label}"] = interp_matvec.interp_reduce(
            x, lo, w_lo, r)
        out[f"ski_fused_pass2 {label}"] = ski_fused.ski_fused_pass2(
            x, z, a, f, True)
        out[f"ski_fused_pass2 {label} backward"] = ski_fused.ski_fused_pass2(
            x, z, a, f.flip(-1).contiguous(), True, left=m - 1,
            transpose_a=True)
    for label, b, n, d, r, m, left in _expand_shapes():
        x, z2, f = _expand_inputs(b, n, d, r, m, seed=9)
        out[f"ski_expand_pass2 {label}"] = ski_fused.ski_expand_pass2(
            x, z2, f, True, left=left)
    return out


#: conv_tap_grad's timed and compared offsets at the path (causal and
#: bidirectional taps)
TAP_GRAD_LEFTS = (0, 16)
#: gram_grad's timed and compared shapes (label, b, r, d): the SKI path and
#: the dense route's ceilings
GRAM_SHAPES = (("path", 8, 64, 512),
               *((label, b, r, d)
                 for label, b, n, d, r, m in chip_smoke.PASS2_CEILING))


def _grad_inputs(seed):
    """g, x (8, 512, 512) and gz, z at each GRAM_SHAPES shape."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    gx = [torch.randn(8, 512, 512, device="cuda", generator=g)
          for _ in range(2)]
    gram = {label: [torch.randn(b, r, d, device="cuda", generator=g)
                    for _ in range(2)]
            for label, b, r, d in GRAM_SHAPES}
    return gx, gram


def _time_ski_grad(peaks) -> dict:
    """Unchecked, timed as chip_smoke times them: conv_tap_grad at the SKI
    path (g, x (8, 512, 512), m = 32) at TAP_GRAD_LEFTS, and gram_grad at
    GRAM_SHAPES, with their bytes bounds."""
    from repro_torch.kernels import ski_grad
    (cot, x), gram = _grad_inputs(seed=8)
    out = {}
    m = 32
    for left in TAP_GRAD_LEFTS:
        out[f"conv_tap_grad left={left}"] = {
            "ms": chip_smoke.time_ms(
                lambda: ski_grad.conv_tap_grad(cot, x, m, left)),
            "bound_ms": 4 * (2 * x.numel() + 512 * m) / peaks[0] * 1e3}
    for label, b, r, d in GRAM_SHAPES:
        gz, z = gram[label]
        out[f"gram_grad {label}"] = {
            "ms": chip_smoke.time_ms(lambda: ski_grad.gram_grad(gz, z)),
            "bound_ms": 4 * (2 * z.numel() + d * r * r) / peaks[0] * 1e3}
    return out


def _ski_grad_outputs() -> dict:
    """The same calls on fixed inputs, for max |new - old|."""
    from repro_torch.kernels import ski_grad
    (cot, x), gram = _grad_inputs(seed=9)
    out = {f"conv_tap_grad left={left}": ski_grad.conv_tap_grad(cot, x, 32,
                                                                left)
           for left in TAP_GRAD_LEFTS}
    for label, *_ in GRAM_SHAPES:
        out[f"gram_grad {label}"] = ski_grad.gram_grad(*gram[label])
    return out


def _short_conv_inputs(seed):
    """short_conv's inputs at every shape of the smoke run (label, x, f,
    left): fp32 at SKI_SHAPES, bf16 at ``short_conv_bf16_inputs``."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    out = []
    for label, b, n, d, r, m, left in chip_smoke.SKI_SHAPES:
        out.append((label, torch.randn(b, n, d, device="cuda", generator=g),
                    torch.randn(d, m, device="cuda", generator=g), left))
    return out + [(f"{label} bf16", x, f, left) for label, x, f, left
                  in chip_smoke.short_conv_bf16_inputs(g)]


def _time_short_conv(peaks) -> dict:
    """Unchecked, timed as chip_smoke times it: short_conv at every shape
    of ``_short_conv_inputs``, with its bytes bound."""
    from repro_torch.kernels import short_conv
    return {f"short_conv {label}": {
        "ms": chip_smoke.time_ms(lambda: short_conv.short_conv(x, f, left)),
        "bound_ms": x.element_size() * (2 * x.numel() + f.numel())
        / peaks[0] * 1e3}
        for label, x, f, left in _short_conv_inputs(seed=8)}


def _short_conv_outputs() -> dict:
    """short_conv at every shape of ``_short_conv_inputs``, for
    max |new - old|."""
    from repro_torch.kernels import short_conv
    return {f"short_conv {label}": short_conv.short_conv(x, f, left)
            for label, x, f, left in _short_conv_inputs(seed=9)}


#: library name -> the unchecked timing of ``--time-only``
TIMERS = {"ski": _time_ski, "ski_grad": _time_ski_grad,
          "short_conv": _time_short_conv}
#: library name -> its kernels' outputs on fixed inputs, compared between
#: builds (max |build - new|)
OUTPUTS = {"ski": _ski_outputs, "ski_grad": _ski_grad_outputs,
           "short_conv": _short_conv_outputs}


def tool(name: str) -> str:
    """Path of a CUDA toolkit program (PATH, then /usr/local/cuda/bin)."""
    path = shutil.which(name) or f"/usr/local/cuda/bin/{name}"
    if not Path(path).is_file():
        raise RuntimeError(f"{name} not found")
    return path


def build_variants(srcs, out_dir: Path = AB_DIR) -> dict:
    """Each source built as the backend builds its sources, into
    ``out_dir/lib<stem>.so``, one ``nvcc`` each, all started together.
    Returns {stem: library path}."""
    from repro_torch.kernels import backend
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {src.stem: (out_dir / f"lib{src.stem}.so", subprocess.Popen(
        [tool("nvcc"), *backend.NVCC_FLAGS, "-o",
         str(out_dir / f"lib{src.stem}.so"), str(src)])) for src in srcs}
    failed = [stem for stem, (_, proc) in procs.items() if proc.wait()]
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}")
    return {stem: out for stem, (out, _) in procs.items()}


@contextlib.contextmanager
def loading(name: str, path: Path):
    """The port's wrappers load library ``name`` from ``path`` inside the
    block (their cached handles are dropped on entry and on exit)."""
    from repro_torch.kernels import backend
    lib = backend.load(path)
    real = backend.library

    def clear():
        for mod in list(sys.modules.values()):
            if (getattr(mod, "__name__", "").startswith("repro_torch.kernels.")
                    and hasattr(getattr(mod, "_lib", None), "cache_clear")):
                mod._lib.cache_clear()
    clear()
    backend.library = lambda n: lib if n == name else real(n)
    try:
        with _compat(name, lib):
            yield lib
    finally:
        backend.library = real
        clear()


@contextlib.contextmanager
def _compat(name: str, lib):
    """A ski build without ``ski_fused_pass2_at_f32`` (before the dense
    pass 2 read Aᵀ in place) runs ``transpose_a`` as its own backward did:
    on a transposed copy of A, through its ``ski_fused_pass2_f32``."""
    if name != "ski" or hasattr(lib, "ski_fused_pass2_at_f32"):
        yield
        return
    from repro_torch.kernels import ski_fused, ski_vjp
    real = ski_fused.ski_fused_pass2

    def pass2(x, z, a, f, causal, left=None, transpose_a=False):
        if transpose_a:
            a = a.transpose(1, 2).contiguous()
        return real(x, z, a, f, causal, left=left)
    with contextlib.ExitStack() as stack:
        for mod in (ski_fused, ski_vjp):
            stack.enter_context(mock.patch.object(mod, "ski_fused_pass2",
                                                  pass2))
        yield


def ptxas_report(src: Path) -> str:
    """``ptxas -v`` of ``src`` built to a cubin (stderr of nvcc)."""
    from repro_torch.kernels import backend
    AB_DIR.mkdir(parents=True, exist_ok=True)
    flags = [f for f in backend.NVCC_FLAGS
             if f not in ("-shared", "-Xcompiler", "-fPIC")]
    out = subprocess.run(
        [tool("nvcc"), *flags, "-cubin", "-Xptxas", "-v", "-o",
         str(AB_DIR / f"{src.stem}.cubin"), str(src)],
        capture_output=True, text=True, check=True)
    return out.stderr.strip()


def ptxas_summary(report: str) -> dict:
    """{kernel: "N registers, S bytes spilled (stores/loads)"} from a
    ``ptxas -v`` report."""
    out, fn = {}, None
    for line in report.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            fn = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if fn and m:
            out[fn] = f"{m.group(1)}/{m.group(2)} bytes spilled"
        m = re.search(r"Used (\d+) registers", line)
        if fn and m:
            out[fn] = f"{m.group(1)} registers, " + out.get(fn, "")
    return out


def mma_counts(lib: Path) -> dict:
    """Tensor-core instructions (HMMA, HGMMA) in the SASS of each kernel of
    ``lib``, by mangled function name."""
    sass = subprocess.run([tool("cuobjdump"), "--dump-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            counts[fn] = 0
        elif fn and re.search(r"\b(HMMA|HGMMA)\b", line):
            counts[fn] += 1
    return counts


def blocks_per_sm(path: Path) -> dict:
    """What each exported ``*_blocks_per_sm()`` of the library returns."""
    nm = shutil.which("nm")
    if nm is None:
        raise RuntimeError("nm not found")
    syms = subprocess.run([nm, "-D", "--defined-only", str(path)],
                          capture_output=True, text=True, check=True).stdout
    lib = ctypes.CDLL(str(path))
    out = {}
    for sym in re.findall(r"\b(\w+_blocks_per_sm)$", syms, re.M):
        fn = getattr(lib, sym)
        fn.restype = ctypes.c_int
        out[sym] = fn()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("name", choices=sorted(CHECKS))
    ap.add_argument("--old", type=Path, action="append", default=[])
    ap.add_argument("--out", type=Path)
    ap.add_argument("--time-only", action="store_true",
                    help="time the kernels of TIMERS without the checks")
    ap.add_argument("--only", action="append", choices=sorted(SKI_TIMERS),
                    help="ski --time-only: time these groups alone")
    args = ap.parse_args()
    if args.time_only and args.name not in TIMERS:
        ap.error(f"--time-only: no timing for {args.name}")
    if args.only and not (args.time_only and args.name == "ski"):
        ap.error("--only needs ski --time-only")
    out = args.out or ROOT / "chiprun_out" / f"ab_{args.name}.json"
    if not torch.cuda.is_available():
        print("ab_kernel: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import backend
    smi = chip_smoke.phase_device()
    _, peaks = chip_smoke._peaks(smi)
    src = backend.SOURCES[args.name]
    print(ptxas_report(src), flush=True)
    for old in args.old:
        print(f"[ptxas] {old.stem}: {ptxas_summary(ptxas_report(old))}",
              flush=True)
    if args.old:
        print(f"[ptxas] new: {ptxas_summary(ptxas_report(src))}", flush=True)
    paths = {"new": backend.build(args.name)[0]}
    paths.update(build_variants(args.old))
    report = {"device": smi, "torch": torch.__version__,
              "cuda": torch.version.cuda, "library": args.name,
              "mma": {b: mma_counts(p) for b, p in paths.items()},
              "blocks_per_sm": {b: blocks_per_sm(p)
                                for b, p in paths.items()}}
    print(f"[sass] tensor-core instructions by kernel: {report['mma']}; "
          f"blocks an SM: {report['blocks_per_sm']}", flush=True)
    order = [b for old in args.old
             for b in (old.stem, "new", "new", old.stem)] or ["new"]
    times, outputs = {}, {}
    for build in order:
        print(f"[ab] {args.name}: build {build}", flush=True)
        with loading(args.name, paths[build]):
            if args.only:
                entries = _time_ski(peaks, args.only)
            else:
                entries = (TIMERS if args.time_only else CHECKS)[args.name](
                    peaks)
            if args.name in OUTPUTS and build not in outputs:
                outputs[build] = {k: v.cpu() for k, v in
                                  OUTPUTS[args.name]().items()}
        for kernel, e in entries.items():
            for key in ("ms", "ms_run"):
                if key in e:
                    name = kernel + ("" if key == "ms" else " ms_run")
                    times.setdefault(name, {}).setdefault(build, []).append(
                        e[key])
            run = (f", ms_run {e['ms_run']:.5f}" if "ms_run" in e else "")
            print(f"[time] {kernel} {build}: {e['ms']:.4f} ms{run} (bound "
                  f"{e['bound_ms']:.4f})", flush=True)
    report["ms"] = times
    if outputs:
        report["max_abs_diff_vs_new"] = {
            build: {k: float((v.float() - outputs["new"][k].float())
                             .abs().max())
                    for k, v in outs.items()}
            for build, outs in outputs.items() if build != "new"}
        print(f"[diff] max |build - new| on the same inputs: "
              f"{report['max_abs_diff_vs_new']}", flush=True)
    line = json.dumps(report)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
