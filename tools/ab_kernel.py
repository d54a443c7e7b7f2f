#!/usr/bin/env python3
"""Two builds of one kernel library's source, side by side on one card.

    python3 tools/ab_kernel.py NAME [--old OTHER.cu ...]
                               [--out chiprun_out/ab_NAME.json]

``NAME`` is a key of ``repro_torch.kernels.backend.SOURCES`` that
:data:`CHECKS` has a check for (``ssd_scan``, ``ski``, ``ski_grad``). Each
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
  the order old, new, new, old for each old build.

With ``--time-only`` the checks are skipped and each build times only
the kernels of :data:`TIMERS` at the main path's shape: for builds that do
not compute the function (an ablation that drops one phase of a kernel, to
see what that phase costs). Where :data:`OUTPUTS` has the library, each
build's outputs on the same fixed inputs are compared with the current
build's (max |build - new|, printed and kept in the report).

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

#: library name -> the chip_smoke.py check of its kernels at their shapes;
#: each takes the card's peaks and returns {kernel: entry with "ms"}
CHECKS = {
    "ski": lambda peaks: {**chip_smoke.phase_ski_kernels(peaks),
                          **chip_smoke.phase_window_kernels(peaks)},
    "ski_grad": chip_smoke.phase_grad_kernels,
    "ssd_scan": chip_smoke.check_ssd_scan,
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


def _time_ski(peaks) -> dict:
    """Unchecked, timed as chip_smoke times them: interp_reduce at the SKI
    path's shape (x (8, 512, 512), r = 64), ski_fused_pass2 (causal) at
    DENSE_SHAPES and, at the path's shape, in the signal backward's
    orientation (Aᵀ, left m - 1), and ski_windowed_pass2 at the large-rank
    path's shape (x (8, 512, 512), r = 512, m = 32, causal)."""
    from repro_torch.core import ski
    from repro_torch.kernels import interp_matvec, ski_fused
    out = {}
    for label, b, n, d, r, m in DENSE_SHAPES:
        x, z, a, f = _dense_inputs(b, n, d, r, m, seed=5)
        if label == "path":
            lo, w_lo, _ = ski.make_inducing(n, r, "cuda")
            out["interp_reduce"] = {
                "ms": chip_smoke.time_ms(
                    lambda: interp_matvec.interp_reduce(x, lo, w_lo, r)),
                "bound_ms": 4 * (x.numel() + z.numel()) / peaks[0] * 1e3}
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
    out["ski_windowed_pass2"] = {"ms": ms, "bound_ms": bound * 1e3}
    return out


def _ski_outputs() -> dict:
    """The dense forward's two kernels on fixed inputs, for max |new - old|:
    interp_reduce and ski_fused_pass2 at DENSE_SHAPES (causal), and the
    backward's pass 2 (Aᵀ, taps flipped, left m - 1)."""
    from repro_torch.core import ski
    from repro_torch.kernels import interp_matvec, ski_fused
    out = {}
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


#: library name -> the unchecked timing of ``--time-only``
TIMERS = {"ski": _time_ski, "ski_grad": _time_ski_grad}
#: library name -> its kernels' outputs on fixed inputs, compared between
#: builds (max |build - new|)
OUTPUTS = {"ski": _ski_outputs, "ski_grad": _ski_grad_outputs}


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
    args = ap.parse_args()
    if args.time_only and args.name not in TIMERS:
        ap.error(f"--time-only: no timing for {args.name}")
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
            entries = (TIMERS if args.time_only else CHECKS)[args.name](
                peaks)
            if args.name in OUTPUTS and build not in outputs:
                outputs[build] = {k: v.cpu() for k, v in
                                  OUTPUTS[args.name]().items()}
        for kernel, e in entries.items():
            times.setdefault(kernel, {}).setdefault(build, []).append(
                e["ms"])
            print(f"[time] {kernel} {build}: {e['ms']:.4f} ms (bound "
                  f"{e['bound_ms']:.4f})", flush=True)
    report["ms"] = times
    if outputs:
        report["max_abs_diff_vs_new"] = {
            build: {k: float((v - outputs["new"][k]).abs().max())
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
