#!/usr/bin/env python3
"""Two builds of one kernel library's source, side by side on one card.

    python3 tools/ab_kernel.py NAME [--old OTHER.cu ...]
                               [--out chiprun_out/ab_NAME.json]

``NAME`` is a key of ``repro_torch.kernels.backend.SOURCES`` that
:data:`CHECKS` has a check for (``ssd_scan``, ``ski``). Each ``--old`` is
another version of that source with the same C interface, for example an
earlier commit's file (``git show
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
    "ssd_scan": chip_smoke.check_ssd_scan,
}


def tool(name: str) -> str:
    """Path of a CUDA toolkit program (PATH, then /usr/local/cuda/bin)."""
    path = shutil.which(name) or f"/usr/local/cuda/bin/{name}"
    if not Path(path).is_file():
        raise RuntimeError(f"{name} not found")
    return path


def build_variant(src: Path, out: Path) -> Path:
    """``src`` built as the backend builds its sources, to ``out``."""
    from repro_torch.kernels import backend
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([tool("nvcc"), *backend.NVCC_FLAGS, "-o", str(out),
                    str(src)], check=True)
    return out


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
        yield lib
    finally:
        backend.library = real
        clear()


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
    args = ap.parse_args()
    out = args.out or ROOT / "chiprun_out" / f"ab_{args.name}.json"
    if not torch.cuda.is_available():
        print("ab_kernel: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import backend
    smi = chip_smoke.phase_device()
    _, peaks = chip_smoke._peaks(smi)
    src = backend.SOURCES[args.name]
    print(ptxas_report(src), flush=True)
    paths = {"new": backend.build(args.name)[0]}
    for old in args.old:
        paths[old.stem] = build_variant(old, AB_DIR / f"lib{old.stem}.so")
    report = {"device": smi, "torch": torch.__version__,
              "cuda": torch.version.cuda, "library": args.name,
              "mma": {b: mma_counts(p) for b, p in paths.items()},
              "blocks_per_sm": {b: blocks_per_sm(p)
                                for b, p in paths.items()}}
    print(f"[sass] tensor-core instructions by kernel: {report['mma']}; "
          f"blocks an SM: {report['blocks_per_sm']}", flush=True)
    order = [b for old in args.old
             for b in (old.stem, "new", "new", old.stem)] or ["new"]
    times = {}
    for build in order:
        print(f"[ab] {args.name}: build {build}", flush=True)
        with loading(args.name, paths[build]):
            entries = CHECKS[args.name](peaks)
        for kernel, e in entries.items():
            times.setdefault(kernel, {}).setdefault(build, []).append(
                e["ms"])
            print(f"[time] {kernel} {build}: {e['ms']:.4f} ms (bound "
                  f"{e['bound_ms']:.4f})", flush=True)
    report["ms"] = times
    line = json.dumps(report)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
