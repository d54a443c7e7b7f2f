#!/usr/bin/env python3
"""Where a chunk's time goes inside the bf16 SSD scan kernel, on one card.

    python3 tools/ssd_scan_phases.py [--out chiprun_out/ssd_scan_phases.json]

Copies ``src/repro_torch/kernels/csrc/ssd_scan.cu`` into
``build/ssd_scan_phases/`` with a ``clock64()`` stamp at each ``// phase:``
comment of ``ssd_scan_bf16_kernel`` (``start`` before the chunk loop, one
comment where each phase of :data:`PHASES` ends, ``end`` after the loop; a
missing or repeated one raises), builds it, runs it through the port's
wrapper at the path shape (x (8, 2048, 80, 64) bf16, B and C (8, 2048, 1,
128), chunk 128) and prints, for each warp of a block, the mean SM cycles
a chunk spends in each phase:

* ``wait``: ``cp.async.wait_all`` and the barrier after it (tiles landing);
* ``cumsum``: the warp's scan of dt a;
* ``CS^T``: C S^T into y's accumulators;
* ``scores``: the column blocks of C B^T, the scores and scores . X;
* ``y``: y's stores (they wait for the last products);
* ``barrier 2``: waiting for the other warps before the state update;
* ``state``: the state update (and issuing the next C);
* ``barrier 3``, ``loads``: the last barrier, issuing the next X, B, dt.

A phase a warp skips adds its time to the next one that it runs. The
stamps cost a few registers and cycles: the instrumented kernel's time is
printed beside them. Needs a CUDA card and ``nvcc``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke  # noqa: E402
from tools.ab_kernel import build_variant, loading  # noqa: E402

OUT_DIR = ROOT / "build" / "ssd_scan_phases"
PHASES = ("wait", "cumsum", "CS^T", "scores", "y", "barrier 2", "state",
          "barrier 3", "loads")
WARPS, BLOCKS = 8, 640                     # the path shape's grid: 80 x 8


def instrument(src: str) -> str:
    """``src`` with a per-(block, warp) cycle count of each phase written
    to ``g_prof`` after the chunk loop, and ``ssd_scan_phases_copy`` to
    read it."""
    n = len(PHASES)
    code = {"start": f"long long ph[{n}] = {{}}, last = clock64();",
            "end": (f"if (lane == 0) for (int k = 0; k < {n}; ++k) g_prof["
                    "((long long)(blockIdx.y * gridDim.x + blockIdx.x) * "
                    f"{WARPS} + warp) * {n} + k] = ph[k];")}
    for k, name in enumerate(PHASES):
        code[name] = (f"{{ const long long t = clock64(); ph[{k}] += t - "
                      "last; last = t; }")
    for name in code:
        found = re.findall(rf"^[ \t]*// phase: {re.escape(name)}$", src, re.M)
        if len(found) != 1:
            raise RuntimeError(f"'// phase: {name}' found {len(found)} times")
    src = re.sub(r"^([ \t]*)// phase: (.+)$",
                 lambda m: m.group(1) + code[m.group(2)], src, flags=re.M)
    return (f"__device__ long long g_prof[{BLOCKS * WARPS * n}];\n" + src
            + '\nextern "C" int ssd_scan_phases_copy(long long* host) {\n'
              "  return (int)cudaMemcpyFromSymbol(host, g_prof, "
              "sizeof(g_prof));\n}\n")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path,
                    default=ROOT / "chiprun_out" / "ssd_scan_phases.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ssd_scan_phases: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import backend, ssd_scan
    smi = chip_smoke.phase_device()
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    src = OUT_DIR / "ssd_scan_phases.cu"
    src.write_text(instrument(backend.SOURCES["ssd_scan"].read_text()))
    lib_path = build_variant(src, OUT_DIR / "libssd_scan_phases.so")
    gen = torch.Generator(device="cuda").manual_seed(3)
    _, bt, n, h, p, gr, s, q = chip_smoke.SSD_SHAPES[0]
    if bt * h != BLOCKS:
        raise RuntimeError("the path shape's grid changed")
    xs = chip_smoke._ssd_inputs(bt, n, h, p, gr, s, torch.bfloat16, gen)
    with loading("ssd_scan", lib_path) as lib:
        ms = chip_smoke.time_ms(lambda: ssd_scan.ssd_scan(*xs, chunk=q), 10)
        ssd_scan.ssd_scan(*xs, chunk=q)
        torch.cuda.synchronize()
        buf = (ctypes.c_longlong * (BLOCKS * WARPS * len(PHASES)))()
        lib.ssd_scan_phases_copy.argtypes = [ctypes.c_void_p]
        if lib.ssd_scan_phases_copy(ctypes.addressof(buf)):
            raise RuntimeError("cudaMemcpyFromSymbol failed")
    chunks = -(-n // q)
    cyc = np.frombuffer(buf, dtype=np.int64).reshape(
        BLOCKS, WARPS, len(PHASES)) / chunks
    mean = cyc.mean(axis=0)                     # (warp, phase)
    report = {"device": smi, "instrumented_ms": ms, "chunks": chunks,
              "phases": list(PHASES),
              "cycles_per_chunk": {f"warp {w}": [float(v) for v in mean[w]]
                                   for w in range(WARPS)}}
    print(f"[phases] instrumented kernel {ms:.4f} ms; mean SM cycles a chunk "
          "by warp:")
    for w in range(WARPS):
        print(f"  warp {w}: " + ", ".join(
            f"{name} {mean[w, k]:.0f}" for k, name in enumerate(PHASES))
              + f"; total {mean[w].sum():.0f}")
    line = json.dumps(report)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
