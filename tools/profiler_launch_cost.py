#!/usr/bin/env python3
"""Host cost of a small CUDA launch before and after a ``torch.profiler``
session with CUDA activities, in one process.

    python3 tools/profiler_launch_cost.py [--launches 20000] [--runs 7]

Times ``runs`` loops of ``launches`` in-place adds on a 16-element card
tensor (host clock, each loop ending in a synchronise), then opens and
closes one profiler session (CPU and CUDA activities) over a short loop,
then times the loops again, at once and 5 s later. Prints the card's
name and power limit and the median microseconds a launch of each set.
A later phase of ``chip_smoke.py`` that is host-bound pays the
difference, which is why its phase ``obs`` runs after the first phase
that already traces. Needs a CUDA card; exits non-zero without one.
"""
from __future__ import annotations

import argparse
import statistics
import subprocess
import sys
import time

import torch


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--launches", type=int, default=20000)
    ap.add_argument("--runs", type=int, default=7)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profiler_launch_cost: no CUDA device", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip())
    x = torch.zeros(16, device="cuda")

    def us_per_launch(n: int) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            x.add_(1)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n * 1e6

    def runs() -> list:
        return [us_per_launch(args.launches) for _ in range(args.runs)]

    for _ in range(3):
        us_per_launch(args.launches)
    before = runs()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        us_per_launch(args.launches // 10)
    after = runs()
    time.sleep(5)
    later = runs()
    for what, xs in (("before the profiler", before),
                     ("after it", after), ("5 s later", later)):
        print(f"[launch cost] {what}: median {statistics.median(xs):.3f} "
              f"us a launch of {[round(v, 3) for v in xs]}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
