#!/usr/bin/env python3
"""The training launcher's step time on one card, for one source tree.

    python3 tools/time_launch_train.py [--src SRC] [--steps 12]
        [--arch fd-tnn-lm-wt103 --arch ski-tnn-lm-wt103]

Runs ``repro_torch.launch.train.main`` from ``SRC`` (default this
checkout's ``src``; another tree's ``src`` compares two versions) for each
``--arch`` at full width, the ``chip_smoke.py`` training workload (fp32,
8 x 512 tokens a step, seed 0), with ``--trace-file``: the launcher's
``train_step`` span ends after a ``torch.cuda.synchronize``, so each span
is one step's wall. Prints, per arch, the median and the range of the
spans after the first, the first step's, and the launcher's own
``[train]`` line, beside the card's name and power limit. To compare two
trees, run them in one call, in the order A, B, B, A.
Needs a CUDA card; exits non-zero without one.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(Path(__file__).resolve()
                                         .parents[1] / "src"))
    ap.add_argument("--arch", action="append")
    ap.add_argument("--steps", type=int, default=12)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    src = str(Path(args.src).resolve())
    sys.path.insert(0, src)
    from repro_torch.launch import train
    from repro_torch.obs import tracing
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0]
    for arch in args.arch or ["fd-tnn-lm-wt103", "ski-tnn-lm-wt103"]:
        with tempfile.TemporaryDirectory() as d:
            tfile = os.path.join(d, "train.jsonl")
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = train.main(["--arch", arch, "--steps", str(args.steps),
                                 "--seq-len", "512", "--global-batch", "8",
                                 "--trace-file", tfile])
            tracing.set_default_tracer(None)
            if rc != 0:
                raise SystemExit(f"launch.train returned {rc}")
            spans, begun = [], {}
            for e in tracing.load_jsonl(tfile):
                if e["name"] != "train_step":
                    continue
                if e["ph"] == "B":
                    begun[e["attrs"]["step"]] = e["ts"]
                elif e["ph"] == "E":
                    spans.append((e["ts"] - begun[e["attrs"]["step"]])
                                 * 1e3)
        line = next(ln for ln in buf.getvalue().splitlines()
                    if ln.startswith("[train] "))
        warm = spans[1:]
        print(json.dumps({
            "src": src, "arch": arch, "card": smi, "steps": len(spans),
            "first_ms": spans[0], "median_ms": statistics.median(warm),
            "min_ms": min(warm), "max_ms": max(warm),
            "launcher": line[:160]}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
