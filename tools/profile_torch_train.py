#!/usr/bin/env python3
"""Where the time goes in the PyTorch port's training step, on one card.

    python3 tools/profile_torch_train.py [--arch ski-tnn-lm-wt103]
        [--out profile_train.json]

Builds the full-width fd-tnn-lm-wt103, or the ``--arch`` given (random
weights, seed 0), at the ``chip_smoke.py`` training workload (AdamW,
synthetic data, 8 x 512 tokens a step), takes three warm-up steps, then
traces with ``torch.profiler`` (``trace`` of
``tools/profile_torch_serve.py``):

* ``step``: three whole ``train_step`` calls;
* ``loss_and_grads``: the forward, the loss and the backward of one step;
* ``optimizer``: one ``adamw.step`` on those gradients;
* ``pre_step_clone``: the Trainer's clone of parameters and optimizer
  state before each step;
* ``data``: ``batch_at`` of one step and its copy to the card.

For each region it prints the host wall time (ending in a synchronise),
the device busy time, the idle share, the device event count and the top
kernels by device time. For ``--arch ski-tnn-lm-wt103`` it then prints the
device ms of each SKI kernel in one step (``loss_and_grads``), by name, with
its launches and its share of that region's busy time. Then, untraced (the
profiler's host overhead inflates short regions), the median wall of five
runs of ``train_step``, ``pre_step_clone`` and ``data``: the parts of one
``Trainer.run`` step.
Needs a CUDA card; exits non-zero without one.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tools"))

from profile_torch_serve import trace  # noqa: E402

#: the SKI kernels of a dense training step, by function-name prefix
#: (``tap_grad_reduce``: the second kernel of conv_tap_grad before PR 23)
SKI_KERNELS = ("interp_reduce", "ski_dense_pass2", "gram_grad",
               "conv_tap_grad", "tap_grad_reduce")


def ski_step_kernels(region: dict) -> dict:
    """Device ms, launches and share of the region's busy time of each SKI
    kernel in a traced ``loss_and_grads`` region (one step)."""
    busy = region["device_busy_ms"]
    out = {name: {**e, "share_of_busy": e["ms"] / busy if busy else None}
           for name in SKI_KERNELS
           if (e := region["port_kernels"].get(name))}
    print(f"[ski kernels] one step (loss_and_grads, device busy {busy:.3f} "
          "ms): " + "; ".join(f"{k} {v['ms']:.4f} ms x{v['calls']} "
                              f"({v['share_of_busy']:.2%})"
                              for k, v in out.items()))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="fd-tnn-lm-wt103",
                    choices=["fd-tnn-lm-wt103", "ski-tnn-lm-wt103"])
    ap.add_argument("--out", default=None, help="write the regions as JSON")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_torch_train: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, batch_at
    from repro_torch.launch.steps import loss_and_grads, make_train_step
    from repro_torch.models.transformer import init_model
    from repro_torch.optim import adamw
    from repro_torch.runtime.trainer import Trainer
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config(args.arch)
    model = init_model(cfg, torch.Generator().manual_seed(0), device="cuda")
    ocfg = adamw.OptConfig(lr=3e-4, warmup_steps=5, total_steps=30)
    params = dict(model.named_parameters())
    state = {"opt": adamw.init(ocfg, params)}
    step_fn = make_train_step(cfg, ocfg)
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=512, global_batch=8, seed=0)

    def data(i):
        return {k: torch.from_numpy(v).to("cuda", torch.long)
                for k, v in batch_at(dcfg, i).items()}
    batches = [data(i) for i in range(6)]

    def steps(bs):
        for b in bs:
            state["opt"], _ = step_fn(model, state["opt"], b)

    def grads():
        state["grads"] = loss_and_grads(model, cfg, batches[0])[2]

    def optimizer():
        state["opt"], _ = adamw.step(ocfg, state["opt"], state["grads"],
                                     params)

    steps(batches[:3])                                   # warm-up
    regions = [trace("step", lambda: steps(batches[3:])),
               trace("loss_and_grads", grads),
               trace("optimizer", optimizer),
               trace("pre_step_clone",
                     lambda: Trainer._snapshot(model, state["opt"])),
               trace("data", lambda: data(6))]
    untraced = {
        "train_step": lambda i: steps(batches[i % 6:i % 6 + 1]),
        "pre_step_clone": lambda i: Trainer._snapshot(model, state["opt"]),
        "data": lambda i: data(7 + i)}
    for name, fn in untraced.items():
        walls = []
        for i in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(i)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        print(f"[untraced] {name}: median {statistics.median(walls):.3f} ms "
              f"of {[round(w, 3) for w in walls]}")
        regions.append({"region": f"untraced {name}", "walls_ms": walls})
    ski = (ski_step_kernels(regions[1]) if args.arch == "ski-tnn-lm-wt103"
           else None)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(
            {"device": torch.cuda.get_device_name(0), "arch": args.arch,
             "regions": regions, "ski_kernels_a_step": ski},
            indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
