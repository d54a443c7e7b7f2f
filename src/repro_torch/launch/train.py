"""Training launcher: ``python -m repro_torch.launch.train --arch <id>
[--smoke] [--device cpu] [...]``, counterpart of ``repro/launch/train.py``.

Wires ``launch/steps.make_train_step`` (loss, autograd, AdamW) + the data
pipeline + the fault-tolerant ``runtime/trainer.Trainer`` on one device:
``cuda`` by default, where every FD-TNO and SKI-TNO forward and backward
runs the hand-written kernels (``fd-tnn-lm-wt103``, ``ski-tnn-lm-wt103``)
and the baseline ``tnn-lm-wt103`` runs cuFFT and cuBLAS (no hand kernel,
as XLA ran it); ``--device cpu`` runs the plain versions. The attention
decoders ``gemma3-4b``, ``stablelm-3b``, ``phi3-medium-14b`` and
``qwen2-72b`` train in bf16 with plain torch attention and cuBLAS;
``--mixer fd|ski|tno`` puts the paper's mixer in place of their attention
and local mixers (on the TNN archs it changes nothing, as in JAX).
``mamba2-2.7b`` (and the jamba hybrid) train in bf16 through the Mamba
kernels: a layer's forward launches the bf16 ``short_conv`` and
``ssd_scan``, its backward the bf16 ``short_conv`` (dx) and
``conv_tap_grad_bf16`` (the taps' cotangent) and runs autograd through
the chunked SSD scan (``kernels/ssd_scan.SSDScan``), with every layer
checkpointed under the config's ``remat="full"``.
Multi-device meshes (``--production-mesh``) and the metrics / trace files
come with later slices (ROADMAP Queue 1 items 10 and 12).
"""
from __future__ import annotations

import argparse
import dataclasses
import logging
import time

import torch

from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.data.pipeline import DataConfig
from repro_torch.launch.steps import make_train_step
from repro_torch.models.transformer import init_model
from repro_torch.optim import adamw
from repro_torch.runtime.trainer import Trainer, TrainerConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--smoke", action="store_true",
                    help="reduce the config to CPU scale")
    ap.add_argument("--mixer", default="",
                    choices=["", "tno", "ski", "fd"],
                    help="override the token mixer with a paper variant")
    ap.add_argument("--data", default="synthetic",
                    choices=["synthetic", "bytes", "lra_match"])
    ap.add_argument("--data-path", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(message)s")

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = reduce_for_smoke(cfg)
    if args.mixer:
        cfg = dataclasses.replace(cfg, mixer_override=args.mixer)
    device = torch.device(args.device)
    model = init_model(cfg, torch.Generator().manual_seed(args.seed),
                       device=device)
    opt_cfg = adamw.OptConfig(lr=args.lr, warmup_steps=args.warmup,
                              total_steps=args.steps)
    opt = adamw.init(opt_cfg, dict(model.named_parameters()))
    data_cfg = DataConfig(vocab=cfg.vocab, seq_len=args.seq_len,
                          global_batch=args.global_batch, seed=args.seed,
                          kind=args.data, path=args.data_path)
    tcfg = TrainerConfig(total_steps=args.steps, ckpt_dir=args.ckpt_dir,
                         ckpt_every=args.ckpt_every)
    trainer = Trainer(tcfg, make_train_step(cfg, opt_cfg), data_cfg)

    opt, start = trainer.try_restore(model, opt)
    t0 = time.time()
    opt, end = trainer.run(model, opt, start)
    dt = time.time() - t0
    steps_done = max(end - start, 1)
    final = (trainer.metrics_history[-1] if trainer.metrics_history else {})
    print(f"[train] {steps_done} steps in {dt:.1f}s "
          f"({steps_done / dt:.2f} it/s); final metrics: "
          f"{ {k: float(v) for k, v in final.items()} }")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
