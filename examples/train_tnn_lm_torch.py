"""End-to-end training with the PyTorch port: pre-train a TNN causal LM (the
baseline ``tno``, ``ski`` or ``fd`` mixer) on the synthetic corpus through
``repro_torch``'s data pipeline, training step and fault-tolerant
``Trainer``, with optional checkpoints. The PyTorch sibling of
``examples/train_tnn_lm.py``; it imports only ``repro_torch``.

Smoke scale (2 layers, d = 128, vocab 1024) on the card:
  PYTHONPATH=src python examples/train_tnn_lm_torch.py --variant tno --steps 200

On the CPU (the plain versions of the kernels):
  PYTHONPATH=src python examples/train_tnn_lm_torch.py --device cpu --steps 20

Full width (6 layers, d = 512, vocab 50265): add ``--full-size``.
"""
import argparse
import math

import torch

from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.data.pipeline import DataConfig
from repro_torch.launch.steps import make_train_step
from repro_torch.models.transformer import init_model
from repro_torch.optim import adamw
from repro_torch.runtime.trainer import Trainer, TrainerConfig

ARCHS = {"tno": "tnn-lm-wt103", "ski": "ski-tnn-lm-wt103",
         "fd": "fd-tnn-lm-wt103"}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--variant", default="fd", choices=sorted(ARCHS))
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--full-size", action="store_true",
                    help="the paper's 6 layers, d = 512, instead of smoke")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint here every 100 steps and resume from "
                         "the latest one (default: no checkpoints)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    cfg = get_config(ARCHS[args.variant])
    if not args.full_size:
        cfg = reduce_for_smoke(cfg, d_model=128, vocab=1024, n_layers=2)
    device = torch.device(args.device)
    model = init_model(cfg, torch.Generator().manual_seed(args.seed),
                       device=device)
    opt_cfg = adamw.OptConfig(lr=1e-3, warmup_steps=20,
                              total_steps=args.steps)
    opt = adamw.init(opt_cfg, dict(model.named_parameters()))
    data_cfg = DataConfig(vocab=cfg.vocab, seq_len=args.seq_len,
                          global_batch=args.batch, kind="synthetic",
                          seed=args.seed)
    tcfg = TrainerConfig(total_steps=args.steps, ckpt_dir=args.ckpt_dir,
                         ckpt_every=100, log_every=25)
    trainer = Trainer(tcfg, make_train_step(cfg, opt_cfg), data_cfg)
    opt, start = trainer.try_restore(model, opt)
    opt, end = trainer.run(model, opt, start)

    nlls = [float(m["nll"]) for m in trainer.metrics_history]
    if not nlls:
        print(f"[example] {args.variant}: nothing to do (restored at step "
              f"{start} of {args.steps})")
        return 0
    print(f"[example] {args.variant} ({cfg.name}, {device}): nll "
          f"{nlls[0]:.3f} -> {nlls[-1]:.3f} (ppl {math.exp(nlls[-1]):.1f}) "
          f"over {end - start} steps")
    if len(nlls) > 1 and not nlls[-1] < nlls[0]:
        raise AssertionError("training should reduce the loss")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
