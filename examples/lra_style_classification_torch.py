"""Long-range classification on the offline ``lra_match`` task (the
paper's Table-2 experiment shape) through the PyTorch port: TNN (the
baseline ``tno``), SKI-TNN and FD-TNN decoders, each with a 2-way head on
the last token's logits, trained for a fixed budget; prints the
accuracies. The PyTorch sibling of ``examples/lra_style_classification.py``
(``benchmarks/bench_lra_style.run``'s shape: 2 layers, d = 64, vocab 64,
SKI rank 16 and 8 taps, AdamW at 1e-3 with 10 warm-up steps); it imports
only ``repro_torch``.

  PYTHONPATH=src python examples/lra_style_classification_torch.py --steps 80
  PYTHONPATH=src python examples/lra_style_classification_torch.py --device cpu
"""
import argparse
import dataclasses

import numpy as np
import torch

from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.data.pipeline import DataConfig, batch_at
from repro_torch.models.transformer import forward, init_model
from repro_torch.optim import adamw

VARIANTS = ("tno", "ski", "fd")


def lra_config(variant: str):
    """The bench's model: the smoke TNN at 2 layers, d = 64, vocab 64, one
    ``variant`` mixer a layer, unscanned (the JAX tree's ``tail<i>``)."""
    cfg = reduce_for_smoke(get_config("tnn-lm-wt103"), n_layers=2,
                           d_model=64, vocab=64, tno_rank=16, tno_filter=8)
    return dataclasses.replace(cfg, pattern=((variant, "dense"),),
                               scan_layers=False)


def cls_loss(model, cfg, batch) -> torch.Tensor:
    """Mean cross-entropy of the 2-way head: the first two logits at the
    last position against ``labels[:, 0]``."""
    final = forward(model, cfg, batch["tokens"])[:, -1, :2].float()
    labels = batch["labels"][:, 0].long()
    lse = torch.logsumexp(final, dim=-1)
    ll = torch.gather(final, 1, labels[:, None])[:, 0]
    return torch.mean(lse - ll)


def accuracy(model, cfg, batch) -> float:
    with torch.no_grad():
        pred = torch.argmax(forward(model, cfg, batch["tokens"])[:, -1, :2],
                            dim=-1)
    return float((pred == batch["labels"][:, 0]).float().mean())


def make_step(cfg, ocfg):
    """One AdamW step on :func:`cls_loss`; returns the loss before it."""
    def step(model, opt, batch):
        params = dict(model.named_parameters())
        loss = cls_loss(model, cfg, batch)
        grads = torch.autograd.grad(loss, list(params.values()))
        opt, _ = adamw.step(ocfg, opt, dict(zip(params, grads)), params)
        return opt, loss.detach()
    return step


def device_batch(dcfg, step: int, device):
    return {k: torch.from_numpy(np.asarray(v)).to(device, torch.long)
            for k, v in batch_at(dcfg, step).items()}


def run(steps=60, seq_len=128, batch=32, device="cuda", seed=0):
    """Train each variant for ``steps`` and return {variant: accuracy} on
    a held-out batch (step 10,000 of the data stream)."""
    results = {}
    for variant in VARIANTS:
        cfg = lra_config(variant)
        model = init_model(cfg, torch.Generator().manual_seed(seed),
                           device=device)
        ocfg = adamw.OptConfig(lr=1e-3, warmup_steps=10, total_steps=steps)
        opt = adamw.init(ocfg, dict(model.named_parameters()))
        dcfg = DataConfig(vocab=64, seq_len=seq_len, global_batch=batch,
                          kind="lra_match", seed=seed)
        step = make_step(cfg, ocfg)
        for i in range(steps):
            opt, loss = step(model, opt, device_batch(dcfg, i, device))
        results[variant] = accuracy(model, cfg,
                                    device_batch(dcfg, 10_000, device))
        print(f"[lra-style] {variant}: {steps} steps, last loss "
              f"{float(loss):.4f}, accuracy {100 * results[variant]:.1f}%",
              flush=True)
    return results


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=80)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    results = run(steps=args.steps, seq_len=args.seq_len, batch=args.batch,
                  device=torch.device(args.device))
    print("\n[lra-style] accuracies (chance = 50%):")
    for variant, acc in results.items():
        print(f"  {variant:4s}: {100 * acc:.1f}%")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
