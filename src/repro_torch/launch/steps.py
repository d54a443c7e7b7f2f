"""The training step and the scoring forward, counterparts of
``StepBuilder.make_train_step`` and ``StepBuilder.make_forward`` in
``repro/launch/steps.py``. PyTorch runs eagerly on one card, so there is
no jit, mesh or sharding to bind; the serving steps live in
``models/serving.py`` and ``launch/serve.py``.
"""
from __future__ import annotations

import torch

from repro_torch.models.config import ArchConfig
from repro_torch.models.transformer import Model, forward, loss_fn
from repro_torch.optim import adamw


def loss_and_grads(model: Model, cfg: ArchConfig, batch: dict):
    """(loss, metrics, grads) with grads keyed like
    ``model.named_parameters()``; the parameters' ``.grad`` is untouched."""
    params = dict(model.named_parameters())
    loss, metrics = loss_fn(model, cfg, batch)
    grads = torch.autograd.grad(loss, list(params.values()))
    return loss.detach(), metrics, dict(zip(params, grads))


def make_train_step(cfg: ArchConfig, opt_cfg: adamw.OptConfig):
    """Returns ``train_step(model, opt_state, batch) -> (opt_state,
    metrics)``: loss and gradients by autograd, then one AdamW step that
    updates the model's parameters and the optimizer state in place (JAX's
    step is functional and returns new trees instead).

    The update runs whatever the loss: checking it here would stall the
    card once a step. A caller that must not keep a non-finite step clones
    the state first and restores it, as ``runtime/trainer.Trainer``'s NaN
    guard does."""

    def train_step(model: Model, opt_state: adamw.OptState, batch: dict):
        loss, metrics, grads = loss_and_grads(model, cfg, batch)
        opt_state, opt_metrics = adamw.step(
            opt_cfg, opt_state, grads, dict(model.named_parameters()))
        metrics = {k: v.detach() for k, v in metrics.items()}
        return opt_state, dict(metrics, loss=loss, **opt_metrics)

    return train_step


def make_forward(cfg: ArchConfig):
    """Returns ``fwd(model, tokens) -> logits``: tokens (b, s) → logits
    (b, s, V_pad) under ``torch.inference_mode()``, for prompt scoring and
    evaluation (the SKI model has no decode path)."""

    def fwd(model: Model, tokens: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            return forward(model, cfg, tokens)

    return fwd
