"""The training step, the scoring forward and the distribution layer's
``StepBuilder``, counterpart of ``repro/launch/steps.py``.

:func:`make_train_step` and :func:`make_forward` are the one-card steps.
:class:`StepBuilder` binds (ArchConfig, mesh, sharding rules) as JAX's
does and gives

* ``abstract_params()`` / ``param_shardings()`` / ``state_shardings()``:
  the parameters on the ``meta`` device (no allocation), their logical
  axes and their specs on the mesh (the optimizer's moments mirror the
  parameters);
* ``init_state(generator)``: the mesh-free ``init_model``'s draws (the
  same generator, the same order, so a sharded model starts bitwise equal
  to the unsharded one on every mesh), each rank then keeping its shards;
* ``make_train_step()`` / ``make_forward()``: the step on the mesh. The
  TNN decoders run sharded (FSDP over the data axes, channel TP over the
  model axis, ``models/transformer.py``); every other arch takes only a
  one-rank mesh, where its state stays plain tensors and the steps are
  the mesh-free ones;
* ``input_specs(shape)``: ``meta`` tensors with JAX's shapes and dtypes
  for an (arch × shape) cell, the decode cache through
  ``serving.init_cache`` on ``meta``; ``serve_ctx`` and
  ``batch_sharding`` as JAX's.

Shape grammar (assignment): ``train_*`` is the train step on (tokens,
labels); ``prefill_*`` the forward; ``decode_*`` / ``long_*`` one decode
step against a cache of seq_len.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate

from repro_torch.configs import get_config
from repro_torch.models import serving
from repro_torch.models.config import ArchConfig
from repro_torch.models.context import Ctx, relayout
from repro_torch.models.transformer import (Model, forward, init_model,
                                            loss_fn, sharded_path_missing)
from repro_torch.nn.params import param_axes
from repro_torch.optim import adamw
from repro_torch.parallel.sharding import (NamedSharding, ShardingRules,
                                           mesh_shape, rules_for_arch,
                                           shard_module, tree_shardings)


# --------------------------------------------------------------- shapes
@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str            # train | prefill | decode


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}

def full_attention_only(cfg: ArchConfig) -> bool:
    """Every mixer of ``cfg`` is full attention (JAX's hand-kept
    ``FULL_ATTENTION_ONLY``, read here from the layer spec)."""
    return all(m == "attention" for m, _ in cfg.layers_spec)


def cell_is_applicable(arch: str, shape: str) -> bool:
    """long_500k is skipped for the full-attention-only archs."""
    return not (shape == "long_500k"
                and full_attention_only(get_config(arch)))


# ------------------------------------------------------- one-card steps
def loss_and_grads(model: Model, cfg: ArchConfig, batch: dict,
                   ctx: Ctx | None = None):
    """(loss, metrics, grads) with grads keyed like
    ``model.named_parameters()``; the parameters' ``.grad`` is untouched.
    With a meshed ``ctx`` the loss is this rank's part
    (``transformer.loss_fn``)."""
    params = dict(model.named_parameters())
    loss, metrics = loss_fn(model, cfg, batch, ctx=ctx)
    grads = torch.autograd.grad(loss, list(params.values()))
    return loss.detach(), metrics, dict(zip(params, grads))


def make_train_step(cfg: ArchConfig, opt_cfg: adamw.OptConfig):
    """Returns ``train_step(model, opt_state, batch) -> (opt_state,
    metrics)``: loss and gradients by autograd (each layer checkpointed
    when ``cfg.remat == "full"``; a Mamba layer's backward runs
    ``ShortConv``'s kernels and ``SSDScan``'s autograd through the chunked
    scan), then one AdamW step that updates the model's parameters and the
    optimizer state in place (JAX's step is functional and returns new
    trees instead).

    The update runs whatever the loss: checking it here would stall the
    card once a step. A caller that must not keep a non-finite step clones
    the state first and restores it, as ``runtime/trainer.Trainer``'s NaN
    guard does."""
    return _train_step(opt_cfg, lambda model, batch: loss_and_grads(
        model, cfg, batch))


def _train_step(opt_cfg: adamw.OptConfig, grads_of):
    """``train_step`` of ``grads_of(model, batch) -> (loss, metrics,
    grads)`` and one AdamW step."""

    def train_step(model: Model, opt_state: adamw.OptState, batch: dict):
        loss, metrics, grads = grads_of(model, batch)
        opt_state, opt_metrics = adamw.step(
            opt_cfg, opt_state, grads, dict(model.named_parameters()))
        metrics = {k: v.detach() for k, v in metrics.items()}
        return opt_state, dict(metrics, loss=loss, **opt_metrics)

    return train_step


def make_forward(cfg: ArchConfig):
    """Returns ``fwd(model, tokens, **inputs) -> logits``: tokens (b, s) →
    logits (b, s, V_pad) under ``torch.inference_mode()`` (``inputs``: an
    encdec's ``enc_embed``, a prefix_vlm's ``patches``), for prompt
    scoring and evaluation (the SKI model has no decode path; a Mamba model
    runs the ``short_conv`` and ``ssd_scan`` kernels once per layer on the
    card, and no layer is checkpointed: ``remat`` acts under grad only; an
    attention decoder runs cuBLAS and plain torch attention, and with
    ``mixer_override`` the paper mixer's kernels)."""

    def fwd(model: Model, tokens: torch.Tensor, **inputs) -> torch.Tensor:
        with torch.inference_mode():
            return forward(model, cfg, tokens, **inputs)

    return fwd


# ------------------------------------------------------------ StepBuilder
class StepBuilder:
    def __init__(self, cfg: ArchConfig, mesh=None, *,
                 rules: Optional[ShardingRules] = None,
                 opt_cfg: Optional[adamw.OptConfig] = None):
        """``mesh``: a named ``DeviceMesh`` (``launch/mesh.py``), a
        stand-in whose ``.shape`` maps axis → extent (the spec tables
        only), or None (the one-card steps). Raises NotImplementedError
        for an arch with no sharded path on a mesh of extent > 1."""
        self.cfg = cfg
        self.mesh = mesh
        self.rules = rules or (rules_for_arch(cfg, mesh)
                               if mesh is not None else None)
        self.opt_cfg = opt_cfg or adamw.OptConfig()
        data_axes = self.rules.data_axes if self.rules else ("data",)
        # Sequence-parallel residual stream for training/prefill (Megatron
        # SP): saved layer inputs are `model`-sharded on seq (DESIGN §5).
        self.ctx = Ctx(mesh=mesh, data_axes=data_axes,
                       seq_shard_resid=mesh is not None)
        missing = sharded_path_missing(cfg)
        if mesh is not None and missing and any(
                e > 1 for e in mesh_shape(mesh).values()):
            raise NotImplementedError(
                f"{cfg.name} on mesh {mesh_shape(mesh)}: {missing} have no "
                "sharded path yet (head/kv TP, expert and Mamba head "
                "sharding: ROADMAP slice 16b); run it on a one-rank mesh")
        self.sharded = mesh is not None and missing is None

    # ------------------------------------------------------------ params
    def abstract_params(self):
        """(name → ``meta`` parameter, name → logical axes): shapes and
        dtypes with no allocation."""
        model = Model(self.cfg, device="meta")
        return dict(model.named_parameters()), param_axes(model)

    def param_shardings(self) -> dict:
        vals, axes = self.abstract_params()
        return tree_shardings(self.mesh, self.rules, axes, vals)

    def state_shardings(self) -> dict:
        """Shardings for (params, opt_state): moments mirror params."""
        ps = self.param_shardings()
        scalar = NamedSharding(self.mesh, ())
        err = (dict(ps) if self.opt_cfg.compress_grads
               else {k: scalar for k in ps})
        return {"params": ps, "opt": adamw.OptState(scalar, ps, ps, err)}

    def init_state(self, generator: torch.Generator, device=None):
        """(model, opt_state): ``init_model``'s parameters from
        ``generator`` on ``device`` (default the mesh's device type), each
        rank keeping its shards of the full draws (plain tensors off the
        sharded path), and zero moments with the parameters' placements."""
        if device is None:
            device = self.mesh.device_type if self.mesh is not None else "cuda"
        model = init_model(self.cfg, generator, device=device)
        if self.sharded:
            shard_module(model, self.param_shardings())
        opt = adamw.init(self.opt_cfg, dict(model.named_parameters()))
        return model, opt

    # ------------------------------------------------------------- steps
    def _data_sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum over the data axes of a value replicated over the
        others (a rank's part of the loss)."""
        pl = [Partial() if n in self.ctx.data_axes else Replicate()
              for n in self.mesh.mesh_dim_names]
        return DTensor.from_local(t, self.mesh, pl).full_tensor()

    def loss_and_grads(self, model: Model, batch: dict):
        """(loss, metrics, grads) of the whole batch on the mesh (the
        sharded path); each gradient with its parameter's placements."""
        params = dict(model.named_parameters())
        loss, metrics, grads = loss_and_grads(model, self.cfg, batch,
                                              self.ctx)
        grads = {k: relayout(g, params[k].placements)
                 for k, g in grads.items()}
        return (self._data_sum(loss),
                {k: self._data_sum(v.detach()) for k, v in metrics.items()},
                grads)

    def make_train_step(self):
        """``train_step(model, opt_state, batch) -> (opt_state, metrics)``
        as :func:`make_train_step`'s; on the sharded path ``batch`` values
        are DTensors with rows over the data axes (``runtime/trainer.
        put_batch``) and the metrics are the whole batch's. Off it (no
        mesh, or a one-rank mesh for an arch of slice 16b) it is the
        mesh-free step."""
        if not self.sharded:
            return make_train_step(self.cfg, self.opt_cfg)
        return _train_step(self.opt_cfg, self.loss_and_grads)

    def make_forward(self):
        """``fwd(model, tokens, **inputs) -> logits`` as
        :func:`make_forward`'s; on the sharded path the logits are a
        DTensor (rows over the data axes, vocab over the model axis:
        ``full_tensor()`` gathers them)."""
        cfg, ctx = self.cfg, self.ctx
        if not self.sharded:
            return make_forward(cfg)

        def sharded_fwd(model: Model, tokens, **inputs):
            with torch.inference_mode():
                return forward(model, cfg, tokens, ctx=ctx, **inputs)
        return sharded_fwd

    def _mesh_sizes(self):
        data = self.rules.data_axes
        shape = mesh_shape(self.mesh)
        return (data, math.prod(shape[a] for a in data),
                shape.get(self.rules.model_axis, 1))

    def serve_ctx(self, shape: Optional[ShapeSpec] = None) -> Ctx:
        """Decode context; for batch-1 long-context cells the idle data
        axes fold into the KV-seq sharding (256-way over a 512k cache)."""
        ctx = dataclasses.replace(self.ctx, decode=True,
                                  seq_shard_resid=False)
        if shape is None or self.mesh is None:
            return ctx
        data, dsz, msz = self._mesh_sizes()
        if shape.global_batch % max(dsz, 1) != 0:
            seq_ax = (tuple(data) + (self.rules.model_axis,)
                      if shape.seq_len % (dsz * msz) == 0
                      else (self.rules.model_axis,))
            ctx = dataclasses.replace(ctx, data_axes=(), seq_kv_axes=seq_ax)
        return ctx

    # ------------------------------------------------------- input specs
    def batch_sharding(self):
        data = self.rules.data_axes if self.rules else ("data",)
        return (NamedSharding(self.mesh, (data, None))
                if self.mesh is not None else None)

    def input_specs(self, shape: ShapeSpec) -> dict:
        """``meta`` tensors for the cell's inputs (+ the cache for decode,
        the port's per-layer list)."""
        cfg = self.cfg
        b, n = shape.global_batch, shape.seq_len
        adt = getattr(torch, cfg.dtype)

        def meta(*s, dtype=torch.int32):
            return torch.empty(s, dtype=dtype, device="meta")
        if shape.kind in ("train", "prefill"):
            specs = {"tokens": meta(b, n)}
            if shape.kind == "train":
                specs["labels"] = meta(b, n)
            if cfg.kind == "prefix_vlm":
                specs["patches"] = meta(b, cfg.n_prefix, cfg.d_model,
                                        dtype=adt)
            if cfg.kind == "encdec":
                specs["enc_embed"] = meta(b, n, cfg.d_model, dtype=adt)
            return specs
        # decode: one new token against a seq_len cache
        batch = {"tokens": meta(b, 1)}
        if cfg.kind == "encdec":
            batch["enc_out"] = meta(b, min(n, 4096), cfg.d_model, dtype=adt)
        cache = serving.init_cache(cfg, b, n, dtype=adt, device="meta")
        return {"batch": batch, "cache": cache}
