"""Training runtime: fault-tolerant step loop, counterpart of
``repro/runtime/trainer.py``.

* **Checkpoint/restart** — async manifest checkpoints every ``ckpt_every``
  steps and a final synchronous one, in the JAX package's layout
  (``bridge.train_state_to_jax``); ``try_restore`` resumes from the latest
  committed step (params + optimizer state + data cursor).
* **Preemption** — SIGTERM/SIGINT triggers a final synchronous
  checkpoint, then a clean exit.
* **Step retry** — transient failures (injected in tests via
  ``failure_hook``) retry the same step up to ``max_retries`` times; the
  data pipeline is stateless, so a retried step re-reads the same batch.
  The port's ``train_step`` updates parameters and optimizer state in
  place, so a failed attempt may leave them half-updated: before each step
  the trainer always clones both on their device (one device copy of the
  state per step; the JAX trainer's ``undonated_retry_copy`` plays this
  part for donated buffers) and copies the clone back before a retry.
* **NaN guard** — a non-finite loss fails the attempt and retries; a
  persistent one raises. Either way the pre-step clone is copied back
  first, so no non-finite update stays in the parameters.
* **Straggler monitor** — per-step wall time EMA; steps slower than
  ``straggler_factor`` × the EMA are logged with their step index.
* **Dispatch banner** — ``run()`` logs the device and, on CUDA, the path
  of the kernel library once at startup.
* **Metrics** — JAX's seven families in the obs registry:
  ``repro_train_steps_total``, ``repro_train_retries_total``,
  ``repro_train_stragglers_total``, ``repro_train_checkpoints_total{mode}``,
  the ``repro_train_step_seconds`` histogram and the ``repro_train_loss``
  and ``repro_train_tokens_per_s`` gauges. ``run`` is one
  ``obs.profiling.session("train")`` and each step an
  ``annotation("train_step")`` (both no-ops unless ``REPRO_PROFILE_DIR``).
  ``metrics_history`` and ``step_seconds`` keep each step's metrics and
  wall time.
"""
from __future__ import annotations

import dataclasses
import logging
import math
import signal
import time
from typing import Callable, Optional

import numpy as np
import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch import bridge
from repro_torch.checkpoint import manifest as ckpt
from repro_torch.data.pipeline import DataConfig, batch_at
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import profiling as obs_prof
from repro_torch.parallel.sharding import data_axes_of


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 100
    keep_ckpts: int = 3
    max_retries: int = 2
    straggler_factor: float = 3.0
    ema_alpha: float = 0.1
    log_every: int = 10


class StragglerMonitor:
    """EMA step-time outlier detector."""

    def __init__(self, factor: float, alpha: float):
        self.factor = factor
        self.alpha = alpha
        self.ema: Optional[float] = None
        self.flagged: list = []

    def observe(self, step: int, dt: float) -> bool:
        is_straggler = self.ema is not None and dt > self.factor * self.ema
        if is_straggler:
            self.flagged.append((step, dt, self.ema))
        # EMA excludes outliers so one straggler doesn't mask the next
        if not is_straggler:
            self.ema = dt if self.ema is None else (
                (1 - self.alpha) * self.ema + self.alpha * dt)
        return is_straggler


def _device_batch(device):
    def put(host_batch):
        return {k: torch.from_numpy(np.asarray(v)).to(device, torch.long)
                for k, v in host_batch.items()}
    return put


def put_batch(mesh):
    """``put_batch`` for a mesh, as JAX's ``launch/train.put_batch``: the
    pipeline's host batch (this rank's rows of the global batch, its
    ``DataConfig`` built with ``launch/mesh.data_rank``) as int64
    DTensors sharded on the rows over the data axes and replicated over
    the rest."""
    data_axes = data_axes_of(mesh)
    pl = [Shard(0) if n in data_axes else Replicate()
          for n in mesh.mesh_dim_names]

    def put(host_batch):
        return {k: DTensor.from_local(
                    torch.from_numpy(np.asarray(v)).to(mesh.device_type,
                                                       torch.long),
                    mesh, pl, run_check=False)
                for k, v in host_batch.items()}
    return put


class Trainer:
    def __init__(self, cfg: TrainerConfig, train_step: Callable,
                 data_cfg: DataConfig, *,
                 put_batch: Optional[Callable] = None,
                 failure_hook: Optional[Callable[[int, int], None]] = None,
                 log: Optional[Callable[[str], None]] = None,
                 metrics=None):
        """``train_step(model, opt_state, batch) -> (opt_state, metrics)``
        (``launch/steps.make_train_step``) may update the model and the
        optimizer state in place. ``put_batch(host_batch) -> batch`` places
        the pipeline's numpy batch (default: int64 tensors on the model's
        device). ``failure_hook(step, attempt)`` may raise to inject
        failures. ``log`` defaults to the ``repro_torch.trainer`` logger.
        ``metrics`` is an obs registry (default: the process registry — a
        no-op unless ``REPRO_METRICS``)."""
        self.cfg = cfg
        self.train_step = train_step
        self.data_cfg = data_cfg
        self.put_batch = put_batch
        self.failure_hook = failure_hook
        self.log = log or logging.getLogger("repro_torch.trainer").info
        self.metrics = (metrics if metrics is not None
                        else obs_metrics.default_registry())
        m = self.metrics
        self._m_steps = m.counter(
            "repro_train_steps_total", "training steps completed")
        self._m_retries = m.counter(
            "repro_train_retries_total", "training step retries")
        self._m_stragglers = m.counter(
            "repro_train_stragglers_total", "steps flagged as stragglers")
        self._m_ckpts = m.counter(
            "repro_train_checkpoints_total",
            "checkpoint saves issued", ("mode",))
        self._m_step_s = m.histogram(
            "repro_train_step_seconds", "train_step wall time")
        self._m_loss = m.gauge(
            "repro_train_loss", "last finite training loss")
        self._m_tok_s = m.gauge(
            "repro_train_tokens_per_s", "training throughput, last step")
        self.monitor = StragglerMonitor(cfg.straggler_factor, cfg.ema_alpha)
        self.ckpt = (ckpt.AsyncCheckpointer(cfg.ckpt_dir, cfg.keep_ckpts)
                     if cfg.ckpt_dir else None)
        self._preempted = False
        self.metrics_history: list = []
        self.step_seconds: list = []

    # ---------------------------------------------------------- signals
    def _install_signals(self):
        def handler(signum, frame):
            self._preempted = True
            self.log(f"[trainer] signal {signum}: checkpoint-and-exit requested")
        self._old = {s: signal.signal(s, handler)
                     for s in (signal.SIGTERM, signal.SIGINT)}

    def _restore_signals(self):
        for s, h in getattr(self, "_old", {}).items():
            signal.signal(s, h)

    # ------------------------------------------------------------- ckpt
    def _save(self, step: int, model, opt, *, sync: bool = False):
        if self.ckpt is None:
            return
        extra = {"data_step": step}
        tree = bridge.train_state_to_jax(model, opt)
        if sync:
            self.ckpt.wait()
            ckpt.save(self.cfg.ckpt_dir, step, tree, extra=extra)
        else:
            self.ckpt.save_async(step, tree, extra=extra)

    def try_restore(self, model, opt):
        """Load the latest committed checkpoint into ``model`` (in place)
        and return (opt_state, start_step); (opt, 0) if there is none."""
        if self.cfg.ckpt_dir is None:
            return opt, 0
        step = ckpt.latest_step(self.cfg.ckpt_dir)
        if step is None:
            return opt, 0
        tree, extra = ckpt.restore(self.cfg.ckpt_dir,
                                   bridge.train_state_to_jax(model, opt),
                                   step=step)
        opt = bridge.load_train_state(model, tree)
        self.log(f"[trainer] restored step {step}")
        return opt, int(extra.get("data_step", step))

    # -------------------------------------------------------------- run
    def _banner(self, device: torch.device) -> str:
        if device.type == "cuda":
            from repro_torch.kernels import backend
            return (f"[trainer] device {device} "
                    f"({torch.cuda.get_device_name(device)}): CUDA kernels "
                    f"from {', '.join(map(str, backend.build()))}")
        return f"[trainer] device {device}: plain torch kernel versions"

    def run(self, model, opt, start_step: int = 0):
        """Train from ``start_step`` to ``total_steps``. Returns
        (opt_state, step reached); the model is updated in place."""
        device = next(model.parameters()).device
        put = self.put_batch or _device_batch(device)
        self.log(self._banner(device))
        self._install_signals()
        prof = obs_prof.session("train")   # no-op unless REPRO_PROFILE_DIR
        prof.__enter__()
        try:
            step = start_step
            while step < self.cfg.total_steps and not self._preempted:
                batch = put(batch_at(self.data_cfg, step))
                opt, metrics = self._step_with_retry(step, model, opt, batch)
                self.metrics_history.append(metrics)
                self._m_steps.inc()
                if self.cfg.log_every and step % self.cfg.log_every == 0:
                    ms = {k: float(v) for k, v in metrics.items()}
                    self.log(f"[trainer] step {step}: {ms}")
                step += 1
                if self.ckpt and step % self.cfg.ckpt_every == 0:
                    self._save(step, model, opt)
                    self._m_ckpts.labels(mode="async").inc()
            if self.ckpt:
                self._save(step, model, opt, sync=True)  # final / preemption
                self._m_ckpts.labels(mode="sync").inc()
            return opt, step
        finally:
            self._restore_signals()
            prof.__exit__(None, None, None)

    @staticmethod
    def _snapshot(model, opt):
        return ({k: p.detach().clone() for k, p in model.named_parameters()},
                ckpt.tree_map(lambda t: t.detach().clone(), opt))

    @staticmethod
    @torch.no_grad()
    def _copy_back(backup, model, opt) -> None:
        params, opt_saved = backup
        for k, p in model.named_parameters():
            p.copy_(params[k])
        for live, saved in zip(ckpt.tree_leaves(opt),
                               ckpt.tree_leaves(opt_saved)):
            live.copy_(saved)

    def _step_with_retry(self, step: int, model, opt, batch):
        last_err: Optional[BaseException] = None
        backup = self._snapshot(model, opt)
        for attempt in range(self.cfg.max_retries + 1):
            try:
                if attempt > 0:
                    self._copy_back(backup, model, opt)
                if self.failure_hook is not None:
                    self.failure_hook(step, attempt)
                t0 = time.perf_counter()
                with obs_prof.annotation("train_step"):
                    new_opt, metrics = self.train_step(model, opt, batch)
                loss = metrics.get("loss")
                if loss is not None:
                    loss = float(loss)
                    if not math.isfinite(loss):
                        raise FloatingPointError(
                            f"non-finite loss at step {step}")
                dt = time.perf_counter() - t0
                self.step_seconds.append(dt)
                self._m_step_s.observe(dt)
                if loss is not None:
                    self._m_loss.set(loss)
                if isinstance(batch, dict) and "tokens" in batch and dt > 0:
                    self._m_tok_s.set(float(batch["tokens"].numel()) / dt)
                if self.monitor.observe(step, dt):
                    self._m_stragglers.inc()
                    self.log(f"[trainer] straggler: step {step} took {dt:.3f}s "
                             f"(ema {self.monitor.ema:.3f}s)")
                return new_opt, metrics
            except (FloatingPointError, RuntimeError, ValueError) as e:
                last_err = e
                if attempt < self.cfg.max_retries:
                    self._m_retries.inc()
                self.log(f"[trainer] step {step} attempt {attempt} failed: {e}")
        self._copy_back(backup, model, opt)
        raise RuntimeError(
            f"step {step} failed after {self.cfg.max_retries + 1} attempts"
        ) from last_err
