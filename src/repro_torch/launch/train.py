"""Training launcher: ``python -m repro_torch.launch.train --arch <id>
[--smoke] [--device cpu] [...]``, counterpart of ``repro/launch/train.py``.

Wires ``launch/steps.StepBuilder``'s train step (loss, autograd, AdamW)
+ the data pipeline + the fault-tolerant ``runtime/trainer.Trainer``.
Without a mesh flag it trains on one device with the mesh-free
``make_train_step`` (plain tensors, no process group). Under ``torchrun
--nproc-per-node N`` (NCCL ranks on the cards, gloo with ``--device
cpu``) ``--mesh DxM`` lays the N ranks out as (data=D, model=M) and
``--production-mesh`` as JAX's (16, 16). The TNN decoders train sharded
on it (DTensor state, FSDP over data, channel TP over model, each rank's
rows of JAX's global batch through ``trainer.put_batch``); every other
arch takes only a one-rank mesh for now (ROADMAP slice 16b), and runs the
mesh-free step there. Only rank 0 prints and writes the metrics and trace
files. The device is ``cuda`` by
default, where every FD-TNO and SKI-TNO forward and backward
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
``--metrics-file`` and ``--trace-file`` are JAX's: the obs registry,
installed as the process default (the Trainer's ``repro_train_*``, the
compile watchdog's ``repro_compiles_total{fn="train.train_step"}``),
dumped on exit; ``train_step`` span events (the end after a
``torch.cuda.synchronize`` on the card) streamed as JSONL with a Chrome
export beside them. With ``REPRO_PROFILE_DIR`` set the run is one
profiler session whose kernel regions ``obs.devstats.aggregate_chrome``
reads.
"""
from __future__ import annotations

import argparse
import dataclasses
import logging
import os
import time

import torch
import torch.distributed as dist

from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.data.pipeline import DataConfig
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch.steps import StepBuilder
from repro_torch.optim import adamw
from repro_torch.runtime.trainer import Trainer, TrainerConfig, put_batch


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
    ap.add_argument("--production-mesh", action="store_true",
                    help="JAX's (data=16, model=16) mesh over 256 ranks")
    ap.add_argument("--mesh", default=None, metavar="DxM",
                    help="a (data=D, model=M) mesh over the torchrun ranks, "
                         "e.g. 2x2 (the port's own flag)")
    ap.add_argument("--metrics-file", default=None, metavar="PATH",
                    help="dump the obs metrics registry on exit "
                         "(.json = JSON dump, anything else = Prometheus "
                         "text exposition); also installs the registry as "
                         "the process default so the compile watchdog's "
                         "counters land in it (same contract as "
                         "launch/serve.py)")
    ap.add_argument("--trace-file", default=None, metavar="PATH",
                    help="stream train_step span events to PATH as JSONL "
                         "and write a Chrome trace_event export "
                         "(PATH + '.chrome.json') on exit")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    meshed = args.production_mesh or args.mesh is not None
    if not meshed and int(os.environ.get("WORLD_SIZE", "1")) > 1:
        ap.error("several ranks need --mesh DxM or --production-mesh")
    started = meshed and mesh_mod.init_distributed(device.type)
    try:
        return _run(args, device, meshed)
    finally:
        if started:
            dist.destroy_process_group()


def _mesh(args, device_type: str):
    """The flag's mesh over the process group's ranks, or None (one
    device, the mesh-free step)."""
    if args.production_mesh:
        return mesh_mod.make_production_mesh(device_type=device_type)
    if args.mesh is not None:
        shape = tuple(int(x) for x in args.mesh.lower().split("x"))
        return mesh_mod.make_mesh(shape, ("data", "model"), device_type)
    return None


def _run(args, device: torch.device, meshed: bool) -> int:
    rank0 = not meshed or dist.get_rank() == 0
    logging.basicConfig(level=logging.INFO if rank0 else logging.WARNING,
                        format="%(message)s")

    from repro_torch.obs import metrics as obs_metrics
    from repro_torch.obs import tracing as obs_tracing
    reg = None
    if args.metrics_file is not None and rank0:
        reg = obs_metrics.Registry()
        # process default too: the compile watchdog and the Trainer's own
        # counters report into the same dump (parity with launch/serve.py)
        obs_metrics.set_default_registry(reg)
    tracer = (obs_tracing.Tracer(args.trace_file)
              if args.trace_file is not None and rank0 else None)
    if tracer is not None:
        obs_tracing.set_default_tracer(tracer)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = reduce_for_smoke(cfg)
    if args.mixer:
        cfg = dataclasses.replace(cfg, mixer_override=args.mixer)
    mesh = _mesh(args, device.type)
    opt_cfg = adamw.OptConfig(lr=args.lr, warmup_steps=args.warmup,
                              total_steps=args.steps)
    sb = StepBuilder(cfg, mesh, opt_cfg=opt_cfg)
    model, opt = sb.init_state(torch.Generator().manual_seed(args.seed),
                               device=device)
    host_id, num_hosts = (mesh_mod.data_rank(mesh) if mesh is not None
                          else (0, 1))
    data_cfg = DataConfig(vocab=cfg.vocab, seq_len=args.seq_len,
                          global_batch=args.global_batch, seed=args.seed,
                          kind=args.data, path=args.data_path,
                          host_id=host_id, num_hosts=num_hosts)
    tcfg = TrainerConfig(total_steps=args.steps, ckpt_dir=args.ckpt_dir,
                         ckpt_every=args.ckpt_every)
    # compile watchdog over the trainer's entry point: one first call is
    # expected for the whole run (the batch/seq shapes are fixed); another
    # signature mid-run shows up as
    # repro_compiles_total{fn="train.train_step"} > 1 plus a warning
    from repro_torch.obs import compilewatch as obs_compile
    watch = obs_compile.CompileWatch(prefix="train.")
    watch.expect("train_step", 1)
    train_step = watch.wrap("train_step", sb.make_train_step())
    if tracer is not None:
        import itertools
        inner_step, counter = train_step, itertools.count()

        def train_step(model, opt, batch):
            i = next(counter)
            tracer.begin("train_step", step=i)
            out = inner_step(model, opt, batch)
            # sync before ending the span so the duration is device time,
            # not enqueue time (the Trainer reads the loss right after)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            tracer.end("train_step", step=i)
            return out

    trainer = Trainer(tcfg, train_step, data_cfg,
                      put_batch=put_batch(mesh) if sb.sharded else None,
                      log=None if rank0 else (lambda line: None))

    opt, start = trainer.try_restore(model, opt)
    t0 = time.time()
    opt, end = trainer.run(model, opt, start)
    dt = time.time() - t0
    steps_done = max(end - start, 1)
    final = (trainer.metrics_history[-1] if trainer.metrics_history else {})
    if not rank0:
        return 0
    print(f"[train] {steps_done} steps in {dt:.1f}s "
          f"({steps_done / dt:.2f} it/s); final metrics: "
          f"{ {k: float(v) for k, v in final.items()} }")
    if watch.count("train_step") > 1:
        print(f"[train] WARNING: train_step retraced "
              f"{watch.count('train_step')}x (expected 1 compile)")
    if tracer is not None:
        tracer.close()
        chrome = args.trace_file + ".chrome.json"
        obs_tracing.write_chrome(tracer.events, chrome)
        print(f"[train] trace: {args.trace_file} (JSONL), "
              f"{chrome} (Perfetto)")
    if reg is not None:
        if args.metrics_file.endswith(".json"):
            reg.dump_json(args.metrics_file)
        else:
            reg.dump_prometheus(args.metrics_file)
        print(f"[train] metrics: {args.metrics_file}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
