"""One rank of the multi-rank tests: imports torch and repro_torch only
(JAX's reference values come in as ``.npz`` files). :func:`spawn` starts
the ranks, each with its own time limit.

    python tests/_mesh_ranks.py RANK WORLD STORE DxM REF_DIR OUT_DIR CKPT_DIR

(``tests/test_torch_sharding_ranks.py``, gloo ranks on the CPU) trains the
bridged smoke TNN models on a (data, model) mesh through
``launch/steps.StepBuilder`` and writes what rank 0 gathered to an
``.npz``.

Each arch of ``REF_DIR/meta.json`` whose meshes name ``DxM``: the model
from the JAX parameters through ``bridge.params_from_jax(mesh=)``, its
forward logits, its loss and every gradient (gathered), three AdamW
steps, the local shapes and placements of its parameters and the kernel
Functions' counters. On mesh 2x2 the FD model's state is then saved to
``CKPT_DIR`` (the trainer's layout, and the parameters by name); on 4x1 it
is restored from there, both ways. On 2x2, ``launch.train.main`` also
trains the smoke FD model 3 steps on the mesh with a checkpoint, then
resumes it to 5 (``LAUNCH_ARGS``); rank 0's printed lines go to the
``.npz``, and an ``AsyncCheckpointer`` whose write on rank 0 fails
reports that failure on every rank (``async_outcome``).

    python tests/_mesh_ranks.py cards RANK WORLD STORE DxM OUT_DIR

(``tests/test_torch_cuda.py::test_mesh_train_on_cards``, one NCCL rank a
card) trains the full-width ``ski-tnn-lm-wt103`` 3 steps of 8 × 512 on the
mesh; rank 0 then trains the mesh-free model from the same init and
batches on its card and writes both runs' losses and the parameters'
differences to ``OUT_DIR/cards_DxM.json``.
"""
import contextlib
import io
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import bridge
from repro_torch.checkpoint import manifest as ckpt
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.data.pipeline import DataConfig, batch_at
from repro_torch.kernels import fd_fused, ski_vjp
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import train as train_launch
from repro_torch.launch.steps import StepBuilder
from repro_torch.optim import adamw
from repro_torch.parallel.sharding import full
from repro_torch.runtime.trainer import put_batch


def _tree(flat: dict) -> dict:
    """Dotted names → the nested JAX tree (digit keys are list indices)."""
    root: dict = {}
    for path, v in flat.items():
        node, keys = root, path.split(".")
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = v
    return bridge._lists(root)


def _np(t):
    return full(t.detach()).cpu().numpy()


def run_arch(arch, meta, mesh, ref_dir, out):
    cfg = reduce_for_smoke(get_config(arch))
    ref = np.load(os.path.join(ref_dir, f"{arch}.npz"))
    tree = _tree({k[2:]: ref[k] for k in ref.files if k.startswith("p.")})
    ocfg = adamw.OptConfig(**meta["opt"])
    sb = StepBuilder(cfg, mesh, opt_cfg=ocfg)
    model = bridge.params_from_jax(tree, cfg, device="cpu", mesh=mesh)
    opt = adamw.init(ocfg, dict(model.named_parameters()))
    host_id, num_hosts = mesh_mod.data_rank(mesh)
    dc = DataConfig(vocab=cfg.vocab, seq_len=meta["seq_len"],
                    global_batch=meta["global_batch"], seed=meta["seed"],
                    host_id=host_id, num_hosts=num_hosts)
    put = put_batch(mesh)
    tag = f"{arch}."
    for k, p in model.named_parameters():
        out[tag + "local." + k] = np.array(p.to_local().shape)
        out[tag + "spec." + k] = np.array(
            [str(pl) for pl in p.placements])
    out[tag + "logits"] = _np(sb.make_forward()(model,
                                                put(batch_at(dc, 0))["tokens"]))
    fd_fused.reset_counters()
    ski_vjp.reset_counters()
    loss, metrics, grads = sb.loss_and_grads(model, put(batch_at(dc, 0)))
    out[tag + "loss"] = _np(loss)
    out[tag + "counters"] = np.array(
        [fd_fused.op_counters[k] + ski_vjp.counters[k]
         for k in ("fwd", "bwd_kernel", "bwd_ref")])
    for k, g in grads.items():
        out[tag + "grad." + k] = _np(g)
        out[tag + "gspec." + k] = np.array([str(pl) for pl in g.placements])
    step = sb.make_train_step()
    losses, lrs = [], []
    for i in range(meta["steps"]):
        opt, m = step(model, opt, put(batch_at(dc, i)))
        losses.append(float(m["loss"]))
        lrs.append(float(m["lr"]))
    out[tag + "losses"] = np.array(losses)
    out[tag + "lrs"] = np.array(lrs)
    for k, p in model.named_parameters():
        out[tag + "param." + k] = _np(p)
    return sb, model, opt


def save_state(ckpt_dir, model, opt, out):
    """The trainer's checkpoint (JAX layout) and the parameters by name."""
    ckpt.save(os.path.join(ckpt_dir, "trainer"), 3,
              bridge.train_state_to_jax(model, opt))
    ckpt.save(os.path.join(ckpt_dir, "named"), 3,
              dict(model.named_parameters()))
    for k, v in opt.mu.items():
        out["saved.mu." + k] = _np(v)


def restore_state(ckpt_dir, sb, model, opt, out):
    """Both checkpoints onto this mesh: the trainer's through the bridge
    into the model's placements, the named one by ``shardings=``."""
    like = bridge.train_state_to_jax(model, opt)
    tree, _ = ckpt.restore(os.path.join(ckpt_dir, "trainer"), like)
    opt = bridge.load_train_state(model, tree)
    for k, p in model.named_parameters():
        out["restored.param." + k] = _np(p)
        out["restored.spec." + k] = np.array([str(pl) for pl in p.placements])
    for k, v in opt.mu.items():
        out["restored.mu." + k] = _np(v)
    named, _ = ckpt.restore(os.path.join(ckpt_dir, "named"),
                            dict(model.named_parameters()),
                            shardings=sb.param_shardings())
    for k, v in named.items():
        out["named.param." + k] = _np(v)
        out["named.local." + k] = np.array(v.to_local().shape)


#: ``launch.train`` arguments of the mesh run and of its one-rank twin
LAUNCH_ARGS = ["--arch", "fd-tnn-lm-wt103", "--smoke", "--device", "cpu",
               "--seq-len", "16", "--global-batch", "4", "--warmup", "1",
               "--ckpt-every", "2"]


def launch_on_mesh(shape, ckpt_dir, out):
    """``launch.train.main`` on the running process group: 3 steps, then
    a resume to 5, each rank's printed lines kept."""
    lines = []
    for steps in ("3", "5"):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = train_launch.main(LAUNCH_ARGS + [
                "--mesh", shape, "--steps", steps, "--ckpt-dir",
                os.path.join(ckpt_dir, "launch")])
        if rc != 0:
            raise RuntimeError(f"launch.train returned {rc}")
        lines += buf.getvalue().splitlines()
    out["launch.lines"] = np.array(lines or [""])


def async_outcome(ckpt_dir, out):
    """``AsyncCheckpointer`` on every rank, rank 0's write made to fail
    once: each rank's ``wait()`` error, then a write that commits and
    the step each rank sees after its ``wait()``."""
    saver = ckpt.AsyncCheckpointer(os.path.join(ckpt_dir, "async"))
    write = ckpt._write

    def failing(*a, **k):
        raise OSError("injected write failure")
    ckpt._write = failing
    try:
        saver.save_async(1, {"x": torch.arange(4.0)})
        err = ""
        try:
            saver.wait()
        except Exception as e:          # the outcome is the result here
            err = f"{type(e).__name__}: {e}"
    finally:
        ckpt._write = write
    saver.save_async(2, {"x": torch.arange(4.0)})
    saver.wait()
    seen = [None] * dist.get_world_size()
    dist.all_gather_object(seen, (err, ckpt.latest_step(saver.ckpt_dir)))
    out["async.errors"] = np.array([e for e, _ in seen])
    out["async.latest"] = np.array([s for _, s in seen])


def cards(argv):
    rank, world, store, shape, out_dir = argv
    rank, world = int(rank), int(world)
    torch.cuda.set_device(rank)
    dist.init_process_group("nccl", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        mesh = mesh_mod.make_mesh(tuple(map(int, shape.split("x"))),
                                  ("data", "model"), "cuda")
        cfg = get_config("ski-tnn-lm-wt103")
        ocfg = adamw.OptConfig(lr=3e-4, warmup_steps=1, total_steps=3)
        sb = StepBuilder(cfg, mesh, opt_cfg=ocfg)
        model, opt = sb.init_state(torch.Generator().manual_seed(0),
                                   device="cuda")
        host_id, num_hosts = mesh_mod.data_rank(mesh)
        kw = dict(vocab=cfg.vocab, seq_len=512, global_batch=8, seed=0)
        dc = DataConfig(**kw, host_id=host_id, num_hosts=num_hosts)
        step, put = sb.make_train_step(), put_batch(mesh)
        losses, lrs = [], []
        for i in range(3):
            opt, m = step(model, opt, put(batch_at(dc, i)))
            losses.append(float(m["loss"]))
            lrs.append(float(m["lr"]))
        got = {k: full(p.detach()) for k, p in model.named_parameters()}
        if rank == 0:
            free = StepBuilder(cfg, None, opt_cfg=ocfg)
            ref, ropt = free.init_state(torch.Generator().manual_seed(0),
                                        device="cuda")
            rstep, gdc = free.make_train_step(), DataConfig(**kw)
            rlosses = []
            for i in range(3):
                batch = {k: torch.from_numpy(v).to("cuda", torch.long)
                         for k, v in batch_at(gdc, i).items()}
                ropt, m = rstep(ref, ropt, batch)
                rlosses.append(float(m["loss"]))
            diffs = {k: (got[k] - p.detach()).abs()
                     for k, p in ref.named_parameters()}
            with open(os.path.join(out_dir, f"cards_{shape}.json"), "w") as f:
                json.dump({"losses": losses, "ref_losses": rlosses,
                           "lrs": lrs,
                           "max_diff": {k: float(d.max())
                                        for k, d in diffs.items()},
                           "within_1e-5": {k: float((d <= 1e-5).float()
                                                    .mean())
                                           for k, d in diffs.items()},
                           "local_wu": list(model.layers[0].mixer.wu.w
                                            .to_local().shape)}, f)
    finally:
        dist.destroy_process_group()


def spawn(argv_of_rank, world: int, timeout: float, env=None) -> list:
    """Start ``world`` ranks of this file (``argv_of_rank(r)`` their
    arguments) and wait for them; kills them all and fails if they outlast
    ``timeout`` seconds or any exits non-zero. Returns their logs."""
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root / "src"), OMP_NUM_THREADS="1",
               **(env or {}))
    procs = [subprocess.Popen(
        [sys.executable, __file__, *map(str, argv_of_rank(r))], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    try:
        logs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        if p.returncode != 0:
            raise AssertionError(f"rank exited {p.returncode}:\n"
                                 f"{log[-4000:]}")
    return logs


def main(argv):
    rank, world, store, shape, ref_dir, out_dir, ckpt_dir = argv
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        mesh = mesh_mod.make_mesh(tuple(map(int, shape.split("x"))),
                                  ("data", "model"), "cpu")
        with open(os.path.join(ref_dir, "meta.json")) as f:
            meta = json.load(f)
        out = {}
        for arch, meshes in meta["archs"].items():
            if shape not in meshes:
                continue
            sb, model, opt = run_arch(arch, meta, mesh, ref_dir, out)
            if arch == meta["ckpt_arch"] and shape == "2x2":
                save_state(ckpt_dir, model, opt, out)
            if arch == meta["ckpt_arch"] and shape == "4x1":
                restore_state(ckpt_dir, sb, model, opt, out)
        if shape == "2x2":
            launch_on_mesh(shape, ckpt_dir, out)
            async_outcome(ckpt_dir, out)
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "repro"))
        out["foreign_modules"] = np.array(len(bad))
        if rank == 0:
            np.savez(os.path.join(out_dir, f"{shape}.npz"), **out)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    if sys.argv[1] == "cards":
        cards(sys.argv[2:])
    else:
        main(sys.argv[1:])
