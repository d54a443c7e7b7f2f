"""Port parity for training (repro_torch: models.transformer.loss_fn,
data.pipeline, launch.steps, runtime.trainer, launch.train) against the
JAX package, plus the trainer's fault behaviour, mirroring
tests/test_substrate.py's trainer tests.

Tolerances, each with its reason:
* loss_fn: 1e-5 relative, fp32 (the FFT and matmul summation orders of
  torch and XLA differ; the loss is a mean of 10^2..10^3 terms);
* three train_steps from the same bridged parameters and batches: losses
  within 1e-4 relative (the logits tier of tests/test_torch_model.py, over
  three steps); parameters within 2·Σ_t lr_t absolute per element. Adam's
  first steps move each weight by about ±lr whatever the gradient's size
  (m/√v ≈ sign(g)), so a near-zero gradient component whose sign differs
  between the two frameworks' round-off moves the two weights apart by up
  to 2·lr a step; 99% of the elements must agree within 1e-5 all the same;
* batch_at: token for token (integer data from the same numpy generator);
* the trainer's own tests compare exactly (they move state, not numerics).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduce_for_smoke as jreduce  # noqa: E402
from repro.data import pipeline as jpipeline  # noqa: E402
from repro.launch.steps import StepBuilder  # noqa: E402
from repro.models.context import Ctx  # noqa: E402
from repro.models.transformer import init_model as jinit_model  # noqa: E402
from repro.models.transformer import loss_fn as jloss_fn  # noqa: E402
from repro.nn.params import unbox  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.checkpoint import manifest as ckpt  # noqa: E402
from repro_torch.configs import get_config, reduce_for_smoke  # noqa: E402
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.kernels import fd_fused  # noqa: E402
from repro_torch.launch import train as train_launch  # noqa: E402
from repro_torch.launch.steps import make_train_step  # noqa: E402
from repro_torch.models.transformer import init_model, loss_fn  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.runtime.trainer import (  # noqa: E402
    StragglerMonitor, Trainer, TrainerConfig)

torch.set_num_threads(1)
ARCH = "fd-tnn-lm-wt103"


@pytest.fixture(scope="module")
def smoke():
    jcfg = jreduce(jget_config(ARCH))
    cfg = reduce_for_smoke(get_config(ARCH))
    init = jax.jit(lambda k: unbox(jinit_model(k, jcfg))[0])
    tree = jax.tree.map(np.asarray, init(jax.random.PRNGKey(0)))
    return jcfg, cfg, tree


def _torch_batch(batch):
    return {k: torch.from_numpy(np.asarray(v)).long() for k, v in batch.items()}


# ------------------------------------------------------------ loss and data
@pytest.mark.parametrize("chunk", [0, 8], ids=["unchunked", "chunked"])
def test_loss_fn_matches_jax(smoke, chunk):
    """loss_fn with the full logits and with loss_chunk=8 over s=16 (two
    checkpointed chunks); the chunked loss and its gradients equal the
    unchunked ones within fp32 round-off."""
    jcfg, cfg, tree = smoke
    jcfg = dataclasses.replace(jcfg, loss_chunk=chunk)
    cfg = dataclasses.replace(cfg, loss_chunk=chunk)
    batch = jpipeline.batch_at(jpipeline.DataConfig(
        vocab=cfg.vocab, seq_len=16, global_batch=2, seed=3), 0)
    want, jm = jloss_fn(tree, jcfg, Ctx(), batch)
    model = bridge.params_from_jax(tree, cfg, device="cpu")
    got, m = loss_fn(model, cfg, _torch_batch(batch))
    assert set(m) == {"nll", "aux"} and float(m["aux"]) == 0.0
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    np.testing.assert_allclose(m["nll"].item(), float(jm["nll"]), rtol=1e-5)
    if chunk:
        ref_model = bridge.params_from_jax(tree, cfg, device="cpu")
        full, _ = loss_fn(ref_model, dataclasses.replace(cfg, loss_chunk=0),
                          _torch_batch(batch))
        got.backward()
        full.backward()
        np.testing.assert_allclose(got.item(), full.item(), rtol=1e-6)
        for (k, p), q in zip(model.named_parameters(), ref_model.parameters()):
            np.testing.assert_allclose(p.grad.numpy(), q.grad.numpy(),
                                       rtol=1e-4, atol=1e-7, err_msg=k)


def test_loss_fn_ignores_padded_vocab(smoke):
    """Padded vocabulary columns take no probability: raising their logits
    changes nothing."""
    _, cfg, tree = smoke
    cfg = dataclasses.replace(cfg, vocab=500)          # 12 padded columns
    model = bridge.params_from_jax(tree, cfg, device="cpu")
    batch = _torch_batch(jpipeline.batch_at(jpipeline.DataConfig(
        vocab=500, seq_len=8, global_batch=2, seed=1), 0))
    with torch.no_grad():
        a, _ = loss_fn(model, cfg, batch)
        model.unembed[:, 500:] += 100.0
        b, _ = loss_fn(model, cfg, batch)
    assert float(a) == float(b)


@pytest.mark.parametrize("kind", ["synthetic", "bytes", "lra_match"])
def test_batch_at_matches_jax(tmp_path, kind):
    path = None
    if kind == "bytes":
        path = str(tmp_path / "corpus.txt")
        with open(path, "wb") as f:
            f.write(bytes(np.random.default_rng(0).integers(0, 256, 5000,
                                                            dtype=np.uint8)))
    for num_hosts, host_id in ((1, 0), (2, 1)):
        kw = dict(vocab=300, seq_len=24, global_batch=4, seed=7, kind=kind,
                  path=path, host_id=host_id, num_hosts=num_hosts)
        for step in (0, 5):
            want = jpipeline.batch_at(jpipeline.DataConfig(**kw), step)
            got = pipeline.batch_at(pipeline.DataConfig(**kw), step)
            assert set(got) == set(want) == {"tokens", "labels"}
            for k in want:
                assert got[k].dtype == want[k].dtype
                np.testing.assert_array_equal(got[k], want[k])


# ------------------------------------------------------------ train steps
def test_three_train_steps_track_jax(smoke):
    """Three train_steps from the same bridged parameters and batches track
    JAX ``StepBuilder(cfg).make_train_step()`` (tolerances: module
    docstring); the FD-TNO backward ran once per layer per step."""
    jcfg, cfg, tree = smoke
    kw = dict(lr=1e-3, warmup_steps=1, total_steps=3)
    sb = StepBuilder(jcfg, opt_cfg=jadamw.OptConfig(**kw))
    jstep = jax.jit(sb.make_train_step())
    jstate = {"params": jax.tree.map(jnp.asarray, tree)}
    jstate["opt"] = jadamw.init(sb.opt_cfg, jstate["params"])
    model = bridge.params_from_jax(tree, cfg, device="cpu")
    ocfg = adamw.OptConfig(**kw)
    opt = adamw.init(ocfg, dict(model.named_parameters()))
    step = make_train_step(cfg, ocfg)
    dcfg = jpipeline.DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=2,
                                seed=0)
    fd_fused.reset_counters()
    lrs = []
    for i in range(3):
        batch = jpipeline.batch_at(dcfg, i)
        jstate, jm = jstep(jstate, batch)
        opt, m = step(model, opt, _torch_batch(batch))
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-4)
        np.testing.assert_allclose(float(m["lr"]), float(jm["lr"]),
                                   rtol=1e-6)
        lrs.append(float(m["lr"]))
    assert fd_fused.op_counters == {"fwd": 3 * cfg.n_layers,
                                    "bwd_kernel": 3 * cfg.n_layers,
                                    "bwd_ref": 0}
    assert int(opt.step) == 3
    want = bridge._port_leaves(jax.tree.map(np.asarray, jstate["params"]),
                               cfg)
    bound = 2 * sum(lrs)
    for k, p in model.named_parameters():
        diff = np.abs(p.detach().numpy() - want[k])
        assert diff.max() <= bound, k
        assert np.mean(diff <= 1e-5) >= 0.99, k


# ----------------------------------------------------------------- trainer
def _tiny_model(seed=0):
    cfg = reduce_for_smoke(get_config(ARCH), n_layers=1, d_model=8, d_ff=16,
                           vocab=16, tno_rpe_hidden=4)
    model = init_model(cfg, torch.Generator().manual_seed(seed), device="cpu")
    opt = adamw.init(adamw.OptConfig(), dict(model.named_parameters()))
    return cfg, model, opt


def _plus(t, n):
    """t + 1, n times, rounded at each step as the in-place adds are."""
    t = t.clone()
    for _ in range(n):
        t += 1.0
    return t


def _counting_step(calls):
    """A stand-in train_step: adds 1 to the embedding in place and counts
    the step in the optimizer state."""
    def step(model, opt, batch):
        calls["steps"] += 1
        with torch.no_grad():
            model.embed.add_(1.0)
        return opt._replace(step=opt.step + 1), {"loss": torch.tensor(1.0)}
    return step


def _trainer(tmp_path, total_steps, step_fn, **tkw):
    dcfg = pipeline.DataConfig(vocab=16, seq_len=8, global_batch=2, seed=0)
    tcfg = TrainerConfig(total_steps=total_steps,
                         ckpt_dir=str(tmp_path / "ck") if tmp_path else None,
                         ckpt_every=4, log_every=0, **tkw)
    return Trainer(tcfg, step_fn, dcfg)


def test_trainer_runs_and_checkpoints(tmp_path):
    _, model, opt = _tiny_model()
    e0 = model.embed.detach().clone()
    calls = {"steps": 0}
    opt, end = _trainer(tmp_path, 8, _counting_step(calls)).run(model, opt)
    assert end == 8 and int(opt.step) == 8 and calls["steps"] == 8
    assert torch.equal(model.embed.detach(), _plus(e0, 8))
    assert ckpt.latest_step(str(tmp_path / "ck")) == 8


def test_trainer_step_retry_on_injected_fault(tmp_path):
    calls = {"steps": 0, "hook": 0}

    def hook(step, attempt):
        calls["hook"] += 1
        if step == 3 and attempt == 0:
            raise RuntimeError("injected fault")

    dcfg = pipeline.DataConfig(vocab=16, seq_len=8, global_batch=2, seed=0)
    tr = Trainer(TrainerConfig(total_steps=8, log_every=0),
                 _counting_step(calls), dcfg, failure_hook=hook)
    _, model, opt = _tiny_model()
    opt, end = tr.run(model, opt)
    assert end == 8                                # survived the fault
    assert calls["hook"] == 9 and calls["steps"] == 8   # one retry


def test_trainer_fails_after_max_retries():
    def always_fail(step, attempt):
        raise RuntimeError("dead node")
    dcfg = pipeline.DataConfig(vocab=16, seq_len=8, global_batch=2, seed=0)
    tr = Trainer(TrainerConfig(total_steps=4, max_retries=1, log_every=0),
                 _counting_step({"steps": 0}), dcfg, failure_hook=always_fail)
    _, model, opt = _tiny_model()
    with pytest.raises(RuntimeError, match="failed after"):
        tr.run(model, opt)


def test_trainer_restart_resumes_from_checkpoint(tmp_path):
    _, model, opt = _tiny_model()
    e0 = model.embed.detach().clone()
    opt, end = _trainer(tmp_path, 4, _counting_step({"steps": 0})).run(
        model, opt)
    assert end == 4
    # a "new job" with other initial values restores and continues to 8
    _, model2, opt2 = _tiny_model(seed=1)
    tr2 = _trainer(tmp_path, 8, _counting_step({"steps": 0}))
    opt2, start = tr2.try_restore(model2, opt2)
    assert start == 4 and int(opt2.step) == 4
    assert torch.equal(model2.embed.detach(), _plus(e0, 4))
    opt2, end = tr2.run(model2, opt2, start)
    assert end == 8 and int(opt2.step) == 8
    assert torch.equal(model2.embed.detach(), _plus(e0, 8))


def test_trainer_nan_guard_retries_then_raises(tmp_path):
    """A non-finite loss fails the attempt; after the retries the trainer
    raises, and the parameters are the pre-step ones, with no NaN from the
    in-place update of the failed attempts."""
    calls = {"steps": 0}

    def nan_step(model, opt, batch):
        calls["steps"] += 1
        with torch.no_grad():
            for p in model.parameters():
                p.fill_(float("nan"))
        return opt, {"loss": torch.tensor(float("nan"))}

    _, model, opt = _tiny_model()
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    tr = _trainer(None, 2, nan_step, max_retries=1)
    with pytest.raises(RuntimeError, match="failed after"):
        tr.run(model, opt)
    assert calls["steps"] == 2
    for k, p in model.named_parameters():
        assert torch.equal(p.detach(), before[k]), k


def test_straggler_monitor_flags_outliers():
    mon = StragglerMonitor(factor=3.0, alpha=0.5)
    for i in range(5):
        assert not mon.observe(i, 1.0)
    assert mon.observe(5, 10.0)                    # 10x the EMA
    assert mon.flagged and mon.flagged[0][0] == 5
    assert not mon.observe(6, 1.0)                 # EMA not poisoned


def test_trainer_retry_after_in_place_update_starts_from_pre_step_state():
    """The port's step updates in place: a fault after the update must not
    leak into the retry. With the pre-step clone, three real train_steps
    whose step 1 fails once after its update end exactly where a clean
    three-step run ends."""
    cfg, model, opt = _tiny_model()
    ocfg = adamw.OptConfig(lr=1e-2, warmup_steps=0, total_steps=3)
    opt = adamw.init(ocfg, dict(model.named_parameters()))
    real = make_train_step(cfg, ocfg)
    calls = {"n": 0}

    def faulty(model, opt, batch):
        out = real(model, opt, batch)
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("fault after the in-place update")
        return out

    tr = _trainer(None, 3, faulty)
    tr.run(model, opt)
    assert calls["n"] == 4                         # one retry
    _, clean, copt = _tiny_model()
    copt = adamw.init(ocfg, dict(clean.named_parameters()))
    _trainer(None, 3, make_train_step(cfg, ocfg)).run(clean, copt)
    want = dict(clean.named_parameters())
    for k, p in model.named_parameters():
        assert torch.equal(p, want[k]), k


# ------------------------------------------------------------------ launch
def test_launch_train_smoke_cpu_resumes(tmp_path, capsys):
    """``python -m repro_torch.launch.train --smoke --device cpu`` trains,
    prints JAX's summary line, and a second call resumes from the
    checkpoint instead of starting over."""
    args = ["--arch", ARCH, "--smoke", "--device", "cpu", "--seq-len", "16",
            "--global-batch", "2", "--warmup", "1", "--ckpt-dir",
            str(tmp_path), "--ckpt-every", "2"]
    assert train_launch.main(args + ["--steps", "3"]) == 0
    out = capsys.readouterr().out
    assert "[train] 3 steps in" in out and "final metrics" in out
    assert ckpt.latest_step(str(tmp_path)) == 3
    assert train_launch.main(args + ["--steps", "5"]) == 0
    assert "[train] 2 steps in" in capsys.readouterr().out


def test_launch_train_unported_mixer_raises(capsys):
    """The baseline ``tnn-lm-wt103`` trains through the launcher (its
    mixer once raised here); an arch the port does not register still
    raises."""
    assert train_launch.main(["--arch", "tnn-lm-wt103", "--smoke",
                              "--device", "cpu", "--steps", "2", "--seq-len",
                              "16", "--global-batch", "2",
                              "--warmup", "1"]) == 0
    assert "[train] 2 steps in" in capsys.readouterr().out
    with pytest.raises(KeyError, match="unknown arch"):
        train_launch.main(["--arch", "no-such-arch", "--smoke", "--device",
                           "cpu", "--steps", "1"])


@pytest.mark.parametrize("mixer", ["tno", "ski", "fd"])
def test_launch_train_mixer_override_keeps_fd_layers(mixer):
    """``--mixer`` replaces attention and local mixers only
    (``models/config.layers_spec``), as in the JAX package: on
    fd-tnn-lm-wt103 every layer stays FD, and the step trains through
    FDTNO (the baseline and SKI mixers are reached through ``--arch``)."""
    jcfg = dataclasses.replace(jreduce(jget_config(ARCH)),
                               mixer_override=mixer)
    cfg = dataclasses.replace(reduce_for_smoke(get_config(ARCH)),
                              mixer_override=mixer)
    assert cfg.layers_spec == tuple(map(tuple, jcfg.layers_spec))
    assert all(m == "fd" for m, _ in cfg.layers_spec)
    fd_fused.reset_counters()
    assert train_launch.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                              "--mixer", mixer, "--steps", "1", "--seq-len",
                              "16", "--global-batch", "2"]) == 0
    assert fd_fused.op_counters == {"fwd": cfg.n_layers,
                                    "bwd_kernel": cfg.n_layers, "bwd_ref": 0}
