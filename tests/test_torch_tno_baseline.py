"""Port parity for the baseline TNN (``repro_torch.core.tno`` variant
``tno``: the MLP RPE at all 2n-1 lags times the decay bias λ^|t|, applied
with the FFT Toeplitz matvec) and the smoke ``tnn-lm-wt103`` built on it,
against the JAX package on the same seeded inputs and bridged parameters.
Also the ``lra_match`` classification path of
``benchmarks/bench_lra_style.py`` (a last-token 2-way head) for all three
variants, through ``examples/lra_style_classification_torch.py``, and that
example and ``examples/train_tnn_lm_torch.py`` run on the CPU.

Tolerances, each with its reason:
* ``decay_bias``, ``baseline_coeffs``, ``tno_apply``, logits, the eval
  loss and every gradient against ``jax.grad``: 1e-5 relative to the
  largest magnitude, fp32 (the pow, FFT and matmul summation orders of
  torch and XLA differ);
* ``tno_apply`` against the dense (d, n, n) oracle: 1e-5 of its scale (the
  FFT against a direct sum);
* losses after AdamW steps: 1e-4 relative, and parameters within 2·Σ lr
  per element (Adam's first steps amplify round-off, m/√v ≈ ±1; ROADMAP
  Queue 3's notes); 99% of the elements within 1e-5;
* checkpoints move bytes: exact.
"""
import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import manifest as jckpt  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduce_for_smoke as jreduce  # noqa: E402
from repro.core import rpe as jrpe  # noqa: E402
from repro.core import tno as jtno  # noqa: E402
from repro.data import pipeline as jpipeline  # noqa: E402
from repro.launch.steps import StepBuilder  # noqa: E402
from repro.models.context import Ctx  # noqa: E402
from repro.models.transformer import forward as jforward  # noqa: E402
from repro.models.transformer import init_model as jinit_model  # noqa: E402
from repro.models.transformer import loss_fn as jloss_fn  # noqa: E402
from repro.nn.params import unbox  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.checkpoint import manifest as ckpt  # noqa: E402
from repro_torch.configs import get_config, reduce_for_smoke  # noqa: E402
from repro_torch.core import rpe, tno, toeplitz  # noqa: E402
from repro_torch.launch.steps import loss_and_grads  # noqa: E402
from repro_torch.launch.steps import make_train_step  # noqa: E402
from repro_torch.models.transformer import (  # noqa: E402
    forward, init_model, loss_fn)
from repro_torch.optim import adamw  # noqa: E402

torch.set_num_threads(1)
ARCH = "tnn-lm-wt103"
ROOT = Path(__file__).resolve().parent.parent
TOL = 1e-5


def _rel(got, want) -> float:
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-30)


def _example(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _mixer(d=8, **kw):
    """(JAX cfg, JAX params, port cfg, port params) of one baseline mixer,
    the port's holding the JAX parameters."""
    jcfg = jtno.TNOConfig(d=d, variant="tno", rpe_hidden=16, **kw)
    jp = jax.tree.map(np.asarray,
                      unbox(jtno.tno_init(jax.random.PRNGKey(0), jcfg))[0])
    cfg = tno.TNOConfig(d=d, variant="tno", rpe_hidden=16, **kw)
    params = tno.tno_init(cfg, device="cpu")
    params.load_state_dict({k: torch.from_numpy(np.array(v))
                            for k, v in bridge._flatten(jp)})
    return jcfg, jp, cfg, params


def _x(b, n, d, seed=1):
    return np.random.default_rng(seed).standard_normal((b, n, d), np.float32)


# -------------------------------------------------------------- the mixer
@pytest.mark.parametrize("lam", [0.9, 0.99, 0.999])
def test_decay_bias_matches_jax(lam):
    t = np.arange(-63, 64)
    got = rpe.decay_bias(torch.from_numpy(t), lam)
    want = jrpe.decay_bias(jnp.asarray(t), lam)
    assert got.dtype == torch.float32
    assert _rel(got, want) <= TOL


@pytest.mark.parametrize("use_decay", [True, False], ids=["decay", "raw"])
@pytest.mark.parametrize("causal", [True, False],
                         ids=["causal", "bidirectional"])
def test_baseline_coeffs_match_jax(causal, use_decay):
    """(d, 2n-1) coefficients for both masks and with the decay bias on and
    off; with it on they are the raw ones times λ^|t| (mirrors
    tests/test_paper_core.py::test_baseline_tno_decay_bias)."""
    jcfg, jp, cfg, params = _mixer(causal=causal, lam=0.9,
                                   use_decay=use_decay)
    n = 16
    with torch.no_grad():
        got = tno.baseline_coeffs(params, cfg, n)
    want = jtno.baseline_coeffs(jp, jcfg, n)
    assert tuple(got.shape) == (8, 2 * n - 1)
    assert _rel(got, want) <= TOL
    if causal:
        assert not bool(got[:, :n - 1].any())
    if use_decay:
        with torch.no_grad():
            raw = tno.baseline_coeffs(
                params, dataclasses.replace(cfg, use_decay=False), n)
        lags = toeplitz.lags(n).float()
        assert _rel(got, raw * (0.9 ** lags.abs())[None]) <= TOL


@pytest.mark.parametrize("causal", [True, False],
                         ids=["causal", "bidirectional"])
def test_tno_apply_matches_jax_and_dense_oracle(causal):
    jcfg, jp, cfg, params = _mixer(causal=causal)
    x = _x(2, 24, 8)
    with torch.no_grad():
        plan = tno.tno_plan(params, cfg, 24)
        got = tno.tno_apply(params, cfg, torch.from_numpy(x), plan=plan)
        unplanned = tno.tno_apply(params, cfg, torch.from_numpy(x))
        dense = tno.tno_dense_oracle(params, cfg, 24)       # (d, n, n)
    assert set(plan) == {"coef"} and torch.equal(got, unplanned)
    want = jtno.tno_apply(jp, jcfg, jnp.asarray(x))
    assert _rel(got, want) <= TOL
    oracle = torch.einsum("dij,bjd->bid", dense, torch.from_numpy(x))
    assert _rel(got, oracle.numpy()) <= TOL
    assert _rel(dense, jtno.tno_dense_oracle(jp, jcfg, 24)) <= TOL


def test_tno_apply_is_causal():
    """y[:, :t] does not depend on x[:, t:] (mirrors
    tests/test_paper_core.py::test_tno_variants_causality, variant tno)."""
    _, _, cfg, params = _mixer()
    x1 = torch.from_numpy(_x(1, 32, 8))
    x2 = x1.clone()
    x2[:, 16:] = torch.from_numpy(_x(1, 16, 8, seed=2))
    with torch.no_grad():
        y1, y2 = (tno.tno_apply(params, cfg, x) for x in (x1, x2))
    assert torch.allclose(y1[:, :16], y2[:, :16], rtol=1e-6, atol=1e-6)
    assert not torch.allclose(y1[:, 16:], y2[:, 16:])


def test_tno_apply_grads_match_jax():
    """The backward is autograd through ``torch.fft`` against ``jax.grad``
    through ``jnp.fft``: the input and every RPE parameter."""
    jcfg, jp, cfg, params = _mixer()
    x = _x(2, 20, 8)
    cot = _x(2, 20, 8, seed=3)
    jgx, jgp = jax.grad(lambda xx, p: jnp.sum(
        jtno.tno_apply(p, jcfg, xx) * cot), argnums=(0, 1))(
            jnp.asarray(x), jp)
    xt = torch.from_numpy(x).requires_grad_()
    (tno.tno_apply(params, cfg, xt) * torch.from_numpy(cot)).sum().backward()
    assert _rel(xt.grad, jgx) <= TOL
    want = dict(bridge._flatten(jax.tree.map(np.asarray, jgp)))
    assert set(want) == {k for k, _ in params.named_parameters()}
    for k, p in params.named_parameters():
        assert _rel(p.grad, want[k]) <= TOL, k


def test_fd_bidirectional_still_refused():
    """Bidirectional FD (ROADMAP Step 8) builds since it was ported: its
    RPE is 2d wide and its plan is the complex spectrum (held against JAX
    in test_torch_fd_bidir.py). An unknown variant is still refused."""
    cfg = tno.TNOConfig(d=8, variant="fd", causal=False, rpe_hidden=16)
    params = tno.tno_init(cfg)
    assert params.rpe.layers[-1].w.shape == (16, 16)
    plan = tno.tno_plan(params, cfg, 5)
    assert set(plan) == {"khat"} and plan["khat"].shape == (8, 6)
    with pytest.raises(ValueError, match="mystery"):
        tno.tno_init(tno.TNOConfig(d=8, variant="mystery"))


# -------------------------------------------------------------- the model
@pytest.fixture(scope="module")
def smoke():
    jcfg = jreduce(jget_config(ARCH))
    cfg = reduce_for_smoke(get_config(ARCH))
    init = jax.jit(lambda k: unbox(jinit_model(k, jcfg))[0])
    tree = jax.tree.map(np.asarray, init(jax.random.PRNGKey(0)))
    return jcfg, cfg, tree


def _batch(cfg, s=16, seed=3, b=2):
    return jpipeline.batch_at(jpipeline.DataConfig(
        vocab=cfg.vocab, seq_len=s, global_batch=b, seed=seed), 0)


def _torch_batch(batch):
    return {k: torch.from_numpy(np.asarray(v)).long() for k, v in batch.items()}


def test_init_model_matches_jax_layout(smoke):
    """The port's own init of the baseline builds every leaf of the JAX
    tree with its shape and dtype (``tno`` holds ``rpe`` alone)."""
    _, cfg, tree = smoke
    got = init_model(cfg, torch.Generator().manual_seed(0),
                     device="cpu").state_dict()
    want = bridge._port_leaves(tree, cfg)
    assert set(got) == set(want)
    for name, arr in want.items():
        assert tuple(got[name].shape) == arr.shape, name
        assert got[name].dtype == bridge._as_torch(arr).dtype, name
    assert any(".mixer.tno.rpe." in name for name in got)


def test_model_logits_and_loss_match_jax(smoke):
    jcfg, cfg, tree = smoke
    batch = _batch(cfg)
    want, _ = jforward(tree, jcfg, Ctx(), batch)
    jl, _ = jloss_fn(tree, jcfg, Ctx(), batch)
    model = bridge.params_from_jax(tree, cfg, device="cpu")
    with torch.no_grad():
        got = forward(model, cfg, _torch_batch(batch)["tokens"])
        loss, _ = loss_fn(model, cfg, _torch_batch(batch))
    assert _rel(got, want) <= TOL
    np.testing.assert_allclose(loss.item(), float(jl), rtol=TOL)


def test_model_grads_match_jax(smoke):
    """Every parameter's gradient of the training loss against
    ``jax.grad``."""
    jcfg, cfg, tree = smoke
    batch = _batch(cfg, seed=4)
    jg = jax.grad(lambda p: jloss_fn(p, jcfg, Ctx(), batch)[0])(
        jax.tree.map(jnp.asarray, tree))
    want = bridge._port_leaves(jax.tree.map(np.asarray, jg), cfg)
    model = bridge.params_from_jax(tree, cfg, device="cpu")
    _, _, grads = loss_and_grads(model, cfg, _torch_batch(batch))
    assert set(grads) == set(want)
    for k, g in grads.items():
        assert _rel(g, want[k]) <= TOL, k


def test_three_train_steps_track_jax(smoke):
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
    lrs = []
    for i in range(3):
        batch = jpipeline.batch_at(dcfg, i)
        jstate, jm = jstep(jstate, batch)
        opt, m = step(model, opt, _torch_batch(batch))
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-4)
        lrs.append(float(m["lr"]))
    want = bridge._port_leaves(jax.tree.map(np.asarray, jstate["params"]),
                               cfg)
    bound = 2 * sum(lrs)
    for k, p in model.named_parameters():
        diff = np.abs(p.detach().numpy() - want[k])
        assert diff.max() <= bound, k
        assert np.mean(diff <= 1e-5) >= 0.99, k


@pytest.mark.parametrize("direction", ["jax-to-port", "port-to-jax"])
def test_checkpoints_pass_both_ways(smoke, tmp_path, direction):
    """A baseline model's training state saved by one package restores in
    the other, leaf for leaf."""
    jcfg, cfg, tree = smoke
    jparams = jax.tree.map(jnp.asarray, tree)
    jopt = jadamw.init(jadamw.OptConfig(), jparams)
    model = bridge.params_from_jax(tree, cfg, device="cpu")
    opt = adamw.init(adamw.OptConfig(), dict(model.named_parameters()))
    if direction == "jax-to-port":
        rng = np.random.default_rng(5)
        state = {"params": jax.tree.map(
            lambda a: jnp.asarray(rng.standard_normal(a.shape), a.dtype),
            jparams), "opt": jopt}
        jckpt.save(str(tmp_path), 2, state)
        got, _ = ckpt.restore(str(tmp_path),
                              bridge.train_state_to_jax(model, opt))
        bridge.load_train_state(model, got)
        want = bridge._port_leaves(jax.tree.map(np.asarray,
                                                state["params"]), cfg)
        for k, p in model.named_parameters():
            np.testing.assert_array_equal(p.detach().numpy(), want[k],
                                          err_msg=k)
    else:
        with torch.no_grad():
            for p in model.parameters():
                p.add_(1.0)
        saved = bridge.train_state_to_jax(model, opt)
        ckpt.save(str(tmp_path), 2, saved)
        got, _ = jckpt.restore(str(tmp_path),
                               {"params": jparams, "opt": jopt})
        jl, pl = jax.tree.leaves(got), ckpt.tree_leaves(saved)
        assert len(jl) == len(pl)
        for a, b in zip(jl, pl):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())


# ------------------------------------------------------- lra_match path
@pytest.mark.parametrize("variant", ["tno", "ski", "fd"])
def test_lra_match_classification_tracks_jax(variant):
    """The Table-2 stand-in's classification loss (last token, 2-way head)
    at step 0 and after 3 AdamW steps, the port's example against the JAX
    bench's ``_cls_loss`` and its AdamW step on the same weights and
    batches."""
    from benchmarks.bench_lra_style import _cls_loss as jcls_loss
    lra = _example("lra_style_classification_torch")
    cfg = lra.lra_config(variant)
    jcfg = dataclasses.replace(
        jreduce(jget_config(ARCH), n_layers=2, d_model=64, vocab=64,
                tno_rank=16, tno_filter=8),
        pattern=((variant, "dense"),), scan_layers=False)
    jparams, _ = unbox(jinit_model(jax.random.PRNGKey(0), jcfg))
    model = bridge.params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                                   device="cpu")
    kw = dict(lr=1e-3, warmup_steps=10, total_steps=3)
    jocfg, ocfg = jadamw.OptConfig(**kw), adamw.OptConfig(**kw)
    jopt = jadamw.init(jocfg, jparams)
    opt = adamw.init(ocfg, dict(model.named_parameters()))
    step = lra.make_step(cfg, ocfg)
    dcfg = jpipeline.DataConfig(vocab=64, seq_len=32, global_batch=4,
                                kind="lra_match", seed=0)

    @jax.jit
    def jstep(params, opt, batch):
        loss, grads = jax.value_and_grad(
            lambda p: jcls_loss(p, jcfg, batch))(params)
        opt, params, _ = jadamw.step(jocfg, opt, grads, params)
        return params, opt, loss

    for i in range(3):
        batch = {k: jnp.asarray(v)
                 for k, v in jpipeline.batch_at(dcfg, i).items()}
        jparams, jopt, jl = jstep(jparams, jopt, batch)
        opt, loss = step(model, opt, lra.device_batch(dcfg, i, "cpu"))
        np.testing.assert_allclose(float(loss), float(jl),
                                   rtol=TOL if i == 0 else 1e-4)
    test = jpipeline.batch_at(dcfg, 10_000)
    want = jcls_loss(jparams, jcfg, {k: jnp.asarray(v)
                                     for k, v in test.items()})
    with torch.no_grad():
        got = lra.cls_loss(model, cfg, lra.device_batch(dcfg, 10_000, "cpu"))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-4)


def test_lra_example_runs_on_cpu(capsys):
    lra = _example("lra_style_classification_torch")
    assert lra.main(["--device", "cpu", "--steps", "2", "--seq-len", "16",
                     "--batch", "4"]) == 0
    out = capsys.readouterr().out
    for variant in ("tno", "ski", "fd"):
        assert f"[lra-style] {variant}: 2 steps" in out


@pytest.mark.parametrize("variant", ["tno", "ski", "fd"])
def test_train_example_runs_on_cpu(variant, tmp_path, capsys):
    """A few steps of each variant through the port's Trainer; a second
    call resumes from the checkpoint directory and has nothing to do."""
    ex = _example("train_tnn_lm_torch")
    args = ["--variant", variant, "--device", "cpu", "--steps", "3",
            "--seq-len", "16", "--batch", "2", "--ckpt-dir", str(tmp_path)]
    assert ex.main(args) == 0
    assert f"[example] {variant} (" in capsys.readouterr().out
    assert ckpt.latest_step(str(tmp_path)) == 3
    assert ex.main(args) == 0
    assert "nothing to do" in capsys.readouterr().out
