"""The sharded TNN models on four gloo ranks of this host against the JAX
package on one device (under GSPMD a sharded step computes what the
unsharded step computes, so JAX on one device is the reference for every
sharded value).

The parent computes JAX's values for the bridged smoke
``fd-tnn-lm-wt103``, ``ski-tnn-lm-wt103`` and ``tnn-lm-wt103`` (4 rows of
16 tokens) and writes them as ``.npz`` files; ``tests/_mesh_ranks.py``
runs four ranks of ``python`` (torch and repro_torch only) on meshes
(data, model) = (2, 2), (1, 4) and (4, 1): FSDP over data, channel TP
over model, the sequence-parallel residual, the vocab-parallel loss, each
TNO mixer on its rank's rows and channels. Every spawn has its own time
limit (``_RANK_TIMEOUT``): a hung collective fails the test and its ranks
are killed.

Tolerances, each with its reason (the port's tiers, as
``tests/test_torch_train.py``):
* logits within 1e-5 × max|logits|: the sharded matmuls sum in another
  order than XLA's (and than the mesh-free port's), fp32;
* loss within 1e-5 relative and every gradient (gathered by
  ``full_tensor()``) within 1e-5 × max|g| of its leaf against
  ``jax.value_and_grad``: the reductions over data and model ranks add
  partial sums in another order;
* three AdamW steps: losses within 1e-4 relative, parameters within
  2·Σ lr per element with 99% within 1e-5 (Adam's first steps move a
  weight by about ±lr whatever its gradient's size, so a near-zero
  component whose sign differs by round-off moves by up to 2·lr a step);
* checkpoints (save under (2, 2), restore under (4, 1) and into a
  one-rank state): bitwise, bytes move and nothing is computed.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduce_for_smoke as jreduce  # noqa: E402
from repro.data import pipeline as jpipeline  # noqa: E402
from repro.launch.steps import StepBuilder as JStepBuilder  # noqa: E402
from repro.models.context import Ctx as JCtx  # noqa: E402
from repro.models.transformer import forward as jforward  # noqa: E402
from repro.models.transformer import init_model as jinit_model  # noqa: E402
from repro.models.transformer import loss_fn as jloss_fn  # noqa: E402
from repro.nn.params import unbox  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.checkpoint import manifest as ckpt  # noqa: E402
from repro_torch.configs import get_config, reduce_for_smoke  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402

import _mesh_ranks  # noqa: E402  (tests/, on sys.path under pytest)

_RANK_TIMEOUT = 120                 # seconds for one spawn of four ranks
FD, SKI, TNO = "fd-tnn-lm-wt103", "ski-tnn-lm-wt103", "tnn-lm-wt103"
ARCHS = {FD: ["2x2", "1x4", "4x1"], SKI: ["2x2", "1x4", "4x1"],
         TNO: ["2x2"]}
META = {"archs": ARCHS, "ckpt_arch": FD, "seq_len": 16, "global_batch": 4,
        "seed": 0, "steps": 3,
        "opt": {"lr": 1e-3, "warmup_steps": 1, "total_steps": 3}}
CASES = [(a, m) for a, ms in ARCHS.items() for m in ms]


def _jax_ref(arch, out_dir):
    """JAX's values for ``arch`` (one device) into ``out_dir/arch.npz``:
    the parameters (dotted JAX paths), logits, loss and grads on batch 0
    and three train steps' losses and final parameters (port names)."""
    jcfg = jreduce(jget_config(arch))
    cfg = reduce_for_smoke(get_config(arch))
    init = jax.jit(lambda k: unbox(jinit_model(k, jcfg))[0])
    tree = jax.tree.map(np.asarray, init(jax.random.PRNGKey(1)))
    dc = jpipeline.DataConfig(vocab=cfg.vocab, seq_len=META["seq_len"],
                              global_batch=META["global_batch"],
                              seed=META["seed"])
    batch = jpipeline.batch_at(dc, 0)
    out = {f"p.{k}": v for k, v in bridge._flatten(tree)}
    out["logits"] = np.asarray(jforward(tree, jcfg, JCtx(), batch)[0])
    (loss, _), grads = jax.value_and_grad(
        lambda p: jloss_fn(p, jcfg, JCtx(), batch), has_aux=True)(tree)
    out["loss"] = np.asarray(loss)
    for k, g in bridge._port_leaves(jax.tree.map(np.asarray, grads),
                                    cfg).items():
        out[f"grad.{k}"] = g
    sb = JStepBuilder(jcfg, opt_cfg=jadamw.OptConfig(**META["opt"]))
    step = jax.jit(sb.make_train_step())
    state = {"params": jax.tree.map(jnp.asarray, tree)}
    state["opt"] = jadamw.init(sb.opt_cfg, state["params"])
    losses, lrs = [], []
    for i in range(META["steps"]):
        state, m = step(state, jpipeline.batch_at(dc, i))
        losses.append(float(m["loss"]))
        lrs.append(float(m["lr"]))
    out["losses"], out["lrs"] = np.array(losses), np.array(lrs)
    for k, v in bridge._port_leaves(
            jax.tree.map(np.asarray, state["params"]), cfg).items():
        out[f"param.{k}"] = v
    np.savez(out_dir / f"{arch}.npz", **out)
    return dict(out, tree=tree)


def _spawn(shape, ref_dir, out_dir, ckpt_dir):
    """Four ranks of ``_mesh_ranks.py`` on ``shape``, within
    ``_RANK_TIMEOUT``."""
    store = out_dir / f"store_{shape}"
    _mesh_ranks.spawn(lambda r: (r, 4, store, shape, ref_dir, out_dir,
                                 ckpt_dir), 4, _RANK_TIMEOUT)
    return dict(np.load(out_dir / f"{shape}.npz"))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's values, then the three spawns (the (4, 1) one restores the
    checkpoint the (2, 2) one saved)."""
    ref_dir = tmp_path_factory.mktemp("ref")
    out_dir = tmp_path_factory.mktemp("out")
    ckpt_dir = tmp_path_factory.mktemp("ckpt")
    with open(ref_dir / "meta.json", "w") as f:
        json.dump(META, f)
    refs = {a: _jax_ref(a, ref_dir) for a in ARCHS}
    got = {m: _spawn(m, ref_dir, out_dir, ckpt_dir)
           for m in ("2x2", "1x4", "4x1")}
    return refs, got, ckpt_dir


def _rel(got, want):
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)),
                                                  1e-30))


@pytest.mark.parametrize("arch,mesh", CASES)
def test_logits_match_jax(runs, arch, mesh):
    refs, got, _ = runs
    assert _rel(got[mesh][f"{arch}.logits"], refs[arch]["logits"]) <= 1e-5


@pytest.mark.parametrize("arch,mesh", CASES)
def test_loss_and_every_gradient_match_jax(runs, arch, mesh):
    """Loss and every gathered gradient against ``jax.value_and_grad``;
    each TNO layer ran its autograd Function's forward and kernel
    backward once on every rank (the plain backward never)."""
    refs, got, _ = runs
    g, r = got[mesh], refs[arch]
    np.testing.assert_allclose(float(g[f"{arch}.loss"]), float(r["loss"]),
                               rtol=1e-5)
    names = [k[5:] for k in r if k.startswith("grad.")]
    assert names
    for k in names:
        assert _rel(g[f"{arch}.grad.{k}"], r[f"grad.{k}"]) <= 1e-5, k
    n = reduce_for_smoke(get_config(arch)).n_layers
    want = [n, n, 0] if arch in (FD, SKI) else [0, 0, 0]
    assert g[f"{arch}.counters"].tolist() == want


@pytest.mark.parametrize("arch,mesh", CASES)
def test_three_adamw_steps_track_jax(runs, arch, mesh):
    refs, got, _ = runs
    g, r = got[mesh], refs[arch]
    np.testing.assert_allclose(g[f"{arch}.losses"], r["losses"], rtol=1e-4)
    np.testing.assert_allclose(g[f"{arch}.lrs"], r["lrs"], rtol=1e-6)
    bound = 2 * float(np.sum(r["lrs"]))
    for k in [k[6:] for k in r if k.startswith("param.")]:
        diff = np.abs(g[f"{arch}.param.{k}"] - r[f"param.{k}"])
        assert diff.max() <= bound, k
        assert np.mean(diff <= 1e-5) >= 0.99, k


@pytest.mark.parametrize("arch,mesh", CASES)
def test_local_shards_are_real(runs, arch, mesh):
    """Each rank holds its shards: wu is (d / data, d_e / model), and on
    every axis of extent > 1 each kind of leaf (FSDP'd weight, TP'd
    weight, the vocab-sharded unembedding, the embedding's d, the
    mixer's channel leaves, a norm scale) is split; the gradients come
    back with their parameters' placements on every axis of extent > 1
    (on one of extent 1 the label is left: nothing would move)."""
    _, got, _ = runs
    g = got[mesh]
    data, model = map(int, mesh.split("x"))
    cfg = reduce_for_smoke(get_config(arch))
    d = cfg.d_model

    def local(k):
        return tuple(g[f"{arch}.local.{k}"])
    assert local("layers.0.mixer.wu.w") == (d // data, d // model)
    assert local("layers.0.mixer.wo.w") == (d // model, d // data)
    assert local("layers.0.ffn.w_gate") == (d // data, cfg.d_ff // model)
    assert local("unembed") == (d // data, cfg.vocab_padded // model)
    assert local("embed") == (cfg.vocab_padded, d // model)
    assert local("layers.0.norm1.scale") == (d // data,)
    last = "layers.0.mixer.tno.rpe.layers.2" if arch != SKI else None
    if last:
        assert local(f"{last}.w") == (cfg.tno_rpe_hidden, d // model)
    else:
        assert local("layers.0.mixer.tno.filt") == (d // model,
                                                     cfg.tno_filter)
        assert local("layers.0.mixer.tno.rpe.vals")[0] == d // model
    wide = [i for i, e in enumerate((data, model)) if e > 1]
    for k in [k for k in g if k.startswith(f"{arch}.gspec.")]:
        name = k[len(f"{arch}.gspec."):]
        got, want = g[k].tolist(), g[f"{arch}.spec.{name}"].tolist()
        assert [got[i] for i in wide] == [want[i] for i in wide], name
    assert int(g["foreign_modules"]) == 0       # no jax, no repro


def test_elastic_restore_bitwise(runs):
    """The FD state saved under (2, 2) restores under (4, 1) (through the
    trainer's layout and by ``shardings=``) and into a one-rank state
    bit for bit."""
    _, got, ckpt_dir = runs
    saved, back = got["2x2"], got["4x1"]
    names = [k[len(f"{FD}.param."):] for k in saved
             if k.startswith(f"{FD}.param.")]
    for k in names:
        want = saved[f"{FD}.param.{k}"]
        np.testing.assert_array_equal(back[f"restored.param.{k}"], want, k)
        np.testing.assert_array_equal(back[f"named.param.{k}"], want, k)
        np.testing.assert_array_equal(back[f"restored.mu.{k}"],
                                      saved[f"saved.mu.{k}"], k)
    assert tuple(back["named.local.layers.0.mixer.wu.w"]) == (128 // 4, 128)
    assert back["restored.spec.layers.0.mixer.wu.w"].tolist() == [
        "S(0)", "S(1)"]
    # one rank, no mesh: the trainer's checkpoint into a plain model
    cfg = reduce_for_smoke(get_config(FD))
    from repro_torch.models.transformer import init_model
    model = init_model(cfg, torch.Generator().manual_seed(9), device="cpu")
    opt = adamw.init(adamw.OptConfig(), dict(model.named_parameters()))
    tree, _ = ckpt.restore(str(ckpt_dir / "trainer"),
                           bridge.train_state_to_jax(model, opt))
    opt = bridge.load_train_state(model, tree)
    for k, p in model.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(),
                                      saved[f"{FD}.param.{k}"], k)
        np.testing.assert_array_equal(opt.mu[k].numpy(),
                                      saved[f"saved.mu.{k}"], k)
    assert int(opt.step) == 3


def test_launch_train_on_a_mesh_resumes(runs, tmp_path):
    """``launch.train --mesh 2x2`` on the four ranks (the process group
    already running) trains 3 steps with checkpoints, only rank 0 prints,
    and a second call resumes to step 5; its final state is the one-rank
    launcher's within the Adam rule (both runs' parameters restored from
    their checkpoints)."""
    from repro_torch.launch import train as train_launch
    from repro_torch.models.transformer import init_model
    _, got, ckpt_dir = runs
    lines = got["2x2"]["launch.lines"].tolist()
    assert sum("[train] 3 steps in" in ln for ln in lines) == 1, lines
    assert sum("[train] 2 steps in" in ln for ln in lines) == 1, lines
    for steps in ("3", "5"):
        assert train_launch.main(_mesh_ranks.LAUNCH_ARGS + [
            "--steps", steps, "--ckpt-dir", str(tmp_path)]) == 0
    cfg = reduce_for_smoke(get_config(FD))
    model = init_model(cfg, torch.Generator().manual_seed(9), device="cpu")
    opt = adamw.init(adamw.OptConfig(), dict(model.named_parameters()))
    like = bridge.train_state_to_jax(model, opt)
    mesh_state, extra = ckpt.restore(str(ckpt_dir / "launch"), like)
    one_state, _ = ckpt.restore(str(tmp_path), like)
    assert extra["data_step"] == 5 and int(mesh_state["opt"][0]) == 5
    lrs = [float(adamw.schedule(adamw.OptConfig(lr=3e-4, warmup_steps=1,
                                                total_steps=5), i))
           for i in range(1, 6)]
    want = bridge._port_leaves(one_state["params"], cfg)
    for k, v in bridge._port_leaves(mesh_state["params"], cfg).items():
        diff = (v - want[k]).abs()
        assert float(diff.max()) <= 2 * sum(lrs), k
        assert float((diff <= 1e-5).float().mean()) >= 0.99, k



def test_async_checkpoint_failure_reaches_every_rank(runs):
    """On the four ranks of (2, 2), rank 0's failed background write
    raises at every rank's ``wait()`` (rank 0 its own error, the others
    rank 0's), and after the next save's ``wait()`` every rank sees the
    commit."""
    _, got, _ = runs
    errors = got["2x2"]["async.errors"].tolist()
    assert errors[0] == "OSError: injected write failure", errors
    for e in errors[1:]:
        assert e.startswith("RuntimeError: rank 0's checkpoint write "
                            "failed") and "injected write failure" in e, e
    assert got["2x2"]["async.latest"].tolist() == [2, 2, 2, 2]
