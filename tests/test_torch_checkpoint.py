"""Checkpoints pass between the two packages: repro_torch.checkpoint.manifest
writes the on-disk layout of repro.checkpoint.manifest (one .npy per leaf in
jax.tree.flatten order, manifest.json, the COMMITTED marker, LATEST), and
repro_torch.bridge converts the training state {"params", "opt"} to and
from the JAX layout (scanned blocks stacked on a leading axis).

Everything compares exactly: a checkpoint moves bytes, no arithmetic.
"""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import manifest as jckpt  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduce_for_smoke as jreduce  # noqa: E402
from repro.models.transformer import init_model as jinit_model  # noqa: E402
from repro.nn.params import unbox  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.checkpoint import manifest as ckpt  # noqa: E402
from repro_torch.configs import get_config, reduce_for_smoke  # noqa: E402
from repro_torch.models.transformer import init_model  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402

torch.set_num_threads(1)
ARCH = "fd-tnn-lm-wt103"
OPTS = {"fp32": dict(), "bf16-moments": dict(moments_dtype="bfloat16"),
        "int8-feedback": dict(compress_grads=True)}


@pytest.fixture(scope="module")
def jparams():
    jcfg = jreduce(jget_config(ARCH))
    return jax.jit(lambda k: unbox(jinit_model(k, jcfg))[0])(
        jax.random.PRNGKey(0))


def _np(x):
    """Leaf values as numpy, bf16 as its raw 16 bits."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.view(torch.int16).numpy() if x.dtype == torch.bfloat16
                else x.numpy())
    a = np.asarray(x)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _jax_state(jparams, opt_kw):
    """A JAX training state (``jadamw.init``'s structure and dtypes) with
    seeded values in every moment and error-feedback leaf and step 1, so
    that no leaf is zero."""
    opt = jadamw.init(jadamw.OptConfig(**opt_kw), jparams)
    rng = np.random.default_rng(5)
    fill = lambda a: jnp.asarray(rng.standard_normal(a.shape), a.dtype)
    opt = opt._replace(step=jnp.int32(1), mu=jax.tree.map(fill, opt.mu),
                       nu=jax.tree.map(fill, opt.nu),
                       err=jax.tree.map(fill, opt.err))
    return {"params": jparams, "opt": opt}


def _port_state(opt_kw, seed):
    cfg = reduce_for_smoke(get_config(ARCH))
    model = init_model(cfg, torch.Generator().manual_seed(seed),
                       device="cpu")
    ocfg = adamw.OptConfig(**opt_kw)
    params = dict(model.named_parameters())
    opt = adamw.init(ocfg, params)
    g = torch.Generator().manual_seed(seed + 1)
    grads = {k: torch.randn(p.shape, generator=g) for k, p in params.items()}
    opt, _ = adamw.step(ocfg, opt, grads, params)
    return model, opt


@pytest.mark.parametrize("opt", list(OPTS))
def test_jax_checkpoint_loads_in_port(tmp_path, jparams, opt):
    state = _jax_state(jparams, OPTS[opt])
    jckpt.save(str(tmp_path), 3, state, extra={"data_step": 3})
    model, popt = _port_state(OPTS[opt], seed=9)     # other values
    assert ckpt.latest_step(str(tmp_path)) == 3
    tree, extra = ckpt.restore(str(tmp_path),
                               bridge.train_state_to_jax(model, popt))
    assert extra == {"data_step": 3}
    popt = bridge.load_train_state(model, tree)
    cfg = model.cfg
    want = bridge._port_leaves(jax.tree.map(np.asarray, state["params"]), cfg)
    for k, p in model.named_parameters():
        np.testing.assert_array_equal(_np(p), _np(want[k]), err_msg=k)
    assert int(popt.step) == int(state["opt"].step) == 1
    for field in ("mu", "nu", "err"):
        jtree = jax.tree.map(np.asarray, getattr(state["opt"], field))
        want = bridge._port_leaves(jtree, cfg)
        for k, t in getattr(popt, field).items():
            assert t.dtype == (torch.bfloat16 if opt == "bf16-moments"
                               and field != "err" else torch.float32)
            np.testing.assert_array_equal(_np(t), _np(want[k]),
                                          err_msg=f"{field} {k}")


@pytest.mark.parametrize("opt", list(OPTS))
def test_port_checkpoint_loads_in_jax(tmp_path, jparams, opt):
    model, popt = _port_state(OPTS[opt], seed=2)
    tree = bridge.train_state_to_jax(model, popt)
    ckpt.save(str(tmp_path), 7, tree, extra={"data_step": 7})
    like = {"params": jparams,
            "opt": jadamw.init(jadamw.OptConfig(**OPTS[opt]), jparams)}
    got, extra = jckpt.restore(str(tmp_path), like)
    assert extra == {"data_step": 7}
    assert jax.tree.structure(got) == jax.tree.structure(like)
    jl, pl = jax.tree.leaves(got), ckpt.tree_leaves(tree)
    assert len(jl) == len(pl)
    for a, b in zip(jl, pl):
        np.testing.assert_array_equal(_np(a), _np(b))
    # the manifest records the structure exactly as the JAX package prints it
    with open(tmp_path / "step_000000007" / "manifest.json") as f:
        assert json.load(f)["treedef"] == str(jax.tree.structure(like))


def test_same_files_as_jax(tmp_path, jparams):
    """The two packages write the same files and manifest entries."""
    state = _jax_state(jparams, OPTS["bf16-moments"])
    jckpt.save(str(tmp_path / "j"), 1, state)
    ptree = jax.tree.map(lambda a: bridge._as_torch(np.asarray(a)), state)
    ckpt.save(str(tmp_path / "p"), 1, ptree)
    for side in ("j", "p"):
        assert sorted(os.listdir(tmp_path / side)) == [
            "LATEST", "step_000000001", "step_000000001.COMMITTED"]
    man = [json.load(open(tmp_path / s / "step_000000001" / "manifest.json"))
           for s in ("j", "p")]
    assert man[0] == man[1]
    for leaf in man[0]["leaves"]:
        a, b = (np.load(tmp_path / s / "step_000000001" / "data" / leaf["file"])
                for s in ("j", "p"))
        np.testing.assert_array_equal(a.reshape(-1), b.reshape(-1))


def test_restore_leaf_count_mismatch_raises(tmp_path):
    ckpt.save(str(tmp_path), 1, {"a": torch.zeros(3)})
    with pytest.raises(ValueError, match="leaves"):
        ckpt.restore(str(tmp_path), {"a": torch.zeros(3), "b": torch.zeros(2)})


def test_restore_shape_mismatch_raises(tmp_path):
    ckpt.save(str(tmp_path), 1, {"a": torch.zeros(3)})
    with pytest.raises(ValueError, match="shape mismatch"):
        ckpt.restore(str(tmp_path), {"a": torch.zeros(4)})


def test_load_train_state_refuses_foreign_tree(tmp_path):
    """A tree that is not this model's (a missing or an extra parameter)
    raises rather than load part of it."""
    model, opt = _port_state({}, seed=0)
    tree = bridge.train_state_to_jax(model, opt)
    del tree["params"]["norm_f"]
    with pytest.raises(ValueError, match=r"unset port parameters \['norm_f"):
        bridge.load_train_state(model, tree)


def test_latest_step_skips_uncommitted_and_async_keeps_last(tmp_path):
    d = str(tmp_path)
    saver = ckpt.AsyncCheckpointer(d, keep=2)
    t = {"w": torch.arange(4.0)}
    for s in (1, 2, 3):
        t["w"] += 1    # in place while the last save may still write: saves copy
        saver.save_async(s, t)
    saver.wait()
    assert ckpt.latest_step(d) == 3
    assert sorted(p for p in os.listdir(d) if p.endswith(".COMMITTED")) == [
        "step_000000002.COMMITTED", "step_000000003.COMMITTED"]
    got, _ = ckpt.restore(d, {"w": torch.zeros(4)}, step=2)
    assert torch.equal(got["w"], torch.arange(4.0) + 2)
    with open(os.path.join(d, "LATEST"), "w") as f:
        f.write("9")           # points at a step that never committed
    assert ckpt.latest_step(d) == 3
