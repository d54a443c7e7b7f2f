"""Port parity for training the jamba hybrid (``jamba-1.5-large-398b``:
Mamba layers with dense and MoE FFNs and one attention layer in an
8-layer period) against ``jax.grad`` of the JAX package's loss, on the
smoke config cut to one period (8 layers, ``blocks/sub0..7``), in fp32,
at capacity factor 8 as JAX's ``test_decode_matches_forward`` takes the
MoE layers (no assignment drops, so the routing alone decides). The JAX
parameters are carried over by ``bridge.params_from_jax`` and both
packages read the same numpy batch.

The reference is ``jax.value_and_grad`` of ``loss_fn`` evaluated as the
port evaluates, op by op, not under ``jax.jit``: XLA's fusion reorders
fp32 sums, and on this cut JAX's jitted gradient sits up to 6.3e-6 ×
max|g| from its own op-by-op one on the ``a_log`` leaves (each a
cancelling sum over every position), which leaves no room under 1e-5 for
a third evaluation order (the port's: 1.1e-5 from the jitted one, 8e-6
from the op-by-op one).

Tolerances, each with its reason: the loss, its nll and its aux term
within 1e-5 relative, and every gradient leaf within 1e-5 × its max|g|
(matmul, SSD, softmax and router sums in another order over 8 layers);
remat "full" against "none": bitwise (the same ops recomputed on the same
inputs on the CPU).
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduce_for_smoke as jreduce  # noqa: E402
from repro.data import pipeline as jpipeline  # noqa: E402
from repro.models.context import Ctx  # noqa: E402
from repro.models.transformer import init_model as jinit_model  # noqa: E402
from repro.models.transformer import loss_fn as jloss_fn  # noqa: E402
from repro.nn.params import unbox  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config, reduce_for_smoke  # noqa: E402
from repro_torch.kernels import short_conv  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd_mod  # noqa: E402
from repro_torch.launch import train as train_launch  # noqa: E402
from repro_torch.launch.steps import loss_and_grads  # noqa: E402
from test_torch_zoo import _rel, _torch_batch  # noqa: E402

torch.set_num_threads(1)
ARCH = "jamba-1.5-large-398b"
CUT = {"dtype": "float32", "param_dtype": "float32", "n_layers": 8,
       "moe_capacity_factor": 8.0}
TOL = 1e-5


@functools.cache
def _setup():
    """(JAX cfg, port cfg, JAX params as numpy, the batch) of the cut."""
    jcfg = jreduce(jget_config(ARCH), **CUT)
    cfg = reduce_for_smoke(get_config(ARCH), **CUT)
    init = jax.jit(lambda k: unbox(jinit_model(k, jcfg))[0])
    tree = jax.tree.map(np.asarray, init(jax.random.PRNGKey(0)))
    batch = jpipeline.batch_at(jpipeline.DataConfig(
        vocab=cfg.vocab, seq_len=40, global_batch=2, seed=3), 0)
    return jcfg, cfg, tree, batch


@functools.cache
def _jax():
    """JAX's (loss, metrics) and gradients by port name, op by op (the
    module docstring)."""
    jcfg, cfg, tree, batch = _setup()
    (loss, metrics), g = jax.value_and_grad(
        lambda p: jloss_fn(p, jcfg, Ctx(), batch), has_aux=True)(
            jax.tree.map(jnp.asarray, tree))
    return ({k: float(v) for k, v in dict(metrics, loss=loss).items()},
            bridge._port_leaves(jax.tree.map(np.asarray, g), cfg))


@functools.cache
def _port(remat: str = "none"):
    """The port's (loss, metrics, grads, SSDScan and ShortConv counts)."""
    _, cfg, tree, batch = _setup()
    cfg = dataclasses.replace(cfg, remat=remat)
    model = bridge.params_from_jax(tree, cfg, device="cpu")
    ssd_mod.reset_counters()
    short_conv.reset_counters()
    loss, metrics, grads = loss_and_grads(model, cfg, _torch_batch(batch))
    return (loss, metrics, grads, dict(ssd_mod.op_counters),
            dict(short_conv.op_counters))


def test_the_cut_is_one_period_of_every_layer_kind():
    _, cfg, tree, _ = _setup()
    assert cfg.n_layers == cfg.period == 8
    assert set(tree["blocks"]) == {f"sub{i}" for i in range(8)}
    assert set(cfg.layers_spec) == {("mamba", "dense"), ("mamba", "moe"),
                                    ("attention", "dense")}
    assert cfg.layers_spec[4] == ("attention", "dense")
    assert sum(m == "attention" for m, _ in cfg.layers_spec) == 1


def test_loss_nll_and_aux_match_jax():
    want, _ = _jax()
    loss, metrics, _, _, _ = _port()
    np.testing.assert_allclose(float(loss), want["loss"], rtol=TOL)
    for k in ("nll", "aux"):
        np.testing.assert_allclose(metrics[k].item(), want[k], rtol=TOL)
    assert want["aux"] > 0.0          # the MoE layers' load-balance term


def test_grads_cover_every_leaf_in_fp32():
    _, want = _jax()
    _, _, grads, _, _ = _port()
    assert set(grads) == set(want)
    assert all(g.dtype == torch.float32 for g in grads.values())


@pytest.mark.parametrize("prefix", [f"layers.{i}." for i in range(8)]
                         + ["embed", "unembed", "norm_f."])
def test_grads_match_jax(prefix):
    """Every gradient leaf of one layer (or of the embedding, the unembed
    and the final norm) against ``jax.grad``."""
    _, want = _jax()
    _, _, grads, _, _ = _port()
    keys = [k for k in grads if k.startswith(prefix)]
    assert keys
    for k in keys:
        assert _rel(grads[k], want[k]) <= TOL, k


def test_each_mamba_layer_runs_the_ops_backwards_once():
    _, cfg, _, _ = _setup()
    n = sum(m == "mamba" for m, _ in cfg.layers_spec)
    _, _, _, ssd, conv = _port()
    assert ssd == {"fwd": n, "bwd_chunked": n}
    assert conv == {"fwd": n, "bwd_kernel": n, "bwd_ref": 0}


def test_remat_full_gives_the_same_loss_and_grads():
    """Every layer checkpointed: the same bits, each Mamba layer's
    Functions run forward twice (the forward and the recompute)."""
    _, cfg, _, _ = _setup()
    n = sum(m == "mamba" for m, _ in cfg.layers_spec)
    l0, m0, g0, _, _ = _port("none")
    l1, m1, g1, ssd, conv = _port("full")
    assert torch.equal(l0, l1) and torch.equal(m0["aux"], m1["aux"])
    assert all(torch.equal(g0[k], g1[k]) for k in g0)
    assert ssd == {"fwd": 2 * n, "bwd_chunked": n}
    assert conv == {"fwd": 2 * n, "bwd_kernel": n, "bwd_ref": 0}


def test_launch_train_jamba_smoke_cpu(capsys):
    """``python -m repro_torch.launch.train --arch jamba-1.5-large-398b
    --smoke --device cpu`` trains the 16-layer smoke hybrid."""
    assert train_launch.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                              "--steps", "1", "--seq-len", "16",
                              "--global-batch", "2", "--warmup", "1"]) == 0
    assert "[train] 1 steps in" in capsys.readouterr().out
