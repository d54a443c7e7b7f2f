"""Port parity for SKI training (repro_torch kernels/ski_grad, ski_vjp and
the differentiable ``ops.ski_fused_tno``, the ``REPRO_PALLAS_GRAD`` switch
of both autograd Functions, and training the bridged ski-tnn-lm-wt103)
against the JAX package. The same numpy inputs go through the JAX function
(its jnp reference, and its Pallas kernels in interpret mode) and the
port's counterpart, which on the CPU runs the plain versions that the CUDA
kernels are held against on the card (``chip_smoke.py``).

Tolerances, each with its reason:
* ``conv_tap_grad_ref`` and ``gram_grad_ref`` at 1e-5 × max|reference|,
  the fp32 tier: the sums (up to b·n = 4,096 terms) run in another order
  in torch than in XLA;
* SKIFusedTNO's (dx, dA, df) at 1e-5 × max|reference| against autograd
  through the port's ``ref.ski_fused_tno_ref`` and against ``jax.grad``
  through the JAX reference op; at 1e-4 × max against the Pallas-interpret
  custom VJP, whose own grads differ from the JAX reference by up to
  1.3e-5 to 1.9e-5 relative (fp32 summation noise, ROADMAP Queue 3
  caveat A, checked below on the very case that shows it);
* the bridged smoke model: loss at 1e-5 relative, as
  ``test_torch_train.py``, and each parameter's gradient at 1e-5 × max|g|
  of that leaf (the worst leaf measured 2.4e-6, the SKI taps of layer 1);
  three train steps as ``test_torch_train.py`` (losses 1e-4 relative,
  parameters within 2·Σ lr, 99% within 1e-5);
* the optimizer state through the bridge and a checkpoint: bitwise (bytes
  move, no arithmetic).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import manifest as jckpt  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduce_for_smoke as jreduce  # noqa: E402
from repro.core import ski as jski  # noqa: E402
from repro.kernels import backend as jbackend  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.ski_grad import (conv_tap_grad_pallas,  # noqa: E402
                                    gram_grad_pallas)
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
from repro_torch.kernels import (backend, fd_fused, ops, ref,  # noqa: E402
                                 ski_grad, ski_vjp)
from repro_torch.launch.steps import (loss_and_grads,  # noqa: E402
                                      make_train_step)
from repro_torch.models.transformer import init_model  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402

torch.set_num_threads(1)
ARCH = "ski-tnn-lm-wt103"
FP32 = 1e-5
PALLAS = 1e-4

# (b, n, d, r, m) of chip_smoke.py's SKI kernel entries: the path, ragged,
# n < m, r = n (h = 1), one tap
GRAD_SHAPES = {"path": (8, 512, 512, 64, 32), "ragged": (3, 37, 45, 11, 4),
               "n<m": (2, 3, 5, 3, 4), "r=n": (2, 64, 40, 64, 8),
               "m=1": (2, 40, 33, 7, 1)}
LEFTS = {"causal": lambda m: 0, "centred": lambda m: m // 2,
         "mirrored": lambda m: m - 1 - m // 2, "last": lambda m: m - 1}
# SKIFusedTNO shapes (b, n, d, r, m), as tests/test_torch_ski.py's SHAPES
OP_SHAPES = {"smoke": (2, 64, 16, 8, 4), "ragged": (3, 37, 45, 11, 4),
             "n<m": (2, 3, 5, 3, 4), "r=n": (2, 12, 6, 12, 3),
             "m=1": (2, 20, 8, 5, 1)}


def _np(a):
    return a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _close(got, want, tol=FP32, what=""):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: max abs err {err} > {tol} x {scale}"


def T(a):
    return torch.from_numpy(np.array(a))


def _f32(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


# ------------------------------------------------- the kernels' plain versions
@pytest.mark.parametrize("left", list(LEFTS))
@pytest.mark.parametrize("shape", list(GRAD_SHAPES))
def test_conv_tap_grad_ref_matches_jax(shape, left):
    b, n, d, r, m = GRAD_SHAPES[shape]
    rng = np.random.default_rng(b * n + d)
    g, x = _f32(rng, b, n, d), _f32(rng, b, n, d)
    lf = LEFTS[left](m)
    got = ski_grad.conv_tap_grad(T(g), T(x), m, lf)
    assert got.shape == (d, m) and got.dtype == torch.float32
    _close(got, jref.conv_tap_grad_ref(g, x, m, lf), what="ref")
    _close(got, conv_tap_grad_pallas(g, x, m, lf, interpret=True),
           what="pallas")


@pytest.mark.parametrize("shape", list(GRAD_SHAPES))
def test_gram_grad_ref_matches_jax(shape):
    b, n, d, r, m = GRAD_SHAPES[shape]
    rng = np.random.default_rng(b * r + d)
    gz, z = _f32(rng, b, r, d), _f32(rng, b, r, d)
    got = ski_grad.gram_grad(T(gz), T(z))
    assert got.shape == (d, r, r) and got.dtype == torch.float32
    _close(got, jref.gram_grad_ref(gz, z), what="ref")
    _close(got, gram_grad_pallas(gz, z, interpret=True), what="pallas")


def test_grad_wrappers_refuse_off_the_cpu():
    """Off the CPU a wrapper launches its kernel or raises: a tensor on
    another device is refused, as is an input that requires grad (the
    kernel on its own is forward-only), and an offset outside [0, m)."""
    x = torch.empty(2, 16, 8, device="meta")
    z = torch.empty(2, 4, 8, device="meta")
    with pytest.raises(ValueError, match="tensor on meta"):
        ski_grad.conv_tap_grad(x, x, 3, 0)
    with pytest.raises(ValueError, match="tensor on meta"):
        ski_grad.gram_grad(z, z)
    with pytest.raises(NotImplementedError, match="forward-only"):
        ski_grad.gram_grad(z, z.clone().requires_grad_())
    with pytest.raises(NotImplementedError, match="forward-only"):
        ski_grad.conv_tap_grad(x.clone().requires_grad_(), x, 3, 0)
    with pytest.raises(ValueError, match="left=3 outside"):
        ski_grad.conv_tap_grad(torch.zeros(1, 4, 2), torch.zeros(1, 4, 2),
                               3, 3)
    # the CPU path counts no launch
    ski_grad.reset_counters()
    ski_grad.gram_grad(torch.ones(1, 2, 3), torch.ones(1, 2, 3))
    assert ski_grad.counters == {"gram_grad": 0, "conv_tap_grad": 0,
                                 "conv_tap_grad_bf16": 0}


# --------------------------------------------------------------- SKIFusedTNO
def _op_inputs(shape, seed):
    b, n, d, r, m = shape
    rng = np.random.default_rng(seed)
    lo, w_lo, _ = jski.make_inducing(n, r)
    return (_f32(rng, b, n, d), _f32(rng, d, r, r), _f32(rng, d, m),
            _f32(rng, b, n, d), np.asarray(lo), np.asarray(w_lo), r)


def _port_grads(x, a, f, g, lo, w_lo, r, causal):
    """(dx, dA, df) of the port's op at cotangent g."""
    ts = [T(v).requires_grad_() for v in (x, a, f)]
    y = ops.ski_fused_tno(*ts, T(lo), T(w_lo), r, causal)
    return torch.autograd.grad(y, ts, T(g))


def _jax_grads(x, a, f, g, lo, w_lo, r, causal, **kw):
    _, vjp = jax.vjp(lambda *t: jops.ski_fused_tno(
        *t, jnp.asarray(lo), jnp.asarray(w_lo), r, causal, **kw),
        jnp.asarray(x), jnp.asarray(a), jnp.asarray(f))
    return vjp(jnp.asarray(g))


def _check_op_grads(x, a, f, g, lo, w_lo, r, causal):
    got = _port_grads(x, a, f, g, lo, w_lo, r, causal)
    names = ("dx", "dA", "df")
    ts = [T(v).requires_grad_() for v in (x, a, f)]
    want = torch.autograd.grad(
        ref.ski_fused_tno_ref(*ts, T(lo), T(w_lo), r, causal), ts, T(g))
    for name, p, q in zip(names, got, want):
        _close(p, q, FP32, f"{name} vs autograd through ref")
    for name, p, q in zip(names, got, _jax_grads(x, a, f, g, lo, w_lo, r,
                                                 causal, use_pallas=False)):
        _close(p, q, FP32, f"{name} vs jax.grad of the reference")
    for name, p, q in zip(names, got, _jax_grads(
            x, a, f, g, lo, w_lo, r, causal, use_pallas=True,
            interpret=True)):
        _close(p, q, PALLAS, f"{name} vs the Pallas custom VJP")


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "bidir"])
@pytest.mark.parametrize("shape", list(OP_SHAPES))
def test_ski_fused_tno_grads_match(shape, causal):
    """The kernel-structured backward (interp_reduce twice, pass 2 with A
    transposed, the taps flipped and left mirrored, gram_grad,
    conv_tap_grad), here over the plain versions, against autograd and
    the JAX package."""
    ski_vjp.reset_counters()
    _check_op_grads(*_op_inputs(OP_SHAPES[shape], seed=11), causal)
    assert ski_vjp.counters == {"fwd": 1, "bwd_kernel": 1, "bwd_ref": 0}


def test_ski_fused_tno_grads_caveat_a_case():
    """The case where the JAX package's own Pallas grads and reference
    grads differ by 1.3e-5 relative (ROADMAP Queue 3 caveat A): n=56, d=2,
    r=11, m=2, non-causal, inputs drawn from seed 0 as
    tests/test_properties.py draws them, and its sin loss."""
    n, d, r, m = 56, 2, 11, 2
    ks = jax.random.split(jax.random.PRNGKey(0), 3)
    x = np.asarray(jax.random.normal(ks[0], (1, n, d)))
    a = np.asarray(jax.random.normal(ks[1], (d, r, r)))
    f = np.asarray(jax.random.normal(ks[2], (d, m)) * 0.1)
    lo, w_lo = (np.asarray(v) for v in jski.make_inducing(n, r)[:2])
    y = ref.ski_fused_tno_ref(T(x), T(a), T(f), T(lo), T(w_lo), r, False)
    g = np.cos(_np(y))                   # the cotangent of sum(sin(y))
    _check_op_grads(x, a, f, g, lo, w_lo, r, False)


# ------------------------------------------------ counters and the switch
@pytest.mark.parametrize("value,want", [
    ("", True), ("auto", True), ("1", True), ("true", True), ("0", False),
    ("false", False), ("FALSE", False), ("on", True)])
def test_resolve_pallas_grad_matches_jax(monkeypatch, value, want):
    monkeypatch.setenv("REPRO_PALLAS_GRAD", value)
    assert backend.resolve_pallas_grad() is want
    assert jbackend.resolve_pallas_grad() is want


@pytest.mark.parametrize("rmax", ["", "1024", "5000"])
def test_windowed_rank_knob_matches_jax(monkeypatch, rmax):
    """``REPRO_SKI_WINDOWED_RMAX`` moves the windowed/fft boundary as in the
    JAX package (it was a constant 4096 before)."""
    monkeypatch.setenv("REPRO_SKI_WINDOWED_RMAX", rmax)
    for r, d in ((600, 8), (2048, 8), (4097, 8), (4999, 8), (5001, 8)):
        assert (backend.ski_rank_variant(r, d)
                == jbackend.ski_rank_variant(r, d)), (rmax, r)
    assert backend.ski_windowed_rank_max() == (int(rmax) if rmax else 4096)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "bidir"])
def test_ski_reference_backward_switch(monkeypatch, causal):
    """REPRO_PALLAS_GRAD=0 keeps SKIFusedTNO's forward and returns
    autograd's cotangents through ref.ski_fused_tno_ref, counted as
    bwd_ref; the gradients are the kernel backward's within the fp32 tier."""
    args = _op_inputs(OP_SHAPES["ragged"], seed=12)
    ski_vjp.reset_counters()
    kernel = _port_grads(*args, causal)
    monkeypatch.setenv("REPRO_PALLAS_GRAD", "0")
    reference = _port_grads(*args, causal)
    assert ski_vjp.counters == {"fwd": 2, "bwd_kernel": 1, "bwd_ref": 1}
    for name, p, q in zip(("dx", "dA", "df"), reference, kernel):
        _close(p, q, FP32, name)


def test_fd_reference_backward_switch(monkeypatch):
    """The same switch for FDTNO: bwd_ref, autograd through
    ref.fd_tno_ref, the kernel backward's gradients."""
    rng = np.random.default_rng(3)
    x, k = _f32(rng, 2, 24, 6), _f32(rng, 6, 25)
    g = _f32(rng, 2, 24, 6)

    def grads():
        ts = [T(v).requires_grad_() for v in (x, k)]
        return torch.autograd.grad(ops.fd_tno(*ts), ts, T(g))
    fd_fused.reset_counters()
    kernel = grads()
    monkeypatch.setenv("REPRO_PALLAS_GRAD", "0")
    reference = grads()
    assert fd_fused.op_counters == {"fwd": 2, "bwd_kernel": 1, "bwd_ref": 1}
    for p, q in zip(reference, kernel):
        _close(p, q)


def test_ski_inference_counts_no_differentiated_forward():
    """Without grad (scoring) the op runs its forward only: no counter
    moves and nothing is kept for a backward."""
    x, a, f, _, lo, w_lo, r = _op_inputs(OP_SHAPES["smoke"], seed=13)
    ski_vjp.reset_counters()
    with torch.inference_mode():
        y = ops.ski_fused_tno(T(x).requires_grad_(), T(a), T(f), T(lo),
                              T(w_lo), r, True)
    assert y.grad_fn is None
    assert ski_vjp.counters == {"fwd": 0, "bwd_kernel": 0, "bwd_ref": 0}


# ------------------------------------------------ the bridged smoke model
@pytest.fixture(scope="module")
def smoke():
    jcfg = jreduce(jget_config(ARCH))
    cfg = reduce_for_smoke(get_config(ARCH))
    init = jax.jit(lambda k: unbox(jinit_model(k, jcfg))[0])
    tree = jax.tree.map(np.asarray, init(jax.random.PRNGKey(0)))
    return jcfg, cfg, tree


def _torch_batch(batch):
    return {k: torch.from_numpy(np.asarray(v)).long() for k, v in batch.items()}


def test_loss_and_grads_match_jax(smoke):
    """Loss and every parameter's gradient of the bridged smoke model
    against jax.grad of the JAX package's loss_fn."""
    jcfg, cfg, tree = smoke
    batch = pipeline.batch_at(pipeline.DataConfig(
        vocab=cfg.vocab, seq_len=32, global_batch=2, seed=4), 0)
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: jloss_fn(p, jcfg, Ctx(), batch), has_aux=True)(
            jax.tree.map(jnp.asarray, tree))
    model = bridge.params_from_jax(tree, cfg, device="cpu")
    ski_vjp.reset_counters()
    loss, _, grads = loss_and_grads(model, cfg, _torch_batch(batch))
    assert ski_vjp.counters == {"fwd": cfg.n_layers,
                                "bwd_kernel": cfg.n_layers, "bwd_ref": 0}
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    want = bridge._port_leaves(jax.tree.map(np.asarray, jgrads), cfg)
    assert set(want) == set(grads)
    for k, g in grads.items():
        _close(g, want[k], FP32, k)


def test_three_train_steps_track_jax(smoke):
    """Three train_steps from the same bridged parameters and batches track
    JAX ``StepBuilder(cfg).make_train_step()`` (tolerances: module
    docstring); SKIFusedTNO's kernel backward ran once a layer a step."""
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
    dcfg = pipeline.DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=2,
                               seed=0)
    ski_vjp.reset_counters()
    lrs = []
    for i in range(3):
        batch = pipeline.batch_at(dcfg, i)
        jstate, jm = jstep(jstate, batch)
        opt, m = step(model, opt, _torch_batch(batch))
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-4)
        lrs.append(float(m["lr"]))
    assert ski_vjp.counters == {"fwd": 3 * cfg.n_layers,
                                "bwd_kernel": 3 * cfg.n_layers, "bwd_ref": 0}
    want = bridge._port_leaves(jax.tree.map(np.asarray, jstate["params"]),
                               cfg)
    bound = 2 * sum(lrs)
    for k, p in model.named_parameters():
        diff = np.abs(p.detach().numpy() - want[k])
        assert diff.max() <= bound, k
        assert np.mean(diff <= 1e-5) >= 0.99, k


# ------------------------------------- optimizer state, bridge, checkpoint
def test_jax_ski_train_state_loads_in_port(tmp_path, smoke):
    """A JAX training state of the SKI model (moments seeded, step 1),
    saved by the JAX package, restores into the port bitwise, SKI leaves
    (``mixer/tno/rpe/vals``, ``mixer/tno/filt``) included."""
    _, cfg, tree = smoke
    opt = jadamw.init(jadamw.OptConfig(), jax.tree.map(jnp.asarray, tree))
    rng = np.random.default_rng(5)
    fill = lambda a: jnp.asarray(rng.standard_normal(a.shape), a.dtype)
    opt = opt._replace(step=jnp.int32(1), mu=jax.tree.map(fill, opt.mu),
                       nu=jax.tree.map(fill, opt.nu))
    jckpt.save(str(tmp_path), 3, {"params": tree, "opt": opt})
    model = init_model(cfg, torch.Generator().manual_seed(9), device="cpu")
    popt = adamw.init(adamw.OptConfig(), dict(model.named_parameters()))
    got, _ = ckpt.restore(str(tmp_path),
                          bridge.train_state_to_jax(model, popt))
    popt = bridge.load_train_state(model, got)
    assert int(popt.step) == 1
    want = bridge._port_leaves(tree, cfg)
    for k, p in model.named_parameters():
        np.testing.assert_array_equal(_np(p), want[k], err_msg=k)
    for field in ("mu", "nu"):
        want = bridge._port_leaves(
            jax.tree.map(np.asarray, getattr(opt, field)), cfg)
        assert any(".mixer.tno." in k for k in want)
        for k, t in getattr(popt, field).items():
            np.testing.assert_array_equal(_np(t), want[k],
                                          err_msg=f"{field} {k}")


def test_port_ski_train_state_loads_in_jax(tmp_path, smoke):
    """The port's SKI training state after one AdamW step, saved by the
    port, restores in the JAX package bitwise, into the structure of
    ``jadamw.init``."""
    _, cfg, tree = smoke
    model = init_model(cfg, torch.Generator().manual_seed(2), device="cpu")
    params = dict(model.named_parameters())
    ocfg = adamw.OptConfig()
    g = torch.Generator().manual_seed(3)
    grads = {k: torch.randn(p.shape, generator=g) for k, p in params.items()}
    popt, _ = adamw.step(ocfg, adamw.init(ocfg, params), grads, params)
    ptree = bridge.train_state_to_jax(model, popt)
    ckpt.save(str(tmp_path), 7, ptree)
    like = {"params": tree,
            "opt": jadamw.init(jadamw.OptConfig(), tree)}
    got, _ = jckpt.restore(str(tmp_path), like)
    assert jax.tree.structure(got) == jax.tree.structure(like)
    jl, pl = jax.tree.leaves(got), ckpt.tree_leaves(ptree)
    assert len(jl) == len(pl)
    for a, b in zip(jl, pl):
        np.testing.assert_array_equal(np.asarray(a), _np(b))
