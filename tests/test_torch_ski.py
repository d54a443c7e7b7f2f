"""Port parity for the SKI forward (repro_torch core/ski, kernels/ref,
interp_matvec, ski_fused, ops) against the JAX package: the same numpy
inputs go through the JAX function (its jnp reference, and its Pallas
kernels in interpret mode) and the port's counterpart, which on the CPU
runs the plain versions that the CUDA kernels are held against on the
card (``chip_smoke.py``).

Tolerances:
* the inducing geometry, the hat matrix, the warped lag grid and the
  bridge compare bitwise: the port builds them with the same numpy code
  or moves bytes;
* the RPE at the warped grid and the plan's Gram compare at 1e-6 × max
  (piecewise-linear blends of the same fp32 values; measured 0);
* kernel-level and op-level outputs at 1e-5 × max|reference|, the fp32
  tier: the contractions sum in another order in torch than in XLA;
* the bridged smoke model's logits and eval loss at rtol = atol = 1e-4,
  as ``test_torch_model.py``: the order noise compounds over the layers
  and the 512-wide unembed.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import manifest as jckpt  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduce_for_smoke as jreduce  # noqa: E402
from repro.core import rpe as jrpe  # noqa: E402
from repro.core import ski as jski  # noqa: E402
from repro.kernels import backend as jbackend  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.ski_fused import ski_fused_pass2_pallas  # noqa: E402
from repro.models.context import Ctx  # noqa: E402
from repro.models.transformer import forward as jforward  # noqa: E402
from repro.models.transformer import init_model as jinit_model  # noqa: E402
from repro.models.transformer import loss_fn as jloss_fn  # noqa: E402
from repro.nn.params import unbox  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.checkpoint import manifest as ckpt  # noqa: E402
from repro_torch.configs import get_config, reduce_for_smoke  # noqa: E402
from repro_torch.core import rpe, ski  # noqa: E402
from repro_torch.kernels import backend, ops, ref, ski_vjp  # noqa: E402
from repro_torch.launch import serve as serve_launch  # noqa: E402
from repro_torch.launch import train as train_launch  # noqa: E402
from repro_torch.launch.steps import make_forward  # noqa: E402
from repro_torch.models import serving  # noqa: E402
from repro_torch.models.transformer import (  # noqa: E402
    forward, init_model, loss_fn)

torch.set_num_threads(1)
ARCH = "ski-tnn-lm-wt103"
FP32 = 1e-5

# (b, n, d, r, m): the model's smoke shape, ragged n and d, n < m, r = n,
# a one-tap filter
SHAPES = {"smoke": (2, 64, 16, 8, 4), "ragged": (3, 37, 45, 11, 4),
          "n<m": (2, 3, 5, 3, 4), "r=n": (2, 12, 6, 12, 3),
          "m=1": (2, 20, 8, 5, 1)}
LEFTS = {"causal": lambda m: 0, "centred": lambda m: m // 2,
         "mirrored": lambda m: m - 1 - m // 2, "last": lambda m: m - 1}


def _np(a):
    return a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _close(got, want, tol=FP32, what=""):
    got, want = _np(got), _np(want)
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert err <= tol * scale, f"{what}: max abs err {err} > {tol} x {scale}"


def _inputs(shape, seed=0):
    """x (b, n, d), z (b, r, d), A (d, r, r), f (d, m) as numpy fp32."""
    b, n, d, r, m = shape
    rng = np.random.default_rng(seed)
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)
    return f32(b, n, d), f32(b, r, d), f32(d, r, r), f32(d, m)


def _geometry(n, r):
    lo, w_lo, _ = jski.make_inducing(n, r)
    return np.asarray(lo), np.asarray(w_lo)


def T(a):
    """A torch copy of a numpy (or JAX) array."""
    return torch.from_numpy(np.array(a))


# -------------------------------------------------------- inducing geometry
@pytest.mark.parametrize("n,r", [(512, 64), (37, 11), (3, 3), (45, 45),
                                 (2, 2), (1000, 7), (129, 64)])
def test_make_inducing_and_hat_matrix_bitwise(n, r):
    lo, w_lo, h = ski.make_inducing(n, r, "cpu")
    jlo, jw_lo, jh = jski.make_inducing(n, r)
    assert h == jh
    assert lo.dtype == torch.int32 and w_lo.dtype == torch.float32
    np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo))
    np.testing.assert_array_equal(w_lo.numpy(), np.asarray(jw_lo))
    np.testing.assert_array_equal(ref.hat_interp_matrix(n, r).numpy(),
                                  np.asarray(jref.hat_interp_matrix(n, r)))
    np.testing.assert_array_equal(
        ref.dense_interp_matrix(lo, w_lo, r).numpy(),
        np.asarray(jref.dense_interp_matrix(jlo, jw_lo, r)))


def test_make_inducing_hands_out_copies():
    """The host cache hands every caller its own tensors."""
    lo, w_lo, _ = ski.make_inducing(40, 6, "cpu")
    lo.zero_()
    w_lo.zero_()
    lo2, w_lo2, _ = ski.make_inducing(40, 6, "cpu")
    jlo, jw_lo, _ = jski.make_inducing(40, 6)
    np.testing.assert_array_equal(lo2.numpy(), np.asarray(jlo))
    np.testing.assert_array_equal(w_lo2.numpy(), np.asarray(jw_lo))


@pytest.mark.parametrize("r,n", [(64, 512), (8, 64), (11, 37)])
def test_warped_grid_and_interp_rpe_match_jax(r, n):
    """The warped lag grid bitwise, equal to the inverse time warp of the
    lags; the interp RPE at it (pinned to 0 at x = 0) within 1e-6 × max."""
    h = (n - 1) / (r - 1)
    grid = ski._warped_lag_grid(r, h, 0.99)
    jgrid = np.asarray(jski._warped_lag_grid(r, h, 0.99))
    np.testing.assert_array_equal(grid.numpy(), jgrid)
    lags = np.arange(-(r - 1), r, dtype=np.float32) * np.float32(h)
    _close(rpe.inverse_time_warp(T(lags), 0.99),
           jrpe.inverse_time_warp(jnp.asarray(lags), 0.99), 1e-6, "warp")
    vals = np.random.default_rng(r).standard_normal((16, 129)).astype(
        np.float32)
    cfg = rpe.InterpRPEConfig(16, 129)
    params = rpe.InterpRPE(cfg)
    with torch.no_grad():
        params.vals.copy_(T(vals))
    got = rpe.interp_rpe_apply(params, cfg, grid)
    want = jrpe.interp_rpe_apply({"vals": jnp.asarray(vals)},
                                 jrpe.InterpRPEConfig(16, 129),
                                 jnp.asarray(jgrid))
    _close(got, want, 1e-6, "interp_rpe_apply")
    with torch.no_grad():
        assert not rpe.interp_rpe_apply(params, cfg, torch.zeros(1)).any()


def test_interp_rpe_init_draws_from_generator():
    cfg = rpe.InterpRPEConfig(64, 129)
    a = rpe.interp_rpe_init(cfg, torch.Generator().manual_seed(3))
    b = rpe.interp_rpe_init(cfg, torch.Generator().manual_seed(3))
    assert torch.equal(a.vals, b.vals)
    assert abs(float(a.vals.detach().std()) / 0.02 - 1) < 0.05


# ------------------------------------------------------ kernels' plain versions
@pytest.mark.parametrize("shape", list(SHAPES))
def test_interp_reduce_ref_matches_jax(shape):
    b, n, d, r, m = SHAPES[shape]
    x, _, _, _ = _inputs(SHAPES[shape])
    lo, w_lo = _geometry(n, r)
    got = ops.interp_reduce(T(x), T(lo), T(w_lo), r)
    assert got.shape == (b, r, d)
    _close(got, jref.interp_reduce_ref(x, lo, w_lo, r), what="ref")
    _close(got, jops.interp_reduce(x, lo, w_lo, r, use_pallas=True),
           what="pallas")
    # and the O(n) scatter oracle
    _close(got, jref.interp_reduce_scatter_oracle(x, lo, w_lo, r),
           what="scatter")


@pytest.mark.parametrize("left", list(LEFTS))
@pytest.mark.parametrize("shape", list(SHAPES))
def test_ski_fused_pass2_ref_matches_jax(shape, left):
    b, n, d, r, m = SHAPES[shape]
    x, z, a, f = _inputs(SHAPES[shape], seed=1)
    lf = LEFTS[left](m)
    got = ops.ski_fused_pass2(T(x), T(z), T(a), T(f), False, left=lf)
    assert got.shape == (b, n, d)
    _close(got, jref.ski_fused_pass2_ref(x, z, a, f, False, left=lf),
           what="ref")
    _close(got, ski_fused_pass2_pallas(x, z, a, f, False, interpret=True,
                                       left=lf), what="pallas")


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "bidir"])
def test_ski_fused_pass2_left_defaults_to_causal_offset(causal):
    x, z, a, f = _inputs(SHAPES["ragged"], seed=2)
    m = f.shape[-1]
    got = ops.ski_fused_pass2(T(x), T(z), T(a), T(f), causal)
    want = ops.ski_fused_pass2(T(x), T(z), T(a), T(f), causal,
                               left=0 if causal else m // 2)
    assert torch.equal(got, want)
    _close(got, jops.ski_fused_pass2(x, z, a, f, causal, use_pallas=False))


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "bidir"])
@pytest.mark.parametrize("shape", ["smoke", "ragged", "n<m", "r=n"])
def test_ski_fused_tno_ref_matches_jax(shape, causal):
    b, n, d, r, m = SHAPES[shape]
    x, _, a, f = _inputs(SHAPES[shape], seed=3)
    lo, w_lo = _geometry(n, r)
    got = ops.ski_fused_tno(T(x), T(a), T(f), T(lo), T(w_lo), r, causal)
    _close(got, jref.ski_fused_tno_ref(x, a, f, lo, w_lo, r, causal),
           what="ref")
    _close(got, jops.ski_fused_tno(x, a, f, lo, w_lo, r, causal,
                                   use_pallas=True), what="pallas")


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "bidir"])
def test_short_conv_ref_matches_jax(causal):
    x, _, _, f = _inputs(SHAPES["ragged"], seed=4)
    _close(ref.short_conv_ref(T(x), T(f), causal),
           jref.short_conv_ref(x, f, causal))
    _close(ref.short_conv_left_ref(T(x), T(f), 3),
           jref.short_conv_left_ref(x, f, 3))


# ------------------------------------------------------------------ the mixer
def _ski_params(d, m, seed):
    """JAX and port SKI parameters holding the same numpy values."""
    rng = np.random.default_rng(seed)
    vals = (0.3 * rng.standard_normal((d, 129))).astype(np.float32)
    filt = (0.3 * rng.standard_normal((d, m))).astype(np.float32)
    cfg = ski.SKIConfig(d, rank=8, filter_size=m)
    params = ski.ski_init(cfg)
    with torch.no_grad():
        params.rpe.vals.copy_(T(vals))
        params.filt.copy_(T(filt))
    jparams = {"rpe": {"vals": jnp.asarray(vals)}, "filt": jnp.asarray(filt)}
    return cfg, params, jski.SKIConfig(d, rank=8, filter_size=m), jparams


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "bidir"])
@pytest.mark.parametrize("n", [40, 8, 5])
def test_ski_plan_matches_jax(n, causal):
    cfg, params, jcfg, jparams = _ski_params(24, 4, seed=n)
    plan = ski.ski_plan(params, cfg, n, causal)
    jplan = jski.ski_plan(jparams, jcfg, n, causal)
    assert plan["r"] == jplan["r"] == min(8, n)
    assert plan["h"] == jplan["h"] and plan["variant"] == jplan["variant"]
    assert plan["causal"] == causal
    for key in ("idx_lo", "w_lo"):
        np.testing.assert_array_equal(plan[key].numpy(),
                                      np.asarray(jplan[key]))
    _close(plan["a_coef"], jplan["a_coef"], 1e-6, "a_coef")
    _close(plan["a_dense"], jplan["a_dense"], 1e-6, "a_dense")
    if causal:                         # upper triangle (lags < 0) is zero
        r = plan["r"]
        assert not plan["a_dense"][:, np.triu_indices(r, 1)[0],
                                   np.triu_indices(r, 1)[1]].any()


@pytest.mark.parametrize("use_pallas", [None, True],
                         ids=["jax-default", "jax-pallas-interpret"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "bidir"])
def test_ski_tno_apply_matches_jax(causal, use_pallas):
    cfg, params, jcfg, jparams = _ski_params(24, 4, seed=7)
    x = np.random.default_rng(8).standard_normal((2, 40, 24)).astype(
        np.float32)
    got = ski.ski_tno_apply(params, cfg, T(x), causal)
    jcfg = jski.SKIConfig(24, rank=8, filter_size=4, use_pallas=use_pallas)
    _close(got, jski.ski_tno_apply(jparams, jcfg, jnp.asarray(x), causal))
    if not causal:         # the dense oracle is the bidirectional operator
        t_dense = ski.ski_dense_oracle(params, cfg, 40)
        _close(t_dense, jski.ski_dense_oracle(jparams, jcfg, 40), FP32,
               "oracle")
        _close(got, torch.einsum("dnm,bmd->bnd", t_dense, T(x)),
               what="vs dense oracle")


def test_ski_tno_apply_rejects_stale_plan():
    cfg, params, _, _ = _ski_params(8, 4, seed=9)
    x = torch.randn(2, 16, 8)
    with pytest.raises(ValueError, match="plan mismatch"):
        ski.ski_tno_apply(params, cfg, x, causal=True,
                          plan=ski.ski_plan(params, cfg, 16, causal=False))
    with pytest.raises(ValueError, match="plan mismatch"):
        ski.ski_tno_apply(params, cfg, x, causal=True,
                          plan=ski.ski_plan(params, cfg, 17, causal=True))


@pytest.mark.parametrize("r,d", [(64, 512), (181, 512), (182, 512),
                                 (512, None), (513, 64), (4096, 8),
                                 (4097, 8)])
def test_ski_rank_variant_matches_jax(r, d):
    assert backend.ski_rank_variant(r, d) == jbackend.ski_rank_variant(r, d)


def test_unported_ski_variants_raise(monkeypatch):
    cfg, params, _, _ = _ski_params(8, 4, seed=10)
    for variant in ("windowed", "fft"):
        with pytest.raises(NotImplementedError, match="item 7"):
            ski.ski_plan(params, cfg, 32, variant=variant)
    import dataclasses
    with pytest.raises(NotImplementedError, match="unfused"):
        ski.ski_plan(params, dataclasses.replace(cfg, fused=False), 32)
    monkeypatch.setenv("REPRO_SKI_DENSE_RMAX", "4")
    with pytest.raises(NotImplementedError, match="item 7"):
        ski.ski_plan(params, cfg, 32)         # r = 8 > 4: windowed
    monkeypatch.setenv("REPRO_SKI_DENSE_RMAX", "four")
    with pytest.raises(ValueError, match="not an integer"):
        backend.ski_rank_variant(8)


# ------------------------------------------------ wrappers off the CPU path
def test_wrappers_refuse_non_cuda_devices():
    """A tensor that is neither on the CPU nor on the card never reaches the
    plain version: the wrapper raises."""
    x = torch.empty(2, 16, 8, device="meta")
    z = torch.empty(2, 4, 8, device="meta")
    a = torch.empty(8, 4, 4, device="meta")
    f = torch.empty(8, 3, device="meta")
    with pytest.raises(ValueError, match="tensor on meta"):
        ops.interp_reduce(x, None, None, 4)
    with pytest.raises(ValueError, match="tensor on meta"):
        ops.ski_fused_pass2(x, z, a, f, True)
    with pytest.raises(ValueError, match="tensor on meta"):
        ops.ski_fused_tno(x, a, f, None, None, 4, True)
    # one CPU input among card inputs is no CPU call either
    with pytest.raises(ValueError, match="tensor on cpu"):
        ops.ski_fused_pass2(torch.zeros(2, 16, 8), z, a, f, True)


def test_wrappers_are_forward_only_off_the_cpu():
    """The standalone kernel wrappers refuse an input that requires grad
    off the CPU; ``ski_fused_tno`` is differentiable (SKIFusedTNO), so with
    grad it reaches the device check as it does without."""
    x = torch.empty(2, 16, 8, device="meta")
    z = torch.empty(2, 4, 8, device="meta")
    a = torch.empty(8, 4, 4, device="meta", requires_grad=True)
    f = torch.empty(8, 3, device="meta")
    with pytest.raises(NotImplementedError, match="forward-only"):
        ops.ski_fused_pass2(x, z, a, f, True)
    with pytest.raises(ValueError, match="tensor on meta"):
        ops.ski_fused_tno(x, a, f, None, None, 4, True)
    with torch.no_grad(), pytest.raises(ValueError, match="tensor on meta"):
        ops.ski_fused_tno(x, a, f, None, None, 4, True)
    with pytest.raises(NotImplementedError, match="forward-only"):
        ops.interp_reduce(x.requires_grad_(), None, None, 4)


def test_cpu_path_is_differentiable():
    """On the CPU the op is SKIFusedTNO over the plain versions, which
    autograd differentiates."""
    x, _, a, f = (T(v).requires_grad_() for v in _inputs(SHAPES["smoke"]))
    lo, w_lo = _geometry(64, 8)
    y = ops.ski_fused_tno(x, a, f, T(lo), T(w_lo), 8, True)
    gx, ga, gf = torch.autograd.grad(y.square().sum(), (x, a, f))
    assert all(bool(torch.isfinite(g).all()) and g.abs().max() > 0
               for g in (gx, ga, gf))


# ----------------------------------------------------- the bridged smoke model
@pytest.fixture(scope="module")
def smoke():
    jcfg = jreduce(jget_config(ARCH))
    cfg = reduce_for_smoke(get_config(ARCH))
    assert (cfg.n_layers, cfg.d_model, cfg.tno_rank, cfg.tno_filter) == (
        2, 128, 8, 4)
    init = jax.jit(lambda k: unbox(jinit_model(k, jcfg))[0])
    tree = jax.tree.map(np.asarray, init(jax.random.PRNGKey(0)))
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (2, 33))
    return jcfg, cfg, tree, toks


@pytest.mark.parametrize("use_pallas", [None, True],
                         ids=["jax-default", "jax-pallas-interpret"])
def test_forward_and_loss_match_jax(smoke, use_pallas):
    jcfg, cfg, tree, toks = smoke
    model = bridge.params_from_jax(tree, cfg, device="cpu")
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    jops.set_default_backend(use_pallas)
    try:
        want, _ = jforward(tree, jcfg, Ctx(), {"tokens": batch["tokens"]})
        jloss, _ = jloss_fn(tree, jcfg, Ctx(), batch)
    finally:
        jops.set_default_backend(None)
    got = make_forward(cfg)(model, T(batch["tokens"]))
    assert got.shape == (2, 32, cfg.vocab_padded) and not got.requires_grad
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    with torch.no_grad():
        loss, _ = loss_fn(model, cfg, {k: T(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-4,
                               atol=1e-4)


def test_make_forward_is_the_forward_without_grad(smoke):
    _, cfg, _, toks = smoke
    model = init_model(cfg, torch.Generator().manual_seed(1), device="cpu")
    got = make_forward(cfg)(model, T(toks))
    with torch.no_grad():
        want = forward(model, cfg, T(toks))
    assert torch.equal(got, want) and got.is_inference()


def test_bridge_round_trip_bitwise(smoke, tmp_path):
    """JAX → port → JAX moves the SKI leaves (``mixer/tno/rpe/vals``,
    ``mixer/tno/filt``) bitwise, in the params tree and through the
    checkpoint layout both ways."""
    jcfg, cfg, tree, _ = smoke
    model = bridge.params_from_jax(tree, cfg, device="cpu")
    for i in range(cfg.n_layers):
        tno = model.layers[i].mixer.tno
        np.testing.assert_array_equal(
            tno.rpe.vals.detach().numpy(),
            tree["blocks"]["sub0"]["mixer"]["tno"]["rpe"]["vals"][i])
        np.testing.assert_array_equal(
            tno.filt.detach().numpy(),
            tree["blocks"]["sub0"]["mixer"]["tno"]["filt"][i])
    back = bridge.params_to_jax(model)
    jl, jdef = jax.tree.flatten(tree)
    bl, bdef = jax.tree.flatten(jax.tree.map(lambda t: t.numpy(), back))
    assert jdef == bdef
    for a, b in zip(jl, bl):
        np.testing.assert_array_equal(a, b)
    # port checkpoint → JAX restore
    ckpt.save(str(tmp_path / "p"), 1, {"params": back})
    got, _ = jckpt.restore(str(tmp_path / "p"), {"params": tree})
    for a, b in zip(jax.tree.leaves(got), jl):
        np.testing.assert_array_equal(np.asarray(a), b)
    # JAX checkpoint → port restore → model
    jckpt.save(str(tmp_path / "j"), 2, {"params": tree})
    other = init_model(cfg, torch.Generator().manual_seed(5), device="cpu")
    got, _ = ckpt.restore(str(tmp_path / "j"),
                          {"params": bridge.params_to_jax(other)})
    again = bridge.params_from_jax(got["params"], cfg, device="cpu")
    for (k, p), q in zip(model.named_parameters(), again.parameters()):
        assert torch.equal(p, q), k


# ------------------------------------------------------------ entry points
def test_launch_train_trains_ski(capsys):
    """``launch.train --arch ski-tnn-lm-wt103`` trains: each step's SKI
    layers run SKIFusedTNO's forward and its kernel backward."""
    cfg = reduce_for_smoke(get_config(ARCH))
    ops.reset_ski_counters()
    assert train_launch.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                              "--steps", "2", "--seq-len", "16",
                              "--global-batch", "2"]) == 0
    assert "[train] 2 steps in" in capsys.readouterr().out
    assert ski_vjp.counters == {"fwd": 2 * cfg.n_layers,
                                "bwd_kernel": 2 * cfg.n_layers,
                                "bwd_ref": 0}


def test_ski_has_no_decode():
    cfg = reduce_for_smoke(get_config(ARCH))
    model = init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(NotImplementedError, match="Appendix B"):
        serving.init_cache(cfg, 1, 16, params=model)
    with pytest.raises(NotImplementedError, match="Appendix B"):
        serve_launch.main(["--arch", ARCH, "--smoke", "--device", "cpu"])
