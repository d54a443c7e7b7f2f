"""Port parity for Mamba-2 training (repro_torch: the ShortConv backward in
fp32 and bf16, the SSDScan autograd Function, per-layer remat, and the
smoke ``mamba2-2.7b`` trained through ``launch.steps`` and
``launch.train``) against the JAX package, on the CPU.

Tolerances, each with its reason:
* ShortConv backward, fp32: dx and df within 1e-5 × max (fp32 sums in
  another order); bf16: 1e-2 × max (both sides sum in fp32 and round
  once to bf16, so at most one bf16 ulp, 2^-8 relative, apart);
* SSDScan's cotangents against ``jax.grad`` of JAX ``ops.ssd_scan``
  (``use_pallas=False``, the chunked scan JAX differentiates): fp32
  within 1e-5 × max|g| (fp32 sums in another order); bf16 inputs: the
  fp32 cotangents of dt, a and d_skip within 1e-4 × max|g| (the same
  fp32 backward from the same bf16 values, with the bf16 rounding of y's
  cotangent inside) and x, B, C within 1e-2 × max|g| (one bf16 rounding
  of each side's fp32 cotangent);
* the bridged smoke model, fp32: the loss within 1e-5 relative and every
  gradient leaf within 1e-5 × its max|g| (matmul and SSD sums in another
  order over two layers);
* bf16 (the config's own dtype), the zoo's rule: each gradient leaf
  within max(2e-2, 2 × JAX's own distance between its bf16 gradient and
  its fp32 gradient of the same weights) × max|g|. The two packages round
  to bf16 at different places (XLA keeps fused elementwise chains in
  fp32), so their distance is of the size of each one's bf16 noise, which
  reaches 4% of a leaf's scale on ``dt_bias`` and ``a_log`` in JAX itself;
* two AdamW steps: losses 1e-5 relative, parameters within 2·Σ lr per
  element (Adam's first steps move a weight by about ±lr whatever the
  gradient's size, so a near-zero component whose sign differs between
  the two frameworks' round-off moves the weights apart by up to 2·lr a
  step; ROADMAP Queue 3) and 99% of them within 1e-5;
* remat "full" against "none": bitwise (the same ops recomputed on the
  same inputs on the CPU).
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
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.short_conv import short_conv_pallas  # noqa: E402
from repro.models.context import Ctx  # noqa: E402
from repro.models.transformer import init_model as jinit_model  # noqa: E402
from repro.models.transformer import loss_fn as jloss_fn  # noqa: E402
from repro.nn.params import unbox  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config, reduce_for_smoke  # noqa: E402
from repro_torch.kernels import ops, short_conv, ski_grad, ssd_chunked  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd_mod  # noqa: E402
from repro_torch.launch import train as train_launch  # noqa: E402
from repro_torch.launch.steps import loss_and_grads  # noqa: E402
from repro_torch.models.transformer import Model, forward  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from test_torch_zoo import _f32, _rel, _torch_batch  # noqa: E402

torch.set_num_threads(1)
ARCH = "mamba2-2.7b"
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
BF16_TOL = 2e-2


# ---------------------------------------------------- ShortConv backward
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,n,d,m,causal", [(2, 37, 24, 4, True),
                                            (1, 40, 320, 4, True),
                                            (2, 3, 8, 4, True),
                                            (2, 33, 16, 5, False)])
def test_short_conv_backward_matches_jax(b, n, d, m, causal, dtype):
    """dx and df of ``ops.short_conv`` (ShortConv: the same conv with the
    taps flipped for dx, ``conv_tap_grad`` for df, in the inputs' dtype)
    against the VJP of JAX's ``short_conv_pallas`` in interpret mode, and
    df against ``conv_tap_grad_ref`` cast to the taps' dtype; n < m
    included."""
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(n * d + m)
    x = rng.standard_normal((b, n, d)).astype(np.float32)
    f = (0.3 * rng.standard_normal((d, m))).astype(np.float32)
    g = rng.standard_normal((b, n, d)).astype(np.float32)
    jx, jf, jg = (jnp.asarray(v).astype(jdt) for v in (x, f, g))
    _, vjp = jax.vjp(lambda a, w: short_conv_pallas(a, w, causal,
                                                    interpret=True), jx, jf)
    want_dx, want_df = vjp(jg)
    tx, tf, tg = (torch.from_numpy(v).to(tdt) for v in (x, f, g))
    tx.requires_grad_()
    tf.requires_grad_()
    short_conv.reset_counters()
    dx, df = torch.autograd.grad(ops.short_conv(tx, tf, causal=causal),
                                 (tx, tf), tg)
    assert short_conv.op_counters == {"fwd": 1, "bwd_kernel": 1,
                                      "bwd_ref": 0}
    assert dx.dtype == df.dtype == tdt
    tol = 1e-5 if dtype == "float32" else 1e-2
    assert _rel(dx, want_dx) <= tol
    assert _rel(df, want_df) <= tol
    left = 0 if causal else m // 2
    tap = jref.conv_tap_grad_ref(jg, jx, m, left).astype(jdt)
    assert _rel(df, tap) <= tol



def test_conv_tap_grad_takes_both_fp32_or_both_bf16():
    """Off the CPU ``conv_tap_grad`` takes a pair of one dtype, fp32 or
    bf16 (meta tensors stand for the card's: a bf16 pair passes the dtype
    check and meets the device check), and refuses any other pair before
    a launch; the CPU path takes bf16 too and sums in fp32."""
    x = torch.empty(2, 16, 8, device="meta", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="tensor on meta"):
        ski_grad.conv_tap_grad(x, x, 4, 0)
    with pytest.raises(TypeError, match="both of one dtype, float32 or "
                                        "bfloat16"):
        ski_grad.conv_tap_grad(x, x.float(), 4, 0)
    with pytest.raises(TypeError, match="both of one dtype"):
        ski_grad.conv_tap_grad(x.half(), x.half(), 4, 0)
    g = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 9, 5)).astype(np.float32)).bfloat16()
    df = ski_grad.conv_tap_grad(g, g, 4, 1)
    assert df.dtype == torch.float32
    assert torch.equal(df, ski_grad.conv_tap_grad(g.float(), g.float(), 4, 1))
    assert ski_grad.counters["conv_tap_grad_bf16"] == 0

# ----------------------------------------------------------------- SSDScan
# (bt, n, h, p, g, s, chunk): one chunk and a ragged tail, g = 2 groups,
# and the smoke model's (q 16, p 32, s 16)
SSD_SHAPES = [(1, 64, 2, 8, 1, 8, 16), (2, 128, 4, 16, 2, 16, 32),
              (2, 50, 4, 8, 2, 8, 16), (2, 37, 8, 32, 1, 16, 16)]


def _ssd_inputs(bt, n, h, p, g, s, seed=0):
    """numpy fp32 (x, dt, a, b, c, d_skip, gy): dt positive and a negative
    as the model makes them (softplus, -exp), gy a cotangent of y."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((bt, n, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((bt, n, h)))).astype(np.float32)
    a = (-np.exp(0.1 * rng.standard_normal(h))).astype(np.float32)
    b = rng.standard_normal((bt, n, g, s)).astype(np.float32)
    c = rng.standard_normal((bt, n, g, s)).astype(np.float32)
    dsk = (1.0 + 0.1 * rng.standard_normal(h)).astype(np.float32)
    gy = rng.standard_normal((bt, n, h, p)).astype(np.float32)
    return x, dt, a, b, c, dsk, gy


def _cast(arrs, dtype):
    """x, b, c and gy in ``dtype`` (the same rounding to bf16 on both
    sides), dt, a, d_skip fp32: (JAX arrays, torch tensors)."""
    jdt, tdt = DTYPES[dtype]
    low = (0, 3, 4, 6)
    jx = [jnp.asarray(v).astype(jdt) if i in low else jnp.asarray(v)
          for i, v in enumerate(arrs)]
    tx = [torch.from_numpy(v).to(tdt) if i in low else torch.from_numpy(v)
          for i, v in enumerate(arrs)]
    return jx, tx


@functools.cache
def _jax_ssd_vjp(chunk: int):
    """jit of (inputs, gy) -> (y, the six cotangents) of JAX
    ``ops.ssd_scan`` on its chunked path."""
    def f(args, gy):
        y, vjp = jax.vjp(lambda *a: jops.ssd_scan(*a, chunk=chunk,
                                                  use_pallas=False), *args)
        return y, vjp(gy)
    return jax.jit(f)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bt,n,h,p,g,s,chunk", SSD_SHAPES)
def test_ssd_scan_grads_match_jax(bt, n, h, p, g, s, chunk, dtype):
    """The six cotangents of ``ops.ssd_scan`` (SSDScan) against
    ``jax.vjp`` of JAX ``ops.ssd_scan(..., use_pallas=False)``; dt, a and
    d_skip get fp32 cotangents, x, B and C their own dtype."""
    (*jx, jgy), (*tx, tgy) = _cast(_ssd_inputs(bt, n, h, p, g, s), dtype)
    y, want = _jax_ssd_vjp(chunk)(jx, jgy)
    for t in tx:
        t.requires_grad_()
    ssd_mod.reset_counters()
    got_y = ops.ssd_scan(*tx, chunk=chunk)
    got = torch.autograd.grad(got_y, tx, tgy)
    assert ssd_mod.op_counters == {"fwd": 1, "bwd_chunked": 1}
    assert ssd_mod.counters == {"ssd_scan": 0}       # the CPU launches none
    names = ("x", "dt", "a", "B", "C", "d_skip")
    for name, t, gt, w in zip(names, tx, got, want):
        assert gt.dtype == t.dtype, name
        if dtype == "float32":
            tol = 1e-5
        else:
            tol = 1e-2 if name in ("x", "B", "C") else 1e-4
        assert _rel(gt, w) <= tol, name
    assert _rel(got_y, y) <= (1e-5 if dtype == "float32" else 1e-2)


def test_ssd_scan_backward_is_autograd_through_the_chunked_scan():
    """On the CPU SSDScan's forward is ``ssd_scan_chunked`` and its
    backward autograd through it: the same bits as differentiating the
    chunked scan directly; an input that needs no grad gets none."""
    _, tx = _cast(_ssd_inputs(2, 50, 4, 8, 2, 8, seed=3), "float32")
    *ins, gy = tx
    leaves = [t.clone().requires_grad_() for t in ins]
    want = torch.autograd.grad(ssd_chunked.ssd_scan_chunked(*leaves,
                                                            chunk=16),
                               leaves, gy)
    for t in ins:
        t.requires_grad_()
    y = ssd_mod.SSDScan.apply(*ins, 16)
    got = torch.autograd.grad(y, ins, gy)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    x, dt, a, b, c, dsk = (t.detach() for t in ins)
    x.requires_grad_()
    (gx,) = torch.autograd.grad(ops.ssd_scan(x, dt, a, b, c, dsk, chunk=16),
                                (x,), gy)
    assert torch.equal(gx, want[0])


# -------------------------------------------------------- the smoke model
def _cfgs(dtype, **kw):
    over = dict(dtype=dtype, param_dtype=dtype, **kw)
    return (jreduce(jget_config(ARCH), **over),
            reduce_for_smoke(get_config(ARCH), **over))


@functools.cache
def _tree(dtype):
    jcfg, _ = _cfgs(dtype)
    init = jax.jit(lambda k: unbox(jinit_model(k, jcfg))[0])
    return jax.tree.map(np.asarray, init(jax.random.PRNGKey(0)))


def _batch(vocab, step=0, seed=3):
    return jpipeline.batch_at(jpipeline.DataConfig(
        vocab=vocab, seq_len=40, global_batch=2, seed=seed), step)


@functools.cache
def _jax_value_and_grad(jcfg):
    """jit of (params, batch) -> ((loss, metrics), grads) of JAX's
    ``loss_fn``."""
    return jax.jit(jax.value_and_grad(
        lambda p, batch: jloss_fn(p, jcfg, Ctx(), batch), has_aux=True))


def _jax_grads(jcfg, tree, batch):
    (loss, metrics), g = _jax_value_and_grad(jcfg)(
        jax.tree.map(jnp.asarray, tree), batch)
    return loss, metrics, g


@functools.cache
def _grads(dtype):
    """(JAX loss, JAX grads by port name in fp32, port loss, port grads,
    port cfg) for the bridged smoke model at seq 40 (a ragged last SSD
    chunk), the SSDScan and ShortConv counts of the step."""
    jcfg, cfg = _cfgs(dtype)
    tree = _tree(dtype)
    batch = _batch(cfg.vocab)
    jl, _, jg = _jax_grads(jcfg, tree, batch)
    want = bridge._port_leaves(jax.tree.map(_f32, jg), cfg)
    model = bridge.params_from_jax(tree, cfg, device="cpu")
    ssd_mod.reset_counters()
    short_conv.reset_counters()
    loss, _, grads = loss_and_grads(model, cfg, _torch_batch(batch))
    counts = (dict(ssd_mod.op_counters), dict(short_conv.op_counters))
    return float(jl), want, float(loss), grads, cfg, counts


def test_fp32_loss_and_every_grad_match_jax():
    jl, want, loss, grads, cfg, counts = _grads("float32")
    np.testing.assert_allclose(loss, jl, rtol=1e-5)
    assert set(grads) == set(want)
    for k, g in grads.items():
        assert g.dtype == torch.float32
        assert _rel(g, want[k]) <= 1e-5, k
    n = cfg.n_layers
    assert counts == ({"fwd": n, "bwd_chunked": n},
                      {"fwd": n, "bwd_kernel": n, "bwd_ref": 0})


def test_bf16_grads_match_jax_under_the_zoo_rule():
    """Each leaf in its own dtype (bf16 matrices and taps, fp32 norm
    scales and Mamba's per-head vectors), within the module docstring's
    bf16 rule against JAX's bf16 gradient."""
    jl, want, loss, grads, cfg, _ = _grads("bfloat16")
    jcfg32, _ = _cfgs("float32")
    tree32 = jax.tree.map(lambda a: np.asarray(a, np.float32),
                          _tree("bfloat16"))
    _, _, jg32 = _jax_grads(jcfg32, tree32, _batch(cfg.vocab))
    own = bridge._port_leaves(jax.tree.map(_f32, jg32), cfg)
    np.testing.assert_allclose(loss, jl, rtol=BF16_TOL)
    dtypes = {k: p.dtype for k, p in Model(cfg, device="meta")
              .named_parameters()}
    for k, g in grads.items():
        assert g.dtype == dtypes[k], k
        limit = max(BF16_TOL, 2 * _rel(own[k], want[k]))
        assert _rel(g, want[k]) <= limit, k


def test_two_adamw_steps_track_jax():
    """Two steps of loss, autograd and the port's ``adamw.step`` against
    ``jax.value_and_grad`` and JAX's ``adamw.step`` from the same bridged
    fp32 parameters and batches."""
    jcfg, cfg = _cfgs("float32")
    tree = _tree("float32")
    kw = dict(lr=1e-3, warmup_steps=1, total_steps=2)
    jocfg, ocfg = jadamw.OptConfig(**kw), adamw.OptConfig(**kw)
    jparams = jax.tree.map(jnp.asarray, tree)
    jstate = jadamw.init(jocfg, jparams)
    jstep = jax.jit(functools.partial(jadamw.step, jocfg))
    model = bridge.params_from_jax(tree, cfg, device="cpu")
    opt = adamw.init(ocfg, dict(model.named_parameters()))
    lrs = []
    for i in range(2):
        batch = _batch(cfg.vocab, step=i, seed=0)
        jl, _, jg = _jax_grads(jcfg, jparams, batch)
        jstate, jparams, jm = jstep(jstate, jg, jparams)
        loss, _, grads = loss_and_grads(model, cfg, _torch_batch(batch))
        opt, m = adamw.step(ocfg, opt, grads, dict(model.named_parameters()))
        np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
        np.testing.assert_allclose(float(m["lr"]), float(jm["lr"]),
                                   rtol=1e-6)
        lrs.append(float(m["lr"]))
    want = bridge._port_leaves(jax.tree.map(np.asarray, jparams), cfg)
    bound = 2 * sum(lrs)
    for k, p in model.named_parameters():
        diff = np.abs(p.detach().numpy() - want[k])
        assert diff.max() <= bound, k
        assert np.mean(diff <= 1e-5) >= 0.99, k


# -------------------------------------------------------------------- remat
def test_remat_full_gives_the_same_loss_and_grads():
    """``remat="full"`` (the config's own setting) checkpoints every layer:
    the same fp32 loss and gradients bit for bit, each Function's forward
    run twice a layer (the forward and the recompute), its backward once."""
    _, cfg = _cfgs("float32")
    tree = _tree("float32")
    batch = _torch_batch(_batch(cfg.vocab))
    out = {}
    for remat in ("none", "full"):
        c = dataclasses.replace(cfg, remat=remat)
        model = bridge.params_from_jax(tree, c, device="cpu")
        ssd_mod.reset_counters()
        short_conv.reset_counters()
        loss, _, grads = loss_and_grads(model, c, batch)
        out[remat] = (loss, grads, dict(ssd_mod.op_counters),
                      dict(short_conv.op_counters))
    (l0, g0, s0, c0), (l1, g1, s1, c1) = out["none"], out["full"]
    assert torch.equal(l0, l1)
    assert all(torch.equal(g0[k], g1[k]) for k in g0)
    n = cfg.n_layers
    assert (s0, s1) == ({"fwd": n, "bwd_chunked": n},
                        {"fwd": 2 * n, "bwd_chunked": n})
    assert (c0["fwd"], c1["fwd"]) == (n, 2 * n)
    assert c0["bwd_kernel"] == c1["bwd_kernel"] == n


def test_remat_is_off_without_grad_and_dots_is_refused():
    _, cfg = _cfgs("float32", remat="full")
    model = bridge.params_from_jax(_tree("float32"), cfg, device="cpu")
    toks = _torch_batch(_batch(cfg.vocab))["tokens"]
    ssd_mod.reset_counters()
    with torch.no_grad():
        forward(model, cfg, toks)
    assert ssd_mod.op_counters == {"fwd": 0, "bwd_chunked": 0}
    with pytest.raises(NotImplementedError, match="remat='dots'"):
        Model(dataclasses.replace(cfg, remat="dots"), device="meta")


# ------------------------------------------------------------------- launch
def test_launch_train_mamba_smoke_cpu(capsys):
    """``python -m repro_torch.launch.train --arch mamba2-2.7b --smoke
    --device cpu`` trains 2 steps through the Trainer."""
    ssd_mod.reset_counters()
    assert train_launch.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                              "--steps", "2", "--seq-len", "32",
                              "--global-batch", "2", "--warmup", "1"]) == 0
    out = capsys.readouterr().out
    assert "[train] 2 steps in" in out and "final metrics" in out
    n = reduce_for_smoke(get_config(ARCH)).n_layers
    assert ssd_mod.op_counters == {"fwd": 2 * n, "bwd_chunked": 2 * n}
