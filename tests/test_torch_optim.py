"""Port parity for AdamW (repro_torch.optim.adamw) against the JAX
package's repro.optim.adamw: the same parameters, gradients and config,
made with numpy from a seed, go through both; the port updates in place.

Tolerances, each with its reason:
* schedule: 1e-7 relative (both evaluate the same fp32 formula; cos may
  round differently in the last place);
* one or two steps, fp32 moments: parameters, moments and the grad norm at
  rtol 1e-6, atol 1e-9: the same fp32 arithmetic per element, with the
  global norm summed over the leaves in another order and pow/sqrt
  possibly a unit in the last place apart;
* bf16 moments: the same, after both round the fp32 moments to bf16 (a
  one-ulp difference before rounding can land on the other side of a bf16
  rounding boundary, so moments compare at one bf16 ulp, 2**-7 relative);
* int8 compression with error feedback: the same as fp32 (round half to
  even in both).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.optim import adamw as jadamw  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402

torch.set_num_threads(1)

SHAPES = {"w": (6, 5), "b": (5,), "scale": (7,), "emb": (3, 4)}


def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {k: (rng.standard_normal(s) * scale).astype(np.float32)
            for k, s in SHAPES.items()}


def _both_steps(kw, n_steps=1):
    """Run n_steps of both optimizers from the same params and per-step
    grads; returns (jax state, jax params, jax metrics, port state, port
    params, port metrics)."""
    cfg, tcfg = jadamw.OptConfig(**kw), adamw.OptConfig(**kw)
    p0 = _tree(0)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    js = jadamw.init(cfg, jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    ts = adamw.init(tcfg, tp)
    for i in range(n_steps):
        g = _tree(10 + i, scale=10.0 ** (i - 1))
        js, jp, jm = jadamw.step(cfg, js, {k: jnp.asarray(v)
                                           for k, v in g.items()}, jp)
        ts, tm = adamw.step(tcfg, ts, {k: torch.from_numpy(v)
                                      for k, v in g.items()}, tp)
    return js, jp, jm, ts, tp, tm


def _close(got, want, rtol=1e-6, atol=1e-9):
    np.testing.assert_allclose(np.asarray(got.float() if isinstance(
        got, torch.Tensor) else got, np.float32),
        np.asarray(want, np.float32), rtol=rtol, atol=atol)


def test_schedule_matches_jax():
    cfg = jadamw.OptConfig(lr=3e-4, warmup_steps=5, total_steps=30)
    tcfg = adamw.OptConfig(lr=3e-4, warmup_steps=5, total_steps=30)
    for s in (0, 1, 3, 5, 6, 17, 29, 30, 45):
        want = float(jadamw.schedule(cfg, jnp.int32(s)))
        got = float(adamw.schedule(tcfg, torch.tensor(s, dtype=torch.int32)))
        assert abs(got - want) <= 1e-7 * max(abs(want), 1e-12), s


@pytest.mark.parametrize("moments,compress,n_steps",
                         [("float32", False, 1), ("float32", False, 2),
                          ("bfloat16", False, 2), ("float32", True, 2)],
                         ids=["fp32", "fp32-2steps", "bf16-moments",
                              "int8-feedback"])
def test_step_matches_jax(moments, compress, n_steps):
    """One (or two) AdamW steps on the same grads give the same
    parameters, moments, error-feedback residual, step count and metrics;
    the first grads are scaled 0.1 and the second 1.0 so that clipping at
    norm 1 engages on the second step."""
    kw = dict(lr=1e-2, warmup_steps=1, total_steps=10, moments_dtype=moments,
              compress_grads=compress)
    js, jp, jm, ts, tp, tm = _both_steps(kw, n_steps)
    assert int(ts.step) == int(js.step) == n_steps
    for k in SHAPES:
        _close(tp[k], jp[k])
        mtol = dict(rtol=2 ** -7, atol=1e-12) if moments == "bfloat16" else {}
        assert ts.mu[k].dtype == getattr(torch, moments)
        _close(ts.mu[k], js.mu[k].astype(jnp.float32), **mtol)
        _close(ts.nu[k], js.nu[k].astype(jnp.float32), **mtol)
        assert tuple(ts.err[k].shape) == tuple(js.err[k].shape)
        _close(ts.err[k], js.err[k])
    _close(tm["grad_norm"], jm["grad_norm"])
    _close(tm["lr"], jm["lr"])


def test_step_decays_every_parameter_and_updates_in_place():
    """Decoupled weight decay reaches every leaf (norm scales included):
    with zero gradients each parameter shrinks by exactly (1 - lr·wd), in
    the tensor the caller holds."""
    cfg = adamw.OptConfig(lr=0.1, warmup_steps=0, total_steps=10,
                          weight_decay=0.5)
    p = {k: torch.from_numpy(v) for k, v in _tree(1).items()}
    before = {k: v.clone() for k, v in p.items()}
    ids = {k: id(v) for k, v in p.items()}
    state = adamw.init(cfg, p)
    state, m = adamw.step(cfg, state, {k: torch.zeros_like(v)
                                       for k, v in p.items()}, p)
    lr = float(m["lr"])
    for k in p:
        assert id(p[k]) == ids[k]
        _close(p[k], before[k] * (1 - lr * 0.5))


def test_clip_and_compression_match_jax():
    g = _tree(3, scale=4.0)
    tg, tn = adamw.clip_by_global_norm(
        {k: torch.from_numpy(v) for k, v in g.items()}, 1.0)
    jg, jn = jadamw.clip_by_global_norm(
        {k: jnp.asarray(v) for k, v in g.items()}, 1.0)
    _close(tn, jn)
    for k in g:
        _close(tg[k], jg[k])
    err = np.random.default_rng(4).standard_normal((6, 5)).astype(np.float32)
    tdeq, terr = adamw.compress_with_feedback(torch.from_numpy(g["w"]),
                                              torch.from_numpy(err))
    jdeq, jerr = jadamw.compress_with_feedback(jnp.asarray(g["w"]),
                                               jnp.asarray(err))
    _close(tdeq, jdeq)
    _close(terr, jerr)
