"""Port parity for the MoE FFN (``repro_torch.models.moe``) against the JAX
package's ``repro/models/moe.py`` on the same seeded numpy inputs and the
JAX parameters (``moe_init``) carried over leaf by leaf, and the granite
smoke model through the serving engine in the regime where its steps drop
assignments. Mirrors tests/test_models.py (:133, :162, :178).

Tolerances, each with its reason:
* fp32: 1e-5 of the largest magnitude (matmul sums in another order);
  bf16 (activations and experts): 2e-2 of it, the bf16 tier (both
  packages round the expert GEMMs and the combine to bf16, at other
  places);
* routing (expert ids, the kept assignments): exact wherever the router
  logits are exact, as with the exact-arithmetic inputs of the ties test;
* the per-token expert loop of ``test_moe_matches_dense_expert_sum``:
  2e-3, JAX's own (the loop promotes x against the bf16 experts to fp32,
  the MoE casts x to bf16 first);
* the engine: token-exact against JAX's ``Engine`` on the same traffic
  (fp32, where no top-2 near-tie flips between packages).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import repro.serving_engine as jse  # noqa: E402
import repro_torch.serving_engine as tse  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduce_for_smoke as jreduce  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models.context import Ctx  # noqa: E402
from repro.models.transformer import init_model as jinit_model  # noqa: E402
from repro.nn.params import unbox  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config, reduce_for_smoke  # noqa: E402
from repro_torch.models import moe  # noqa: E402

torch.set_num_threads(1)
ARCH = "granite-moe-3b-a800m"
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
#: the MoE width of tests/test_models.py's MoE tests
SMALL = dict(n_experts=4, top_k=2, d_model=32, d_ff=16)


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _rel(got, want) -> float:
    got, want = _f32(got), _f32(want)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-30)


def _cfgs(dtype="float32", **kw):
    kw = dict(SMALL, dtype=dtype, param_dtype=dtype, **kw)
    return jreduce(jget_config(ARCH), **kw), \
        reduce_for_smoke(get_config(ARCH), **kw)


def _moe(jcfg, cfg, seed=0, edit=None):
    """(JAX params as numpy, the port's MoE holding them). ``edit`` maps
    the numpy leaves before both packages take them."""
    p = jax.tree.map(np.asarray, unbox(jmoe.moe_init(
        jax.random.PRNGKey(seed), jcfg))[0])
    if edit is not None:
        p = edit(p)
    m = moe.MoE(cfg, device="meta")
    want = dict(m.state_dict())
    for k, v in p.items():
        bridge._check_leaf(k, v, want[k])
    m.load_state_dict({k: bridge._tensor(v, "cpu") for k, v in p.items()},
                      assign=True)
    return p, m


def _x(shape, dtype="float32", seed=1):
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return torch.from_numpy(a).to(getattr(torch, dtype)), \
        jnp.asarray(a).astype(jnp.dtype(dtype))


def _hold(jcfg, cfg, shape, dtype, seed=0):
    p, m = _moe(jcfg, cfg, seed)
    x, jx = _x(shape, dtype)
    want, jaux = jmoe.moe_apply(p, jcfg, Ctx(), jx)
    with torch.no_grad():
        got, aux = moe.moe_apply(m, cfg, x)
    assert got.dtype == x.dtype and got.shape == x.shape
    assert _rel(got, want) <= TOL[dtype]
    assert abs(float(aux) - float(jaux)) <= 1e-5 * abs(float(jaux))
    return got


# ------------------------------------------------------------- the paths
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", ["capacity", "ragged"])
def test_moe_matches_jax(impl, dtype):
    """Both dispatches against JAX's ``moe_apply`` (the capacity path at
    the configs' cf 1.25, where a (2, 24) batch drops assignments)."""
    jcfg, cfg = _cfgs(dtype, moe_impl=impl)
    _hold(jcfg, cfg, (2, 24, 32), dtype)


def test_moe_matches_dense_expert_sum():
    """Mirrors tests/test_models.py::test_moe_matches_dense_expert_sum: the
    ragged path equals an explicit per-token loop over the chosen experts
    (bf16 experts, fp32 x), and routes as JAX does."""
    jcfg, cfg = _cfgs("float32", moe_impl="ragged")
    cfg = dataclasses.replace(cfg, param_dtype="bfloat16")
    jcfg = dataclasses.replace(jcfg, param_dtype="bfloat16")
    p, m = _moe(jcfg, cfg)
    x, jx = _x((1, 8, 32))
    with torch.no_grad():
        got, aux = moe.moe_apply(m, cfg, x)
        x2d = x.reshape(-1, 32)
        probs = torch.softmax(x2d @ m.router, -1)
        w, ids = torch.topk(probs, 2)
        w = w / w.sum(-1, keepdim=True)
        want = torch.zeros_like(x2d)
        for t in range(x2d.shape[0]):
            for j in range(2):
                e = int(ids[t, j])
                gate, up, down = (m.w_gate[e].float(), m.w_up[e].float(),
                                  m.w_down[e].float())
                h = torch.nn.functional.silu(x2d[t] @ gate) * (x2d[t] @ up)
                want[t] += w[t, j] * (h @ down)
    np.testing.assert_allclose(got.reshape(-1, 32).numpy(), want.numpy(),
                               rtol=2e-3, atol=2e-3)
    assert float(aux) > 0.0
    _, jids, _ = jmoe._route(jx.reshape(-1, 32), p["router"], 2)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))


def test_moe_capacity_matches_ragged_when_unsaturated():
    """Mirrors tests/test_models.py::test_moe_capacity_matches_ragged_when_
    unsaturated: at cf 8.0 (cap 16 ≥ 16 tokens) nothing drops and the
    capacity path equals the dropless one, in the port as in JAX."""
    jcfg, cfg = _cfgs("float32", moe_impl="ragged")
    p, m = _moe(jcfg, cfg)
    x, _ = _x((2, 8, 32))
    cap = dataclasses.replace(cfg, moe_impl="capacity",
                              moe_capacity_factor=8.0)
    assert moe.capacity(16, 2, 8.0, 4) >= 16
    with torch.no_grad():
        want, _ = moe.moe_apply(m, cfg, x)
        got, _ = moe.moe_apply(m, cap, x)
    assert _rel(got, want) <= TOL["float32"]


def _kept(ids: np.ndarray, cap: int, e: int) -> np.ndarray:
    """(T, k) bool: the assignments that find a slot, taking the flat
    (token, k) order, each expert's first ``cap`` of them."""
    seen = np.zeros(e, np.int64)
    keep = np.zeros(ids.size, bool)
    for i, ex in enumerate(ids.reshape(-1)):
        keep[i] = seen[ex] < cap
        seen[ex] += 1
    return keep.reshape(ids.shape)


def test_moe_capacity_drops_overflow_tokens():
    """Mirrors tests/test_models.py::test_moe_capacity_drops_overflow_
    tokens at cf 0.3 (cap 10 for 64 tokens × 2 over 4 experts), held to
    JAX's output, not only for finiteness: the same assignments kept (by
    the routing JAX takes), the same output within 1e-5, a token whose
    assignments all drop exactly 0 in both, and the output away from the
    dropless one."""
    jcfg, cfg = _cfgs("float32", moe_impl="capacity",
                      moe_capacity_factor=0.3)
    cap = moe.capacity(64, 2, 0.3, 4)
    assert cap == 10
    got = _hold(jcfg, cfg, (2, 32, 32), "float32")
    p, m = _moe(jcfg, cfg)
    x, jx = _x((2, 32, 32))
    want, _ = jmoe.moe_apply(p, jcfg, Ctx(), jx)
    _, ids, _ = moe.route(x.reshape(-1, 32), m.router, 2)
    _, jids, _ = jmoe._route(jx.reshape(-1, 32), p["router"], 2)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    keep = _kept(ids.numpy(), cap, 4)
    assert 0 < keep.sum() < keep.size
    np.testing.assert_array_equal(
        (moe.slot_positions(ids.reshape(-1), 4) < cap).view(ids.shape)
        .numpy(), keep)
    dropped = ~keep.any(1)
    assert dropped.any()
    got2d, want2d = got.reshape(-1, 32).numpy(), _f32(want).reshape(-1, 32)
    assert np.all(got2d[dropped] == 0) and np.all(want2d[dropped] == 0)
    assert np.all(np.isfinite(got2d))
    with torch.no_grad():
        dropless, _ = moe.moe_apply(
            m, dataclasses.replace(cfg, moe_impl="ragged"), x)
    assert _rel(got, dropless) > 0.1


def test_small_steps_never_drop():
    """An expert takes at most one slot a token and cap ≥ 4: a step of at
    most 4 tokens keeps every assignment whatever cf is; cf = E / k gives
    cap ≥ T."""
    for t in range(1, 5):
        for cf in (0.01, 0.3, 1.25):
            assert moe.capacity(t, 8, cf, 40) >= t
    for t in (5, 64, 4096, 4480):
        assert moe.capacity(t, 8, 40 / 8, 40) >= t
    assert moe.capacity(4096, 8, 1.25, 40) == 1024


# ------------------------------------------------------------------ ties
def test_top_k_ties_take_the_lower_index():
    probs = torch.tensor([[0.25, 0.25, 0.25, 0.25],
                          [0.1, 0.3, 0.3, 0.3],
                          [0.4, 0.1, 0.4, 0.1]])
    vals, ids = moe.top_k(probs, 2)
    assert ids.tolist() == [[0, 1], [1, 2], [0, 2]]
    jv, jids = jax.lax.top_k(jnp.asarray(probs.numpy()), 2)
    assert ids.tolist() == np.asarray(jids).tolist()
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))


@pytest.mark.parametrize("impl", ["capacity", "ragged"])
def test_exact_router_ties_route_as_jax(impl):
    """A router of 4 experts whose columns come in duplicated pairs, with x
    and the router on a grid where every logit is exact, and top-3: every
    token's third pick ties exactly with the fourth expert (the k-th/(k+1)-th
    boundary), and the port picks JAX's experts (the lower index of the
    pair) and gives its output."""
    jcfg, cfg = _cfgs("float32", moe_impl=impl, top_k=3)
    rng = np.random.default_rng(5)

    def dup(p):
        r = rng.integers(-4, 5, (32, 2)).astype(np.float32) / 8
        return dict(p, router=np.repeat(r, 2, axis=1))
    p, m = _moe(jcfg, cfg, edit=dup)
    a = rng.integers(-2, 3, (2, 16, 32)).astype(np.float32) / 2
    x, jx = torch.from_numpy(a), jnp.asarray(a)
    with torch.no_grad():
        _, ids, _ = moe.route(x.reshape(-1, 32), m.router, 3)
        logits = (x.reshape(-1, 32) @ m.router).numpy()
    _, jids, _ = jmoe._route(jx.reshape(-1, 32), p["router"], 3)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    assert np.array_equal(logits[:, 0::2], logits[:, 1::2])
    assert np.all(ids.numpy()[:, 2] % 2 == 0)      # a pair's lower index
    want, _ = jmoe.moe_apply(p, jcfg, Ctx(), jx)
    with torch.no_grad():
        got, _ = moe.moe_apply(m, cfg, x)
    assert _rel(got, want) <= TOL["float32"]


# ------------------------------------------------------------ aux, chunks
def test_aux_loss_matches_jax_and_the_formula():
    """E · Σ_e mean_t(p_e) · f_e, f_e the share of the T·k assignments."""
    jcfg, cfg = _cfgs("float32")
    p, m = _moe(jcfg, cfg)
    x, jx = _x((3, 10, 32), seed=7)
    _, _, jaux = jmoe._route(jx.reshape(-1, 32), p["router"], 2)
    with torch.no_grad():
        _, _, aux = moe.route(x.reshape(-1, 32), m.router, 2)
        probs = torch.softmax(x.reshape(-1, 32) @ m.router, -1)
        ids = torch.topk(probs, 2).indices.reshape(-1)
        f = torch.bincount(ids, minlength=4).float() / ids.numel()
        want = 4 * float((probs.mean(0) * f).sum())
    assert abs(float(aux) - float(jaux)) <= 1e-6 * float(jaux)
    assert abs(float(aux) - want) <= 1e-6 * want


def test_two_chunk_input_matches_jax():
    """t = 16,384 tokens: two 8192-token chunks, each with its own
    capacity (cap 5,120); the forward against JAX's scan and the
    gradients through ``torch.utils.checkpoint`` against ``jax.grad``."""
    jcfg, cfg = _cfgs("float32")
    p, m = _moe(jcfg, cfg)
    x, jx = _x((2, 8192, 32), seed=2)
    cot = np.random.default_rng(3).standard_normal((2, 8192, 32)).astype(
        np.float32)
    want, _ = jmoe.moe_apply(p, jcfg, Ctx(), jx)
    x.requires_grad_()
    got, _ = moe.moe_apply(m, cfg, x)
    assert _rel(got, want) <= TOL["float32"]
    with torch.no_grad():
        halves = torch.cat([moe.moe_apply(m, cfg, x[i:i + 1])[0]
                            for i in range(2)], 1)
    assert torch.equal(got.detach().reshape(1, -1, 32), halves)
    (got * torch.from_numpy(cot)).sum().backward()
    jgx = jax.grad(lambda x: jnp.sum(jmoe.moe_apply(
        p, jcfg, Ctx(), x)[0] * cot))(jx)
    assert _rel(x.grad, jgx) <= TOL["float32"]


@pytest.mark.parametrize("impl", ["capacity", "ragged"])
def test_grads_match_jax(impl):
    """d(Σ out · cot + aux) by autograd against ``jax.grad`` for x and
    every leaf (fp32; the capacity path drops at cf 1.25)."""
    jcfg, cfg = _cfgs("float32", moe_impl=impl)
    p, m = _moe(jcfg, cfg)
    x, jx = _x((2, 24, 32), seed=4)
    cot = np.random.default_rng(6).standard_normal((2, 24, 32)).astype(
        np.float32)

    def jloss(p, x):
        out, aux = jmoe.moe_apply(p, jcfg, Ctx(), x)
        return jnp.sum(out * cot) + aux
    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(
        jax.tree.map(jnp.asarray, p), jx)
    x.requires_grad_()
    out, aux = moe.moe_apply(m, cfg, x)
    ((out * torch.from_numpy(cot)).sum() + aux).backward()
    assert _rel(x.grad, jgx) <= TOL["float32"]
    for k, w in m.named_parameters():
        assert _rel(w.grad, jgp[k]) <= TOL["float32"], k


# ------------------------------------------------------- the engine drops
def test_engine_drops_and_matches_jax_engine(monkeypatch):
    """The granite smoke model (fp32) through Engines of 8 slots, the
    port's ``Scheduler`` against JAX's on the same 10 requests: a step of 8
    rows has cap 5 for 16 assignments over 4 experts, so steps drop
    assignments (counted here), parked rows taking capacity as in JAX;
    the tokens are JAX's, token for token."""
    jcfg = jreduce(jget_config(ARCH), dtype="float32", param_dtype="float32")
    cfg = reduce_for_smoke(get_config(ARCH), dtype="float32",
                           param_dtype="float32")
    tree = jax.tree.map(np.asarray, unbox(jinit_model(
        jax.random.PRNGKey(0), jcfg))[0])
    model = bridge.params_from_jax(tree, cfg, device="cpu")
    drops = []
    route = moe.route

    def counting(x2d, router, k):
        w, ids, aux = route(x2d, router, k)
        keep = _kept(ids.numpy(), moe.capacity(x2d.shape[0], k, 1.25, 4), 4)
        drops.append(int((~keep).sum()))
        return w, ids, aux
    monkeypatch.setattr(moe, "route", counting)
    rng = np.random.default_rng(3)
    plens = [3, 9, 5, 2, 7, 4, 11, 6, 3, 8]
    gens = [9, 6, 12, 8, 5, 10, 7, 9, 11, 6]
    prompts = [rng.integers(0, cfg.vocab, (n,)).astype(np.int32)
               for n in plens]
    sched = tse.Scheduler(tse.Engine(cfg, model, slots=8, max_len=24))
    jsched = jse.Scheduler(jse.Engine(jcfg, tree, slots=8, max_len=24))
    for i, (pr, g) in enumerate(zip(prompts, gens)):
        sched.submit(tse.Request(uid=f"r{i}", prompt=pr, max_new=g))
        jsched.submit(jse.Request(uid=f"r{i}", prompt=pr, max_new=g))
    got, _ = sched.run()
    want, _ = jsched.run()
    assert sum(drops) > 0, drops
    for i in range(len(prompts)):
        assert list(got[f"r{i}"]) == list(map(int, want[f"r{i}"])), i
