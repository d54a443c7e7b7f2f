"""The port's distribution layer (repro_torch: nn/params, parallel/sharding,
launch/mesh, models/context, launch/steps.StepBuilder) against the JAX
package's, in this process: no spawned ranks.

* every parameter's logical axes (``nn.params.param_axes``) equal JAX's
  ``unbox(init_model(...))[1]`` leaf for leaf, for every arch (smoke
  size; the scanned ``"layers"`` axis dropped, as the port has no scan);
* every leaf's spec (``spec_for`` through ``tree_shardings`` and
  ``StepBuilder.param_shardings``) equals JAX's ``spec_for`` at full width
  on meshes (16, 16), (2, 16, 16), (2, 2) and (1, 4). Both read only the
  mesh's axis extents, so a stand-in mesh (``_Mesh``) serves at sizes no
  host has; the table asserts that the TNN leaves it must shard are
  sharded, so a size at which nothing divides cannot pass it;
* ``rules_for_arch``, ``input_specs`` (shapes and dtypes of every
  applicable arch × ``SHAPES`` cell, the decode caches in JAX's layout),
  ``cell_is_applicable`` and ``serve_ctx`` equal JAX's;
* the refusals: a mesh of the wrong size, and the archs whose sharded
  paths are slice 16b on a mesh of extent > 1;
* on a one-rank gloo (1, 1) mesh, three ``StepBuilder`` train steps of the
  smoke SKI and FD models equal the mesh-free ``make_train_step``'s bit
  for bit (losses, grad norms, every parameter and moment): an axis of
  extent 1 moves nothing, and ``models/context.shard`` and
  ``nn/params.gathered`` add no autograd node there, so every sum runs in
  the mesh-free order.

Exact comparisons throughout: no arithmetic differs.
"""
import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import torch.distributed as dist  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduce_for_smoke as jreduce  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.nn.params import tree_param_count as jcount  # noqa: E402
from repro.nn.params import tree_size_bytes as jbytes  # noqa: E402
from repro.parallel import sharding as jsharding  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config, list_archs  # noqa: E402
from repro_torch.configs import reduce_for_smoke  # noqa: E402
from repro_torch.data.pipeline import DataConfig, batch_at  # noqa: E402
from repro_torch.launch import mesh as mesh_mod  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models.context import Ctx, shard  # noqa: E402
from repro_torch.models.transformer import Model  # noqa: E402
from repro_torch.models.transformer import sharded_path_missing  # noqa: E402
from repro_torch.nn import params as nparams  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.parallel import sharding  # noqa: E402
from repro_torch.runtime.trainer import put_batch  # noqa: E402

torch.set_num_threads(1)
ARCHS = list_archs()
TNN = ["fd-tnn-lm-wt103", "ski-tnn-lm-wt103", "tnn-lm-wt103"]
MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16},
          "2x2": {"data": 2, "model": 2},
          "1x4": {"data": 1, "model": 4}}


class _Mesh:
    """A mesh of named axis extents and no devices: what both packages'
    spec functions read."""

    def __init__(self, shape):
        self.shape = dict(shape)
        self.mesh_dim_names = tuple(shape)


def _is_axes(x):
    return isinstance(x, tuple) and all(a is None or isinstance(a, str)
                                        for a in x)


def _flat(tree, prefix=""):
    if _is_axes(tree) or not isinstance(tree, (dict, list, tuple)):
        yield prefix[:-1], tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{prefix}{k}.")
    else:
        for i, v in enumerate(tree):
            yield from _flat(v, f"{prefix}{i}.")


def _port_names(cfg, name):
    """A JAX leaf path → [(port name, leading scanned axis?)]."""
    head, _, rest = name.partition(".")
    if head == "blocks":
        sub, _, rest = rest.partition(".")
        k = int(sub.removeprefix("sub"))
        return [(f"layers.{b * cfg.period + k}.{rest}", True)
                for b in range(cfg.n_scan_blocks)]
    if head == "enc_blocks":
        return [(f"enc_layers.{i}.{rest}", True)
                for i in range(cfg.enc_layers)]
    if head.startswith("tail"):
        i = cfg.n_scan_blocks * cfg.period + int(head.removeprefix("tail"))
        return [(f"layers.{i}.{rest}", False)]
    return [(name, False)]


@functools.lru_cache(maxsize=None)
def _jax_abstract(arch, smoke):
    """JAX's (name → (axes, shape)) under the port's names, the scanned
    ``"layers"`` dim dropped."""
    jcfg = jget_config(arch)
    if smoke:
        jcfg = jreduce(jcfg)
    vals, axes = jsteps.StepBuilder(jcfg, None).abstract_params()
    shapes = {k: v.shape for k, v in _flat(vals)}
    out = {}
    for name, ax in _flat(axes):
        shape = tuple(shapes[name])
        for port, scanned in _port_names(jcfg, name):
            if scanned:
                assert ax[0] == "layers"
            out[port] = ((ax[1:], shape[1:]) if scanned else (ax, shape))
    return out


# ------------------------------------------------------------- param axes
@pytest.mark.parametrize("arch", ARCHS)
def test_param_axes_match_jax(arch):
    model = Model(reduce_for_smoke(get_config(arch)), device="meta")
    want = {k: v[0] for k, v in _jax_abstract(arch, True).items()}
    assert nparams.param_axes(model) == want


@pytest.mark.parametrize("arch", TNN)
def test_tree_size_and_count_match_jax(arch):
    jcfg = jreduce(jget_config(arch))
    vals, _ = jsteps.StepBuilder(jcfg, None).abstract_params()
    model = Model(reduce_for_smoke(get_config(arch)), device="meta")
    assert nparams.tree_param_count(model) == jcount(vals)
    assert nparams.tree_size_bytes(model) == jbytes(vals)
    assert nparams.tree_size_bytes(dict(model.named_parameters())) \
        == jbytes(vals)


# ---------------------------------------------------------------- specs
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_specs_match_jax(arch, mesh):
    """Every leaf's spec at full width equals JAX's ``spec_for``; for the
    TNN archs through ``StepBuilder.param_shardings`` too, and the leaves
    that must shard on each axis do."""
    m = _Mesh(MESHES[mesh])
    cfg = get_config(arch)
    jrules = jsharding.rules_for_arch(jget_config(arch), m)
    want = {k: tuple(jsharding.spec_for(m, jrules, ax, shape))
            for k, (ax, shape) in _jax_abstract(arch, False).items()}
    vals, axes = steps.StepBuilder(cfg, None).abstract_params()
    rules = sharding.rules_for_arch(cfg, m)
    got = {k: sh.spec for k, sh in
           sharding.tree_shardings(m, rules, axes, vals).items()}
    assert got == want
    if arch in TNN:
        got = {k: sh.spec for k, sh in
               steps.StepBuilder(cfg, m).param_shardings().items()}
        assert got == want
        data = rules.resolve("embed")
        for leaf in ("layers.0.mixer.wu.w", "layers.0.ffn.w_gate",
                     "unembed"):
            assert got[leaf][0] == data, leaf
        assert got["layers.0.mixer.wo.w"] == ("model", data)
        assert got["unembed"][1] == "model"
        assert got["embed"] == (None, "model")
        tno = [k for k in got if ".tno." in k and k.startswith("layers.0.")
               and "rpe.layers.0" not in k and "rpe.layers.1" not in k]
        assert tno and all("model" in got[k] for k in tno), tno


@pytest.mark.parametrize("mesh", list(MESHES) + ["1x1", "2x8"])
@pytest.mark.parametrize("arch", ["qwen2-72b", "gemma3-4b", "stablelm-3b",
                                  "whisper-medium", "fd-tnn-lm-wt103"])
def test_rules_for_arch_match_jax(arch, mesh):
    """The kv projections replicate where kv heads < the model extent."""
    shape = MESHES.get(mesh) or dict(zip(("data", "model"),
                                         map(int, mesh.split("x"))))
    m = _Mesh(shape)
    want = jsharding.rules_for_arch(jget_config(arch), m)
    got = sharding.rules_for_arch(get_config(arch), m)
    assert (got.data_axes, got.model_axis, got.overrides) \
        == (want.data_axes, want.model_axis, want.overrides)
    for name in list(jsharding.DEFAULT_RULES) + ["no-such-name"]:
        assert got.resolve(name) == want.resolve(name), name


def test_spec_for_guards_match_jax():
    """The divisibility guard and no axis reuse, on JAX's own cases."""
    rules = sharding.ShardingRules(data_axes=("data",))
    jr = jsharding.ShardingRules(data_axes=("data",))
    for shape in ({"data": 1, "model": 1}, {"data": 4, "model": 8}):
        m = _Mesh(shape)
        for axes, dims in [(("embed", "heads"), (64, 64)),
                           (("heads", "ffn"), (16, 16)),
                           (("embed", "vocab"), (6, 12)),
                           (("embed", "embed"), (8, 8))]:
            assert sharding.spec_for(m, rules, axes, dims) \
                == tuple(jsharding.spec_for(m, jr, axes, dims))


# ---------------------------------------------------------- input specs
def _cells():
    return [(a, s) for a in ARCHS for s in jsteps.SHAPES
            if jsteps.cell_is_applicable(a, s)]


def test_cell_applicability_matches_jax():
    assert steps.SHAPES == {k: steps.ShapeSpec(**dataclasses.asdict(v))
                            for k, v in jsteps.SHAPES.items()}
    assert {a for a in ARCHS if steps.full_attention_only(get_config(a))} \
        == jsteps.FULL_ATTENTION_ONLY
    for a in ARCHS:
        for s in jsteps.SHAPES:
            assert steps.cell_is_applicable(a, s) \
                == jsteps.cell_is_applicable(a, s), (a, s)
    assert len(_cells()) == 45


def _dtype(t):
    return str(t.dtype).removeprefix("torch.")


@pytest.mark.parametrize("arch,shape", _cells())
def test_input_specs_match_jax(arch, shape):
    """Shapes and dtypes of every input (and decode cache leaf, in JAX's
    layout) on ``meta``; SKI decode raises in both packages."""
    jsb = jsteps.StepBuilder(jget_config(arch), None)
    sb = steps.StepBuilder(get_config(arch), None)
    spec = steps.SHAPES[shape]
    if arch == "ski-tnn-lm-wt103" and spec.kind == "decode":
        with pytest.raises(NotImplementedError):
            jsb.input_specs(jsteps.SHAPES[shape])
        with pytest.raises(NotImplementedError):
            sb.input_specs(spec)
        return
    want = jsb.input_specs(jsteps.SHAPES[shape])
    got = sb.input_specs(spec)
    if spec.kind == "decode":
        cache = got.pop("cache")
        assert all(t.device.type == "meta" for lc in cache
                   for t in lc.values())
        flat = {f"layers.{i}.{k}": v for i, lc in enumerate(cache)
                for k, v in lc.items()}
        got["cache"] = bridge._jax_tree(flat, get_config(arch))
    got = {k: (tuple(v.shape), _dtype(v)) for k, v in _flat(got)}
    want = {k: (tuple(v.shape), str(v.dtype)) for k, v in _flat(want)}
    assert got == want


# ------------------------------------------------------------ serve_ctx
def _ctx_fields(ctx):
    return (tuple(ctx.data_axes), ctx.model_axis, ctx.decode,
            ctx.seq_shard_resid, tuple(ctx.seq_kv_axes))


def _ctx_cases():
    """The TNN archs on every mesh; every arch without one and on the
    one-rank mesh (the others refuse meshes of extent > 1)."""
    return ([(a, m) for a in TNN for m in MESHES]
            + [(a, m) for a in ARCHS for m in (None, "1x1")])


@pytest.mark.parametrize("arch,mesh", _ctx_cases())
def test_serve_ctx_matches_jax(arch, mesh):
    """Decode contexts of every shape (batch-1 long context folds the data
    axes into the KV-sequence sharding) and the training context."""
    m = (_Mesh(MESHES.get(mesh, {"data": 1, "model": 1})) if mesh
         else None)
    jsb = jsteps.StepBuilder(jget_config(arch), m)
    sb = steps.StepBuilder(get_config(arch), m)
    assert _ctx_fields(sb.ctx) == _ctx_fields(jsb.ctx)
    assert sb.ctx.rules() == jsb.ctx.rules()
    for s in [None] + list(jsteps.SHAPES):
        assert _ctx_fields(sb.serve_ctx(s and steps.SHAPES[s])) \
            == _ctx_fields(jsb.serve_ctx(s and jsteps.SHAPES[s])), s
    if m is not None:
        # JAX's P(data_axes, None) (its NamedSharding needs real devices)
        assert sb.batch_sharding().spec == (jsb.rules.data_axes, None)
        st = sb.state_shardings()
        assert st["opt"].mu == st["params"] == st["opt"].nu
        assert st["opt"].step.spec == () and st["opt"].err["embed"].spec == ()


# ------------------------------------------------------------- refusals
@pytest.mark.parametrize("arch", [a for a in ARCHS if a not in TNN])
def test_unsharded_archs_refused_on_a_mesh(arch):
    """Attention, MoE, Mamba, hybrid, encdec and prefix-VLM archs raise by
    name on a mesh of extent > 1 (slice 16b), never replicate quietly;
    a one-rank mesh takes them."""
    cfg = get_config(arch)
    assert sharded_path_missing(cfg)
    with pytest.raises(NotImplementedError, match=cfg.name):
        steps.StepBuilder(cfg, _Mesh({"data": 2, "model": 2}))
    with pytest.raises(NotImplementedError, match="16b"):
        steps.StepBuilder(cfg, _Mesh({"data": 4, "model": 1}))
    assert not steps.StepBuilder(cfg, _Mesh({"data": 1, "model": 1})).sharded


def test_shard_is_identity_without_a_mesh():
    x = torch.randn(2, 3, 4)
    assert shard(None, x, "batch", "seq", "embed") is x
    assert shard(Ctx(), x, "batch", "seq", "embed") is x
    assert nparams.gathered(x) is x


# ---------------------------------------------------- one-rank gloo mesh
@pytest.fixture(scope="module")
def group(tmp_path_factory):
    path = tmp_path_factory.mktemp("pg") / "store"
    dist.init_process_group("gloo", init_method=f"file://{path}", rank=0,
                            world_size=1)
    yield
    dist.destroy_process_group()


def test_meshes_refuse_a_wrong_world_size(group):
    with pytest.raises(ValueError, match="256 ranks"):
        mesh_mod.make_production_mesh(device_type="cpu")
    with pytest.raises(ValueError, match="512 ranks"):
        mesh_mod.make_production_mesh(multi_pod=True, device_type="cpu")
    with pytest.raises(ValueError, match="4 ranks"):
        mesh_mod.make_mesh((2, 2), ("data", "model"), "cpu")
    m = mesh_mod.make_host_mesh("cpu")
    assert m.device_type == "cpu" and m.mesh_dim_names == ("data", "model")
    assert sharding.mesh_shape(m) == {"data": 1, "model": 1}
    assert mesh_mod.data_axes_of(m) == ("data",)
    assert mesh_mod.data_rank(m) == (0, 1)
    assert mesh_mod.init_distributed("cpu") is False   # already running


def _tensors(model, opt):
    out = {f"p.{k}": p for k, p in model.named_parameters()}
    out.update({f"mu.{k}": v for k, v in opt.mu.items()})
    out.update({f"nu.{k}": v for k, v in opt.nu.items()})
    return {k: v.full_tensor() if hasattr(v, "full_tensor") else v
            for k, v in out.items()}


@pytest.mark.parametrize("arch", ["ski-tnn-lm-wt103", "fd-tnn-lm-wt103"])
def test_one_rank_mesh_train_steps_bitwise(group, arch):
    """Three StepBuilder train steps on the (1, 1) gloo mesh equal the
    mesh-free ``make_train_step``'s bit for bit (see the module
    docstring), and the state really is DTensors."""
    cfg = reduce_for_smoke(get_config(arch))
    ocfg = adamw.OptConfig(lr=1e-2, warmup_steps=1, total_steps=3)
    mesh = mesh_mod.make_host_mesh("cpu")
    sb = steps.StepBuilder(cfg, mesh, opt_cfg=ocfg)
    assert sb.sharded and sb.ctx.seq_shard_resid
    model, opt = sb.init_state(torch.Generator().manual_seed(3),
                               device="cpu")
    assert all(hasattr(p, "placements") for p in model.parameters())
    assert hasattr(opt.mu["embed"], "placements")
    ref, ropt = steps.StepBuilder(cfg, None, opt_cfg=ocfg).init_state(
        torch.Generator().manual_seed(3), device="cpu")
    assert all(torch.equal(v, w) for v, w in zip(
        _tensors(model, opt).values(), _tensors(ref, ropt).values()))
    dc = DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=2, seed=5)
    step, rstep = sb.make_train_step(), steps.make_train_step(cfg, ocfg)
    put = put_batch(mesh)
    for i in range(3):
        hb = batch_at(dc, i)
        opt, m = step(model, opt, put(hb))
        ropt, rm = rstep(ref, ropt, {k: torch.from_numpy(v).long()
                                     for k, v in hb.items()})
        for k in ("loss", "nll", "grad_norm", "lr"):
            assert float(m[k]) == float(rm[k]), (i, k)
    assert int(opt.step) == int(ropt.step) == 3
    got, want = _tensors(model, opt), _tensors(ref, ropt)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_one_rank_mesh_keeps_unsharded_archs_plain(group):
    """An arch with no sharded path yet (slice 16b) on the one-rank gloo
    mesh keeps plain tensors and the mesh-free steps: nothing is wrapped
    only to be unwrapped again."""
    cfg = reduce_for_smoke(get_config("stablelm-3b"))
    sb = steps.StepBuilder(cfg, mesh_mod.make_host_mesh("cpu"))
    assert not sb.sharded
    model, opt = sb.init_state(torch.Generator().manual_seed(3),
                               device="cpu")
    assert not any(hasattr(p, "placements") for p in model.parameters())
    assert not hasattr(opt.mu["embed"], "placements")
    hb = batch_at(DataConfig(vocab=cfg.vocab, seq_len=8, global_batch=2,
                             seed=5), 0)
    tokens = torch.from_numpy(hb["tokens"]).long()
    ref = steps.make_forward(cfg)(model, tokens)
    assert torch.equal(sb.make_forward()(model, tokens), ref)
    opt, m = sb.make_train_step()(model, opt, {
        k: torch.from_numpy(v).long() for k, v in hb.items()})
    assert torch.isfinite(m["loss"]) and int(opt.step) == 1


def test_launch_train_needs_a_mesh_flag_on_several_ranks(monkeypatch):
    """Several torchrun ranks without ``--mesh``/``--production-mesh``
    would each train alone: the launcher refuses before any work."""
    from repro_torch.launch import train as train_launch
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(SystemExit):
        train_launch.main(["--arch", "fd-tnn-lm-wt103", "--smoke",
                           "--device", "cpu", "--steps", "1"])
