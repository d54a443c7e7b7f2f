"""Port parity for the FD TNN LM (repro_torch.models.transformer) against
the JAX package: the same JAX-initialised parameters, carried over by
repro_torch.bridge, must give the same forward logits; plus the bridge's
refusal of a tree that does not match.

Tolerance: logits at rtol = atol = 1e-4. The fp32 FFT summation order
differs between torch and XLA and compounds over the layers and the
512-wide unembed, so the kernels' 1e-5 tier is loosened tenfold here.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduce_for_smoke as jreduce  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models.context import Ctx  # noqa: E402
from repro.models.transformer import forward as jforward  # noqa: E402
from repro.models.transformer import init_model as jinit_model  # noqa: E402
from repro.nn.params import unbox  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config, reduce_for_smoke  # noqa: E402
from repro_torch.models.transformer import (  # noqa: E402
    Model, forward, init_model)

torch.set_num_threads(1)
ARCH = "fd-tnn-lm-wt103"


def _setup(arch):
    jcfg = jreduce(jget_config(arch))
    cfg = reduce_for_smoke(get_config(arch))
    init = jax.jit(lambda k: unbox(jinit_model(k, jcfg))[0])
    tree = jax.tree.map(np.asarray, init(jax.random.PRNGKey(0)))
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (2, 19))
    return jcfg, cfg, tree, toks


@pytest.fixture(scope="module")
def setup():
    return _setup(ARCH)


@pytest.fixture(scope="module")
def ski_setup():
    return _setup("ski-tnn-lm-wt103")


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("name", ["fd-tnn-lm-wt103", "tnn-lm-wt103",
                                  "ski-tnn-lm-wt103"])
def test_configs_are_copies(name, smoke):
    """The port's own config copy matches the JAX registry field for field."""
    j, p = jget_config(name), get_config(name)
    if smoke:
        j, p = jreduce(j), reduce_for_smoke(p)
    assert vars(j) == vars(p)
    assert j.layers_spec == p.layers_spec
    assert j.vocab_padded == p.vocab_padded
    assert j.n_scan_blocks == p.n_scan_blocks


@pytest.mark.parametrize("use_pallas", [None, True],
                         ids=["jax-default", "jax-pallas-interpret"])
def test_forward_matches_jax(setup, use_pallas):
    jcfg, cfg, tree, toks = setup
    model = bridge.params_from_jax(tree, cfg, device="cpu")
    jops.set_default_backend(use_pallas)
    try:
        want, _ = jforward(tree, jcfg, Ctx(), {"tokens": toks})
    finally:
        jops.set_default_backend(None)
    with torch.no_grad():
        got = forward(model, cfg, torch.from_numpy(toks))
    assert got.shape == (2, 19, cfg.vocab_padded)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-4)


def test_init_model_matches_jax_layout(setup, ski_setup):
    """The port's own init builds every parameter of the JAX tree, with the
    same shapes, and the same init scale (lecun fan-in, or N(0, 0.02²) for
    the SKI leaves) per leaf: for the FD and the SKI model."""
    for _, cfg, tree, _ in (setup, ski_setup):
        model = init_model(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
        want = bridge._port_leaves(tree, cfg)
        got = model.state_dict()
        assert set(got) == set(want)
        for name, arr in want.items():
            assert tuple(got[name].shape) == arr.shape, name
            if arr.size > 1000:               # std within 20% of JAX's
                assert abs(float(got[name].std()) / float(arr.std())
                           - 1) < 0.2, name


def test_bridge_refuses_missing_and_extra_leaves(setup):
    _, cfg, tree, _ = setup
    missing = dict(tree)
    del missing["norm_f"]
    with pytest.raises(ValueError, match=r"unset port parameters \['norm_f"):
        bridge.params_from_jax(missing, cfg, device="cpu")
    extra = dict(tree, stray={"w": np.zeros(3, np.float32)})
    with pytest.raises(ValueError, match=r"unconsumed JAX leaves \['stray.w"):
        bridge.params_from_jax(extra, cfg, device="cpu")
    bad = dict(tree, unembed=np.zeros((3, 3), np.float32))
    with pytest.raises(ValueError, match="unembed"):
        bridge.params_from_jax(bad, cfg, device="cpu")


def test_unported_mixers_raise():
    """The encoder-decoder and prefix-VLM kinds build (whisper: an
    encoder and a cross sublayer in every decoder layer; paligemma: plain
    decoder layers; both held against JAX in test_torch_encdec.py and
    test_torch_prefix_vlm.py); Mamba layers with a dense or an MoE FFN build (the jamba hybrid, whose
    forward, decode and engine are held against JAX in
    test_torch_jamba.py), as do attention layers with either FFN (held
    against JAX in test_torch_zoo.py and test_torch_moe.py), and the
    baseline TNO and SKI models, the baseline's mixer holding the RPE MLP
    alone (their forwards are held against JAX in
    test_torch_tno_baseline.py and test_torch_ski.py)."""
    import dataclasses
    base = reduce_for_smoke(get_config("tnn-lm-wt103"))
    moe = dataclasses.replace(base, pattern=(("attention", "moe"),),
                              n_heads=4, n_kv_heads=2, head_dim=32,
                              n_experts=4, top_k=2)
    assert all(type(layer.ffn).__name__ == "MoE"
               for layer in Model(moe, device="meta").layers)
    for ffn, kind in (("moe", "MoE"), ("dense", "FFN")):
        hybrid = dataclasses.replace(moe, pattern=(("mamba", ffn),),
                                     ssm_state=16)
        assert all((type(layer.mixer).__name__, type(layer.ffn).__name__)
                   == ("Mamba", kind)
                   for layer in Model(hybrid, device="meta").layers)
    jamba = Model(reduce_for_smoke(get_config("jamba-1.5-large-398b")),
                  device="meta")
    assert [type(layer.mixer).__name__ for layer in jamba.layers[:8]] == \
        ["Mamba"] * 4 + ["Attention"] + ["Mamba"] * 3
    whisper = Model(reduce_for_smoke(get_config("whisper-medium")),
                    device="meta")
    assert len(whisper.enc_layers) == 2 and all(
        type(layer.cross).__name__ == "Attention"
        and not hasattr(enc, "cross")
        for layer, enc in zip(whisper.layers, whisper.enc_layers))
    paligemma = Model(reduce_for_smoke(get_config("paligemma-3b")),
                      device="meta")
    assert not hasattr(paligemma, "enc_layers") and not any(
        hasattr(layer, "cross") for layer in paligemma.layers)
    attn = dataclasses.replace(base, pattern=(("attention", "dense"),),
                               n_heads=4, n_kv_heads=2, head_dim=32)
    model = Model(attn, device="meta")
    assert all(type(layer.mixer).__name__ == "Attention"
               for layer in model.layers)
    for arch, kind in (("tnn-lm-wt103", "BaselineParams"),
                       ("ski-tnn-lm-wt103", "SKIParams")):
        model = Model(reduce_for_smoke(get_config(arch)), device="meta")
        assert all(type(layer.mixer.tno).__name__ == kind
                   for layer in model.layers), arch
        if kind == "BaselineParams":
            assert {name for name, _ in
                    model.layers[0].mixer.tno.named_children()} == {"rpe"}
