"""The port's overlap-save decode step at per-row positions
(repro_torch.kernels.fd_stream, the continuous-batching engine's ragged
decode) against itself at one int position and against the JAX
package's vector ``stream_step``.

Tolerances: the port's ragged rows equal the rows run alone (b = 1, int
positions) bit for bit, the contract of tests/test_engine.py:234; against
JAX 1e-6 × max, fp32 sums in another order (torch vs XLA FFTs and
reductions).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import fd_stream as jfd_stream  # noqa: E402
from repro.models import serving as jserving  # noqa: E402
from repro_torch.configs import get_config, reduce_for_smoke  # noqa: E402
from repro_torch.kernels import fd_stream  # noqa: E402
from repro_torch.models import serving  # noqa: E402
from repro_torch.models.transformer import init_model  # noqa: E402

torch.set_num_threads(1)
PER_ROW = ("ring", "tail", "uspec_re", "uspec_im")


def _inputs(b, d, n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((d, n)).astype(np.float32),
            rng.standard_normal((b, n, d)).astype(np.float32))


def _staggered(k, u, starts, c, step_fn):
    """Run every row from its start step (rows not yet started park at
    position 0 with zero input, the engine's convention); returns each
    row's outputs over its live steps and the positions fed."""
    b, n, d = u.shape
    cache = step_fn.init(k, b, n, c)
    got = [[] for _ in range(b)]
    for step in range(n):
        pos = np.array([max(step - s, 0) for s in starts], np.int64)
        live = [step >= s for s in starts]
        inp = np.stack([u[i, step - starts[i]] if live[i]
                        else np.zeros((d,), np.float32) for i in range(b)])
        y, cache = step_fn.step(cache, inp, pos)
        for i in range(b):
            if live[i]:
                got[i].append(y[i])
    return [np.stack(g) for g in got]


class _Port:
    init = staticmethod(lambda k, b, n, c: fd_stream.fd_stream_cache(
        torch.from_numpy(k), b, n, c))

    @staticmethod
    def step(cache, inp, pos):
        y, cache = fd_stream.stream_step(cache, torch.from_numpy(inp),
                                         torch.from_numpy(pos))
        return y.numpy(), cache


class _Jax:
    init = staticmethod(lambda k, b, n, c: jfd_stream.fd_stream_cache(
        jnp.asarray(k), b, n, c))

    @staticmethod
    def step(cache, inp, pos):
        y, cache = jfd_stream.stream_step(cache, jnp.asarray(inp),
                                          jnp.asarray(pos, jnp.int32))
        return np.asarray(y), cache


@pytest.mark.parametrize("starts", [[0, 2, 7], [5, 0, 3, 1]])
def test_stream_step_ragged_matches_lockstep_rows(starts):
    """Vector-position stream_step == each row run alone with int
    positions, bit for bit (staggered boundaries, parked rows at position
    0); the same inputs through JAX's vector stream_step within 1e-6 ×
    max."""
    b, d, n, c = len(starts), 5, 16, 4
    k, u = _inputs(b, d, n)
    refs = []
    for i in range(b):
        cache = fd_stream.fd_stream_cache(torch.from_numpy(k), 1, n, c)
        ys = []
        for t in range(n - starts[i]):
            y, cache = fd_stream.stream_step(
                cache, torch.from_numpy(u[i:i + 1, t]), t)
            ys.append(y[0].numpy())
        refs.append(np.stack(ys))
    got = _staggered(k, u, starts, c, _Port)
    want = _staggered(k, u, starts, c, _Jax)
    for i in range(b):
        np.testing.assert_array_equal(got[i], refs[i], err_msg=f"row {i}")
        scale = float(np.abs(want[i]).max())
        assert float(np.abs(got[i] - want[i]).max()) <= 1e-6 * scale, i


def test_int_position_is_the_vector_form_broadcast():
    """An int position and the same position in every row give the same
    bits, output and cache, across a block boundary."""
    b, d, n, c = 3, 6, 12, 4
    k, u = _inputs(b, d, n, seed=1)
    ca = cb = fd_stream.fd_stream_cache(torch.from_numpy(k), b, n, c)
    for t in range(n):
        x = torch.from_numpy(u[:, t])
        ya, ca = fd_stream.stream_step(ca, x, t)
        yb, cb = fd_stream.stream_step(cb, x, [t] * b)
        assert torch.equal(ya, yb), t
        for leaf in PER_ROW:
            assert torch.equal(ca[leaf], cb[leaf]), (t, leaf)


def test_refresh_touches_only_boundary_rows():
    """A step that completes one row's block leaves the other rows'
    tail and block spectra bit for bit, and writes no input tensor."""
    b, d, n, c = 3, 4, 16, 4
    k, u = _inputs(b, d, n, seed=2)
    cache = fd_stream.fd_stream_cache(torch.from_numpy(k), b, n, c)
    for t in range(5):                    # rows at 5, 6, 7 afterwards
        _, cache = fd_stream.stream_step(
            cache, torch.from_numpy(u[:, t]), [t, t + 1, t + 2])
    saved = {leaf: cache[leaf].clone() for leaf in PER_ROW}
    _, new = fd_stream.stream_step(cache, torch.from_numpy(u[:, 5]),
                                   [5, 6, 7])      # row 2 ends block 1
    for leaf in ("tail", "uspec_re", "uspec_im"):
        assert torch.equal(new[leaf][:2], cache[leaf][:2]), leaf
        assert not torch.equal(new[leaf][2], cache[leaf][2]), leaf
    for leaf in PER_ROW:
        assert torch.equal(cache[leaf], saved[leaf]), leaf


def test_tail_from_specs_per_row_matches_jax():
    rng = np.random.default_rng(3)
    b, nb, f, d = 4, 5, 5, 3
    usr, usi = (rng.standard_normal((b, nb, f, d)).astype(np.float32)
                for _ in range(2))
    ksr, ksi = (rng.standard_normal((nb, f, d)).astype(np.float32)
                for _ in range(2))
    j = np.array([0, 3, 1, 4])
    got = fd_stream._tail_from_specs(*map(torch.from_numpy,
                                          (usr, usi, ksr, ksi)),
                                     torch.from_numpy(j))
    want = np.asarray(jfd_stream._tail_from_specs(usr, usi, ksr, ksi,
                                                  jnp.asarray(j, jnp.int32)))
    assert float(np.abs(got.numpy() - want).max()) <= 1e-6 * float(
        np.abs(want).max())
    for i in range(b):                    # each row = its own int index
        alone = fd_stream._tail_from_specs(
            *map(torch.from_numpy, (usr[i:i + 1], usi[i:i + 1], ksr, ksi)),
            int(j[i]))
        assert torch.equal(got[i], alone[0]), i


def test_positions_and_capacity():
    k = torch.ones(3, 24)
    cache = fd_stream.fd_stream_cache(k, 1, 20, 8)
    assert fd_stream.stream_capacity(cache) == 20 == jfd_stream.stream_capacity(
        jfd_stream.fd_stream_cache(jnp.ones((3, 24)), 1, 20, 8))
    pos = fd_stream.positions([1, 2], 2, "cpu")
    assert pos.host.tolist() == [1, 2] and pos.dev.tolist() == [1, 2]
    assert fd_stream.positions(pos, 2, "cpu") is pos
    assert fd_stream.positions(5, 3, "cpu").host.tolist() == [5, 5, 5]
    with pytest.raises(ValueError, match="host values"):
        fd_stream.positions(torch.zeros(2, dtype=torch.long, device="meta"),
                            2, "cpu")
    with pytest.raises(ValueError, match="3 positions for 2 rows"):
        fd_stream.positions([1, 2, 3], 2, "cpu")
    with pytest.raises(ValueError, match="negative"):
        fd_stream.positions([1, -1], 2, "cpu")


@pytest.mark.parametrize("arch,want", [("fd-tnn-lm-wt103", 24),
                                       ("mamba2-2.7b", None)])
def test_cache_capacity_by_family(arch, want, monkeypatch):
    monkeypatch.setenv("REPRO_FD_STREAM_C", "4")
    cfg = reduce_for_smoke(get_config(arch), dtype="float32",
                           param_dtype="float32")
    model = init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    with torch.no_grad():
        cache = serving.init_cache(cfg, 2, 24, params=model)
    assert serving.cache_capacity(cache) == want
    assert jserving.cache_capacity(
        {"tail0": {"cap": jnp.zeros((24, 0))}}) == 24


def test_decode_step_ragged_rows_match_solo_rows(monkeypatch):
    """The smoke FD model's decode_step at per-row positions: each row's
    logits within 1e-5 × max of that row decoded alone at int positions.
    Not bit for bit: torch's CPU matmul ``x @ w`` rounds a 1-row product
    differently from a 3-row one (about 1e-5 apart at d = 128), while the
    stream step itself is exact per row (the tests above)."""
    monkeypatch.setenv("REPRO_FD_STREAM_C", "4")
    cfg = reduce_for_smoke(get_config("fd-tnn-lm-wt103"))
    model = init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    starts, n = [0, 3, 6], 14
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab, (3, n)))
    with torch.inference_mode():
        refs = []
        for i, s in enumerate(starts):
            cache = serving.init_cache(cfg, 1, n, params=model)
            ys = []
            for t in range(n - s):
                y, cache = serving.decode_step(model, cfg,
                                               toks[i:i + 1, t:t + 1],
                                               cache, t)
                ys.append(y[0, 0])
            refs.append(ys)
        cache = serving.init_cache(cfg, 3, n, params=model)
        for step in range(n):
            pos = [max(step - s, 0) for s in starts]
            live = [step >= s for s in starts]
            tok = torch.stack([toks[i, step - s] if live[i]
                               else torch.tensor(0)
                               for i, s in enumerate(starts)])[:, None]
            y, cache = serving.decode_step(model, cfg, tok, cache,
                                           torch.tensor(pos))
            for i, s in enumerate(starts):
                if live[i]:
                    want = refs[i][step - s]
                    err = float((y[i, 0] - want).abs().max())
                    assert err <= 1e-5 * float(want.abs().max()), (i, step)
