"""The port's seeded sampling (repro_torch.models.sampling) in the solo
``launch.serve.generate`` and the continuous-batching engine.

JAX's ``jax.random.categorical`` bits cannot be reproduced in torch, so
the port is held to the contract and the distribution, not to JAX's bits:
* over 20,000 fixed seeds (and over 20,000 draws of one seed) the
  sampler's first-token frequencies on fixed logits pass a chi-square test
  against softmax(logits / T), truncated to top_k and the real vocabulary,
  at the 0.999 quantile;
* seeded runs reproduce, independent of slot count, submission order and
  neighbours (tests/test_frontend.py's contract), and a request's engine
  stream equals the solo stream of its seed; two seeds differ;
* temperature 0 with seeds attached equals greedy; negative temperature
  or top_k raises.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
scipy_stats = pytest.importorskip("scipy.stats")

from repro_torch.configs import get_config, reduce_for_smoke  # noqa: E402
from repro_torch.launch.serve import generate  # noqa: E402
from repro_torch.models import sampling  # noqa: E402
from repro_torch.models.transformer import init_model  # noqa: E402
from repro_torch.serving_engine import Engine  # noqa: E402

torch.set_num_threads(1)
N_DRAWS = 20_000


@pytest.fixture(autouse=True)
def _block_size(monkeypatch):
    monkeypatch.setenv("REPRO_FD_STREAM_C", "4")


@pytest.fixture(scope="module")
def fd():
    cfg = reduce_for_smoke(get_config("fd-tnn-lm-wt103"))
    return cfg, init_model(cfg, torch.Generator().manual_seed(0),
                           device="cpu")


def _prompts(vocab, plens, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, (p,)) for p in plens]


def _serve(eng, prompts, gens, seeds, order):
    """Admit requests in ``order`` as slots free; one generate a step."""
    queue, out = list(order), {i: [] for i in order}
    slot_of, free, state = {}, list(range(eng.slots)), eng.init_state()
    while queue or slot_of:
        while queue and free:
            i, s = queue.pop(0), free.pop(0)
            cache, first, plen = eng.prefill(prompts[i], seed=seeds[i])
            out[i].append(int(first))
            slot_of[s] = i
            state = eng.insert(state, cache, plen, first, s, seed=seeds[i])
        state, toks, ok = eng.generate(state)
        assert bool(ok.all())
        for s, i in list(slot_of.items()):
            out[i].append(int(toks[s]))
            if len(out[i]) >= gens[i]:
                state = eng.release(state, s)
                del slot_of[s]
                free.append(s)
    return out


# ------------------------------------------------------- distribution
@pytest.mark.parametrize("over", ["seeds", "draws"])
@pytest.mark.parametrize("temperature,top_k,vocab,v_pad", [
    (0.7, 8, 24, 32), (1.3, 0, 12, 16), (1.0, 5, 40, 40)])
def test_first_token_frequencies_pass_chi_square(over, temperature, top_k,
                                                  vocab, v_pad):
    rng = np.random.default_rng(0)
    logits = np.zeros(v_pad, np.float32)
    logits[:vocab] = rng.uniform(-1.5, 1.5, vocab)
    logits[vocab:] = 10.0                      # padding must never be drawn
    if over == "seeds":
        keys = torch.tensor([sampling.seed_key(s) for s in range(N_DRAWS)])
        counters = torch.zeros(N_DRAWS, dtype=torch.long)
    else:
        keys = torch.full((N_DRAWS,), sampling.seed_key(17))
        counters = torch.arange(N_DRAWS)
    got = sampling.sample(torch.from_numpy(logits).expand(N_DRAWS, v_pad),
                          keys, counters, temperature=temperature,
                          top_k=top_k, vocab=vocab).numpy()
    real = logits[:vocab].astype(np.float64) / temperature
    support = np.arange(vocab)
    if 0 < top_k < vocab:
        support = np.argsort(-real)[:top_k]
    assert set(np.unique(got)) <= set(support.tolist())
    p = np.exp(real[support] - real[support].max())
    p /= p.sum()
    expected = N_DRAWS * p
    assert expected.min() >= 5, expected.min()
    observed = np.array([(got == v).sum() for v in support])
    stat = float(((observed - expected) ** 2 / expected).sum())
    limit = scipy_stats.chi2.ppf(0.999, len(support) - 1)
    assert stat < limit, (stat, limit, observed, expected)


def test_uniforms_are_open_and_keyed():
    keys = torch.tensor([sampling.seed_key(s) for s in range(64)])
    u = sampling.uniforms(keys, torch.zeros(64, dtype=torch.long), 512)
    assert u.dtype == torch.float32 and u.shape == (64, 512)
    assert float(u.min()) > 0 and float(u.max()) < 1
    again = sampling.uniforms(keys, torch.zeros(64, dtype=torch.long), 512)
    assert torch.equal(u, again)
    nxt = sampling.uniforms(keys, torch.ones(64, dtype=torch.long), 512)
    assert not torch.equal(u, nxt) and not torch.equal(u[0], u[1])


# ------------------------------------------------------------ the solo path
def test_solo_sampled_generate_is_seeded(fd):
    cfg, model = fd
    prompt = torch.from_numpy(np.stack(_prompts(cfg.vocab, [5, 5], 1)))
    with torch.inference_mode():
        a = generate(model, cfg, prompt, 9, temperature=0.8, seed=3)
        b = generate(model, cfg, prompt, 9, temperature=0.8, seed=3)
        c = generate(model, cfg, prompt, 9, temperature=0.8, seed=4)
        greedy = generate(model, cfg, prompt, 9)
        zero = generate(model, cfg, prompt, 9, temperature=0.0, seed=3)
        # row 1 of a seed-3 batch is the batch-1 stream of seed 4
        row1 = generate(model, cfg, prompt[1:], 9, temperature=0.8, seed=4)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.equal(zero, greedy) and not torch.equal(a, greedy)
    assert torch.equal(a[1:], row1)
    assert int(a.max()) < cfg.vocab
    with pytest.raises(ValueError, match="temperature"):
        generate(model, cfg, prompt, 2, temperature=-0.5)


# ------------------------------------------------------------ the engine
def test_engine_sampled_reproducible_and_placement_independent(fd):
    """Same seeds → identical streams run to run and across slot counts
    and submission orders; each stream equals the solo stream of its seed
    (top_k 0); two seeds differ."""
    cfg, model = fd
    prompts = _prompts(cfg.vocab, [3, 6, 5, 4], 29)
    seeds, gens = [101, 202, 303, 404], [7, 7, 7, 7]

    def serve(slots, order, top_k=8):
        eng = Engine(cfg, model, slots=slots, max_len=24, temperature=0.7,
                     top_k=top_k)
        return _serve(eng, prompts, gens, seeds, order)

    a = serve(2, [0, 1, 2, 3])
    assert a == serve(2, [0, 1, 2, 3])
    assert a == serve(4, [3, 1, 0, 2])
    full = serve(3, [2, 0, 3, 1], top_k=0)
    with torch.inference_mode():
        for i, pr in enumerate(prompts):
            solo = generate(model, cfg, torch.from_numpy(pr)[None], gens[i],
                            temperature=0.7, seed=seeds[i], max_len=24)
            assert full[i] == solo[0, len(pr):].tolist(), i
    eng = Engine(cfg, model, slots=2, max_len=24, temperature=0.9)
    two = _serve(eng, [prompts[0]] * 2, [12, 12], [1, 2], [0, 1])
    assert two[0] != two[1]


def test_engine_t0_with_seeds_equals_greedy(fd):
    cfg, model = fd
    prompts = _prompts(cfg.vocab, [3, 6], 31)

    def serve(**kw):
        eng = Engine(cfg, model, slots=2, max_len=24, **kw)
        return _serve(eng, prompts, [9, 9], [555, 556], [0, 1])

    assert serve(temperature=0.0) == serve()


def test_engine_sampled_draws_only_when_advancing(fd):
    """A frozen slot consumes no randomness: its lane counter stays put
    while its neighbour's counts every step."""
    cfg, model = fd
    eng = Engine(cfg, model, slots=2, max_len=24, temperature=0.7, top_k=8)
    cache, first, plen = eng.prefill(_prompts(cfg.vocab, [4], 2)[0], seed=9)
    state = eng.insert(eng.init_state(), cache, plen, first, 0, seed=9)
    for _ in range(3):
        state, _, _ = eng.generate(state)
    assert state.rng[:, 1].tolist() == [4, 0]
    assert state.rng[0, 0] == sampling.seed_key(9)


def test_sampled_validation(fd):
    cfg, model = fd
    with pytest.raises(ValueError, match="temperature"):
        Engine(cfg, model, slots=1, max_len=16, temperature=-0.1)
    with pytest.raises(ValueError, match="top_k"):
        Engine(cfg, model, slots=1, max_len=16, top_k=-1)
