"""Deterministic, resumable, shardable data pipeline — the port's own
verbatim copy of ``repro/data/pipeline.py`` (pure numpy), so the port
never imports the JAX package; ``tests/test_torch_train.py`` holds the two
token for token.

Design goals for 1000+-node training (DESIGN §5):

* **Stateless, per-row indexing** — row ``r`` of global batch ``i`` is a
  pure function of (seed, i, r). Restart-at-step-k needs no iterator state
  in the checkpoint, only ``k``; *re-sharding onto a different host count
  reproduces the identical global batch* (elastic restore invariant,
  tested). Every host materialises only its own rows.
* **Two sources**: a synthetic Zipf-Markov corpus (offline container —
  stands in for wikitext; local bigram structure + a long-range copy
  channel so models have both signals to learn) and a byte-level reader
  for real text files.
* **LRA-style long-range matching task** for the paper's bidirectional
  experiments (classification that requires cross-sequence interaction).
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    kind: str = "synthetic"       # synthetic | bytes | lra_match
    path: Optional[str] = None    # bytes kind
    host_id: int = 0
    num_hosts: int = 1

    @property
    def host_batch(self) -> int:
        assert self.global_batch % self.num_hosts == 0
        return self.global_batch // self.num_hosts


def _rng(cfg: DataConfig, step: int, row: int, salt: int) -> np.random.Generator:
    return np.random.default_rng([cfg.seed, step, row, salt])


# --------------------------------------------------------------- synthetic
def _zipf_probs(v: int) -> np.ndarray:
    p = 1.0 / np.arange(1, v + 1)
    return p / p.sum()


def _zipf_markov_row(cfg: DataConfig, step: int, row: int) -> np.ndarray:
    """Zipf marginals + fixed successor map: next = succ(prev) w.p. 0.5,
    fresh Zipf draw otherwise; position t >= n/2 copies t - n/2 w.p. 0.1
    (a long-range signal the TNN's global mixing can exploit)."""
    rng = _rng(cfg, step, row, 0)
    n, v = cfg.seq_len + 1, cfg.vocab
    zipf = _zipf_probs(v)
    draws = rng.choice(v, size=n, p=zipf).astype(np.int32)
    mix = rng.random(n)
    succ = (np.arange(v) * 7919 + 13) % v
    toks = np.empty(n, np.int32)
    toks[0] = draws[0]
    half = cfg.seq_len // 2
    for t in range(1, n):
        toks[t] = succ[toks[t - 1]] if mix[t] < 0.5 else draws[t]
        if t >= half and mix[t] > 0.9:
            toks[t] = toks[t - half]
    return toks


# ------------------------------------------------------------------ bytes
class _ByteCorpus:
    _cache: dict = {}

    @classmethod
    def get(cls, path: str) -> np.ndarray:
        if path not in cls._cache:
            with open(path, "rb") as f:
                cls._cache[path] = np.frombuffer(f.read(), np.uint8)
        return cls._cache[path]


def _bytes_row(cfg: DataConfig, step: int, row: int) -> np.ndarray:
    data = _ByteCorpus.get(cfg.path)
    rng = _rng(cfg, step, row, 1)
    n = cfg.seq_len + 1
    s = int(rng.integers(0, max(len(data) - n, 1)))
    out = data[s:s + n].astype(np.int32)
    if len(out) < n:                       # tiny corpus: wrap
        out = np.resize(out, n)
    return out


# -------------------------------------------------------- LRA-style tasks
def _lra_match_row(cfg: DataConfig, step: int, row: int):
    """label = do the sentinels at positions 1 and n-2 match? Requires
    interaction across ~the whole sequence. Returns (tokens, label)."""
    rng = _rng(cfg, step, row, 2)
    n, v = cfg.seq_len, cfg.vocab
    toks = rng.integers(0, max(v - 2, 1), size=n, dtype=np.int32)
    half_v = max(v // 2, 2)
    sent = int(rng.integers(0, half_v))
    match = bool(rng.random() < 0.5)
    other = (sent + 1 + int(rng.integers(0, half_v - 1))) % half_v
    toks[1] = sent
    toks[n - 2] = sent if match else other
    return toks, int(match)


# ------------------------------------------------------------------ public
def batch_at(cfg: DataConfig, step: int) -> dict:
    """Host-local shard of global batch ``step`` — pure in (cfg, step)."""
    hb = cfg.host_batch
    rows = range(cfg.host_id * hb, (cfg.host_id + 1) * hb)
    if cfg.kind == "lra_match":
        pairs = [_lra_match_row(cfg, step, r) for r in rows]
        toks = np.stack([p[0] for p in pairs])
        lab = np.array([p[1] for p in pairs], np.int32)
        labels = np.broadcast_to(lab[:, None], toks.shape).copy()
        return {"tokens": toks, "labels": labels}
    gen = _zipf_markov_row if cfg.kind == "synthetic" else _bytes_row
    toks = np.stack([gen(cfg, step, r) for r in rows])
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def iterate(cfg: DataConfig, start_step: int = 0) -> Iterator[dict]:
    step = start_step
    while True:
        yield batch_at(cfg, step)
        step += 1
