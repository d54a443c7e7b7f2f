"""Continuous-batching inference engine: prefill → insert → generate,
counterpart of ``repro/serving_engine/engine.py``.

The device half of the serving engine (``scheduler.py`` is the host
half that drives it). Functions over a :class:`~.state.DecodeState` of S
slots:

* ``prefill(prompt)`` — one request's prompt through a **batch-1** cache:
  ``(prefix_cache, first_token, prompt_len)``. The prompt is padded to a
  geometric **length bucket**; an FD streaming model takes whole C-token
  blocks through ``serving.decode_chunk``, then the token remainder by
  masked per-row ``decode_step`` s (every other model takes the prompt
  token by token), each step merged with ``state.select_rows``. The same
  math as the solo ``launch/serve.generate`` prefill, so engine output
  matches solo decode token for token.
* ``prefill_packed(prompts)`` — the same at batch P: several prompts
  padded to the bucket of the longest, one packed cache whose rows
  ``insert_from`` scatters into slots.
* ``insert`` / ``insert_from`` — a prefix cache (or one row of a packed
  one) into a free slot, no other slot's row touched.
* ``generate(state)`` — ONE batched masked ``decode_step`` over all S
  slots at their own positions. Parked slots decode at position 0 with
  token 0 (never a block boundary, their writes are scratch); only
  active, finite slots advance. ``temperature == 0`` takes the argmax;
  ``temperature > 0`` samples from each slot's private lane
  (``models/sampling.py``). The non-finite guard (on by default)
  quarantines a slot whose logits are not finite: it neither advances
  nor stays active, and its ``ok`` is False.

Where JAX compiles one executable per argument shape, the port runs
eagerly; ``trace_counts`` keeps the JAX keys and counts a function's first
call at each new argument shape, as a jit trace would, so the bucketing
contract (one ``prefill_bucket`` shape per (batch, bucket, remainder
length), not one per prompt length) stays testable. Under a live metrics
registry (``metrics=``, or the ``REPRO_METRICS`` process default) the same
counts feed ``repro_engine_traces_total{fn}``, and the ``compile_watch``
(``obs/compilewatch.CompileWatch``, prefix ``"engine."``) records each
first call into ``repro_compiles_total{fn}`` under JAX's retrace budgets
(``generate`` 2, ``decode1`` 2, ``prefill_bucket`` 2 · buckets · slots).
Positions, admission
and the masks of a prefill are decided on the host: a prefill moves its
tokens and masks to the card once, a ``generate`` step moves the slots'
positions and liveness once and reads back its tokens and ``ok`` once. The
engine runs on the parameters' device, under ``torch.inference_mode``;
nothing moves a cache off the device.

Knobs, read as JAX reads them: ``REPRO_ENGINE_SLOTS`` (default S = 8),
``REPRO_PREFILL_BUCKET0`` (the smallest bucket, 16, rounded up to C) and
``REPRO_PREFILL_BUCKETS=0`` (the per-length chunk/token loop instead of
buckets).
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from repro_torch.kernels import fd_stream
from repro_torch.models import sampling, serving
from repro_torch.models.config import ArchConfig
from repro_torch.obs import compilewatch as obs_compile
from repro_torch.obs import metrics as obs_metrics
from repro_torch.serving_engine import state as st

_ENV_SLOTS = "REPRO_ENGINE_SLOTS"
_ENV_BUCKET0 = "REPRO_PREFILL_BUCKET0"
_ENV_BUCKETS = "REPRO_PREFILL_BUCKETS"


def default_slots() -> int:
    v = os.environ.get(_ENV_SLOTS)
    if v is None or v == "":
        return 8
    s = int(v)
    if s < 1:
        raise ValueError(f"{_ENV_SLOTS}={s} must be >= 1")
    return s


def _env_flag(name: str, default: bool) -> bool:
    v = os.environ.get(name)
    if v is None or v == "":
        return default
    return v.strip().lower() not in ("0", "false", "off", "no")


class Engine:
    """Bind (cfg, params, S slots, max_len) once. ``temperature == 0``
    (default) decodes greedily; ``temperature > 0`` samples per slot from
    private lanes, optionally top-k truncated. ``dtype`` is the Mamba
    caches' dtype (default ``cfg.dtype``)."""

    def __init__(self, cfg: ArchConfig, params, *, slots: int | None = None,
                 max_len: int = 256, dtype=None,
                 guard_nonfinite: bool = True, temperature: float = 0.0,
                 top_k: int = 0, bucket0: int | None = None,
                 use_buckets: bool | None = None, metrics=None):
        if cfg.kind != "decoder":
            raise NotImplementedError(
                f"serving engine supports decoder archs, got {cfg.kind}")
        if temperature < 0:
            raise ValueError(f"temperature={temperature} must be >= 0")
        if top_k < 0:
            raise ValueError(f"top_k={top_k} must be >= 0")
        self.cfg = cfg
        self.params = params
        self.device = params.embed.device
        self.slots = default_slots() if slots is None else int(slots)
        if self.slots < 1:
            raise ValueError(f"slots={self.slots} must be >= 1")
        self.max_len = int(max_len)
        self.guard_nonfinite = bool(guard_nonfinite)
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.dtype = dtype
        # the batch-1 template realises the kernel constants (one
        # hilbert_window launch per FD layer on the card); every other
        # template and state shares them (state.empty_cache)
        with torch.inference_mode():
            self._prefix_template = serving.init_cache(
                cfg, 1, self.max_len, params=params, dtype=dtype)
        self.capacity = serving.cache_capacity(self._prefix_template)
        self._chunk_c = (serving.stream_block_of(self._prefix_template)
                         if serving.supports_chunked_prefill(
                             cfg, self._prefix_template) else None)
        self.use_buckets = (_env_flag(_ENV_BUCKETS, True)
                            if use_buckets is None else bool(use_buckets))
        if bucket0 is None:
            bucket0 = int(os.environ.get(_ENV_BUCKET0) or 16)
        self.buckets = self._bucket_ladder(int(bucket0))
        self._templates = {1: self._prefix_template}
        reg = (metrics if metrics is not None
               else obs_metrics.default_registry())
        self.metrics = reg
        initial = {"generate": 0, "insert": 0, "insert_from": 0,
                   "decode1": 0, "chunk1": 0, "prefill_bucket": 0}
        if isinstance(reg, obs_metrics.NullRegistry):
            self.trace_counts = dict(initial)
        else:
            self.trace_counts = obs_metrics.MirroredCounts(
                initial,
                reg.counter("repro_engine_traces_total",
                            "jitted engine fn retraces (trace_counts)",
                            ("fn",)),
                "fn")
        self._shapes = {name: set() for name in self.trace_counts}
        # the compile watchdog over the same first calls: they land in
        # repro_compiles_total{fn="engine.*"}, and past JAX's budgets
        # (decode1/generate batch over all S slots, packed prefill <= 2
        # shapes per (batch, bucket)) it warns; insert/chunk1 run one shape
        # per prompt length on the unbucketed path, counted, not budgeted
        w = self.compile_watch = obs_compile.CompileWatch(
            metrics=reg, prefix="engine.")
        w.expect("generate", 2)
        w.expect("decode1", 2)
        w.expect("prefill_bucket",
                 2 * max(len(self.buckets), 1) * max(self.slots, 1))

    # ------------------------------------------------------------ plumbing
    def _trace(self, name: str, shape) -> None:
        """Count ``name``'s first call at ``shape`` (a jit trace in JAX)."""
        if shape not in self._shapes[name]:
            self._shapes[name].add(shape)
            self.trace_counts[name] += 1
            self.compile_watch._mark(name)

    def _bucket_ladder(self, b0: int):
        """Geometric prompt-length buckets b0, 2·b0, … up to capacity. For
        streaming archs every rung is a multiple of the block size C; the
        top rung rounds capacity up to a C-multiple."""
        if b0 < 1:
            raise ValueError(f"prefill bucket0={b0} must be >= 1")
        c = self._chunk_c or 1
        b0 = ((max(b0, c) + c - 1) // c) * c
        cap = self.capacity if self.capacity is not None else self.max_len
        top = ((max(cap, b0) + c - 1) // c) * c
        ladder = []
        b = b0
        while b < top:
            ladder.append(b)
            b *= 2
        ladder.append(top)
        return ladder

    def bucket_for(self, p: int) -> int | None:
        """Smallest bucket holding a p-token prompt (None: bucketing off,
        or p past the top rung of a length-unbounded arch — both take the
        per-length loop)."""
        if not self.use_buckets:
            return None
        for b in self.buckets:
            if p <= b:
                return b
        return None

    def _template_for(self, batch: int) -> list:
        if batch not in self._templates:
            self._templates[batch] = st.empty_cache(self._prefix_template,
                                                    batch)
        return self._templates[batch]

    def _to_device(self, a) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _keys(self, seeds) -> torch.Tensor:
        return self._to_device(np.array([sampling.seed_key(s) for s in seeds],
                                        np.int64))

    def _pick_last(self, last: torch.Tensor) -> torch.Tensor:
        """Greedy token per row from last-position logits (b, V_pad)."""
        return torch.clamp(torch.argmax(last, dim=-1), max=self.cfg.vocab - 1)

    def _sample_last(self, last, keys, counters) -> torch.Tensor:
        return sampling.sample(last, keys, counters,
                               temperature=self.temperature, top_k=self.top_k,
                               vocab=self.cfg.vocab)

    def _first_candidate(self, last, keys) -> torch.Tensor:
        """Next-token candidate at the end of a prompt: draw 0 of the
        request's lane when sampling, else the argmax."""
        if self.temperature > 0:
            return self._sample_last(last, keys, torch.zeros_like(keys))
        return self._pick_last(last)

    def _n_tok_for(self, bucket: int, plens) -> int:
        """Length of the token-remainder phase of a bucketed prefill:
        streaming archs need C catch-up steps only when some prompt is not
        chunk-aligned; other archs teacher-force the whole bucket."""
        c = self._chunk_c
        if c and bucket % c == 0:
            return 0 if all(p % c == 0 for p in plens) else c
        return bucket

    def _prefill_bucket(self, cache, padded: np.ndarray, plens, seeds,
                        n_tok: int):
        """Packed bucketed prefill: ``padded`` (B, Lb) host tokens, plens
        the true lengths. Streaming archs run the whole C-blocks, then
        ``n_tok`` (≤ C) per-row remainder tokens; other archs
        teacher-force the bucket. A row's cache merges only while a step is
        inside its own prompt, so each row ends with the cache and first
        token of its prompt alone. Steps that no row takes are skipped (the
        result is the same); the tokens and every step's masks go to the
        card in one transfer."""
        B, Lb = padded.shape
        self._trace("prefill_bucket", (B, Lb, n_tok))
        plens = np.asarray(plens, np.int64)
        keys = self._keys(seeds) if self.temperature > 0 else None
        c = self._chunk_c
        nb = Lb // c if c and Lb % c == 0 else 0
        base = (plens // c) * c if nb else np.zeros_like(plens)
        # host plan: chunk k takes rows with (k+1)C <= plen; token step t
        # sits at base + t, parked at 0 (never a block boundary) once past
        # the row's prompt
        ends_c = np.arange(1, nb + 1)[:, None] * (c or 0)          # (K, 1)
        pos_t = base[None, :] + np.arange(n_tok)[:, None]          # (T, B)
        take = np.concatenate([ends_c <= plens, pos_t < plens])    # (K+T, B)
        done = np.concatenate([ends_c == plens, pos_t == plens - 1])
        pos_safe = np.where(pos_t < plens, pos_t, 0)
        tok_t = padded[np.arange(B), np.clip(pos_t, 0, Lb - 1)]    # (T, B)
        dev = self._to_device(np.concatenate(
            [take, done, pos_safe, tok_t]).astype(np.int64))
        n = nb + n_tok
        take_d, done_d = dev[:n].bool(), dev[n:2 * n].bool()
        pos_d, tok_d = dev[2 * n:2 * n + n_tok], dev[2 * n + n_tok:]
        prompts = self._to_device(padded.astype(np.int64)) if nb else None
        first = torch.zeros(B, dtype=torch.long, device=self.device)
        for i in range(n):
            if not take[i].any():
                continue
            if i < nb:
                logits, new = serving.decode_chunk(
                    self.params, self.cfg, prompts[:, i * c:(i + 1) * c],
                    cache, i * c)
            else:
                t = i - nb
                logits, new = serving.decode_step(
                    self.params, self.cfg, tok_d[t][:, None], cache,
                    fd_stream.Positions(pos_safe[t], pos_d[t]))
            cache = (new if take[i].all()
                     else st.select_rows(take_d[i], new, cache))
            if done[i].any():
                cand = self._first_candidate(logits[:, -1], keys)
                first = torch.where(done_d[i], cand, first)
        return cache, first

    # -------------------------------------------------------------- public
    @torch.inference_mode()
    def init_state(self) -> st.DecodeState:
        return st.init_decode_state(self.cfg, self.params, self.slots,
                                    self.max_len, self.dtype,
                                    template=self._prefix_template)

    @torch.inference_mode()
    def state_from_jax(self, state) -> st.DecodeState:
        """A DecodeState in the JAX layout (a JAX engine's state or a
        snapshot's arrays; see ``bridge.decode_state_from_jax``) as this
        engine's state on its device, holding the engine's own kernel
        constants rather than copies."""
        from repro_torch import bridge
        return bridge.decode_state_from_jax(state, self.cfg, self.device,
                                            template=self._prefix_template)

    def _check_prompt_len(self, p: int):
        if p < 1:
            raise ValueError("empty prompt")
        if self.capacity is not None and p > self.capacity:
            raise ValueError(
                f"prompt length {p} exceeds slot capacity "
                f"{self.capacity} (cache max_len {self.max_len}); "
                "raise Engine(max_len=...) or reject the request")

    def _prefill_loop(self, prompt: np.ndarray, seed: int):
        """Per-length fallback: whole C-blocks then token by token on a
        batch-1 cache."""
        p = prompt.shape[1]
        toks = self._to_device(prompt.astype(np.int64))
        cache = self._prefix_template
        pos = 0
        logits = None
        if self._chunk_c:
            c = self._chunk_c
            while pos + c <= p:
                self._trace("chunk1", (1, c))
                logits, cache = serving.decode_chunk(
                    self.params, self.cfg, toks[:, pos:pos + c], cache, pos)
                pos += c
        while pos < p:
            self._trace("decode1", (1, 1))
            logits, cache = serving.decode_step(
                self.params, self.cfg, toks[:, pos:pos + 1], cache, pos)
            pos += 1
        keys = self._keys([seed]) if self.temperature > 0 else None
        return cache, self._first_candidate(logits[:, -1], keys)[0], p

    @torch.inference_mode()
    def prefill(self, prompt, seed: int = 0):
        """prompt: (p,) or (1, p) host ints. Returns (prefix_cache,
        first_token (0-d device tensor), prompt_len). ``seed`` matters
        only when sampling, and must match the seed later passed to
        ``insert``. Raises when the prompt alone exceeds the slot
        capacity."""
        prompt = np.asarray(prompt, np.int64).reshape(1, -1)
        p = prompt.shape[1]
        self._check_prompt_len(p)
        bucket = self.bucket_for(p)
        if bucket is None:
            return self._prefill_loop(prompt, seed)
        padded = np.zeros((1, bucket), np.int64)
        padded[0, :p] = prompt[0]
        cache, first = self._prefill_bucket(
            self._template_for(1), padded, [p], [seed],
            self._n_tok_for(bucket, [p]))
        return cache, first[0], p

    @torch.inference_mode()
    def prefill_packed(self, prompts, seeds=None):
        """Pack several prompts into ONE padded prefill batch: all padded
        to the bucket of the longest. Returns (packed_cache, first_tokens
        (B,) device, plens); scatter row i into a slot with
        :meth:`insert_from`. Raises when a prompt is off the ladder."""
        B = len(prompts)
        if B < 1:
            raise ValueError("prefill_packed needs at least one prompt")
        prompts = [np.asarray(pr, np.int64).reshape(-1) for pr in prompts]
        plens = [int(pr.shape[0]) for pr in prompts]
        for p in plens:
            self._check_prompt_len(p)
        bucket = self.bucket_for(max(plens))
        if bucket is None:
            raise ValueError(
                f"prompt length {max(plens)} is off the bucket ladder "
                f"(buckets={self.buckets}, use_buckets={self.use_buckets})")
        padded = np.zeros((B, bucket), np.int64)
        for i, pr in enumerate(prompts):
            padded[i, :plens[i]] = pr
        if seeds is None:
            seeds = [0] * B
        cache, first = self._prefill_bucket(
            self._template_for(B), padded, plens, seeds,
            self._n_tok_for(bucket, plens))
        return cache, first, plens

    def _lane(self, seed: int) -> torch.Tensor:
        """A slot's lane after its prefill took draw 0: (key, 1)."""
        return self._to_device(np.array([sampling.seed_key(seed), 1],
                                        np.int64))

    @torch.inference_mode()
    def with_lanes(self, state, lanes: dict) -> st.DecodeState:
        """``state`` with slot s's sampling lane set to (key of seed,
        draws) for each ``lanes[s] = (seed, draws)``. A request that has
        emitted k tokens has taken k draws (its prefill draw 0 and one per
        advancing step), so a restored request resumes its stream where
        it stopped; a greedy engine never reads the lanes."""
        rng = state.rng.to("cpu", copy=True)
        for slot, (seed, draws) in lanes.items():
            rng[slot] = torch.tensor([sampling.seed_key(seed), draws])
        return dataclasses.replace(state, rng=rng.to(self.device))

    @torch.inference_mode()
    def insert(self, state, prefix_cache, plen, token, slot, seed: int = 0):
        """Admit a prefilled request into ``slot``. ``seed`` must be the
        request's prefill seed: it re-derives the slot's sampling lane."""
        self._trace("insert", (1,))
        return st.insert(state, prefix_cache, slot, plen, token,
                         key=self._lane(seed))

    @torch.inference_mode()
    def insert_from(self, state, packed_cache, row, plen, token, slot,
                    seed: int = 0):
        """Admit row ``row`` of a packed prefill cache into ``slot``."""
        self._trace("insert_from", (st.batch_size(packed_cache),))
        return st.insert(state, st.take_row(packed_cache, row), slot, plen,
                         token, key=self._lane(seed))

    @torch.inference_mode()
    def generate(self, state: st.DecodeState):
        """One batched decode step: (state, tokens (S,), ok (S,)), both on
        the host. Read tokens only for slots that were active going in AND
        finite (``ok``). A slot with ``ok=False`` is quarantined in the
        returned state (frozen and deactivated); the caller records the
        failure and releases or recycles it. Raises when an active slot is
        at the capacity (its next write would fall past the cache)."""
        S = state.slots
        self._trace("generate", (S,))
        if self.capacity is not None and bool(
                (state.active & (state.cur_len >= self.capacity)).any()):
            raise ValueError(f"an active slot is at capacity {self.capacity}: "
                             f"positions {state.cur_len.tolist()}")
        cur = torch.where(state.active, state.cur_len, 0)
        both = torch.stack([cur, state.active.long()]).to(self.device)
        act = both[1].bool()
        toks = torch.where(act, state.tokens, 0)[:, None]
        logits, cache = serving.decode_step(
            self.params, self.cfg, toks, state.cache,
            fd_stream.Positions(cur.numpy(), both[0]))
        last = logits[:, -1]
        if self.temperature > 0:
            nxt = self._sample_last(last, state.rng[:, 0], state.rng[:, 1])
        else:
            nxt = self._pick_last(last)
        if self.guard_nonfinite:
            # parked slots decode scratch rows (possibly a quarantined
            # slot's NaN remnants): only active slots can be flagged
            ok = torch.where(act, torch.isfinite(last).all(dim=-1), True)
        else:
            ok = torch.ones_like(act)
        advance = act & ok
        rng = state.rng
        if self.temperature > 0:
            # only advancing slots consume a draw
            rng = torch.stack([rng[:, 0], rng[:, 1] + advance.long()], dim=1)
        host = torch.stack([nxt, ok.long()]).cpu()
        nxt_h, ok_h = host[0], host[1].bool()
        adv_h = state.active & ok_h
        new_state = st.DecodeState(
            cache=cache,
            cur_len=torch.where(adv_h, state.cur_len + 1, state.cur_len),
            tokens=torch.where(advance, nxt, state.tokens),
            active=adv_h,
            rng=rng,
        )
        return new_state, nxt_h, ok_h

    @torch.inference_mode()
    def release(self, state, slot: int):
        return st.release(state, slot)

    @torch.inference_mode()
    def poison_slot(self, state, slot: int):
        """Chaos hook: ``slot``'s per-slot float cache rows become NaN, so
        the next step trips the non-finite guard for that slot only."""
        return st.poison(state, slot)
