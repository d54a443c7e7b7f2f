"""Config registry + smoke-reduction helper (copy of
``repro/configs/base.py``). The port registers the TNN LM configs,
``mamba2-2.7b``, the dense attention decoders ``gemma3-4b``,
``stablelm-3b``, ``phi3-medium-14b`` and ``qwen2-72b``, and the MoE
decoders ``granite-moe-3b-a800m`` and ``grok-1-314b``, the
Mamba + attention + MoE hybrid ``jamba-1.5-large-398b``, the
encoder-decoder ``whisper-medium`` and the prefix-VLM ``paligemma-3b``:
every arch of the JAX registry."""
from __future__ import annotations

import dataclasses

from repro_torch.models.config import ArchConfig

_REGISTRY = {}


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ArchConfig:
    if not _REGISTRY:
        _load_all()
    key = name.replace("_", "-")
    if key in _REGISTRY:
        return _REGISTRY[key]
    raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")


def list_archs():
    if not _REGISTRY:
        _load_all()
    return sorted(_REGISTRY)


def _load_all():
    import importlib
    for mod in ("phi3_medium_14b", "qwen2_72b", "gemma3_4b", "stablelm_3b",
                "granite_moe_3b_a800m", "grok_1_314b", "mamba2_2p7b",
                "jamba_1_5_large_398b", "whisper_medium", "paligemma_3b",
                "tnn_lm"):
        importlib.import_module(f"repro_torch.configs.{mod}")


def reduce_for_smoke(cfg: ArchConfig, **overrides) -> ArchConfig:
    """Shrink a full config to CPU-smoke size, preserving the layer pattern
    and family (GQA ratios, MoE top-k, SSM structure)."""
    kw = dict(
        name=cfg.name + "-smoke",
        n_layers=min(cfg.n_layers, 2 * cfg.period),
        d_model=128,
        n_heads=4 if cfg.n_heads else 0,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads else 0,
        head_dim=32 if cfg.n_heads else 0,
        d_ff=256 if cfg.d_ff else 0,
        vocab=512 if cfg.vocab else 0,
        enc_layers=min(cfg.enc_layers, 2),
        n_experts=min(cfg.n_experts, 4) if cfg.n_experts else 0,
        top_k=min(cfg.top_k, 2) if cfg.top_k else 0,
        ssm_state=min(cfg.ssm_state, 16) if cfg.ssm_state else 0,
        ssm_groups=min(cfg.ssm_groups, 2) if cfg.ssm_state else 1,
        ssm_head_dim=32 if cfg.ssm_state else 64,
        ssd_chunk=16,
        window=min(cfg.window, 8) if cfg.window else 0,
        n_prefix=min(cfg.n_prefix, 8) if cfg.n_prefix else 0,
        attn_chunk=32,
        tno_rank=8,
        tno_filter=4,
        tno_rpe_hidden=16,
        vocab_pad_multiple=16,
        remat="none",
    )
    if cfg.n_kv_heads == cfg.n_heads:   # MHA family (stablelm, whisper)
        kw["n_kv_heads"] = kw["n_heads"]
    kw.update(overrides)
    return dataclasses.replace(cfg, **kw)
