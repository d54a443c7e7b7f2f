"""Gemma-3-4B [hf:google/gemma-3]: 5:1 local:global interleave, 128k ctx.
head_dim=256 per the official model. Copy of
``repro/configs/gemma3_4b.py``. The port scores, trains and serves it
(attention layers: ``models/attention.py``)."""
from repro_torch.configs.base import register
from repro_torch.models.config import ArchConfig

_PATTERN = tuple(
    ("local" if i < 5 else "attention", "dense") for i in range(6))

CONFIG = register(ArchConfig(
    name="gemma3-4b",
    n_layers=34, d_model=2560, n_heads=8, n_kv_heads=4, head_dim=256,
    d_ff=10240, vocab=262144, window=1024,
    pattern=_PATTERN,
    dtype="bfloat16", param_dtype="bfloat16", remat="full",
    notes="5:1 local:global; long_500k RUNS (decode O(n), mostly windowed)",
))
