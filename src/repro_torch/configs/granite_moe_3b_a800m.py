"""Granite-3.0-3b-a800m [hf:ibm-granite]: 40 experts top-8, d_ff=512.
Copy of ``repro/configs/granite_moe_3b_a800m.py``. The port scores and
serves it at full width on one card (6.75 GB in bf16; ``models/moe.py``)."""
from repro_torch.configs.base import register
from repro_torch.models.config import ArchConfig

CONFIG = register(ArchConfig(
    name="granite-moe-3b-a800m",
    n_layers=32, d_model=1536, n_heads=24, n_kv_heads=8, head_dim=64,
    d_ff=512, vocab=49155,
    pattern=(("attention", "moe"),),
    n_experts=40, top_k=8,
    dtype="bfloat16", param_dtype="bfloat16", remat="full",
    notes="pure full attention; long_500k SKIPPED; vocab padded to /256",
))
