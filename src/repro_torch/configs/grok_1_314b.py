"""Grok-1 314B [hf:xai-org/grok-1]: 64L GQA MoE 8e top-2 on every layer.
Copy of ``repro/configs/grok_1_314b.py``. The port runs it at smoke size
only (316 B parameters)."""
from repro_torch.configs.base import register
from repro_torch.models.config import ArchConfig

CONFIG = register(ArchConfig(
    name="grok-1-314b",
    n_layers=64, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
    d_ff=32768, vocab=131072,
    pattern=(("attention", "moe"),),
    n_experts=8, top_k=2,
    dtype="bfloat16", param_dtype="bfloat16", remat="full",
    notes="pure full attention; long_500k SKIPPED",
))
