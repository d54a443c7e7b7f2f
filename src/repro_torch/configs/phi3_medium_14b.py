"""Phi-3-medium 14B [arXiv:2404.14219]: dense, RoPE, SwiGLU, GQA kv=10.
Copy of ``repro/configs/phi3_medium_14b.py``."""
from repro_torch.configs.base import register
from repro_torch.models.config import ArchConfig

CONFIG = register(ArchConfig(
    name="phi3-medium-14b",
    n_layers=40, d_model=5120, n_heads=40, n_kv_heads=10, head_dim=128,
    d_ff=17920, vocab=100352,
    pattern=(("attention", "dense"),),
    dtype="bfloat16", param_dtype="bfloat16", remat="full",
    notes="pure full attention; long_500k SKIPPED",
))
