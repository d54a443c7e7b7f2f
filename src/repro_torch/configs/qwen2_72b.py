"""Qwen2-72B [arXiv:2407.10671]: dense GQA kv=8 with QKV bias. Copy of
``repro/configs/qwen2_72b.py`` (144 GB in bf16: more than one card holds;
the port runs it at smoke size)."""
from repro_torch.configs.base import register
from repro_torch.models.config import ArchConfig

CONFIG = register(ArchConfig(
    name="qwen2-72b",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=29568, vocab=152064, qkv_bias=True,
    pattern=(("attention", "dense"),),
    dtype="bfloat16", param_dtype="bfloat16", remat="full",
    notes="pure full attention; long_500k SKIPPED",
))
