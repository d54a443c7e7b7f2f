"""Jamba-1.5-Large 398B [arXiv:2403.19887]: Mamba+attention 1:7 interleave,
MoE 16e top-2 every other layer. Copy of
``repro/configs/jamba_1_5_large_398b.py``: the SSD-based Mamba sublayer
(Mamba-2 chunked scan) in place of the original Mamba-1 selective scan.
The port scores and serves it at full width on one card cut to its first
5 layers (``n_layers=5``: 24,050,696,192 parameters, about 48.1 GB in
bf16, every layer kind of the period); the whole 72 layers hold 797 GB."""
from repro_torch.configs.base import register
from repro_torch.models.config import ArchConfig

# 8-layer period: attention at index 4, mamba elsewhere; MoE on odd layers.
_PATTERN = tuple(
    ("attention" if i == 4 else "mamba", "moe" if i % 2 == 1 else "dense")
    for i in range(8))

CONFIG = register(ArchConfig(
    name="jamba-1.5-large-398b",
    n_layers=72, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=24576, vocab=65536,
    pattern=_PATTERN,
    n_experts=16, top_k=2,
    ssm_state=128, ssm_groups=8, ssm_head_dim=64, ssm_expand=2, conv_width=4,
    dtype="bfloat16", param_dtype="bfloat16", remat="full",
    notes="hybrid; long_500k RUNS (sub-quadratic)",
))
