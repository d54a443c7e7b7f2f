"""StableLM-3B [hf:stabilityai]: dense MHA (kv=heads=32), head_dim 80.
Copy of ``repro/configs/stablelm_3b.py``."""
from repro_torch.configs.base import register
from repro_torch.models.config import ArchConfig

CONFIG = register(ArchConfig(
    name="stablelm-3b",
    n_layers=32, d_model=2560, n_heads=32, n_kv_heads=32, head_dim=80,
    d_ff=6912, vocab=50304,
    pattern=(("attention", "dense"),),
    dtype="bfloat16", param_dtype="bfloat16", remat="full",
    notes="pure full attention; long_500k SKIPPED",
))
