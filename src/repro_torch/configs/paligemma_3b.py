"""PaliGemma-3B [arXiv:2407.07726]: SigLIP patch frontend (a stub: the
caller gives precomputed patch embeddings, ``patches``) + gemma text tower
as a prefix-LM (bidirectional over 256 patches, causal over text). Copy
of ``repro/configs/paligemma_3b.py``. The port scores it under the prefix
mask and serves the text alone, as JAX's decode does
(``kind="prefix_vlm"``, ``models/transformer.py``)."""
from repro_torch.configs.base import register
from repro_torch.models.config import ArchConfig

CONFIG = register(ArchConfig(
    name="paligemma-3b",
    n_layers=18, d_model=2048, n_heads=8, n_kv_heads=1, head_dim=256,
    d_ff=16384, vocab=257216,
    pattern=(("attention", "dense"),),
    kind="prefix_vlm", n_prefix=256,
    dtype="bfloat16", param_dtype="bfloat16", remat="full",
    notes="pure full attention; long_500k SKIPPED; MQA (kv=1)",
))
