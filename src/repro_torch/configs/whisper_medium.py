"""Whisper-medium [arXiv:2212.04356]: enc-dec; the conv audio frontend is a
stub (the caller gives precomputed frame embeddings, ``enc_embed``).
SwiGLU FFN in place of the original 2-proj MLP. Copy of
``repro/configs/whisper_medium.py``. The port scores and serves it
(``kind="encdec"``: the encoder and the decoder's cross-attention in
``models/transformer.py``, the decode's cross step in
``models/serving.py``)."""
from repro_torch.configs.base import register
from repro_torch.models.config import ArchConfig

CONFIG = register(ArchConfig(
    name="whisper-medium",
    n_layers=24, enc_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
    head_dim=64, d_ff=4096, vocab=51865,
    pattern=(("attention", "dense"),),
    kind="encdec",
    dtype="bfloat16", param_dtype="bfloat16", remat="full",
    notes="enc-dec; decode shapes RUN (decoder side); long_500k SKIPPED",
))
