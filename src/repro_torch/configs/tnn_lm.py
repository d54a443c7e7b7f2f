"""The paper's own architecture: TNN causal LM (Qin et al. 2023 config:
6 decoder layers, d=512) with the token mixer selectable between baseline
TNO / SKI-TNO / FD-TNO. GTU+GLU realised as mixer+ffn. Copy of
``repro/configs/tnn_lm.py``. The port scores, trains and serves the
baseline ``tno`` (hist-replay decode) and the ``fd`` mixer (streaming
decode), and scores and trains the ``ski`` mixer (no decode, as in the
JAX package)."""
import dataclasses

from repro_torch.configs.base import register
from repro_torch.models.config import ArchConfig

CONFIG = register(ArchConfig(
    name="tnn-lm-wt103",
    n_layers=6, d_model=512, d_ff=1024, vocab=50265,
    pattern=(("tno", "dense"),),
    tno_rpe_layers=3, tno_rpe_hidden=64, tno_lam=0.99,
    dtype="float32", param_dtype="float32",
    notes="paper's arch; variants: mixer_override('', tno->ski/fd)",
))

FD = register(dataclasses.replace(CONFIG, name="fd-tnn-lm-wt103",
                                  pattern=(("fd", "dense"),)))
SKI = register(dataclasses.replace(CONFIG, name="ski-tnn-lm-wt103",
                                   pattern=(("ski", "dense"),)))
