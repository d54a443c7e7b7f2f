"""Mamba2-2.7B [arXiv:2405.21060]: attention-free SSD, 64L, d_state=128.
Copy of ``repro/configs/mamba2_2p7b.py``. The port serves and scores it
(``launch/serve.py``, ``launch/steps.make_forward``); training it is not
ported yet (ROADMAP Queue 1)."""
from repro_torch.configs.base import register
from repro_torch.models.config import ArchConfig

CONFIG = register(ArchConfig(
    name="mamba2-2.7b",
    n_layers=64, d_model=2560, vocab=50280,
    pattern=(("mamba", "none"),),
    ssm_state=128, ssm_groups=1, ssm_head_dim=64, ssm_expand=2, conv_width=4,
    dtype="bfloat16", param_dtype="bfloat16", remat="full",
    notes="SSM; long_500k RUNS",
))
