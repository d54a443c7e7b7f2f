"""Architecture configuration — the port's own copy of
``repro/models/config.py`` (same fields, same derived properties), so the
port never imports the JAX package.

``pattern`` is a tuple of (mixer, ffn) pairs tiled across layers.
``mixer_override`` injects the paper's TNO variants as the token mixer of
any architecture.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

MIXERS = ("attention", "local", "mamba", "tno", "ski", "fd")
FFNS = ("dense", "moe", "none")


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0
    d_ff: int = 0
    vocab: int = 0
    # per-layer structure: tiled (mixer, ffn) pairs
    pattern: Tuple[Tuple[str, str], ...] = (("attention", "dense"),)
    kind: str = "decoder"           # decoder | encdec | prefix_vlm
    enc_layers: int = 0             # encdec only
    n_prefix: int = 0               # prefix_vlm stub patch count
    # attention details
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    window: int = 0                 # sliding window for "local" mixer
    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_impl: str = "capacity"
    moe_capacity_factor: float = 1.25
    # SSM (mamba2 / jamba)
    ssm_state: int = 0
    ssm_groups: int = 1
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    conv_width: int = 4
    ssd_chunk: int = 128
    # paper technique injection
    mixer_override: str = ""        # "" | tno | ski | fd
    tno_rank: int = 64
    tno_filter: int = 32
    tno_lam: float = 0.99
    tno_rpe_hidden: int = 64
    tno_rpe_layers: int = 3
    tno_rpe_act: str = "relu"
    # numerics / structure
    act: str = "silu"
    norm_eps: float = 1e-6
    dtype: str = "float32"          # activation/compute dtype
    param_dtype: str = "float32"
    vocab_pad_multiple: int = 256
    scan_layers: bool = True
    remat: str = "none"             # none | full | dots
    attn_chunk: int = 1024          # flash q-chunk
    loss_chunk: int = 2048          # CE seq-chunking (0 = off)
    unroll_inner: bool = False
    notes: str = ""

    # ------------------------------------------------------------ derived
    @property
    def vocab_padded(self) -> int:
        m = self.vocab_pad_multiple
        return ((self.vocab + m - 1) // m) * m

    @property
    def layers_spec(self):
        """Per-layer (mixer, ffn), honoring mixer_override for seq mixers."""
        out = []
        for i in range(self.n_layers):
            mixer, ffn = self.pattern[i % len(self.pattern)]
            if self.mixer_override and mixer in ("attention", "local"):
                mixer = self.mixer_override
            out.append((mixer, ffn))
        return tuple(out)

    @property
    def period(self) -> int:
        return len(self.pattern)

    @property
    def n_scan_blocks(self) -> int:
        """Layers the JAX package stacks into scanned blocks. The port runs
        layers in a Python loop; the bridge reads this to unstack them."""
        return self.n_layers // self.period if self.scan_layers else 0

    @property
    def n_tail_layers(self) -> int:
        return self.n_layers - self.n_scan_blocks * self.period

    @property
    def d_inner(self) -> int:  # ssm inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def param_count(self) -> dict:
        """Analytic parameter counts, as the JAX package counts them: the
        matrices of every layer and the two embeddings (norms, biases and
        the TNO mixers' RPEs are left out)."""
        d, f, v = self.d_model, self.d_ff, self.vocab_padded
        per_layer_total = 0
        per_layer_active = 0
        for mixer, ffn in self.layers_spec:
            p = 0
            if mixer in ("attention", "local"):
                p += d * (self.n_heads + 2 * self.n_kv_heads) * self.head_dim
                p += self.n_heads * self.head_dim * d
            elif mixer == "mamba":
                di, g, s = self.d_inner, self.ssm_groups, self.ssm_state
                h = self.ssm_heads
                p += d * (2 * di + 2 * g * s + h)      # in_proj
                p += self.conv_width * (di + 2 * g * s)  # conv
                p += di * d                             # out_proj
            elif mixer in ("tno", "ski", "fd"):
                p += 3 * d * d                          # GTU u/v/o
            a = p
            if ffn == "dense":
                p += 3 * d * f
                a = p
            elif ffn == "moe":
                p += d * self.n_experts                 # router
                p += self.n_experts * 3 * d * f
                a += d * self.n_experts + self.top_k * 3 * d * f
            else:
                a = p
            per_layer_total += p
            per_layer_active += a
        emb = 2 * v * d
        return {
            "total": per_layer_total + emb,
            "active": per_layer_active + emb,
            "embedding": emb,
        }
