"""Analytic per-kernel cost model: FLOP/byte estimators + roofline math,
counterpart of ``repro/obs/cost.py`` formula for formula.

Estimators are keyed off the SAME plan dicts the kernel layer receives
(:func:`repro_torch.core.ski.ski_plan` / :func:`repro_torch.core.tno.tno_plan`,
which keep the JAX package's keys), so "what should this op cost" and
"which kernel actually ran" cannot drift apart:

* :func:`cost_of_plan` — dispatch on a ski/tno plan dict → per-kernel
  :class:`Cost` map, keyed by the kernel regions of ``kernels/ops.py``'s
  dispatch names;
* family estimators — ``short_conv_cost``, ``interp_cost``, ``gram_cost``
  (dense/windowed/fft), ``fd_mul_cost``, ``fd_khat_grad_cost``,
  ``hilbert_window_cost``, ``rfft_cost``, ``ssd_cost``,
  ``attention_decode_cost``, ``mlp_cost``, ``lm_head_cost``;
* :func:`decode_step_cost` — one engine decode step (embed + every layer's
  mixer + FFN + LM head) as a per-family map, which
  :func:`repro_torch.obs.devstats.attribute_engine` uses to split measured
  engine seconds across kernel families;
* roofline: :func:`seconds` (compute and memory terms under a
  :class:`Peaks`), :func:`achieved_fraction` (roofline-implied time /
  measured time), and :func:`flop_cost`, the counterpart of JAX's
  ``xla_cost`` (``jit(...).lower().compile().cost_analysis()``): XLA does
  not exist here, so it counts FLOPs with
  ``torch.utils.flop_counter.FlopCounterMode``, which counts no bytes.

**Peaks.** ``peaks("gpu")`` reads NVIDIA's published data-sheet figures
for the card by the name ``torch.cuda.get_device_name`` gives
(:data:`GPU_PEAKS`; dense rates, no sparsity), and the FLOP rate follows
the dtype the work runs in: float32 takes the CUDA cores' rate, since the
port keeps TF32 off for its fp32 tier; bfloat16/float16 take the tensor
cores'. A card that is not in the table raises: there is no ballpark. The
CPU keeps the JAX package's conservative defaults and their
``REPRO_CPU_PEAK_FLOPS`` / ``REPRO_CPU_PEAK_BW`` overrides; there the
fractions rank kernels, they are not device claims.

Estimates are *models*, not measurements: they count the algorithmic
multiply-adds and the unavoidable main-memory traffic of each family.
"""
from __future__ import annotations

import dataclasses
import math
import os
from typing import Dict, Optional, Tuple

_ENV_CPU_FLOPS = "REPRO_CPU_PEAK_FLOPS"
_ENV_CPU_BW = "REPRO_CPU_PEAK_BW"

#: NVIDIA data-sheet peaks by the name the card reports, as (device memory
#: bytes/s, dense FLOP/s in fp32 outside the tensor cores, TF32 and bf16 on
#: them, without sparsity); "H100" alone is the SXM part, so the longer
#: names are matched first (the table's order)
GPU_PEAKS: Dict[str, Tuple[float, float, float, float]] = {
    "H100 PCIe": (2.0e12, 51e12, 378e12, 756e12),
    "H100 NVL": (3.9e12, 60e12, 417.5e12, 835.5e12),
    "H100": (3.35e12, 67e12, 495e12, 989e12)}


@dataclasses.dataclass(frozen=True)
class Cost:
    """Algorithmic work of one kernel launch: floating-point operations
    and bytes moved to/from main memory (inputs + outputs, once each)."""
    flops: float
    bytes: float

    def __add__(self, other: "Cost") -> "Cost":
        return Cost(self.flops + other.flops, self.bytes + other.bytes)

    def scale(self, k: float) -> "Cost":
        return Cost(self.flops * k, self.bytes * k)


@dataclasses.dataclass(frozen=True)
class Peaks:
    """Per-device roofline ceilings (FLOP/s, memory B/s, interconnect
    B/s). ``collective_bw=0`` means no interconnect term."""
    flops: float
    mem_bw: float
    collective_bw: float = 0.0


def _env_float(name: str, default: float) -> float:
    v = os.environ.get(name)
    if v is None or v == "":
        return default
    try:
        return float(v)
    except ValueError:
        raise ValueError(f"{name}={v!r} is not a number") from None


def gpu_peaks(name: str) -> Tuple[str, Tuple[float, float, float, float]]:
    """(table key, (bytes/s, fp32, TF32, bf16 FLOP/s)) of the card called
    ``name``; raises for a card the table does not hold."""
    for key, val in GPU_PEAKS.items():
        if key in name:
            return key, val
    raise RuntimeError(f"no published peaks for {name!r} (known: "
                       f"{', '.join(GPU_PEAKS)})")


def _is_half(dtype) -> bool:
    import torch
    if isinstance(dtype, str):
        dtype = getattr(torch, dtype)
    if dtype in (torch.bfloat16, torch.float16):
        return True
    if dtype in (None, torch.float32):
        return False
    raise ValueError(f"no peak FLOP rate for dtype {dtype}")


def peaks(platform: Optional[str] = None, *, dtype=None,
          name: Optional[str] = None) -> Peaks:
    """Roofline ceilings for a platform (default: "gpu" when a CUDA card
    is present, else "cpu"). "gpu": the data-sheet figures of the card
    ``name`` (default ``torch.cuda.get_device_name()``), at the FLOP rate
    of ``dtype`` (float32 by default, on the CUDA cores; bf16/fp16 on the
    tensor cores). "cpu": a conservative laptop-class estimate,
    overridable by ``REPRO_CPU_PEAK_FLOPS`` / ``REPRO_CPU_PEAK_BW``."""
    if platform is None:
        import torch
        platform = "gpu" if torch.cuda.is_available() else "cpu"
    if platform == "gpu":
        if name is None:
            import torch
            name = torch.cuda.get_device_name()
        _, (bw, fp32, _tf32, bf16) = gpu_peaks(name)
        return Peaks(bf16 if _is_half(dtype) else fp32, bw, 0.0)
    if platform == "cpu":
        return Peaks(_env_float(_ENV_CPU_FLOPS, 5e10),
                     _env_float(_ENV_CPU_BW, 2e10), 0.0)
    raise ValueError(f"unknown platform {platform!r} (want gpu|cpu)")


def dtype_bytes(dtype) -> int:
    """Bytes of one element of a torch dtype (or its name)."""
    import torch
    if isinstance(dtype, str):
        dtype = getattr(torch, dtype)
    return torch.empty((), dtype=dtype).element_size()


def fft_flops(n: int) -> float:
    """Real-input FFT of length n: ~2.5·n·log2(n) (split-radix real
    transform; the standard roofline convention)."""
    return 2.5 * n * math.log2(max(n, 2))


# -------------------------------------------------- per-family estimators
def short_conv_cost(n: int, m: int, d: int, batch: int = 1,
                    elem: int = 4) -> Cost:
    """Depthwise m-tap conv over (b, n, d): one multiply-add per tap."""
    return Cost(2.0 * batch * n * m * d,
                elem * (2.0 * batch * n * d + d * m))


def interp_cost(n: int, r: int, d: int, batch: int = 1,
                elem: int = 4) -> Cost:
    """One hat-interpolation pass (reduce z=Wᵀx or expand y=Wz): two
    taps per position, multiply-add each."""
    return Cost(4.0 * batch * n * d,
                elem * (batch * n * d + batch * r * d) + 8.0 * n)


def gram_cost(variant: str, r: int, d: int, batch: int = 1,
              elem: int = 4, bw: Optional[int] = None) -> Cost:
    """Applying the r×r inducing Gram per channel: dense matvec,
    banded (width bw) matvec, or circulant FFT matvec (length 2r)."""
    if variant == "dense":
        return Cost(2.0 * batch * d * r * r,
                    elem * (d * r * r + 2.0 * batch * r * d))
    if variant == "windowed":
        if bw is None:
            from repro_torch.kernels import backend
            bw = min(backend.band_budget(), r)
        return Cost(2.0 * batch * d * r * bw,
                    elem * (d * (2 * r - 1) + 2.0 * batch * r * d))
    if variant == "fft":
        n2 = 2 * r
        per_ch = 2 * fft_flops(n2) + 6.0 * n2     # fwd+inv FFT + pointwise
        return Cost(batch * d * per_ch,
                    elem * (d * (2 * r - 1) + 2.0 * batch * r * d))
    raise ValueError(f"unknown gram variant {variant!r} "
                     "(want dense|windowed|fft)")


def rfft_cost(n: int, d: int, batch: int = 1, elem: int = 4) -> Cost:
    """One real FFT (or inverse) of length n per (batch, channel)."""
    return Cost(batch * d * fft_flops(n),
                elem * 2.0 * batch * n * d)


def fd_mul_cost(n_f: int, d: int, batch: int = 1, elem: int = 4) -> Cost:
    """Pointwise complex spectral multiply over n_f frequency bins:
    6 real flops per complex multiply."""
    return Cost(6.0 * batch * n_f * d,
                elem * (4.0 * batch * n_f * d + 2.0 * n_f * d))


def fd_khat_grad_cost(n_f: int, d: int, batch: int = 1,
                      elem: int = 4) -> Cost:
    """Backward khat reduction: conjugated multiply + batch-sum."""
    return Cost(8.0 * batch * n_f * d,
                elem * (4.0 * batch * n_f * d + 2.0 * n_f * d))


def hilbert_window_cost(n: int, d: int, elem: int = 4) -> Cost:
    """Causal (analytic-signal) lag window over the (d, n) response."""
    return Cost(4.0 * d * n, elem * 2.0 * d * n)


def ssd_cost(n: int, d_inner: int, state: int, batch: int = 1,
             elem: int = 4) -> Cost:
    """Selective state-space scan: per token, a (d_inner × state) update
    and readout (~6 flops per element)."""
    return Cost(6.0 * batch * n * d_inner * state,
                elem * (2.0 * batch * n * d_inner
                        + batch * d_inner * state))


def attention_decode_cost(n_ctx: int, heads: int, head_dim: int,
                          batch: int = 1, elem: int = 4) -> Cost:
    """One decode step against an n_ctx KV cache: QK^T + AV."""
    return Cost(4.0 * batch * heads * n_ctx * head_dim,
                elem * 2.0 * batch * n_ctx * heads * head_dim)


def mlp_cost(d_model: int, d_ff: int, batch: int = 1, tokens: int = 1,
             elem: int = 4) -> Cost:
    """Gated FFN: up + gate + down projections per token."""
    t = batch * tokens
    return Cost(2.0 * t * d_model * d_ff * 3,
                elem * (3.0 * d_model * d_ff + 2.0 * t * d_model))


def lm_head_cost(d_model: int, vocab: int, batch: int = 1,
                 elem: int = 4) -> Cost:
    return Cost(2.0 * batch * d_model * vocab,
                elem * (d_model * vocab + batch * (d_model + vocab)))


# -------------------------------------------------------- plan dispatch
def ski_plan_cost(plan: dict, n: int, d: int, batch: int = 1,
                  elem: int = 4, m: int = 4) -> Dict[str, Cost]:
    """Per-kernel cost of one fused SKI-TNO forward under ``plan``
    (:func:`repro_torch.core.ski.ski_plan`): pass-1 reduce, the Gram apply
    in the plan's variant, pass-2 expand, and the m-tap sparse correction.
    The dense variant's Gram+expand+conv run as one ``ski_fused`` launch;
    windowed/fft split into ``ski_windowed``/``ski_fft_gram`` + the
    Gram-free ``ski_expand2``."""
    r = int(plan["r"])
    variant = plan.get("variant", "dense" if "a_dense" in plan
                       else "unfused")
    reduce_c = interp_cost(n, r, d, batch, elem)
    expand_c = interp_cost(n, r, d, batch, elem)
    conv_c = short_conv_cost(n, m, d, batch, elem)
    if variant in ("dense", "unfused"):
        return {"interp_reduce": reduce_c,
                "ski_fused": gram_cost("dense", r, d, batch, elem)
                + expand_c + conv_c}
    if variant == "windowed":
        return {"interp_reduce": reduce_c,
                "ski_windowed": gram_cost("windowed", r, d, batch, elem),
                "ski_expand2": expand_c + conv_c}
    if variant == "fft":
        return {"interp_reduce": reduce_c,
                "ski_fft_gram": gram_cost("fft", r, d, batch, elem),
                "ski_expand2": expand_c + conv_c}
    raise ValueError(f"ski plan with unknown variant {variant!r}")


def fd_plan_cost(plan: dict, n: int, d: int, batch: int = 1,
                 elem: int = 4) -> Dict[str, Cost]:
    """Per-kernel cost of one causal/acausal FD-TNO forward under a
    :func:`repro_torch.core.tno.tno_plan` fd plan: x rfft + spectral
    multiply + irfft, plus (causal plans, ``khat_real``) the Hilbert
    completion of the real response."""
    n_f = n + 1                       # rfft bins of the length-2n embed
    out = {"rfft": rfft_cost(2 * n, d, batch, elem).scale(2.0),
           "fd_mul": fd_mul_cost(n_f, d, batch, elem)}
    if "khat_real" in plan:
        out["hilbert_window"] = hilbert_window_cost(n, d, elem)
    return out


def cost_of_plan(plan: dict, *, n: int, d: int, batch: int = 1,
                 dtype=None, m: int = 4) -> Dict[str, Cost]:
    """Dispatch on the SAME plan dicts the kernel layer receives:

    * ski plan (``{"variant", "r", ...}``) → :func:`ski_plan_cost`;
    * fd plan (``{"khat"}`` / ``{"khat_real"}``) → :func:`fd_plan_cost`;
    * baseline tno plan (``{"coef"}``) → circulant Toeplitz matvec.
    """
    elem = 4 if dtype is None else dtype_bytes(dtype)
    if "variant" in plan or "a_dense" in plan:
        return ski_plan_cost(plan, n, d, batch, elem, m)
    if "khat" in plan or "khat_real" in plan:
        return fd_plan_cost(plan, n, d, batch, elem)
    if "coef" in plan:
        # dense Toeplitz matvec via length-2n circular embedding
        return {"toeplitz_fft": rfft_cost(2 * n, d, batch, elem).scale(3.0)
                + fd_mul_cost(n + 1, d, batch, elem)}
    raise ValueError(
        f"unrecognised plan keys {sorted(plan)}: want a ski plan "
        "(variant/a_dense), an fd plan (khat/khat_real), or a baseline "
        "plan (coef)")


def decode_step_cost(cfg, batch: int, max_len: int,
                     dtype=None) -> Dict[str, Cost]:
    """One engine decode step (S=batch slots, one token each) against a
    ``max_len`` cache, split per kernel family — the analytic share map
    :func:`repro_torch.obs.devstats.attribute_engine` projects measured
    engine seconds onto. Mixer families follow ``cfg.layers_spec`` (the
    same per-layer table the model builds from). The attention head width
    is the JAX model's ``d // n_heads``, also where a config sets
    ``head_dim``: this is the reference's model, held to it."""
    elem = 4 if dtype is None else dtype_bytes(dtype)
    d = cfg.d_model
    out: Dict[str, Cost] = {}

    def add(key: str, c: Cost):
        out[key] = out.get(key, Cost(0.0, 0.0)) + c

    add("embed", Cost(0.0, elem * float(batch * d)))
    c_blk = None
    for mixer, _ffn in cfg.layers_spec:
        if mixer == "fd":
            # streaming decode: O(C·d) ring head per token, spectra
            # refresh amortised over C steps (one block rfft + multiply)
            if c_blk is None:
                from repro_torch.kernels import backend
                c_blk = backend.fd_stream_block()
            head = short_conv_cost(1, c_blk, d, batch, elem)
            refresh = (rfft_cost(2 * c_blk, d, batch, elem)
                       + fd_mul_cost(c_blk + 1, d, batch, elem)
                       ).scale(1.0 / c_blk)
            add("fd_stream", head + refresh)
        elif mixer in ("tno", "ski"):
            # hist-replay decode: the full Toeplitz row against max_len
            add("tno_hist", Cost(2.0 * batch * max_len * d,
                                 elem * batch * max_len * d))
        elif mixer in ("attention", "local"):
            heads = max(getattr(cfg, "n_heads", 1), 1)
            hd = max(d // heads, 1)
            n_ctx = (min(max_len, cfg.window) if mixer == "local"
                     and cfg.window else max_len)
            add("attention", attention_decode_cost(
                n_ctx, heads, hd, batch, elem))
        elif mixer == "mamba":
            add("ssd", ssd_cost(1, cfg.d_inner,
                                getattr(cfg, "ssm_state", 16), batch, elem))
        else:
            add(mixer or "mixer", Cost(2.0 * batch * d, elem * batch * d))
        add("mixer_proj", Cost(2.0 * batch * d * d * 2,
                               elem * 2.0 * d * d))
        add("mlp", mlp_cost(d, cfg.d_ff, batch, 1, elem))
    add("lm_head", lm_head_cost(d, cfg.vocab_padded, batch, elem))
    return out


def total(costs: Dict[str, Cost]) -> Cost:
    t = Cost(0.0, 0.0)
    for c in costs.values():
        t = t + c
    return t


# ------------------------------------------------------------- roofline
def seconds(cost: Cost, pk: Optional[Peaks] = None) -> dict:
    """Roofline-implied times for one launch: compute and memory terms,
    the binding one, and its name."""
    pk = pk or peaks()
    t_comp = cost.flops / max(pk.flops, 1.0)
    t_mem = cost.bytes / max(pk.mem_bw, 1.0)
    t_star = max(t_comp, t_mem)
    return {"compute_s": t_comp, "memory_s": t_mem, "bound_s": t_star,
            "dominant": "compute" if t_comp >= t_mem else "memory"}


def achieved_fraction(cost: Cost, measured_s: float,
                      pk: Optional[Peaks] = None) -> float:
    """Fraction of the roofline bound achieved: (time the dominant
    roofline term implies) / (measured time). 1.0 = at the roof; small
    values mean the kernel leaves the machine idle (launch overhead,
    bad tiling, host-bound enqueue)."""
    if measured_s <= 0:
        return float("nan")
    return seconds(cost, pk)["bound_s"] / measured_s


# --------------------------------------------------- FLOP counter check
def flop_cost(fn, *args, **kwargs) -> dict:
    """FLOPs of one call of ``fn(*args, **kwargs)`` as PyTorch's
    ``FlopCounterMode`` counts them (the operators it has formulas for:
    matmuls, convolutions, attention), reduced to ``{"flops": f, "raw":
    {operator: flops}}``. The counterpart of the JAX package's
    ``xla_cost`` (XLA's ``cost_analysis()``), which the estimators are
    held against; unlike it, this counts no bytes, so there is no
    ``"bytes"`` key."""
    from torch.utils.flop_counter import FlopCounterMode
    counter = FlopCounterMode(display=False)
    with counter:
        fn(*args, **kwargs)
    raw = {str(op): float(n)
           for op, n in counter.get_flop_counts().get("Global", {}).items()}
    return {"flops": float(counter.get_total_flops()), "raw": raw}


__all__ = [
    "Cost", "Peaks", "GPU_PEAKS", "gpu_peaks", "peaks", "dtype_bytes",
    "fft_flops",
    "short_conv_cost", "interp_cost", "gram_cost", "rfft_cost",
    "fd_mul_cost", "fd_khat_grad_cost", "hilbert_window_cost",
    "ssd_cost", "attention_decode_cost", "mlp_cost", "lm_head_cost",
    "ski_plan_cost", "fd_plan_cost", "cost_of_plan", "decode_step_cost",
    "total", "seconds", "achieved_fraction", "flop_cost",
]
