"""Primitive NN layers: dense, norms, the scalar MLP.

Weights keep the JAX package's ``(d_in, d_out)`` layout with ``y = x @ w``,
so the bridge copies every leaf as it is. The modules are parameter
containers (named like the JAX leaves) that the plain functions read;
constructors allocate (``device="meta"`` allocates nothing) and
``reset_parameters(generator)`` draws the values, as ``repro/nn/params.py``
does: lecun truncated normal for weights, zeros for biases, ones for norm
scales. Each module records its parameters' logical axes as the JAX
package boxes them (``nn/params.set_axes``); :func:`dense` and
:func:`rmsnorm` gather a weight sharded over the data axes at use
(``nn/params.gathered``, a no-op on a plain tensor).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.nn.params import gathered, set_axes

ACTS = {
    "relu": F.relu,
    # jax.nn.gelu defaults to the tanh approximation
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "silu": F.silu,
    "sigmoid": torch.sigmoid,
    "none": lambda x: x,
}


def draw_buffer(shape, generator: torch.Generator) -> torch.Tensor:
    """An empty fp32 tensor for a draw from ``generator``, on the
    generator's device: a CPU generator draws on the host whatever the
    parameter's device (so a seed gives the same model on every device),
    a CUDA generator on its card (no host copy of the leaf; other values
    than the CPU's for the same seed)."""
    return torch.empty(shape, dtype=torch.float32, device=generator.device)


def lecun_normal_(w: torch.Tensor, generator: torch.Generator,
                  scale: float = 1.0) -> torch.Tensor:
    """scale/sqrt(fan_in) · N(0, 1) truncated to [-2, 2], fan_in the
    product of all but the last dim (``repro/nn/params.boxed``, "lecun").
    Drawn from ``generator`` (:func:`draw_buffer`) and copied into
    ``w``."""
    fan_in = math.prod(w.shape[:-1]) if w.dim() >= 2 else w.shape[0]
    v = draw_buffer(w.shape, generator)
    nn.init.trunc_normal_(v, 0.0, 1.0, -2.0, 2.0, generator=generator)
    with torch.no_grad():
        w.copy_(v.mul_(scale / math.sqrt(max(fan_in, 1))))
    return w


def cast_params(model: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Cast every floating-point parameter (and buffer) of ``model`` to
    ``dtype`` in place and return the model: the counterpart of
    ``repro/nn/layers.cast_params``, the mixed-precision helper of the
    kernel training path (activations and parameters in bf16, the SKI
    kernels summing in fp32). Integer tensors keep their dtype."""
    return model.to(dtype=dtype)


# ---------------------------------------------------------------- dense
def dense(w: torch.Tensor, x: torch.Tensor, b: torch.Tensor | None = None):
    """x @ w (+ b) in the dtype JAX's ``x @ w`` promotes to: bf16 × bf16
    stays bf16, fp32 × bf16 computes in fp32 (torch's matmul refuses mixed
    dtypes, so the narrower operand is widened first, exactly)."""
    w = gathered(w)
    dt = torch.promote_types(x.dtype, w.dtype)
    y = x.to(dt) @ w.to(dt)
    if b is not None:
        y = y + gathered(b).to(y.dtype)
    return y


class Dense(nn.Module):
    def __init__(self, d_in: int, d_out: int, *, use_bias: bool = False,
                 axes=("embed", "mlp"), device=None):
        super().__init__()
        self.w = nn.Parameter(torch.empty(d_in, d_out, device=device))
        self.b = (nn.Parameter(torch.empty(d_out, device=device))
                  if use_bias else None)
        set_axes(self, w=axes, b=axes[-1:])

    def reset_parameters(self, generator: torch.Generator) -> None:
        lecun_normal_(self.w, generator)
        if self.b is not None:
            nn.init.zeros_(self.b)


# ---------------------------------------------------------------- norms
def rmsnorm(scale: torch.Tensor, x: torch.Tensor, eps: float = 1e-6):
    dt = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps)
    return (y * gathered(scale).float()).to(dt)


def layernorm(scale: torch.Tensor, bias: torch.Tensor, x: torch.Tensor,
              eps: float = 1e-5):
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(dt)


class RMSNorm(nn.Module):
    def __init__(self, d: int, device=None):
        super().__init__()
        self.scale = nn.Parameter(torch.empty(d, device=device))
        set_axes(self, scale=("embed",))

    def reset_parameters(self, generator=None) -> None:
        nn.init.ones_(self.scale)


class LayerNorm(nn.Module):
    def __init__(self, d: int, axes=("embed",), device=None):
        super().__init__()
        self.scale = nn.Parameter(torch.empty(d, device=device))
        self.bias = nn.Parameter(torch.empty(d, device=device))
        set_axes(self, scale=axes, bias=axes)

    def reset_parameters(self, generator=None) -> None:
        nn.init.ones_(self.scale)
        nn.init.zeros_(self.bias)


# ---------------------------------------------------------------- scalar MLP
class MLPLayer(Dense):
    """One MLP layer: dense with bias, plus an optional layernorm (``ln``)
    applied before the activation — the JAX leaf layout {w, b, ln}."""

    def __init__(self, d_in: int, d_out: int, *, use_layernorm: bool,
                 axes=("embed", "mlp"), device=None):
        super().__init__(d_in, d_out, use_bias=True, axes=axes,
                         device=device)
        self.ln = (LayerNorm(d_out, axes=axes[-1:], device=device)
                   if use_layernorm else None)


class MLP(nn.Module):
    def __init__(self, layers):
        super().__init__()
        self.layers = nn.ModuleList(layers)


def mlp_init(d_in, d_hidden, d_out, n_layers, *, use_layernorm=True,
             device=None) -> MLP:
    """n_layers >= 1 linear layers with activations between (none on
    output); a layernorm after every hidden layer when ``use_layernorm``.
    Axes as JAX's: the hidden dims ``"rpe_hidden"``, the output dim
    ``"tno_channel"`` (the MLP is the TNN mixer's RPE)."""
    dims = [d_in] + [d_hidden] * (n_layers - 1) + [d_out]

    def axes(i):
        return ("rpe_hidden" if i > 0 else None,
                "rpe_hidden" if i < n_layers - 1 else "tno_channel")
    return MLP([MLPLayer(dims[i], dims[i + 1],
                         use_layernorm=use_layernorm and i < n_layers - 1,
                         axes=axes(i), device=device)
                for i in range(n_layers)])


def mlp_apply(p: MLP, x, act="relu"):
    """x: (..., d_in) -> (..., d_out)."""
    f = ACTS[act]
    n = len(p.layers)
    for i, lp in enumerate(p.layers):
        x = dense(lp.w, x, lp.b)
        if i < n - 1:
            if lp.ln is not None:
                x = layernorm(lp.ln.scale, lp.ln.bias, x)
            x = f(x)
    return x


def reset_parameters(module: nn.Module, generator: torch.Generator) -> None:
    """Draw every parameter of ``module`` in module order."""
    for m in module.modules():
        if hasattr(m, "reset_parameters"):
            m.reset_parameters(generator)
