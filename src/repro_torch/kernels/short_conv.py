"""Depthwise short 1-D convolution, the sparse Toeplitz part of SKI (paper
§3.2), with the hand-written CUDA kernel of ``csrc/short_conv.cu``,
counterpart of ``repro/kernels/short_conv.py`` (replaces the Pallas
``_kernel`` / ``_short_conv_call``):

    y[b, j, c] = Σ_{k<m} f[c, k] · x[b, j-k+left, c],   x zero outside [0, n)

The tap offset ``left`` ∈ [0, m-1] is an argument: 0 is causal, m//2
bidirectional. :func:`short_conv` is the kernel-level wrapper: the plain
version (``ref.short_conv_left_ref``) for a CPU tensor, the kernel for a
CUDA tensor, counting the launch in :data:`counters`; another device,
dtype or layout raises, and on the card it refuses an input that requires
grad while grad is enabled (the kernel writes a tensor autograd cannot
see). Every n >= 1 runs in the kernel, n < m included: the TPU wrapper's
plain fallback for small n has no counterpart.

:class:`ShortConv` is the differentiable op, with the structure of the
JAX custom VJP (``short_conv.py:96-123``): residuals (x, f) only, and a
backward of kernel launches::

    dx = short_conv(g, f flipped, m-1-left)    the same kernel
    df = conv_tap_grad(g, x, m, left)          csrc/ski_grad.cu

It runs on both devices (on the CPU over the plain versions), and
:data:`op_counters` counts its differentiated forwards and which backward
ran; ``REPRO_PALLAS_GRAD=0`` keeps the kernel forward and returns
autograd's cotangents through ``ref.short_conv_left_ref`` instead.
On the card x and the taps are both fp32 or both bf16 (Mamba's conv): the
sum runs in fp32 and a bf16 y is rounded once, as in the plain version.
The backward runs in the same dtype: dx is the same kernel's instance,
and df the ``conv_tap_grad`` instance of that dtype (fp32 sums, cast to
the taps' dtype, as JAX's ``_short_conv_core_bwd`` casts them).
"""
from __future__ import annotations

import ctypes
import functools

import torch
from torch.autograd.function import once_differentiable

from repro_torch.kernels import backend, ref
from repro_torch.kernels.interp_matvec import forward_only
from repro_torch.kernels.ski_grad import conv_tap_grad

#: kernel launches (CUDA path only; the CPU path counts nothing)
counters = {"short_conv": 0}
#: differentiated :func:`short_conv_op` forwards (grad enabled and an input
#: that requires grad) and :class:`ShortConv` backwards: the kernel
#: backward, or autograd through the plain version
op_counters = {"fwd": 0, "bwd_kernel": 0, "bwd_ref": 0}

#: shared memory a block may use on Hopper (227 KB)
_MAX_SMEM = 232448
#: the kernel's entry point for each element type it takes
_ENTRIES = {torch.float32: "short_conv_f32", torch.bfloat16: "short_conv_bf16"}


def reset_counters() -> None:
    for d in (counters, op_counters):
        for k in d:
            d[k] = 0


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = backend.library("short_conv")
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    for fn in (lib.short_conv_f32, lib.short_conv_bf16):
        fn.argtypes = [p, p, p, i64, i64, i64, i64, i64, p]
        fn.restype = ctypes.c_int
    lib.short_conv_smem_bytes.argtypes = [i64]
    lib.short_conv_smem_bytes.restype = i64
    return lib


def short_conv(x: torch.Tensor, filt: torch.Tensor,
               left: int) -> torch.Tensor:
    """y[b,j,c] = Σ_k f[c,k] · x[b, j-k+left, c]: x (b, n, d), filt
    (d, m), 0 <= left < m → (b, n, d) in x's dtype. Forward-only on the
    card, where x and filt are both fp32 or both bf16.
    CPU: :func:`ref.short_conv_left_ref`."""
    m = filt.shape[-1]
    if not 0 <= left < m:
        raise ValueError(f"short_conv: left={left} outside [0, m={m})")
    if x.device.type == "cpu" and filt.device.type == "cpu":
        return ref.short_conv_left_ref(x, filt, left)
    forward_only("short_conv", x, filt)
    if x.dtype not in _ENTRIES or filt.dtype != x.dtype:
        raise TypeError(f"short_conv: x {x.dtype} and taps {filt.dtype}; the "
                        "kernel takes both fp32 or both bf16")
    backend.require_cuda(x, "short_conv x", x.dtype)
    backend.require_cuda(filt, "short_conv taps", x.dtype)
    if (x.dim() != 3 or x.numel() == 0 or filt.dim() != 2
            or filt.shape[0] != x.shape[2] or filt.device != x.device):
        raise ValueError(f"short_conv: x {tuple(x.shape)} on {x.device} and "
                         f"taps {tuple(filt.shape)} on {filt.device} are "
                         "not a non-empty (b, n, d) and (d, m) on one device")
    b, n, d = x.shape
    lib = _lib()
    smem = lib.short_conv_smem_bytes(m)
    if smem > _MAX_SMEM:
        raise ValueError(f"short_conv: m={m} needs {smem} bytes of shared "
                         f"memory a block, over {_MAX_SMEM}")
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        rc = getattr(lib, _ENTRIES[x.dtype])(x.data_ptr(), filt.data_ptr(),
                                 y.data_ptr(), b, n, d, m, left,
                                 backend.stream(x))
    backend.check(lib, rc, f"short_conv (b={b}, n={n}, d={d}, m={m})")
    counters["short_conv"] += 1
    return y


class ShortConv(torch.autograd.Function):
    """The short conv with the kernel backward of the module docstring.
    x (b, n, d); filt (d, m); ``left`` the tap offset."""

    @staticmethod
    def forward(ctx, x, filt, left):
        ctx.save_for_backward(x, filt)
        ctx.left = left
        return short_conv(x, filt, left)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, filt = ctx.saved_tensors
        left, m = ctx.left, filt.shape[-1]
        if not backend.resolve_pallas_grad():
            op_counters["bwd_ref"] += 1
            dx, df = backend.ref_cotangents(ref.short_conv_left_ref,
                                            (x, filt), g, left)
            return dx, df, None
        op_counters["bwd_kernel"] += 1
        # the kernels read raw memory: contiguous copies, never lazy views
        g = g.contiguous()
        dx = short_conv(g, filt.flip(-1).contiguous(), m - 1 - left)
        df = conv_tap_grad(g, x, m, left)
        return dx.to(x.dtype), df.to(filt.dtype), None


def short_conv_op(x: torch.Tensor, filt: torch.Tensor,
                  left: int) -> torch.Tensor:
    """The short conv, differentiable in (x, filt) through
    :class:`ShortConv` on both devices."""
    if torch.is_grad_enabled() and (x.requires_grad or filt.requires_grad):
        op_counters["fwd"] += 1
    return ShortConv.apply(x, filt, left)
