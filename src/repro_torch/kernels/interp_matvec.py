"""SKI's interpolation pair (paper §3.2.1) with the hand-written CUDA
kernels of ``csrc/ski.cu``, counterpart of ``repro/kernels/interp_matvec.py``:

* :func:`interp_reduce` — z = Wᵀx, (b, n, d) → (b, r, d) (replaces the
  Pallas ``_reduce_kernel`` / ``_reduce_call``);
* :func:`interp_expand` — y = W z, (b, r, d) → (b, n, d) (replaces
  ``_expand_kernel`` / ``_expand_call``).

Because the inducing points are uniform, W is the hat function
max(0, 1 - |i/h - j|) with h = (n-1)/(r-1); both kernels regenerate its
clamped two-tap rows from (n, r), bit for bit the plain versions' weights,
and read no weights, so they are exact adjoints of each other. Each
wrapper takes the plain version (``ref.interp_reduce_ref``,
``ref.interp_expand_ref``, the dense hat contractions) for a CPU tensor
and launches its kernel for a CUDA tensor, counting the launch in
:data:`counters` under the instance's name; another device, dtype or
layout raises. Both take their input fp32 or bf16: the bf16 instances
(``interp_reduce_bf16``, ``interp_expand_bf16``) sum in fp32 and round the
output once to bf16, as the plain versions round it. On the card a kernel
writes a tensor that autograd cannot see, so a wrapper called on its own
refuses an input that requires grad while grad is enabled.

The differentiable forms are :class:`InterpReduce` and
:class:`InterpExpand` (``ops.interp_reduce``, ``ops.interp_expand``), as
the JAX custom VJPs: W has no parameters, so each is residual-free and
its backward is one launch of the other kernel. Both run on both devices
(on the CPU over the plain versions); :data:`reduce_op_counters` and
:data:`expand_op_counters` count their differentiated forwards and which
backward ran, and ``REPRO_PALLAS_GRAD=0`` returns autograd's cotangents
through the plain version instead. ``SKIFusedTNO`` calls the kernel-level
:func:`interp_reduce` itself, so the fused path counts no Function here.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from repro_torch.kernels import backend, ref
from repro_torch.obs.devstats import kernel_region

#: kernel launches (CUDA path only; the CPU path counts nothing)
counters = {"interp_reduce": 0, "interp_reduce_bf16": 0, "interp_expand": 0,
            "interp_expand_bf16": 0}
#: interp_reduce's and interp_expand's (entry point, launch counter) for
#: each element type
_REDUCE_ENTRIES = {torch.float32: ("interp_reduce_f32", "interp_reduce"),
                   torch.bfloat16: ("interp_reduce_bf16",
                                    "interp_reduce_bf16")}
_EXPAND_ENTRIES = {torch.float32: ("interp_expand_f32", "interp_expand"),
                   torch.bfloat16: ("interp_expand_bf16",
                                    "interp_expand_bf16")}
#: differentiated forwards (grad enabled and an input that requires grad)
#: and backwards (the kernel, or autograd through the plain version) of
#: :class:`InterpReduce` and of :class:`InterpExpand`
reduce_op_counters = {"fwd": 0, "bwd_kernel": 0, "bwd_ref": 0}
expand_op_counters = {"fwd": 0, "bwd_kernel": 0, "bwd_ref": 0}


def reset_counters() -> None:
    for d in (counters, reduce_op_counters, expand_op_counters):
        for k in d:
            d[k] = 0


def forward_only(what: str, *ts: torch.Tensor) -> None:
    """Raise for a CUDA call whose output autograd would lose: grad enabled
    and an input that requires grad."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        raise NotImplementedError(
            f"{what}: the CUDA kernel on its own is forward-only; "
            "differentiate through the ops entry (ops.ski_fused_tno, "
            "ops.short_conv, ops.interp_reduce, ops.interp_expand), whose "
            "backward runs the kernels, or call it under torch.no_grad()")


def hat_spacing(n: int, r: int) -> tuple[float, float]:
    """(h, float32(h)) of n positions on r inducing points, as the kernels
    take them (the fp32 value is the divisor of the hat weights)."""
    if n < 2 or not 2 <= r <= n:
        raise ValueError(f"SKI needs n >= 2 and 2 <= r <= n; got n={n}, "
                         f"r={r}")
    h = (n - 1) / (r - 1)
    return h, float(np.float32(h))


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = backend.library("ski")
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    # an earlier build, loaded by tools/ab_kernel.py, may have no bf16
    # entry: a bf16 call then fails on the missing symbol
    for name, _ in _REDUCE_ENTRIES.values():
        if hasattr(lib, name):
            getattr(lib, name).argtypes = [p, p, i64, i64, i64, i64,
                                           ctypes.c_double, ctypes.c_float, p]
            getattr(lib, name).restype = ctypes.c_int
    for name, _ in _EXPAND_ENTRIES.values():
        if hasattr(lib, name):
            getattr(lib, name).argtypes = [p, p, i64, i64, i64, i64,
                                           ctypes.c_float, p]
            getattr(lib, name).restype = ctypes.c_int
    return lib


def interp_reduce(x: torch.Tensor, idx_lo: torch.Tensor | None,
                  w_lo: torch.Tensor | None, r: int) -> torch.Tensor:
    """z = Wᵀ x: x (b, n, d) -> (b, r, d). ``idx_lo``/``w_lo`` (the
    inducing geometry of ``core/ski.make_inducing``) feed the plain version
    only; the kernel regenerates the weights from (n, r), as the Pallas
    kernel does. z is in x's dtype: on the card x fp32 or bf16, one launch
    of that dtype's instance. CPU: :func:`ref.interp_reduce_ref`."""
    if x.device.type == "cpu":
        return ref.interp_reduce_ref(x, idx_lo, w_lo, r)
    forward_only("interp_reduce", x)
    if x.dtype not in _REDUCE_ENTRIES:
        raise TypeError(f"interp_reduce: x {x.dtype}; the kernel takes "
                        "float32 or bfloat16")
    backend.require_cuda(x, "interp_reduce x", x.dtype)
    if x.dim() != 3 or x.numel() == 0:
        raise ValueError(f"interp_reduce: x {tuple(x.shape)} is not a "
                         "non-empty (b, n, d)")
    b, n, d = x.shape
    h, hf = hat_spacing(n, r)
    if max(b, r) > 65535:                 # grid (d tiles, r, b)
        raise ValueError(f"interp_reduce: b={b} or r={r} over 65535")
    z = torch.empty((b, r, d), dtype=x.dtype, device=x.device)
    entry, counter = _REDUCE_ENTRIES[x.dtype]
    lib = _lib()
    with torch.cuda.device(x.device):
        rc = getattr(lib, entry)(x.data_ptr(), z.data_ptr(), b, n, d, r, h,
                                 hf, backend.stream(x))
    backend.check(lib, rc, f"interp_reduce {x.dtype}")
    counters[counter] += 1
    return z


def interp_expand(z: torch.Tensor, idx_lo: torch.Tensor,
                  w_lo: torch.Tensor | None) -> torch.Tensor:
    """y = W z: z (b, r, d) -> (b, n, d), n = ``idx_lo.shape[0]``. The
    geometry's values feed the plain version only; the kernel regenerates
    the weights from (n, r). y is in z's dtype: on the card z fp32 or
    bf16, one launch of that dtype's instance.
    CPU: :func:`ref.interp_expand_ref`."""
    if z.device.type == "cpu":
        return ref.interp_expand_ref(z, idx_lo, w_lo)
    forward_only("interp_expand", z)
    if z.dtype not in _EXPAND_ENTRIES:
        raise TypeError(f"interp_expand: z {z.dtype}; the kernel takes "
                        "float32 or bfloat16")
    backend.require_cuda(z, "interp_expand z", z.dtype)
    if z.dim() != 3 or z.numel() == 0:
        raise ValueError(f"interp_expand: z {tuple(z.shape)} is not a "
                         "non-empty (b, r, d)")
    b, r, d = z.shape
    n = int(idx_lo.shape[0])
    _, hf = hat_spacing(n, r)
    if b > 65535:                         # grid (row blocks, b)
        raise ValueError(f"interp_expand: b={b} over 65535")
    y = torch.empty((b, n, d), dtype=z.dtype, device=z.device)
    entry, counter = _EXPAND_ENTRIES[z.dtype]
    lib = _lib()
    with torch.cuda.device(z.device):
        rc = getattr(lib, entry)(z.data_ptr(), y.data_ptr(), b, n, d, r, hf,
                                 backend.stream(z))
    backend.check(lib, rc, f"interp_expand {z.dtype}")
    counters[counter] += 1
    return y


class InterpReduce(torch.autograd.Function):
    """z = Wᵀ x; the backward is one :func:`interp_expand` launch."""

    @staticmethod
    def forward(ctx, x, idx_lo, w_lo, r):
        ctx.save_for_backward(idx_lo, w_lo)       # the geometry, no residual
        ctx.r = r
        return interp_reduce(x, idx_lo, w_lo, r)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        with kernel_region("interp_reduce"):
            idx_lo, w_lo = ctx.saved_tensors
            r = ctx.r
            if not backend.resolve_pallas_grad():
                # the op is linear: autograd's cotangent is the same at any
                # input, so a zero (b, n, d) input stands in for x
                reduce_op_counters["bwd_ref"] += 1
                (dx,) = backend.ref_cotangents(
                    lambda t: ref.interp_reduce_ref(t, idx_lo, w_lo, r),
                    (g.new_zeros((g.shape[0], idx_lo.shape[0],
                                  g.shape[2])),), g)
                return dx, None, None, None
            reduce_op_counters["bwd_kernel"] += 1
            return (interp_expand(g.contiguous(), idx_lo, w_lo), None, None,
                    None)


class InterpExpand(torch.autograd.Function):
    """y = W z; the backward is one :func:`interp_reduce` launch."""

    @staticmethod
    def forward(ctx, z, idx_lo, w_lo):
        ctx.save_for_backward(idx_lo, w_lo)       # the geometry, no residual
        ctx.r = z.shape[1]
        return interp_expand(z, idx_lo, w_lo)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        with kernel_region("interp_expand"):
            idx_lo, w_lo = ctx.saved_tensors
            r = ctx.r
            if not backend.resolve_pallas_grad():
                # linear: a zero (b, r, d) input stands in for z
                expand_op_counters["bwd_ref"] += 1
                (dz,) = backend.ref_cotangents(
                    lambda t: ref.interp_expand_ref(t, idx_lo, w_lo),
                    (g.new_zeros((g.shape[0], r, g.shape[2])),), g)
                return dz, None, None
            expand_op_counters["bwd_kernel"] += 1
            return interp_reduce(g.contiguous(), idx_lo, w_lo, r), None, None


def interp_reduce_op(x: torch.Tensor, idx_lo: torch.Tensor,
                     w_lo: torch.Tensor, r: int) -> torch.Tensor:
    """z = Wᵀ x, differentiable in x through :class:`InterpReduce`."""
    if torch.is_grad_enabled() and x.requires_grad:
        reduce_op_counters["fwd"] += 1
    return InterpReduce.apply(x, idx_lo, w_lo, r)


def interp_expand_op(z: torch.Tensor, idx_lo: torch.Tensor,
                     w_lo: torch.Tensor) -> torch.Tensor:
    """y = W z, differentiable in z through :class:`InterpExpand`."""
    if torch.is_grad_enabled() and z.requires_grad:
        expand_op_counters["fwd"] += 1
    return InterpExpand.apply(z, idx_lo, w_lo)
