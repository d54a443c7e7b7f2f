"""Mamba-2 SSD chunked scan with the hand-written CUDA kernel of
``csrc/ssd_scan.cu``, counterpart of ``repro/kernels/ssd_scan.py``
(replaces the Pallas ``_kernel`` / ``ssd_scan_pallas``).

:func:`ssd_scan` takes the plain version (``ssd_chunked.ssd_scan_chunked``,
which zero-pads a ragged tail) for CPU tensors and launches the kernel for
CUDA tensors, counting the launch in :data:`counters`; another device,
dtype or layout raises. Each dtype has one kernel body: bf16 runs its
products on the tensor cores (C Bᵀ in bf16, the other three in TF32, fp32
sums), fp32 runs fp32 FMAs on the CUDA cores (``csrc/ssd_scan.cu`` states
the error budget and the bounds). Both read x, dt, B and C in place (no
head transposes, no per-head copies of B and C), loop over the chunks
inside the block and mask a ragged last chunk, so every n >= 1 runs in
them.

As ``ssd_scan_pallas`` in the JAX package, the kernel is forward-only: on
the card :func:`ssd_scan` refuses an input that requires grad while grad
is enabled. :class:`SSDScan` is the differentiable op (``ops.ssd_scan``):
its forward is :func:`ssd_scan` (the kernel on the card, the chunked
scan on the CPU) and saves the inputs only, the recompute policy of the
JAX package's custom VJPs; its backward recomputes
``ssd_scan_chunked`` on the saved inputs under autograd and returns
autograd's cotangents of it. That is the gradient the JAX package takes:
``ssd_scan_pallas`` has no VJP, and JAX trains Mamba by ``jax.grad``
through ``ssd_scan_chunked``, XLA code outside any Pallas kernel, so
there is no SSD backward kernel to port. The backward always takes this
one route, on both devices, counted in :data:`op_counters`.
"""
from __future__ import annotations

import ctypes
import functools

import torch
from torch.autograd.function import once_differentiable

from repro_torch.kernels import backend
from repro_torch.kernels.ssd_chunked import ssd_scan_chunked

#: kernel launches (CUDA path only; the CPU path counts nothing)
counters = {"ssd_scan": 0}
#: differentiated :func:`ssd_scan_op` forwards (grad enabled and an input
#: that requires grad) and :class:`SSDScan` backwards (autograd through
#: ``ssd_scan_chunked``), on both devices
op_counters = {"fwd": 0, "bwd_chunked": 0}

#: the kernel's entry point for each element type of x, B, C and y
_ENTRIES = {torch.float32: "ssd_scan_f32", torch.bfloat16: "ssd_scan_bf16"}


def reset_counters() -> None:
    for d in (counters, op_counters):
        for k in d:
            d[k] = 0


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = backend.library("ssd_scan")
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    for name in _ENTRIES.values():
        fn = getattr(lib, name)
        fn.argtypes = [p] * 7 + [i64] * 7 + [p]
        fn.restype = ctypes.c_int
    for name in ("ssd_scan_max_q", "ssd_scan_max_p", "ssd_scan_max_s"):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = i64
    return lib


def ssd_scan(x, dt, a, b, c, d_skip, *, chunk: int = 64) -> torch.Tensor:
    """Mamba-2 SSD over chunks of q = min(chunk, n) positions: x (bt, n, h,
    p), dt (bt, n, h), a (h,), b/c (bt, n, g, s), d_skip (h,) → y (bt, n,
    h, p) in x's dtype (``ref.ssd_scan_ref``'s recurrence). On the card x,
    b and c are all fp32 or all bf16, dt, a and d_skip fp32, and the kernel
    takes q <= 128, p <= 64 and s <= 128; forward-only there. CPU:
    :func:`ssd_chunked.ssd_scan_chunked`."""
    ts = (x, dt, a, b, c, d_skip)
    if all(t.device.type == "cpu" for t in ts):
        return ssd_scan_chunked(x, dt, a, b, c, d_skip, chunk=chunk)
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        raise NotImplementedError(
            "ssd_scan: the CUDA kernel is forward-only, as ssd_scan_pallas "
            "is; differentiate through ops.ssd_scan (the SSDScan autograd "
            "Function, whose backward runs autograd through "
            "ssd_scan_chunked), or call it under torch.no_grad()")
    if x.dtype not in _ENTRIES or b.dtype != x.dtype or c.dtype != x.dtype:
        raise TypeError(f"ssd_scan: x, B, C of dtypes {x.dtype}, {b.dtype}, "
                        f"{c.dtype}; the kernel takes all fp32 or all bf16")
    for t, what in ((x, "x"), (b, "B"), (c, "C")):
        backend.require_cuda(t, f"ssd_scan {what}", x.dtype)
    for t, what in ((dt, "dt"), (a, "a"), (d_skip, "d_skip")):
        backend.require_cuda(t, f"ssd_scan {what}", torch.float32)
    if x.dim() != 4 or b.dim() != 4 or x.numel() == 0 or b.numel() == 0:
        raise ValueError(f"ssd_scan: x {tuple(x.shape)} and B "
                         f"{tuple(b.shape)} are not non-empty (bt, n, h, p) "
                         "and (bt, n, g, s)")
    bt, n, h, p = x.shape
    g, s = b.shape[2], b.shape[3]
    want = {"dt": (bt, n, h), "a": (h,), "B": (bt, n, g, s),
            "C": (bt, n, g, s), "d_skip": (h,)}
    got = {"dt": dt, "a": a, "B": b, "C": c, "d_skip": d_skip}
    for name, shape in want.items():
        if tuple(got[name].shape) != shape:
            raise ValueError(f"ssd_scan: {name} {tuple(got[name].shape)}, "
                             f"want {shape} for x {tuple(x.shape)}")
    if h % g or any(t.device != x.device for t in ts):
        raise ValueError(f"ssd_scan: {g} groups do not divide {h} heads, or "
                         "the inputs lie on more than one device")
    q = min(chunk, n)
    lib = _lib()
    limits = (lib.ssd_scan_max_q(), lib.ssd_scan_max_p(),
              lib.ssd_scan_max_s())
    if not (1 <= q <= limits[0] and p <= limits[1] and s <= limits[2]):
        raise ValueError(f"ssd_scan: chunk {q}, head dim {p}, state {s}; "
                         f"the kernel takes at most {limits}")
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        rc = getattr(lib, _ENTRIES[x.dtype])(
            x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(),
            c.data_ptr(), d_skip.data_ptr(), y.data_ptr(), bt, n, h, g, p, s,
            q, backend.stream(x))
    backend.check(lib, rc, f"ssd_scan (bt={bt}, n={n}, h={h}, p={p}, g={g}, "
                           f"s={s}, q={q})")
    counters["ssd_scan"] += 1
    return y


class SSDScan(torch.autograd.Function):
    """The SSD scan with the backward of the module docstring: forward
    :func:`ssd_scan`, residuals the inputs only, backward autograd through
    ``ssd_scan_chunked`` recomputed on them. dt, a and d_skip get fp32
    cotangents, x, B and C cotangents in their own dtype."""

    @staticmethod
    def forward(ctx, x, dt, a, b, c, d_skip, chunk):
        ctx.save_for_backward(x, dt, a, b, c, d_skip)
        ctx.chunk = chunk
        return ssd_scan(x, dt, a, b, c, d_skip, chunk=chunk)

    @staticmethod
    @once_differentiable
    def backward(ctx, gy):
        op_counters["bwd_chunked"] += 1
        need = ctx.needs_input_grad[:6]
        ins = [t.detach().requires_grad_(n)
               for t, n in zip(ctx.saved_tensors, need)]
        with torch.enable_grad():
            y = ssd_scan_chunked(*ins, chunk=ctx.chunk)
            got = iter(torch.autograd.grad(
                y, [t for t, n in zip(ins, need) if n], gy))
        return (*(next(got) if n else None for n in need), None)


def ssd_scan_op(x, dt, a, b, c, d_skip, *, chunk: int = 64) -> torch.Tensor:
    """The SSD scan, differentiable in all six inputs through
    :class:`SSDScan` on both devices."""
    ts = (x, dt, a, b, c, d_skip)
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        op_counters["fwd"] += 1
    return SSDScan.apply(x, dt, a, b, c, d_skip, chunk)
