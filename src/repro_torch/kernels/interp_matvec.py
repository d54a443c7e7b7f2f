"""SKI's interpolation reduce z = Wᵀx (paper §3.2.1) with the hand-written
CUDA kernel of ``csrc/ski.cu``, counterpart of the ``interp_reduce`` half
of ``repro/kernels/interp_matvec.py`` (replaces the Pallas
``_reduce_kernel`` / ``_reduce_call``).

Because the inducing points are uniform, W is the hat function
max(0, 1 - |i/h - j|) with h = (n-1)/(r-1); the kernel regenerates it
from (n, r) and reads no weights. The wrapper takes the plain version
(``ref.interp_reduce_ref``, the dense hat contraction) for a CPU tensor
and launches the kernel for a CUDA tensor, counting the launch in
:data:`counters`; another device, dtype or layout raises. On the card
the kernel writes a tensor that autograd cannot see, so called on its own
it refuses an input that requires grad while grad is enabled; gradients
go through ``ops.ski_fused_tno`` (``ski_vjp.SKIFusedTNO``), whose forward
and backward launch it. ``interp_expand`` (y = W z) is not on the dense
fused path.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.kernels import backend, ref

#: kernel launches (CUDA path only; the CPU path counts nothing)
counters = {"interp_reduce": 0}

def reset_counters() -> None:
    for k in counters:
        counters[k] = 0


def forward_only(what: str, *ts: torch.Tensor) -> None:
    """Raise for a CUDA call whose output autograd would lose: grad enabled
    and an input that requires grad."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        raise NotImplementedError(
            f"{what}: the CUDA kernel on its own is forward-only; "
            "differentiate through ops.ski_fused_tno (SKIFusedTNO), whose "
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
    lib.interp_reduce_f32.argtypes = [p, p, i64, i64, i64, i64,
                                      ctypes.c_double, ctypes.c_float, p]
    lib.interp_reduce_f32.restype = ctypes.c_int
    return lib


def interp_reduce(x: torch.Tensor, idx_lo: torch.Tensor | None,
                  w_lo: torch.Tensor | None, r: int) -> torch.Tensor:
    """z = Wᵀ x: x (b, n, d) -> (b, r, d). ``idx_lo``/``w_lo`` (the
    inducing geometry of ``core/ski.make_inducing``) feed the plain version
    only; the kernel regenerates the weights from (n, r), as the Pallas
    kernel does. CPU: :func:`ref.interp_reduce_ref`."""
    if x.device.type == "cpu":
        return ref.interp_reduce_ref(x, idx_lo, w_lo, r)
    forward_only("interp_reduce", x)
    backend.require_cuda(x, "interp_reduce x", torch.float32)
    if x.dim() != 3 or x.numel() == 0:
        raise ValueError(f"interp_reduce: x {tuple(x.shape)} is not a "
                         "non-empty (b, n, d)")
    b, n, d = x.shape
    h, hf = hat_spacing(n, r)
    if max(b, r) > 65535:                 # grid (d tiles, r, b)
        raise ValueError(f"interp_reduce: b={b} or r={r} over 65535")
    z = torch.empty((b, r, d), dtype=torch.float32, device=x.device)
    lib = _lib()
    with torch.cuda.device(x.device):
        rc = lib.interp_reduce_f32(x.data_ptr(), z.data_ptr(), b, n, d, r,
                                   h, hf, backend.stream(x))
    backend.check(lib, rc, "interp_reduce")
    counters["interp_reduce"] += 1
    return z
