"""Fused SKI-TNO pass 2 (paper §3.2) with the hand-written CUDA kernel of
``csrc/ski.cu``, counterpart of the dense ``ski_fused_pass2_pallas`` of
``repro/kernels/ski_fused.py`` (replaces the Pallas ``_fused_kernel`` /
``_fused_call``).

    y = W (A z) + T_sparse x          one kernel, one write of y

z = Wᵀx comes from pass 1 (``interp_matvec.interp_reduce``). The Gram
contraction A z, the two-tap expansion by W and the m-tap short conv all
run inside the kernel. The tap offset ``left`` is an argument (0 for the
causal forward, m//2 bidirectional), so the signal backward
(``ski_vjp.SKIFusedTNO``) launches this same kernel with A transposed, the
taps flipped and ``left`` mirrored to m-1-left.

The wrapper takes the plain version (``ref.ski_fused_pass2_ref``) for CPU
tensors and launches the kernel for CUDA tensors, counting the launch in
:data:`counters`; another device, dtype or layout raises, as does an input
that requires grad while grad is enabled (the kernel on its own is
forward-only; gradients go through ``ops.ski_fused_tno``). The kernel
handles every n >= 2 and 2 <= r <= n itself, n < m and r = n included:
the TPU wrapper's plain fallback for tiny n has no counterpart here.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import backend, ref
from repro_torch.kernels.interp_matvec import forward_only, hat_spacing

#: kernel launches (CUDA path only; the CPU path counts nothing)
counters = {"ski_fused_pass2": 0}

#: shared memory a block may use on Hopper (227 KB)
_MAX_SMEM = 232448


def reset_counters() -> None:
    for k in counters:
        counters[k] = 0


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = backend.library("ski")
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.ski_fused_pass2_f32.argtypes = [p, p, p, p, p, i64, i64, i64, i64,
                                        i64, i64, ctypes.c_float, p]
    lib.ski_fused_pass2_f32.restype = ctypes.c_int
    lib.ski_fused_pass2_smem_bytes.argtypes = [i64, i64]
    lib.ski_fused_pass2_smem_bytes.restype = i64
    return lib


def _check_shapes(x, z, a_dense, filt, left: int) -> None:
    if x.dim() != 3 or x.numel() == 0:
        raise ValueError(f"ski_fused_pass2: x {tuple(x.shape)} is not a "
                         "non-empty (b, n, d)")
    b, n, d = x.shape
    r, m = z.shape[1], filt.shape[-1]
    if (tuple(z.shape) != (b, r, d) or tuple(a_dense.shape) != (d, r, r)
            or tuple(filt.shape) != (d, m)):
        raise ValueError(f"ski_fused_pass2: x {tuple(x.shape)}, z "
                         f"{tuple(z.shape)}, A {tuple(a_dense.shape)}, taps "
                         f"{tuple(filt.shape)} are not (b, n, d), (b, r, d), "
                         "(d, r, r), (d, m)")
    if not 0 <= left < m:
        raise ValueError(f"ski_fused_pass2: left={left} outside [0, m={m})")
    if b > 65535:                                 # grid (d tiles, b)
        raise ValueError(f"ski_fused_pass2: b={b} over 65535")


def ski_fused_pass2(x: torch.Tensor, z: torch.Tensor, a_dense: torch.Tensor,
                    filt: torch.Tensor, causal: bool,
                    left: int | None = None) -> torch.Tensor:
    """y = W (A z) + T_sparse x: x (b, n, d), z = Wᵀx (b, r, d), a_dense
    (d, r, r), filt (d, m) → (b, n, d). ``left`` overrides the
    causal-derived tap offset (0 causal, m//2 bidirectional).
    CPU: :func:`ref.ski_fused_pass2_ref`."""
    m = filt.shape[-1]
    if left is None:
        left = 0 if causal else m // 2
    ts = (x, z, a_dense, filt)
    if all(t.device.type == "cpu" for t in ts):
        return ref.ski_fused_pass2_ref(x, z, a_dense, filt, causal,
                                       left=left)
    forward_only("ski_fused_pass2", *ts)
    for name, t in zip(("x", "z", "A", "taps"), ts):
        backend.require_cuda(t, f"ski_fused_pass2 {name}", torch.float32)
    if any(t.device != x.device for t in ts):
        raise ValueError("ski_fused_pass2: inputs on "
                         f"{sorted({str(t.device) for t in ts})}")
    _check_shapes(x, z, a_dense, filt, left)
    b, n, d = x.shape
    r = z.shape[1]
    _, hf = hat_spacing(n, r)
    lib = _lib()
    smem = lib.ski_fused_pass2_smem_bytes(r, m)
    if smem > _MAX_SMEM:
        raise ValueError(f"ski_fused_pass2: r={r}, m={m} need {smem} bytes "
                         f"of shared memory a block, over {_MAX_SMEM}")
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        rc = lib.ski_fused_pass2_f32(x.data_ptr(), z.data_ptr(),
                                     a_dense.data_ptr(), filt.data_ptr(),
                                     y.data_ptr(), b, n, d, r, m, left, hf,
                                     backend.stream(x))
    backend.check(lib, rc, "ski_fused_pass2")
    counters["ski_fused_pass2"] += 1
    return y
