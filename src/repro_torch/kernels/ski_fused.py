"""Fused SKI-TNO pass 2 (paper §3.2) with the hand-written CUDA kernels of
``csrc/ski.cu``, counterparts of ``repro/kernels/ski_fused.py``:

* :func:`ski_fused_pass2` — the dense-Gram pass 2 (replaces the Pallas
  ``_fused_kernel`` / ``_fused_call``), A as (d, r, r);
* :func:`ski_windowed_pass2` — the large-rank pass 2 with A as its (d, 2r-1)
  Toeplitz coefficients, each sequence tile computing only the window of
  z₂ = A z that its hat rows touch (replaces ``_windowed_kernel`` /
  ``_windowed_call`` with ``banded=True``);
* :func:`ski_expand_pass2` — the Gram-free pass 2 of the FFT-Gram variant,
  z₂ = A z applied before it by rfft/irfft (``banded=False``).

    y = W z₂ + T_sparse x,   z₂ = A z      one kernel, one write of y

z = Wᵀx comes from pass 1 (``interp_matvec.interp_reduce``). The two-tap
expansion by W and the m-tap short conv run inside each kernel, and so
does the Gram contraction of the first two. The tap offset ``left`` is an
argument (0 for the causal forward, m//2 bidirectional), so the signal
backwards (``ski_vjp``) launch these same kernels with the Gram transposed
(the dense form read transposed in place, ``transpose_a``; the
coefficient form lag-flipped), the taps flipped and ``left`` mirrored to
m-1-left.

Each wrapper takes the plain version (``ref.ski_fused_pass2_ref``;
``ref.ski_expand_pass2_ref`` after ``ref.toeplitz_gram_matvec_ref`` for
the windowed one) for CPU tensors and launches the kernel for CUDA
tensors, counting the launch in :data:`counters`; another device, dtype or
layout raises, as does an input that requires grad while grad is enabled
(a kernel on its own is forward-only; gradients go through
``ops.ski_fused_tno`` and ``ops.ski_fused_tno_coef``). The dense pass 2
takes the signal (x, z, and so y) fp32 or bf16, one instance each
(``ski_fused_pass2_bf16``, and ``ski_fused_pass2_at_bf16`` for Aᵀ, each
counted under its own name); A and the taps reach the kernel as fp32, a
bf16 A or bf16 taps widened by the wrapper (exactly). The windowed
kernels do the same: ``ski_windowed_pass2_bf16`` and
``ski_expand_pass2_bf16`` take x and z (z₂) bf16, the coefficients and
the taps as fp32 (bf16 ones widened exactly), and sum in fp32. x and z of
different dtypes, or a dtype other than fp32 and bf16, raise: no signal
is widened quietly. The kernels handle
every n >= 2 and 2 <= r <= n themselves, n < m and r = n included: the TPU
wrappers' padding copies and plain fallbacks for tiny shapes have no
counterpart here. The windowed kernels tile the sequence by
``backend.band_fit`` from a 128-row tile (``REPRO_SKI_BAND_MAX``).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import backend, ref
from repro_torch.kernels.interp_matvec import forward_only, hat_spacing

#: kernel launches (CUDA path only; the CPU path counts nothing)
counters = {"ski_fused_pass2": 0, "ski_fused_pass2_bf16": 0,
            "ski_fused_pass2_at_bf16": 0, "ski_windowed_pass2": 0,
            "ski_windowed_pass2_bf16": 0, "ski_expand_pass2": 0,
            "ski_expand_pass2_bf16": 0}
#: the dense pass 2's (entry point, launch counter) for each signal dtype
#: and orientation (``transpose_a``); the fp32 instance counts both
#: orientations as one kernel, as it always has
_DENSE_ENTRIES = {
    (torch.float32, False): ("ski_fused_pass2_f32", "ski_fused_pass2"),
    (torch.float32, True): ("ski_fused_pass2_at_f32", "ski_fused_pass2"),
    (torch.bfloat16, False): ("ski_fused_pass2_bf16", "ski_fused_pass2_bf16"),
    (torch.bfloat16, True): ("ski_fused_pass2_at_bf16",
                             "ski_fused_pass2_at_bf16")}
#: the windowed kernels' (entry point, launch counter) for each signal
#: dtype, banded (ski_windowed_pass2) or not (ski_expand_pass2)
_WINDOW_ENTRIES = {
    (torch.float32, True): ("ski_windowed_pass2_f32", "ski_windowed_pass2"),
    (torch.bfloat16, True): ("ski_windowed_pass2_bf16",
                             "ski_windowed_pass2_bf16"),
    (torch.float32, False): ("ski_expand_pass2_f32", "ski_expand_pass2"),
    (torch.bfloat16, False): ("ski_expand_pass2_bf16",
                              "ski_expand_pass2_bf16")}

#: shared memory a block may use on Hopper (227 KB)
_MAX_SMEM = 232448
#: sequence rows of a windowed pass-2 tile before ``backend.band_fit``
_TILE = 128


def reset_counters() -> None:
    for k in counters:
        counters[k] = 0


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = backend.library("ski")
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    dense = [p, p, p, p, p, i64, i64, i64, i64, i64, i64, ctypes.c_float, p]
    # a build of an earlier version of ski.cu (tools/ab_kernel.py --old)
    # may have no transposing or bf16 entry point: it stays unbound there
    for name, _ in _DENSE_ENTRIES.values():
        if hasattr(lib, name):
            getattr(lib, name).argtypes = dense
            getattr(lib, name).restype = ctypes.c_int
    lib.ski_fused_pass2_smem_bytes.argtypes = [i64, i64]
    lib.ski_fused_pass2_smem_bytes.restype = i64
    window = [i64, i64, i64, i64, i64, i64, ctypes.c_float, i64, i64, p]
    for (_, banded), (name, _) in _WINDOW_ENTRIES.items():
        if hasattr(lib, name):
            getattr(lib, name).argtypes = [p, p, *([p] if banded else []),
                                           p, p, *window]
            getattr(lib, name).restype = ctypes.c_int
    lib.ski_window_pass2_smem_bytes.argtypes = [i64, i64, i64, i64,
                                                ctypes.c_int]
    lib.ski_window_pass2_smem_bytes.restype = i64
    return lib


def _check_shapes(what: str, x, z, gram, filt, left: int) -> None:
    """x (b, n, d), z (b, r, d), filt (d, m) and, unless None, the Gram:
    (d, r, r) for the dense pass 2, else (d, 2r-1) coefficients;
    0 <= left < m."""
    if x.dim() != 3 or x.numel() == 0:
        raise ValueError(f"{what}: x {tuple(x.shape)} is not a non-empty "
                         "(b, n, d)")
    b, n, d = x.shape
    r, m = z.shape[1], filt.shape[-1]
    want = {"z": (z, (b, r, d)), "taps": (filt, (d, m))}
    if gram is not None:
        want["A"] = (gram, (d, r, r) if what == "ski_fused_pass2"
                     else (d, 2 * r - 1))
    bad = [f"{k} {tuple(t.shape)}, not {shape}"
           for k, (t, shape) in want.items() if tuple(t.shape) != shape]
    if bad:
        raise ValueError(f"{what}: x {tuple(x.shape)} with " + "; ".join(bad))
    if not 0 <= left < m:
        raise ValueError(f"{what}: left={left} outside [0, m={m})")
    if b > 65535:                                 # grid (d tiles, b)
        raise ValueError(f"{what}: b={b} over 65535")


def _require_kernel_inputs(what: str, ts, names, dtypes) -> None:
    """The CUDA path's checks: forward-only, each input of its dtype in
    ``dtypes``, contiguous, one device."""
    forward_only(what, *ts)
    for name, t, dtype in zip(names, ts, dtypes):
        backend.require_cuda(t, f"{what} {name}", dtype)
    if any(t.device != ts[0].device for t in ts):
        raise ValueError(f"{what}: inputs on "
                         f"{sorted({str(t.device) for t in ts})}")


def _widened(t: torch.Tensor) -> torch.Tensor:
    """A bf16 Gram or taps as the fp32 the dense kernels read (exact);
    anything else as it is, for the checks to judge."""
    return t.float() if t.dtype == torch.bfloat16 else t


def ski_fused_pass2(x: torch.Tensor, z: torch.Tensor, a_dense: torch.Tensor,
                    filt: torch.Tensor, causal: bool,
                    left: int | None = None,
                    transpose_a: bool = False) -> torch.Tensor:
    """y = W (A z) + T_sparse x: x (b, n, d), z = Wᵀx (b, r, d), a_dense
    (d, r, r), filt (d, m) → (b, n, d). ``left`` overrides the
    causal-derived tap offset (0 causal, m//2 bidirectional);
    ``transpose_a`` applies Aᵀ, read from ``a_dense`` as it lies (the
    signal backward), with no transposed copy. y is in x's dtype: on the
    card x and z both fp32 or both bf16, one launch of that instance, A
    and the taps fp32 or bf16 (read as fp32).
    CPU: :func:`ref.ski_fused_pass2_ref`."""
    m = filt.shape[-1]
    if left is None:
        left = 0 if causal else m // 2
    ts = (x, z, a_dense, filt)
    if all(t.device.type == "cpu" for t in ts):
        return ref.ski_fused_pass2_ref(x, z, a_dense, filt, causal,
                                       left=left, transpose_a=transpose_a)
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"ski_fused_pass2: x {x.dtype}; the kernel takes "
                        "float32 or bfloat16")
    a_dense, filt = _widened(a_dense), _widened(filt)
    ts = (x, z, a_dense, filt)
    _require_kernel_inputs("ski_fused_pass2", ts, ("x", "z", "A", "taps"),
                           (x.dtype, x.dtype, torch.float32, torch.float32))
    _check_shapes("ski_fused_pass2", x, z, a_dense, filt, left)
    b, n, d = x.shape
    r = z.shape[1]
    _, hf = hat_spacing(n, r)
    lib = _lib()
    smem = lib.ski_fused_pass2_smem_bytes(r, m)
    if smem > _MAX_SMEM:
        raise ValueError(f"ski_fused_pass2: r={r}, m={m} need {smem} bytes "
                         f"of shared memory a block, over {_MAX_SMEM}")
    y = torch.empty_like(x)
    entry, counter = _DENSE_ENTRIES[x.dtype, bool(transpose_a)]
    with torch.cuda.device(x.device):
        rc = getattr(lib, entry)(x.data_ptr(), z.data_ptr(),
                                 a_dense.data_ptr(), filt.data_ptr(),
                                 y.data_ptr(), b, n, d, r, m, left, hf,
                                 backend.stream(x))
    backend.check(lib, rc, f"ski_fused_pass2 {x.dtype}")
    counters[counter] += 1
    return y


def _window_pass2(what: str, x, z, a_coef, filt, causal: bool,
                  left: int | None) -> torch.Tensor:
    """The two windowed pass-2 kernels: a_coef None is ski_expand_pass2
    (z holds z₂), else ski_windowed_pass2. On the card x and z both fp32
    or both bf16, one launch of that dtype's instance."""
    m = filt.shape[-1]
    if left is None:
        left = 0 if causal else m // 2
    ts = (x, z, filt) + (() if a_coef is None else (a_coef,))
    if all(t.device.type == "cpu" for t in ts):
        z2 = z if a_coef is None else ref.toeplitz_gram_matvec_ref(a_coef, z)
        return ref.ski_expand_pass2_ref(x, z2, filt, causal, left=left)
    if x.dtype not in (torch.float32, torch.bfloat16) or z.dtype != x.dtype:
        raise TypeError(f"{what}: x {x.dtype} and z {z.dtype}; the kernel "
                        "takes both float32 or both bfloat16")
    filt = _widened(filt)
    a_coef = None if a_coef is None else _widened(a_coef)
    ts = (x, z, filt) + (() if a_coef is None else (a_coef,))
    _require_kernel_inputs(what, ts, ("x", "z" if a_coef is not None
                                      else "z2", "taps", "coefficients"),
                           (x.dtype, x.dtype) + (torch.float32,) * (
                               len(ts) - 2))
    _check_shapes(what, x, z, a_coef, filt, left)
    b, n, d = x.shape
    r = z.shape[1]
    _, hf = hat_spacing(n, r)
    bn, bw = backend.band_fit(_TILE, n, r)
    lib = _lib()
    banded = a_coef is not None
    smem = lib.ski_window_pass2_smem_bytes(b, bn, bw, m, int(banded))
    if smem > _MAX_SMEM:
        raise ValueError(f"{what}: tile {bn}, band {bw}, m={m} need {smem} "
                         f"bytes of shared memory a block, over {_MAX_SMEM}")
    y = torch.empty_like(x)
    entry, counter = _WINDOW_ENTRIES[x.dtype, banded]
    gram = () if a_coef is None else (a_coef.data_ptr(),)
    with torch.cuda.device(x.device):
        rc = getattr(lib, entry)(
            x.data_ptr(), z.data_ptr(), *gram, filt.data_ptr(), y.data_ptr(),
            b, n, d, r, m, left, hf, bn, bw, backend.stream(x))
    backend.check(lib, rc, f"{what} {x.dtype} (r={r}, tile {bn}, band {bw})")
    counters[counter] += 1
    return y


def ski_windowed_pass2(x: torch.Tensor, z: torch.Tensor, a_coef: torch.Tensor,
                       filt: torch.Tensor, causal: bool,
                       left: int | None = None) -> torch.Tensor:
    """y = W (A z) + T_sparse x with A as Toeplitz coefficients: x (b, n, d),
    z = Wᵀx (b, r, d), a_coef (d, 2r-1) lags -(r-1)..r-1, filt (d, m) →
    (b, n, d). No (r, r) panel or dense Gram exists, on the card or off it.
    CPU: ``ref.ski_expand_pass2_ref`` of ``ref.toeplitz_gram_matvec_ref``."""
    return _window_pass2("ski_windowed_pass2", x, z, a_coef, filt, causal,
                         left)


def ski_expand_pass2(x: torch.Tensor, z2: torch.Tensor, filt: torch.Tensor,
                     causal: bool, left: int | None = None) -> torch.Tensor:
    """y = W z2 + T_sparse x: x (b, n, d), z2 = A z (b, r, d), filt (d, m) →
    (b, n, d), the FFT-Gram variant's pass 2. CPU:
    :func:`ref.ski_expand_pass2_ref`."""
    return _window_pass2("ski_expand_pass2", x, z2, None, filt, causal, left)
