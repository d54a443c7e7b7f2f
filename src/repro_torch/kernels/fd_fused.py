"""Causal FD-TNO forward (paper §3.3, Algorithm 2) with the hand-written
Hopper kernels of ``csrc/fd_fused.cu`` between the cuFFT stages.

Counterpart of ``repro/kernels/fd_fused.py``:

* :func:`hilbert_window` — the analytic-signal lag window applied to the
  kernel's time response (replaces the Pallas ``_window_kernel``);
* :func:`fd_mul` — the per-channel complex spectral multiply
  ŷ = x̂ ⊙ k̂ (replaces the Pallas ``_mul_kernel``). The TPU kernel works on
  re/im planes because Pallas has no complex dtype; here the kernel reads
  and writes the interleaved complex64 tensors of ``torch.fft`` directly,
  so there is no plane split before it and no ``re + 1j·im`` assembly
  after it. :func:`fd_spectral_multiply` keeps the planes signature for
  the parity tests.

Spectra are kept channel-major, (b, d, n+1): ``torch.fft`` transforms the
last axis of a (b, d, 2n) signal into exactly that contiguous layout, and
the causal spectrum of a (d, n+1) response needs no transpose either.

Each wrapper takes the plain version (``kernels/ref.py``) for a CPU tensor
and launches its kernel for a CUDA tensor, counting the launch in
:data:`counters`; any other device, dtype, shape or layout raises. The
kernels are forward-only in this slice (serving): each wrapper raises for a
non-CPU input that requires grad while grad is enabled, rather than return
a tensor cut off from autograd. Their backward (``fd_khat_grad`` and the
conjugate-spectrum multiply) comes with the training slice. On the CPU
plain autograd applies.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import backend, ref

#: kernel launches per wrapper (CUDA path only; the CPU path counts nothing)
counters = {"hilbert_window": 0, "fd_mul": 0}


def reset_counters() -> None:
    for k in counters:
        counters[k] = 0


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = backend.library()
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.hilbert_window_f32.argtypes = [p, p, i64, i64, p]
    lib.hilbert_window_f32.restype = ctypes.c_int
    lib.fd_mul_c64.argtypes = [p, p, p, i64, i64, p]
    lib.fd_mul_c64.restype = ctypes.c_int
    return lib


def _forward_only(what: str, *ts: torch.Tensor) -> None:
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        raise NotImplementedError(
            f"{what}: the CUDA kernel is forward-only; its backward "
            "(fd_khat_grad kernel, conjugate-spectrum fd_mul) comes with the "
            "training slice (ROADMAP Queue 1). Serve under "
            "torch.inference_mode()")


def _require_cuda(t: torch.Tensor, what: str, dtype: torch.dtype) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{what}: tensor on {t.device}; the kernel takes "
                         "CUDA tensors and the plain version CPU tensors")
    if t.dtype != dtype:
        raise TypeError(f"{what}: dtype {t.dtype}, the kernel takes {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: tensor of shape {tuple(t.shape)} and "
                         f"strides {t.stride()} is not contiguous")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


# ------------------------------------------------------ hilbert lag window
def hilbert_window(kt: torch.Tensor, n: int) -> torch.Tensor:
    """kt (d, 2n) fp32 time response → a new (d, 2n) tensor with lag 0 and
    lag n kept, lags 1..n-1 doubled and lags beyond n zeroed.
    CPU: :func:`ref.hilbert_window_ref`."""
    if kt.dim() != 2 or kt.shape[1] != 2 * n:
        raise ValueError(f"hilbert_window: kt {tuple(kt.shape)} is not "
                         f"(d, 2n) with 2n = {2 * n}")
    if kt.device.type == "cpu":
        return ref.hilbert_window_ref(kt, n)
    _forward_only("hilbert_window", kt)
    _require_cuda(kt, "hilbert_window", torch.float32)
    out = torch.empty_like(kt)
    lib = _lib()
    with torch.cuda.device(kt.device):
        rc = lib.hilbert_window_f32(kt.data_ptr(), out.data_ptr(),
                                    kt.shape[0], n, _stream(kt))
    backend.check(lib, rc, "hilbert_window")
    counters["hilbert_window"] += 1
    return out


# ------------------------------------------------- complex spectral multiply
def fd_mul(xhat: torch.Tensor, khat: torch.Tensor) -> torch.Tensor:
    """ŷ[i] = x̂[i] ⊙ k̂ for every batch row i: xhat (b, ...) complex64,
    khat complex64 shaped like one row (``xhat.shape[1:]``), both
    contiguous. Returns a new complex64 tensor shaped like xhat.
    CPU: :func:`ref.fd_mul_ref`."""
    if xhat.device.type == "cpu" and khat.device.type == "cpu":
        return ref.fd_mul_ref(xhat, khat)
    _forward_only("fd_mul", xhat, khat)
    _require_cuda(xhat, "fd_mul x̂", torch.complex64)
    _require_cuda(khat, "fd_mul k̂", torch.complex64)
    if (xhat.device != khat.device
            or tuple(khat.shape) != tuple(xhat.shape[1:])):
        raise ValueError(f"fd_mul: k̂ {tuple(khat.shape)} on {khat.device} "
                         f"does not match one row of x̂ {tuple(xhat.shape)} "
                         f"on {xhat.device}")
    out = torch.empty_like(xhat)
    lib = _lib()
    with torch.cuda.device(xhat.device):
        rc = lib.fd_mul_c64(xhat.data_ptr(), khat.data_ptr(), out.data_ptr(),
                            xhat.shape[0], khat.numel(), _stream(xhat))
    backend.check(lib, rc, "fd_mul")
    counters["fd_mul"] += 1
    return out


def fd_spectral_multiply(xr, xi, kr, ki):
    """Planes signature of :func:`fd_mul`, as
    ``repro.kernels.fd_fused.fd_spectral_multiply_pallas``: xr, xi
    (b, F, d); kr, ki (F, d) → (yr, yi) fp32."""
    y = fd_mul(torch.complex(xr.float(), xi.float()),
               torch.complex(kr.float(), ki.float()))
    return y.real, y.imag


# --------------------------------------------------------- the fused op
def causal_khat_planes(khat_real: torch.Tensor):
    """(d, n+1) real response → (n+1, d) re/im planes of the causal
    spectrum ``khat - i·H{khat}`` (the JAX function's layout, for the
    parity tests; :func:`fd_tno` keeps the (d, n+1) complex tensor)."""
    from repro_torch.core.hilbert import causal_spectrum
    khat = causal_spectrum(khat_real)
    return khat.real.T, khat.imag.T


def fd_tno(x: torch.Tensor, khat_real: torch.Tensor) -> torch.Tensor:
    """Causal FD-TNO: y = irfft(rfft(x) ⊙ k̂)[:n] with k̂ the
    Hilbert-completed causal spectrum of ``khat_real``.

    x: (b, n, d); khat_real: (d, n+1) real response on the rfft grid.
    Returns (b, n, d) in x's dtype (a channel-major view). Matches
    :func:`ref.fd_tno_ref`. On the card both kernels run and the op is
    forward-only: an input that requires grad raises in the kernels'
    wrappers."""
    from repro_torch.core.hilbert import causal_spectrum
    b, n, d = x.shape
    khat = causal_spectrum(khat_real)                        # (d, n+1)
    xhat = torch.fft.rfft(x.float().transpose(1, 2), n=2 * n, dim=-1)
    y = torch.fft.irfft(fd_mul(xhat.contiguous(), khat.contiguous()),
                        n=2 * n, dim=-1)                     # (b, d, 2n)
    return y[..., :n].transpose(1, 2).to(x.dtype)
