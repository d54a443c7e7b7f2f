"""Causal FD-TNO (paper §3.3, Algorithm 2), forward and backward, with the
hand-written Hopper kernels of ``csrc/fd_fused.cu`` between the cuFFT
stages.

Counterpart of ``repro/kernels/fd_fused.py``:

* :func:`hilbert_window` — the analytic-signal lag window applied to the
  kernel's time response (replaces the Pallas ``_window_kernel``). The
  window is diagonal, hence self-adjoint: :class:`HilbertWindow`'s
  backward is the same kernel on the cotangent.
* :func:`fd_mul` — the per-channel complex spectral multiply
  ŷ = x̂ ⊙ k̂ (replaces the Pallas ``_mul_kernel``). The TPU kernel works on
  re/im planes because Pallas has no complex dtype; here the kernel reads
  and writes the interleaved complex64 tensors of ``torch.fft`` directly,
  so there is no plane split before it and no ``re + 1j·im`` assembly
  after it. :func:`fd_spectral_multiply` keeps the planes signature for
  the parity tests.
* :func:`fd_khat_grad` — the backward's batch reduction Σ_b ĝ ⊙ conj(x̂)
  (replaces the Pallas ``_khat_grad_kernel``); :func:`fd_khat_grad_planes`
  keeps the planes signature.
* :func:`causal_spectrum` and :func:`causal_spectrum_adjoint` — the
  Hilbert completion k̂ = rfft(w ⊙ irfft(u, 2n)) of a (d, n+1) real
  response and its adjoint, each in one launch that does both transforms
  and the window in shared memory (replace ``causal_khat_planes`` and the
  end of ``_fd_bwd``: irfft → ``_window_call`` → rfft or the irfft VJP),
  for the lengths of ``backend.causal_spectrum_route``'s "fused" route;
  every other length keeps cuFFT around :func:`hilbert_window`.
* :class:`FDTNO` — the differentiable op :func:`fd_tno`, with the
  structure of ``fd_tno_pallas``'s custom VJP: residuals are the inputs
  (x, khat_real) only; the backward recomputes both spectra and runs
  ``fd_mul`` with the spectrum conjugated for dx, ``fd_khat_grad`` for the
  spectrum cotangent, then the window and the exact irfft adjoint
  (:func:`causal_spectrum_adjoint` on the fused route) for dkhat_real.
  :data:`op_counters` counts its differentiated forwards and which
  backward ran (``bwd_kernel``, or ``bwd_ref`` under
  ``REPRO_PALLAS_GRAD=0``), as ``repro/kernels/fd_fused.py`` does, beside
  the kernels' launch counts in :data:`counters`.

Spectra are kept channel-major, (b, d, n+1): ``torch.fft`` transforms the
last axis of a (b, d, 2n) signal into exactly that contiguous layout, and
the causal spectrum of a (d, n+1) response needs no transpose either.

Each kernel wrapper takes the plain version (``kernels/ref.py``) for a CPU
tensor and launches its kernel for a CUDA tensor, counting the launch in
:data:`counters`; any other device, dtype, shape, layout, or a lazily
conjugated or negated view, raises. A kernel writes a fresh tensor that
autograd cannot see, so ``fd_mul`` and ``fd_khat_grad`` called on their
own are forward-only on the card: they raise for an input that requires
grad while grad is enabled. Gradients go through :func:`fd_tno` and
:func:`hilbert_window`, whose autograd Functions run on both devices (on
the CPU with the plain versions inside), so the CPU tests check the
backward formulas and only the kernels' insides are left for the card.
"""
from __future__ import annotations

import ctypes
import functools

import torch
from torch.autograd.function import once_differentiable

from repro_torch.kernels import backend, ref
from repro_torch.obs.devstats import kernel_region

#: kernel launches per wrapper (CUDA path only; the CPU path counts nothing)
counters = {"hilbert_window": 0, "causal_spectrum": 0,
            "causal_spectrum_adjoint": 0, "fd_mul": 0, "fd_khat_grad": 0}
#: differentiated :func:`fd_tno` forwards (grad enabled and an input that
#: requires grad) and :class:`FDTNO` backwards: the kernel backward, or
#: autograd through the plain version (``backend.resolve_pallas_grad``)
op_counters = {"fwd": 0, "bwd_kernel": 0, "bwd_ref": 0}


def reset_counters() -> None:
    for d in (counters, op_counters):
        for k in d:
            d[k] = 0


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = backend.library("fd_fused")
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.hilbert_window_f32.argtypes = [p, p, i64, i64, p]
    lib.hilbert_window_f32.restype = ctypes.c_int
    lib.fd_mul_c64.argtypes = [p, p, p, i64, i64, p]
    lib.fd_mul_c64.restype = ctypes.c_int
    lib.fd_khat_grad_c64.argtypes = [p, p, p, i64, i64, p]
    lib.fd_khat_grad_c64.restype = ctypes.c_int
    lib.causal_spectrum_f32.argtypes = [p, p, i64, i64, ctypes.c_int, p]
    lib.causal_spectrum_f32.restype = ctypes.c_int
    lib.causal_spectrum_adjoint_f32.argtypes = [p, p, i64, i64, p]
    lib.causal_spectrum_adjoint_f32.restype = ctypes.c_int
    return lib


def _forward_only(what: str, *ts: torch.Tensor) -> None:
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        raise NotImplementedError(
            f"{what}: the CUDA kernel on its own is forward-only; "
            "differentiate through fd_tno (or hilbert_window), whose "
            "backward runs the kernels, or call it under torch.no_grad()")


# ------------------------------------------------------ hilbert lag window
def _window(kt: torch.Tensor, n: int) -> torch.Tensor:
    if kt.device.type == "cpu":
        return ref.hilbert_window_ref(kt, n)
    backend.require_cuda(kt, "hilbert_window", torch.float32)
    out = torch.empty_like(kt)
    lib = _lib()
    with torch.cuda.device(kt.device):
        rc = lib.hilbert_window_f32(kt.data_ptr(), out.data_ptr(),
                                    kt.shape[0], n, backend.stream(kt))
    backend.check(lib, rc, "hilbert_window")
    counters["hilbert_window"] += 1
    return out


class HilbertWindow(torch.autograd.Function):
    """The lag window as a differentiable op. Diagonal ⇒ self-adjoint: the
    backward is the same kernel on the cotangent (``_window_core``'s custom
    VJP in the JAX package)."""

    @staticmethod
    def forward(ctx, kt, n):
        ctx.n = n
        return _window(kt, n)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        return _window(g.contiguous(), ctx.n), None


def hilbert_window(kt: torch.Tensor, n: int) -> torch.Tensor:
    """kt (d, 2n) fp32 time response → a new (d, 2n) tensor with lag 0 and
    lag n kept, lags 1..n-1 doubled and lags beyond n zeroed.
    Differentiable (:class:`HilbertWindow`). CPU: :func:`ref.hilbert_window_ref`."""
    if kt.dim() != 2 or kt.shape[1] != 2 * n:
        raise ValueError(f"hilbert_window: kt {tuple(kt.shape)} is not "
                         f"(d, 2n) with 2n = {2 * n}")
    return HilbertWindow.apply(kt, n)


# ------------------------------------------------- complex spectral multiply
def fd_mul(xhat: torch.Tensor, khat: torch.Tensor) -> torch.Tensor:
    """ŷ[i] = x̂[i] ⊙ k̂ for every batch row i: xhat (b, ...) complex64,
    khat complex64 shaped like one row (``xhat.shape[1:]``), both
    contiguous. Returns a new complex64 tensor shaped like xhat.
    CPU: :func:`ref.fd_mul_ref`."""
    if xhat.device.type == "cpu" and khat.device.type == "cpu":
        return ref.fd_mul_ref(xhat, khat)
    _forward_only("fd_mul", xhat, khat)
    backend.require_cuda(xhat, "fd_mul x̂", torch.complex64)
    backend.require_cuda(khat, "fd_mul k̂", torch.complex64)
    if (xhat.device != khat.device
            or tuple(khat.shape) != tuple(xhat.shape[1:])):
        raise ValueError(f"fd_mul: k̂ {tuple(khat.shape)} on {khat.device} "
                         f"does not match one row of x̂ {tuple(xhat.shape)} "
                         f"on {xhat.device}")
    out = torch.empty_like(xhat)
    lib = _lib()
    with torch.cuda.device(xhat.device):
        rc = lib.fd_mul_c64(xhat.data_ptr(), khat.data_ptr(), out.data_ptr(),
                            xhat.shape[0], khat.numel(), backend.stream(xhat))
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


# --------------------------------------------------- khat cotangent reduce
def fd_khat_grad(ghat: torch.Tensor, xhat: torch.Tensor) -> torch.Tensor:
    """Σ_b ĝ[b] ⊙ conj(x̂[b]): ghat, xhat (b, ...) complex64 of one shape,
    contiguous (the channel-major (b, d, n+1) spectra of the backward).
    Returns a new (...) complex64 tensor. On the card the batch is summed
    in order by one thread per output element, so the result is bitwise
    reproducible. CPU: :func:`ref.fd_khat_grad_ref`."""
    if ghat.device.type == "cpu" and xhat.device.type == "cpu":
        return ref.fd_khat_grad_ref(ghat, xhat)
    _forward_only("fd_khat_grad", ghat, xhat)
    backend.require_cuda(ghat, "fd_khat_grad ĝ", torch.complex64)
    backend.require_cuda(xhat, "fd_khat_grad x̂", torch.complex64)
    if (ghat.device != xhat.device or ghat.shape != xhat.shape
            or ghat.dim() < 1):
        raise ValueError(f"fd_khat_grad: ĝ {tuple(ghat.shape)} on "
                         f"{ghat.device} and x̂ {tuple(xhat.shape)} on "
                         f"{xhat.device} are not (b, ...) of one shape")
    out = torch.empty(ghat.shape[1:], dtype=torch.complex64,
                      device=ghat.device)
    lib = _lib()
    with torch.cuda.device(ghat.device):
        rc = lib.fd_khat_grad_c64(ghat.data_ptr(), xhat.data_ptr(),
                                  out.data_ptr(), ghat.shape[0], out.numel(),
                                  backend.stream(ghat))
    backend.check(lib, rc, "fd_khat_grad")
    counters["fd_khat_grad"] += 1
    return out


def fd_khat_grad_planes(gr, gi, xr, xi):
    """Planes signature of :func:`fd_khat_grad`, as
    ``repro.kernels.fd_fused.fd_khat_grad_pallas``: gr, gi, xr, xi
    (b, F, d) → (dkr, dki) fp32 (F, d)."""
    dk = fd_khat_grad(torch.complex(gr.float(), gi.float()).contiguous(),
                      torch.complex(xr.float(), xi.float()).contiguous())
    return dk.real, dk.imag


# ------------------------------------------------ causal spectrum, fused
def _fused_length(t: torch.Tensor, what: str) -> int:
    """n of a (d, n+1) spectrum on the fused route (d >= 1), or raise."""
    if t.dim() != 2 or t.shape[0] < 1 or t.shape[1] < 2:
        raise ValueError(f"{what}: {tuple(t.shape)} is not (d, n+1) with "
                         "d >= 1 and n >= 1")
    n = t.shape[1] - 1
    if backend.causal_spectrum_route(n) != "fused":
        raise ValueError(f"{what}: n = {n} is not on the fused route (a "
                         "power of two up to "
                         f"{backend.CAUSAL_SPECTRUM_NMAX}); other lengths "
                         "take irfft, hilbert_window and rfft")
    return n


def causal_spectrum(u: torch.Tensor, conj: bool = False) -> torch.Tensor:
    """Causal spectrum k̂ = rfft(w ⊙ irfft(u, 2n), 2n) of u (d, n+1) fp32
    contiguous, n on ``backend.causal_spectrum_route``'s "fused" route:
    a new (d, n+1) complex64 tensor, conj(k̂) with ``conj``. One launch
    on the card, bitwise the same from call to call; forward-only there
    (gradients go through :func:`fd_tno`). CPU:
    :func:`ref.causal_spectrum_ref`."""
    n = _fused_length(u, "causal_spectrum")
    if u.device.type == "cpu":
        return ref.causal_spectrum_ref(u, conj)
    _forward_only("causal_spectrum", u)
    backend.require_cuda(u, "causal_spectrum u", torch.float32)
    out = torch.empty(u.shape, dtype=torch.complex64, device=u.device)
    lib = _lib()
    with torch.cuda.device(u.device):
        rc = lib.causal_spectrum_f32(u.data_ptr(), out.data_ptr(),
                                     u.shape[0], n, int(conj),
                                     backend.stream(u))
    backend.check(lib, rc, "causal_spectrum")
    counters["causal_spectrum"] += 1
    return out


def causal_spectrum_adjoint(dk: torch.Tensor, n: int) -> torch.Tensor:
    """The spectrum cotangent dk (d, n+1) complex64 contiguous pulled back
    to the real response: irfftᵀ(w ⊙ irfft(dk, 2n)), the imaginary parts
    of bins 0 and n dropped. A new (d, n+1) fp32 tensor; n on the "fused"
    route. One launch on the card, bitwise the same from call to call;
    forward-only there. CPU: :func:`ref.causal_spectrum_adjoint_ref`."""
    if _fused_length(dk, "causal_spectrum_adjoint") != n:
        raise ValueError(f"causal_spectrum_adjoint: dk {tuple(dk.shape)} "
                         f"is not (d, n+1) with n = {n}")
    if dk.device.type == "cpu":
        return ref.causal_spectrum_adjoint_ref(dk, n)
    _forward_only("causal_spectrum_adjoint", dk)
    backend.require_cuda(dk, "causal_spectrum_adjoint dk", torch.complex64)
    out = torch.empty(dk.shape, dtype=torch.float32, device=dk.device)
    lib = _lib()
    with torch.cuda.device(dk.device):
        rc = lib.causal_spectrum_adjoint_f32(dk.data_ptr(), out.data_ptr(),
                                             dk.shape[0], n,
                                             backend.stream(dk))
    backend.check(lib, rc, "causal_spectrum_adjoint")
    counters["causal_spectrum_adjoint"] += 1
    return out


# --------------------------------------------------------- the fused op
def causal_khat_planes(khat_real: torch.Tensor):
    """(d, n+1) real response → (n+1, d) re/im planes of the causal
    spectrum ``khat - i·H{khat}`` (the JAX function's layout, for the
    parity tests; :func:`fd_tno` keeps the (d, n+1) complex tensor)."""
    from repro_torch.core.hilbert import causal_spectrum
    khat = causal_spectrum(khat_real)
    return khat.real.T, khat.imag.T


def _spectrum(s: torch.Tensor, n: int) -> torch.Tensor:
    """(b, n, d) signal → its contiguous channel-major (b, d, n+1) rfft on
    the length-2n grid (zero-padded)."""
    return torch.fft.rfft(s.float().transpose(1, 2), n=2 * n,
                          dim=-1).contiguous()


def window_route_spectrum(khat_real: torch.Tensor,
                          conj: bool = False) -> torch.Tensor:
    """The causal spectrum off the fused route: irfft,
    :func:`hilbert_window`, rfft (``core.hilbert.causal_spectrum``), then
    ``conj_physical`` with ``conj`` (the kernels read raw memory).
    Contiguous (d, n+1) complex64."""
    from repro_torch.core.hilbert import causal_spectrum as completion
    khat = completion(khat_real).contiguous()                 # (d, n+1)
    return torch.conj_physical(khat) if conj else khat


def irfft_adjoint(g: torch.Tensor, n: int) -> torch.Tensor:
    """The adjoint of ``irfft(·, 2n)`` on a real (..., n+1) input, applied
    to a real (..., 2n) cotangent g: (c_s / 2n) · Re rfft(g)[s], c_0 = c_n =
    1 and c_s = 2 between (irfft(k)[t] = (k_0 + (-1)^t k_n + 2 Σ_s k_s
    cos(π s t / n)) / 2n). One rfft and one scale: the closed form of
    autograd's irfft VJP, and what ``causal_spectrum_adjoint`` computes."""
    out = torch.fft.rfft(g, n=2 * n, dim=-1).real / n
    out[..., ::n] *= 0.5  # bins 0 and n
    return out


def window_route_cotangent(dk: torch.Tensor, khat_real: torch.Tensor,
                           n: int) -> torch.Tensor:
    """dkhat_real off the fused route, in khat_real's dtype: the imaginary
    parts of bins 0 and n of the spectrum cotangent dropped (a C2R irfft
    assumes them 0; cuFFT keeps them at some lengths, pocketfft never), its
    irfft, the self-adjoint :func:`hilbert_window`, and the closed-form irfft
    adjoint (:func:`irfft_adjoint`), as the fused
    :func:`causal_spectrum_adjoint` and ``ref.causal_spectrum_adjoint_ref``
    compute it."""
    dk = dk.clone()
    dk.imag[..., ::n] = 0  # bins 0 and n
    dkt = hilbert_window(torch.fft.irfft(dk, n=2 * n, dim=-1), n)
    return irfft_adjoint(dkt, n).to(khat_real.dtype)


def _causal_khat(khat_real: torch.Tensor, conj: bool = False) -> torch.Tensor:
    """The contiguous (d, n+1) causal spectrum, conjugated with ``conj``,
    on the route ``backend.causal_spectrum_route`` gives its length."""
    n = khat_real.shape[-1] - 1
    if backend.causal_spectrum_route(n) == "fused":
        return causal_spectrum(khat_real.float().contiguous(), conj)
    return window_route_spectrum(khat_real, conj)


def _khat_real_cotangent(dk: torch.Tensor, khat_real: torch.Tensor,
                         n: int) -> torch.Tensor:
    """dkhat_real = irfftᵀ(w ⊙ irfft(dk)) from the spectrum cotangent dk
    (d, n+1), on the route of its length."""
    if backend.causal_spectrum_route(n) == "fused":
        return causal_spectrum_adjoint(dk, n).to(khat_real.dtype)
    return window_route_cotangent(dk, khat_real, n)


class FDTNO(torch.autograd.Function):
    """Causal FD-TNO with the backward of ``fd_tno_pallas``'s custom VJP
    (``repro/kernels/fd_fused.py:307-347``). All cotangents are exact
    linear-operator adjoints (circular correlation theorem):

        dx      = slice_n( irfft( rfft(pad g) ⊙ conj k̂ ) )   fd_mul, conj k̂
        dk̂_time = irfft( Σ_b rfft(pad g) ⊙ conj(rfft(pad x)) )   fd_khat_grad
        dkhat   = irfftᵀ( w ⊙ dk̂_time )          causal_spectrum_adjoint

    Residuals are the inputs only; the backward recomputes k̂ (one more
    ``causal_spectrum`` launch, or window launch off the fused route) and
    x̂ rather than keep 2 MB a layer of spectrum. Under
    ``REPRO_PALLAS_GRAD=0`` the backward is autograd through
    :func:`ref.fd_tno_ref` instead, and launches no kernel."""

    @staticmethod
    def forward(ctx, x, khat_real):
        ctx.save_for_backward(x, khat_real)
        n = x.shape[1]
        y = torch.fft.irfft(fd_mul(_spectrum(x, n), _causal_khat(khat_real)),
                            n=2 * n, dim=-1)                 # (b, d, 2n)
        return y[..., :n].transpose(1, 2).to(x.dtype)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        with kernel_region("fd_tno"):
            x, khat_real = ctx.saved_tensors
            if not backend.resolve_pallas_grad():
                op_counters["bwd_ref"] += 1
                return backend.ref_cotangents(ref.fd_tno_ref,
                                              (x, khat_real), g)
            op_counters["bwd_kernel"] += 1
            n = x.shape[1]
            ghat = _spectrum(g, n)
            # signal cotangent: the forward multiply with the spectrum
            # conjugated (adjoint of causal conv = anticausal correlation)
            dx = torch.fft.irfft(
                fd_mul(ghat, _causal_khat(khat_real, conj=True)),
                n=2 * n, dim=-1)
            dx = dx[..., :n].transpose(1, 2).to(x.dtype)
            # kernel cotangent: Σ_b ĝ ⊙ conj(x̂); its irfft is exactly the
            # time cotangent of the causal kernel; then the self-adjoint
            # window and the exact irfft adjoint pull it back to khat_real
            dk = fd_khat_grad(ghat, _spectrum(x, n))              # (d, n+1)
            return dx, _khat_real_cotangent(dk, khat_real, n)


def fd_tno(x: torch.Tensor, khat_real: torch.Tensor) -> torch.Tensor:
    """Causal FD-TNO: y = irfft(rfft(x) ⊙ k̂)[:n] with k̂ the
    Hilbert-completed causal spectrum of ``khat_real``.

    x: (b, n, d); khat_real: (d, n+1) real response on the rfft grid.
    Returns (b, n, d) in x's dtype (a channel-major view). Matches
    :func:`ref.fd_tno_ref`; differentiable through :class:`FDTNO` on
    both devices."""
    if torch.is_grad_enabled() and (x.requires_grad
                                    or khat_real.requires_grad):
        op_counters["fwd"] += 1
    return FDTNO.apply(x, khat_real)
