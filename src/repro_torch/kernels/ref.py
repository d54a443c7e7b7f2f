"""Plain torch versions of the kernels, function for function with
``repro/kernels/ref.py``. The CPU path of every kernel wrapper runs these;
``chip_smoke.py`` holds each CUDA kernel against them on the card. Nothing
on the CUDA main path calls them. All are differentiable by autograd."""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import toeplitz


# ------------------------------------------------------------- short conv
def _shift_conv(x: torch.Tensor, filt: torch.Tensor,
                left: int) -> torch.Tensor:
    """y[:, j] = sum_k f_k x[:, j-k+left] (x zero outside [0, n)) by m
    shifted multiply-adds over a zero-padded copy, in fp32.
    x: (b, n, d); filt: (d, m)."""
    n = x.shape[1]
    m = filt.shape[-1]
    xp = F.pad(x.float(), (0, 0, m - 1 - left, left))
    f = filt.float()
    acc = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for k in range(m):
        acc = acc + xp[:, m - 1 - k:m - 1 - k + n, :] * f[:, k][None, None, :]
    return acc


def short_conv_ref(x: torch.Tensor, filt: torch.Tensor,
                   causal: bool) -> torch.Tensor:
    """Depthwise short 1-D convolution, the sparse Toeplitz part of SKI.
    x: (b, n, d); filt: (d, m) per-channel taps. causal: taps cover lags
    0..m-1; bidirectional: lags -(m//2)..m-1-m//2. Returns (b, n, d) in
    x's dtype. Autograd differentiates it; the analytic rule of the JAX
    function's custom VJP (dx the same conv with the taps flipped and
    ``left`` mirrored to m-1-left, df :func:`conv_tap_grad_ref`) is the
    backward of ``kernels/short_conv.ShortConv``, on both devices."""
    m = filt.shape[-1]
    return _shift_conv(x, filt, 0 if causal else m // 2).to(x.dtype)


def short_conv_left_ref(x: torch.Tensor, filt: torch.Tensor,
                        left: int) -> torch.Tensor:
    """Short conv with a general tap offset ``left`` (0 <= left < m)."""
    return _shift_conv(x, filt, left).to(x.dtype)


def conv_tap_grad_ref(g: torch.Tensor, x: torch.Tensor, m: int,
                      left: int) -> torch.Tensor:
    """Filter cotangent of the short conv: df[c, k] = Σ_{b,j} g[b,j,c] ·
    x[b, j-k+left, c] (x zero outside [0, n)). g, x: (b, n, d) → (d, m)
    fp32. Plain version of the ``conv_tap_grad`` kernel."""
    n = x.shape[1]
    gf = g.float()
    xp = F.pad(x.float(), (0, 0, m - 1 - left, left))
    return torch.stack(
        [torch.einsum("bnc,bnc->c", gf, xp[:, m - 1 - k:m - 1 - k + n, :])
         for k in range(m)], dim=-1)


# -------------------------------------------------- banded interp (SKI W)
def hat_geometry(n: int, r: int):
    """Host-numpy (idx_lo (n,) int32, w_lo (n,) fp32, h) of the linear
    interpolation of n positions onto r uniform inducing points, built as
    ``repro/core/ski.py`` builds it: fp32 i / float32(h), so the CUDA
    kernels (which compute the same fp32 quotient) agree bit for bit."""
    h = (n - 1) / (r - 1)
    f = np.arange(n, dtype=np.float32) / np.float32(h)
    lo = np.clip(np.floor(f).astype(np.int32), 0, r - 2)
    # clamp: fp32 rounding of the irrational spacing h can push the
    # boundary weight a few ulp outside [0, 1]
    w_lo = np.clip((1.0 - (f - lo.astype(np.float32))).astype(np.float32),
                   np.float32(0.0), np.float32(1.0))
    return lo, w_lo, h


def dense_interp_matrix(idx_lo: torch.Tensor, w_lo: torch.Tensor,
                        r: int) -> torch.Tensor:
    """Materialised (n, r) W: w_lo on idx_lo, 1 - w_lo on idx_lo + 1."""
    n = idx_lo.shape[0]
    rows = torch.arange(n, device=idx_lo.device)
    lo = idx_lo.long()
    w = torch.zeros((n, r), dtype=torch.float32, device=idx_lo.device)
    w = w.index_put((rows, lo), w_lo.float(), accumulate=True)
    return w.index_put((rows, lo + 1), 1.0 - w_lo.float(), accumulate=True)


def hat_interp_matrix(n: int, r: int) -> torch.Tensor:
    """(n, r) W regenerated from the uniform grid alone."""
    lo, w_lo, _ = hat_geometry(n, r)
    return dense_interp_matrix(torch.from_numpy(lo), torch.from_numpy(w_lo),
                               r)


def interp_reduce_ref(x: torch.Tensor, idx_lo: torch.Tensor,
                      w_lo: torch.Tensor, r: int) -> torch.Tensor:
    """Plain version of the ``interp_reduce`` kernel: z = Wᵀ x as the dense
    hat-weight contraction. x: (b, n, d) -> (b, r, d) in x's dtype."""
    w = dense_interp_matrix(idx_lo, w_lo, r)                  # (n, r)
    return torch.einsum("nr,bnd->brd", w, x.float()).to(x.dtype)


def interp_reduce_scatter_oracle(x: torch.Tensor, idx_lo: torch.Tensor,
                                 w_lo: torch.Tensor, r: int) -> torch.Tensor:
    """z = Wᵀ x by two scatter-adds of the weighted rows, O(n) (tests
    only): an oracle independent of the dense hat matrix."""
    xf = x.float()
    w = w_lo.float()[None, :, None]
    lo = idx_lo.long()
    z = torch.zeros((x.shape[0], r, x.shape[2]), dtype=torch.float32,
                    device=x.device)
    z = z.index_add(1, lo, xf * w)
    return z.index_add(1, lo + 1, xf * (1.0 - w)).to(x.dtype)


def interp_expand_ref(z: torch.Tensor, idx_lo: torch.Tensor,
                      w_lo: torch.Tensor) -> torch.Tensor:
    """Plain version of the ``interp_expand`` kernel: y = W z as the dense
    hat-weight contraction. z: (b, r, d) -> (b, n, d) with n =
    ``idx_lo.shape[0]``, in z's dtype."""
    w = dense_interp_matrix(idx_lo, w_lo, z.shape[1])         # (n, r)
    return torch.einsum("nr,brd->bnd", w, z.float()).to(z.dtype)


def gram_grad_ref(gz: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Gram cotangent: dA[c, s, t] = Σ_b gz[b,s,c] · z[b,t,c]. gz, z:
    (b, r, d) → (d, r, r) fp32. Plain version of the ``gram_grad``
    kernel."""
    return torch.einsum("bsc,btc->cst", gz.float(), z.float())


# ----------------------------------------------------- fused SKI pass 2
def ski_expand_pass2_ref(x: torch.Tensor, z2: torch.Tensor,
                         filt: torch.Tensor, causal: bool,
                         left: int | None = None) -> torch.Tensor:
    """Gram-free half of pass 2: y = W z2 + T_sparse x, with W's two-tap
    rows (two row gathers and a blend). x: (b, n, d); z2: (b, r, d);
    filt: (d, m); ``left`` overrides the causal-derived tap offset."""
    n = x.shape[1]
    r = z2.shape[1]
    m = filt.shape[-1]
    if left is None:
        left = 0 if causal else m // 2
    lo, w_lo, _ = hat_geometry(n, r)
    lo = torch.from_numpy(lo).to(x.device).long()
    w_lo = torch.from_numpy(w_lo).to(x.device)[None, :, None]
    z2 = z2.float()
    y = w_lo * z2[:, lo, :] + (1.0 - w_lo) * z2[:, lo + 1, :]
    y = y + _shift_conv(x, filt, left)
    return y.to(x.dtype)


def ski_fused_pass2_ref(x: torch.Tensor, z: torch.Tensor,
                        a_dense: torch.Tensor, filt: torch.Tensor,
                        causal: bool, left: int | None = None,
                        transpose_a: bool = False) -> torch.Tensor:
    """Plain version of the ``ski_fused_pass2`` kernel:
    y = W (A z) + T_sparse x, or W (Aᵀ z) + T_sparse x when
    ``transpose_a``. x: (b, n, d); z = Wᵀx: (b, r, d); a_dense: (d, r, r);
    filt: (d, m); fp32 throughout, cast back to x's dtype."""
    gram = "dts,btd->bsd" if transpose_a else "dst,btd->bsd"
    z2 = torch.einsum(gram, a_dense.float(), z.float())
    return ski_expand_pass2_ref(x, z2, filt, causal, left=left)


def ski_fused_tno_ref(x: torch.Tensor, a_dense: torch.Tensor,
                      filt: torch.Tensor, idx_lo: torch.Tensor,
                      w_lo: torch.Tensor, r: int,
                      causal: bool) -> torch.Tensor:
    """Two-pass fused SKI-TNO: y = W (A (Wᵀ x)) + T_sparse x.
    Differentiable by autograd in (x, a_dense, filt)."""
    z = interp_reduce_ref(x, idx_lo, w_lo, r)
    return ski_fused_pass2_ref(x, z, a_dense, filt, causal)


def toeplitz_gram_matvec_ref(a_coef: torch.Tensor,
                             z: torch.Tensor) -> torch.Tensor:
    """z2 = A z for the coefficient-form Gram: a_coef (d, 2r-1) Toeplitz
    lags -(r-1)..(r-1), z (b, r, d) → (b, r, d), by the length-2r circulant
    rfft/irfft (the only Gram action that exists at large rank, where the
    dense (d, r, r) form does not fit)."""
    z2t = toeplitz.toeplitz_matvec(a_coef[None], z.transpose(1, 2))
    return z2t.transpose(1, 2)


def ski_fused_tno_coef_ref(x: torch.Tensor, a_coef: torch.Tensor,
                           filt: torch.Tensor, idx_lo: torch.Tensor,
                           w_lo: torch.Tensor, r: int,
                           causal: bool) -> torch.Tensor:
    """Large-rank fused SKI-TNO, coefficient form: y = W (A (Wᵀ x)) +
    T_sparse x with A given as a_coef (d, 2r-1). The plain version of both
    ``ski_vjp.SKIFusedTNOCoef`` variants (windowed and FFT-Gram: two ways
    to the same operator); differentiable by autograd."""
    z = interp_reduce_ref(x, idx_lo, w_lo, r)
    z2 = toeplitz_gram_matvec_ref(a_coef, z)
    return ski_expand_pass2_ref(x, z2, filt, causal)


def gram_coef_grad_ref(gz: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Coefficient-Gram cotangent, O(r²) (tests): dcoef[c, k] =
    Σ_{b, s-t = k-(r-1)} gz[b,s,c] · z[b,t,c] → (d, 2r-1) fp32, the
    diagonal sums of the dense cotangent :func:`gram_grad_ref`. The
    production form is ``ski_grad.gram_coef_grad_fft``."""
    r, d = z.shape[1], z.shape[2]
    da = gram_grad_ref(gz, z)                                 # (d, r, r)
    i = torch.arange(r, device=z.device)
    lag = (i[:, None] - i[None, :] + (r - 1)).reshape(-1)    # in [0, 2r-2]
    out = torch.zeros((d, 2 * r - 1), dtype=torch.float32, device=z.device)
    return out.index_add(1, lag, da.reshape(d, r * r))


# ------------------------------------------------------- causal FD-TNO
def hilbert_window_ref(kt: torch.Tensor, n: int) -> torch.Tensor:
    """Analytic-signal lag window (paper §3.3.1 Hilbert step in the lag
    variable): keep lag 0 and lag n, double lags 1..n-1, zero the rest.
    kt: (d, T) with T >= n+1 (normally T = 2n). Plain version of the
    ``hilbert_window`` kernel; diagonal ⇒ self-adjoint."""
    t = torch.arange(kt.shape[-1], device=kt.device)
    w = torch.where((t == 0) | (t == n), 1.0,
                    torch.where(t < n, 2.0, 0.0))
    return (kt.float() * w[None]).to(kt.dtype)


def fd_spectral_multiply_ref(xr, xi, kr, ki):
    """Complex spectral multiply on planes: ŷ = x̂ ⊙ k̂ per channel.
    xr, xi: (b, F, d); kr, ki: (F, d). fp32 outputs."""
    xr, xi = xr.float(), xi.float()
    kr, ki = kr.float()[None], ki.float()[None]
    return xr * kr - xi * ki, xr * ki + xi * kr


def fd_mul_ref(xhat: torch.Tensor, khat: torch.Tensor) -> torch.Tensor:
    """Plain version of the ``fd_mul`` kernel on complex64 tensors:
    ŷ[b] = x̂[b] ⊙ k̂, with k̂ shaped like one batch row of x̂. The same
    real arithmetic as the kernel, through :func:`fd_spectral_multiply_ref`."""
    yr, yi = fd_spectral_multiply_ref(xhat.real, xhat.imag,
                                      khat.real, khat.imag)
    return torch.complex(yr, yi)


def fd_khat_grad_planes_ref(gr, gi, xr, xi):
    """Kernel-spectrum cotangent on planes: Σ_b ĝ ⊙ conj(x̂), reduced over
    the leading (batch) axis. gr, gi, xr, xi: (b, F, d) → (dkr, dki) fp32
    (F, d) each, as ``repro/kernels/ref.py:fd_khat_grad_ref``."""
    gr, gi, xr, xi = gr.float(), gi.float(), xr.float(), xi.float()
    return (torch.sum(gr * xr + gi * xi, dim=0),
            torch.sum(gi * xr - gr * xi, dim=0))


def fd_khat_grad_ref(ghat: torch.Tensor, xhat: torch.Tensor) -> torch.Tensor:
    """Plain version of the ``fd_khat_grad`` kernel on complex64 tensors:
    Σ_b ĝ[b] ⊙ conj(x̂[b]) for ĝ, x̂ of one shape (b, ...), e.g. the
    channel-major (b, d, n+1) spectra; returns (...) complex64. The same
    real arithmetic as the kernel, through :func:`fd_khat_grad_planes_ref`."""
    dr, di = fd_khat_grad_planes_ref(ghat.real, ghat.imag,
                                     xhat.real, xhat.imag)
    return torch.complex(dr, di)


def causal_spectrum_ref(khat_real: torch.Tensor,
                        conj: bool = False) -> torch.Tensor:
    """(d, n+1) real response → complex (d, n+1) causal spectrum
    ``khat - i·H{khat}`` via the lag window (plain version of
    ``core.hilbert.causal_spectrum`` and of the ``causal_spectrum``
    kernel); its conjugate with ``conj``."""
    n = khat_real.shape[-1] - 1
    kt = torch.fft.irfft(khat_real.float(), n=2 * n, dim=-1)
    khat = torch.fft.rfft(hilbert_window_ref(kt, n), n=2 * n, dim=-1)
    return torch.conj_physical(khat) if conj else khat


def causal_spectrum_adjoint_ref(dk: torch.Tensor, n: int) -> torch.Tensor:
    """Pull a (d, n+1) complex spectrum cotangent back to the real
    response: irfftᵀ(w ⊙ irfft(dk, 2n)), the irfft's adjoint by autograd,
    as the FD-TNO backward's window route does it. The imaginary parts of
    bins 0 and n are dropped first, as a C2R irfft assumes (pocketfft
    ignores them; cuFFT's result for them differs by length). Plain
    version of the ``causal_spectrum_adjoint`` kernel; (d, n+1) fp32."""
    edge = torch.zeros(n + 1, dtype=torch.bool, device=dk.device)
    edge[0] = edge[n] = True
    dk = torch.where(edge, dk.real.to(dk.dtype), dk)
    dkt = hilbert_window_ref(torch.fft.irfft(dk, n=2 * n, dim=-1), n)
    with torch.enable_grad():
        k = torch.zeros(dk.shape, dtype=torch.float32, device=dk.device,
                        requires_grad=True)
        (dkhat_real,) = torch.autograd.grad(
            torch.fft.irfft(k, n=2 * n, dim=-1), k, dkt, create_graph=True)
    return dkhat_real


def fd_tno_ref(x: torch.Tensor, khat_real: torch.Tensor) -> torch.Tensor:
    """Causal FD-TNO: y = irfft(rfft(x, 2n) ⊙ k̂, 2n)[:n] with
    k̂ = causal_spectrum(khat_real). x: (b, n, d); khat_real: (d, n+1)."""
    b, n, d = x.shape
    khat = causal_spectrum_ref(khat_real)                      # (d, n+1)
    xhat = torch.fft.rfft(x.float(), n=2 * n, dim=1)          # (b, n+1, d)
    y = torch.fft.irfft(xhat * khat.T[None], n=2 * n, dim=1)[:, :n]
    return y.to(x.dtype)


# ------------------------------------------------------------- mamba2 SSD
def ssd_scan_ref(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                 b: torch.Tensor, c: torch.Tensor,
                 d_skip: torch.Tensor) -> torch.Tensor:
    """Mamba-2 SSD sequential oracle (the state-space recurrence), one
    step a position, in fp32 (float64 inputs stay float64).

    x (bt, n, h, p) per-head inputs; dt (bt, n, h) positive step sizes;
    a (h,) negative decay rates (A = -exp(a_log)); b, c (bt, n, g, s) the
    input and output projections of g groups (head i reads group
    i // (h/g)); d_skip (h,) the skip. Returns y (bt, n, h, p) in x's
    dtype."""
    bt, n, h, p = x.shape
    g = b.shape[2]
    wt = torch.promote_types(x.dtype, torch.float32)
    bx = b.to(wt).repeat_interleave(h // g, dim=2)       # (bt, n, h, s)
    cx = c.to(wt).repeat_interleave(h // g, dim=2)
    xf, dtf = x.to(wt), dt.to(wt)
    da = torch.exp(dtf * a.to(wt)[None, None, :])         # (bt, n, h)
    state = torch.zeros(bt, h, p, b.shape[-1], dtype=wt, device=x.device)
    ys = []
    for t in range(n):
        state = state * da[:, t, :, None, None] + (
            (dtf[:, t, :, None] * xf[:, t])[..., :, None]
            * bx[:, t, :, None, :])
        ys.append(torch.einsum("bhps,bhs->bhp", state, cx[:, t]))
    y = torch.stack(ys, dim=1) + xf * d_skip.to(wt)[None, None, :, None]
    return y.to(x.dtype)
