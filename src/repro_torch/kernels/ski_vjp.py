"""The trainable fused SKI-TNO, counterpart of the ``ski_fused_tno_pallas``
(dense Gram, ``:51-115``) and ``ski_fused_tno_coef_pallas`` (large rank,
``:118-204``) custom VJPs of ``repro/kernels/ski_vjp.py``.

Every factor of the two-pass pipeline is linear in the signal, so the
backward is the transposed pipeline and reuses the forward kernels::

    forward   z  = Wᵀ x                        interp_reduce
              y  = W (A z) + T_sparse x        ski_fused_pass2
    backward  gz = Wᵀ g, z = Wᵀ x (recomputed) interp_reduce, twice
              dx = W (Aᵀ gz) + T_sparseᵀ g     ski_fused_pass2 with Aᵀ
                                               (read in place), the taps
                                               flipped and left -> m-1-left
              dA[c] = Σ_b gz[b,:,c] z[b,:,c]ᵀ  gram_grad
              df[c,k] = Σ_{b,j} g[b,j,c] x[b,j-k+left,c]   conv_tap_grad

:class:`SKIFusedTNO` takes A dense, (d, r, r). :class:`SKIFusedTNOCoef`
takes it as its (d, 2r-1) Toeplitz coefficients, never dense, for the
ranks ``backend.ski_rank_variant`` routes away from the dense Gram:
"windowed" runs pass 2 as ``ski_windowed_pass2`` (each tile computes its
window of A z), "fft" applies A by a length-2r rfft/irfft (:func:`_gram_fft`)
and runs ``ski_expand_pass2``. Its backward is the same with Aᵀ as the
lag-flipped coefficients, and dA as ``gram_coef_grad_fft`` (the diagonal
sums of gz zᵀ by FFT, no (r, r) panel).

Residuals are the op's inputs (x, A, f) only: no O(n·r) activation is
kept. :class:`SKIFusedTNO` runs in x's dtype, fp32 or bf16 (the bf16 SKI
model: x bf16, A fp32 from the RPE's fp32 lags, the taps bf16): on the
card a bf16 x launches the bf16 instances (``interp_reduce_bf16``
twice in the backward, ``ski_fused_pass2_bf16`` and
``ski_fused_pass2_at_bf16``, ``gram_grad_bf16``, ``conv_tap_grad_bf16``),
each summing in fp32; z, gz and dx are rounded to bf16 where the plain
versions round them, and the cotangents come back in the primal dtypes
(dx in x's, dA in A's, df in the taps'), as JAX's custom VJP returns them.
:class:`SKIFusedTNOCoef` runs in x's dtype too: a bf16 x launches
``interp_reduce_bf16`` (three times a step), ``ski_windowed_pass2_bf16``
or ``ski_expand_pass2_bf16`` (forward, and the backward with the
lag-flipped coefficients) and ``conv_tap_grad_bf16``; on the "fft" route
:func:`_gram_fft` sums in fp32 and hands pass 2 a bf16 z₂, as JAX's
``_gram_fft`` does, and ``gram_coef_grad_fft`` widens gz and z before its
transforms (the card's FFT has no bf16). Both Functions run on both
devices: on the card every step above
is a CUDA kernel (or ``torch.fft``), on the CPU its plain version, so the
CPU tests check the adjoint structure itself. :data:`counters` and
:data:`coef_counters` count the differentiated forwards and which
backward ran; ``REPRO_PALLAS_GRAD=0`` (``backend.resolve_pallas_grad``)
keeps the kernel forward and returns autograd's cotangents through
``ref.ski_fused_tno_ref`` / ``ref.ski_fused_tno_coef_ref`` instead.
"""
from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from repro_torch.core import toeplitz
from repro_torch.kernels import backend, ref
from repro_torch.kernels.interp_matvec import interp_reduce
from repro_torch.kernels.ski_fused import (ski_expand_pass2, ski_fused_pass2,
                                           ski_windowed_pass2)
from repro_torch.kernels.ski_grad import (conv_tap_grad, gram_coef_grad_fft,
                                          gram_grad)
from repro_torch.obs.devstats import kernel_region

#: differentiated :func:`ski_fused_tno` forwards (grad enabled and an input
#: that requires grad) and :class:`SKIFusedTNO` backwards: the kernel
#: backward, or autograd through the plain version
counters = {"fwd": 0, "bwd_kernel": 0, "bwd_ref": 0}
#: the same counts for :func:`ski_fused_tno_coef` / :class:`SKIFusedTNOCoef`
coef_counters = {"fwd": 0, "bwd_kernel": 0, "bwd_ref": 0}


def reset_counters() -> None:
    for c in (counters, coef_counters):
        for k in c:
            c[k] = 0


class SKIFusedTNO(torch.autograd.Function):
    """y = W (A (Wᵀ x)) + T_sparse x with the kernel backward of the module
    docstring. x (b, n, d); a_dense (d, r, r); filt (d, m); idx_lo / w_lo
    the inducing geometry (read by the plain versions only)."""

    @staticmethod
    def forward(ctx, x, a_dense, filt, idx_lo, w_lo, r, causal):
        ctx.save_for_backward(x, a_dense, filt, idx_lo, w_lo)
        ctx.r, ctx.causal = r, causal
        z = interp_reduce(x, idx_lo, w_lo, r)
        return ski_fused_pass2(x, z, a_dense, filt, causal)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        with kernel_region("ski_fused"):
            x, a_dense, filt, idx_lo, w_lo = ctx.saved_tensors
            r, causal = ctx.r, ctx.causal
            if not backend.resolve_pallas_grad():
                counters["bwd_ref"] += 1
                dx, da, df = backend.ref_cotangents(
                    ref.ski_fused_tno_ref, (x, a_dense, filt), g, idx_lo, w_lo,
                    r, causal)
                return dx, da, df, None, None, None, None
            counters["bwd_kernel"] += 1
            m = filt.shape[-1]
            left = 0 if causal else m // 2
            # the kernels read raw memory: contiguous copies, never lazy views
            g = g.contiguous()
            gz = interp_reduce(g, idx_lo, w_lo, r)
            z = interp_reduce(x, idx_lo, w_lo, r)
            dx = ski_fused_pass2(g, gz, a_dense, filt.flip(-1).contiguous(),
                                 causal, left=m - 1 - left, transpose_a=True)
            da = gram_grad(gz, z)
            df = conv_tap_grad(g, x, m, left)
            return (dx.to(x.dtype), da.to(a_dense.dtype), df.to(filt.dtype),
                    None, None, None, None)


def ski_fused_tno(x: torch.Tensor, a_dense: torch.Tensor,
                  filt: torch.Tensor, idx_lo: torch.Tensor,
                  w_lo: torch.Tensor, r: int, causal: bool) -> torch.Tensor:
    """Two-pass fused SKI-TNO, differentiable in (x, a_dense, filt) through
    :class:`SKIFusedTNO` on both devices."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, a_dense, filt)):
        counters["fwd"] += 1
    return SKIFusedTNO.apply(x, a_dense, filt, idx_lo, w_lo, r, causal)


# ------------------------------------------------ large-rank coef variants
def _gram_fft(a_coef: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """z2 = A z by the length-2r circulant rfft/irfft, the FFT-Gram step
    between the passes: a_coef (d, 2r-1), z (b, r, d) → contiguous
    (b, r, d)."""
    z2t = toeplitz.toeplitz_matvec(a_coef[None], z.transpose(1, 2))
    return z2t.transpose(1, 2).contiguous()


def _coef_pass2(variant: str, x, z, a_coef, filt, causal: bool,
                left: int | None = None) -> torch.Tensor:
    """Pass 2 of a coefficient variant: the windowed kernel, or the rfft
    Gram and the expand kernel."""
    if variant == "windowed":
        return ski_windowed_pass2(x, z, a_coef, filt, causal, left=left)
    return ski_expand_pass2(x, _gram_fft(a_coef, z), filt, causal, left=left)


class SKIFusedTNOCoef(torch.autograd.Function):
    """y = W (A (Wᵀ x)) + T_sparse x with A as a_coef (d, 2r-1) and the
    kernel backward of the module docstring; ``variant`` "windowed" or
    "fft". idx_lo / w_lo the inducing geometry (plain versions only)."""

    @staticmethod
    def forward(ctx, x, a_coef, filt, idx_lo, w_lo, r, causal, variant):
        ctx.save_for_backward(x, a_coef, filt, idx_lo, w_lo)
        ctx.r, ctx.causal, ctx.variant = r, causal, variant
        z = interp_reduce(x, idx_lo, w_lo, r)
        return _coef_pass2(variant, x, z, a_coef, filt, causal)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        with kernel_region(f"ski_{ctx.variant}"):
            x, a_coef, filt, idx_lo, w_lo = ctx.saved_tensors
            r, causal = ctx.r, ctx.causal
            if not backend.resolve_pallas_grad():
                coef_counters["bwd_ref"] += 1
                dx, dcoef, df = backend.ref_cotangents(
                    ref.ski_fused_tno_coef_ref, (x, a_coef, filt), g, idx_lo,
                    w_lo, r, causal)
                return dx, dcoef, df, None, None, None, None, None
            coef_counters["bwd_kernel"] += 1
            m = filt.shape[-1]
            left = 0 if causal else m // 2
            g = g.contiguous()
            gz = interp_reduce(g, idx_lo, w_lo, r)
            z = interp_reduce(x, idx_lo, w_lo, r)
            # Aᵀ of a Toeplitz matrix: the lag-reversed coefficients
            dx = _coef_pass2(ctx.variant, g, gz, a_coef.flip(-1).contiguous(),
                             filt.flip(-1).contiguous(), causal,
                             left=m - 1 - left)
            dcoef = gram_coef_grad_fft(gz, z)
            df = conv_tap_grad(g, x, m, left)
            return (dx.to(x.dtype), dcoef.to(a_coef.dtype), df.to(filt.dtype),
                    None, None, None, None, None)


def ski_fused_tno_coef(x: torch.Tensor, a_coef: torch.Tensor,
                       filt: torch.Tensor, idx_lo: torch.Tensor,
                       w_lo: torch.Tensor, r: int, causal: bool,
                       variant: str) -> torch.Tensor:
    """Large-rank fused SKI-TNO, differentiable in (x, a_coef, filt)
    through :class:`SKIFusedTNOCoef` on both devices."""
    if variant not in ("windowed", "fft"):
        raise ValueError(f"ski_fused_tno_coef: variant {variant!r} is not "
                         "'windowed' or 'fft'")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, a_coef, filt)):
        coef_counters["fwd"] += 1
    return SKIFusedTNOCoef.apply(x, a_coef, filt, idx_lo, w_lo, r, causal,
                                 variant)
