"""The trainable fused SKI-TNO, counterpart of the dense
``ski_fused_tno_pallas`` custom VJP of ``repro/kernels/ski_vjp.py``
(``:51-115``).

Every factor of the two-pass pipeline is linear in the signal, so the
backward is the transposed pipeline and reuses the forward kernels::

    forward   z  = Wᵀ x                        interp_reduce
              y  = W (A z) + T_sparse x        ski_fused_pass2
    backward  gz = Wᵀ g, z = Wᵀ x (recomputed) interp_reduce, twice
              dx = W (Aᵀ gz) + T_sparseᵀ g     ski_fused_pass2 with A
                                               transposed, the taps flipped
                                               and left -> m-1-left
              dA[c] = Σ_b gz[b,:,c] z[b,:,c]ᵀ  gram_grad
              df[c,k] = Σ_{b,j} g[b,j,c] x[b,j-k+left,c]   conv_tap_grad

Residuals are the op's inputs (x, A, f) only: no O(n·r) activation is
kept. :class:`SKIFusedTNO` runs on both devices: on the card every step
above is a CUDA kernel, on the CPU its plain version, so the CPU tests
check the adjoint structure itself. :data:`counters` counts the
differentiated forwards and which backward ran; ``REPRO_PALLAS_GRAD=0``
(``backend.resolve_pallas_grad``) keeps the kernel forward and returns
autograd's cotangents through ``ref.ski_fused_tno_ref`` instead.
"""
from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from repro_torch.kernels import backend, ref
from repro_torch.kernels.interp_matvec import interp_reduce
from repro_torch.kernels.ski_fused import ski_fused_pass2
from repro_torch.kernels.ski_grad import conv_tap_grad, gram_grad

#: differentiated :func:`ski_fused_tno` forwards (grad enabled and an input
#: that requires grad) and :class:`SKIFusedTNO` backwards: the kernel
#: backward, or autograd through the plain version
counters = {"fwd": 0, "bwd_kernel": 0, "bwd_ref": 0}


def reset_counters() -> None:
    for k in counters:
        counters[k] = 0


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
        dx = ski_fused_pass2(g, gz, a_dense.transpose(1, 2).contiguous(),
                             filt.flip(-1).contiguous(), causal,
                             left=m - 1 - left)
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
