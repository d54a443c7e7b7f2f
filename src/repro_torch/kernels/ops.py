"""Op entry points over the kernels (counterpart of ``repro/kernels/ops.py``).

There is no backend switch: a CPU tensor runs the plain torch version and
a CUDA tensor the hand-written kernels (see ``kernels/fd_fused.py``,
``kernels/interp_matvec.py``, ``kernels/short_conv.py``,
``kernels/ski_fused.py``, ``kernels/ski_grad.py``, ``kernels/ski_vjp.py``
and ``kernels/ssd_scan.py``). As the JAX entries go through their custom VJPs,
the differentiable entries here go through autograd Functions whose
backwards launch kernels (``fd_tno``, ``short_conv``, ``interp_reduce``,
``interp_expand``, ``ski_fused_tno``, ``ski_fused_tno_coef``) or, for
``ssd_scan``, autograd through the chunked plain version;
``ski_fused_pass2`` is forward-only on the card.

Every entry runs under ``obs.devstats.kernel_region`` with the JAX
package's region names (``short_conv``, ``interp_reduce``,
``interp_expand``, ``ski_fused`` for pass 2 and the dense TNO,
``ski_{variant}``, ``fd_tno``, ``ssd``), and each autograd Function's
backward enters its entry's region again, so a profiled training step's
kernel time is all attributed. The regions are ``record_function`` ranges
while ``REPRO_PROFILE_DIR`` is set and no-ops otherwise.
"""
from __future__ import annotations

from repro_torch.kernels import (fd_fused, interp_matvec, short_conv as sc,
                                  ski_fused, ski_grad, ski_vjp,
                                  ssd_scan as ssd)
from repro_torch.obs.devstats import kernel_region


def fd_tno(x, khat_real):
    """Causal FD-TNO (paper §3.3, Algorithm 2): Hilbert-completed spectrum
    + per-channel spectral multiply + (i)rfft staging, as one op.

    x (b, n, d); khat_real (d, n+1) — the RPE's raw real frequency
    response on the rfft grid (no decay bias). Differentiable in both
    arguments (``fd_fused.FDTNO``): on the card the forward runs the lag
    window and the complex multiply as the CUDA kernels of
    ``csrc/fd_fused.cu`` around cuFFT, and the backward runs the multiply
    with the spectrum conjugated, the ``fd_khat_grad`` reduction and the
    window again; on the CPU the same op runs their plain versions."""
    with kernel_region("fd_tno"):
        return fd_fused.fd_tno(x, khat_real)


def short_conv(x, filt, causal: bool, left: int | None = None):
    """Depthwise short conv, the m-tap sparse Toeplitz part of SKI.

    x (b, n, d); filt (d, m) per-channel taps; returns (b, n, d).
    ``causal=True`` convolves lags 0..m-1, ``False`` centres the taps
    (left = m//2); ``left`` overrides the offset. Differentiable in (x,
    filt) through ``short_conv.ShortConv``: the backward is the same
    kernel with the taps flipped and the offset mirrored for dx, and
    ``conv_tap_grad`` for df."""
    if left is None:
        left = 0 if causal else filt.shape[-1] // 2
    with kernel_region("short_conv"):
        return sc.short_conv_op(x, filt, left)


def ssd_scan(x, dt, a, b, c, d_skip, *, chunk: int = 64):
    """Mamba-2 SSD chunked scan (the model zoo's state-space mixer).

    x (bt, n, h, p) fp32/bf16 per-head inputs; dt (bt, n, h) positive
    step sizes; a (h,) negative decay rates; b/c (bt, n, g, s) in/out
    projections (g groups, s state dim); d_skip (h,) skip; returns
    (bt, n, h, p) in x's dtype. Sequential oracle: ``ref.ssd_scan_ref``.
    Differentiable in all six inputs through ``ssd_scan.SSDScan`` on both
    devices: the forward is ``ssd_chunked.ssd_scan_chunked`` for CPU
    tensors and the kernel of ``csrc/ssd_scan.cu`` for CUDA tensors (both
    take ``chunk``-long blocks and every n); the backward is autograd
    through ``ssd_scan_chunked`` recomputed on the saved inputs, the
    gradient JAX takes (its Pallas kernel has no VJP)."""
    with kernel_region("ssd"):
        return ssd.ssd_scan_op(x, dt, a, b, c, d_skip, chunk=chunk)


def interp_reduce(x, idx_lo, w_lo, r: int):
    """z = Wᵀ x, projecting n positions onto r uniform inducing points.
    x (b, n, d); idx_lo (n,) / w_lo (n,) the inducing geometry (plain
    version only: the CUDA kernel regenerates the hat weights from (n, r));
    returns (b, r, d). Differentiable in x through
    ``interp_matvec.InterpReduce``: the backward is one
    :func:`interp_expand` launch."""
    with kernel_region("interp_reduce"):
        return interp_matvec.interp_reduce_op(x, idx_lo, w_lo, r)


def interp_expand(z, idx_lo, w_lo):
    """y = W z, interpolating r inducing values back to n positions.
    z (b, r, d); idx_lo (n,) / w_lo (n,) as in :func:`interp_reduce` (n is
    read off idx_lo); returns (b, n, d). Differentiable in z through
    ``interp_matvec.InterpExpand``: the backward is one
    :func:`interp_reduce` launch."""
    with kernel_region("interp_expand"):
        return interp_matvec.interp_expand_op(z, idx_lo, w_lo)


def ski_fused_pass2(x, z, a_dense, filt, causal: bool,
                    left: int | None = None):
    """Fused SKI pass 2: y = W (A z) + T_sparse x in one kernel and one
    write. x (b, n, d); z = Wᵀx (b, r, d); a_dense (d, r, r); filt (d, m);
    ``left`` overrides the causal-derived tap offset. Forward-only on the
    card: gradients go through :func:`ski_fused_tno`."""
    with kernel_region("ski_fused"):
        return ski_fused.ski_fused_pass2(x, z, a_dense, filt, causal,
                                         left=left)


def ski_fused_tno(x, a_dense, filt, idx_lo, w_lo, r: int, causal: bool):
    """Differentiable two-pass fused SKI-TNO: y = W (A (Wᵀ x)) + T_sparse x.

    x (b, n, d); a_dense (d, r, r) per-channel inducing Gram; filt (d, m);
    idx_lo / w_lo the inducing geometry (plain versions only: the kernels
    regenerate the hat weights). x fp32 or bf16 (fp32 sums, y in x's
    dtype; on the card the bf16 instances). The op the TNN block trains
    through,
    ``ski_vjp.SKIFusedTNO`` on both devices: on the card the forward is
    ``interp_reduce`` then ``ski_fused_pass2`` and the backward is kernel
    launches too (``interp_reduce`` twice, the transposed pass 2,
    ``gram_grad``, ``conv_tap_grad``); on the CPU the same structure runs
    the plain versions. ``REPRO_PALLAS_GRAD=0`` swaps in autograd's
    cotangents through ``ref.ski_fused_tno_ref``."""
    with kernel_region("ski_fused"):
        return ski_vjp.ski_fused_tno(x, a_dense, filt, idx_lo, w_lo, r, causal)


def ski_fused_tno_coef(x, a_coef, filt, idx_lo, w_lo, r: int, causal: bool,
                       variant: str):
    """Differentiable large-rank fused SKI-TNO, the Gram as its Toeplitz
    coefficients: y = W (A (Wᵀ x)) + T_sparse x.

    x (b, n, d); a_coef (d, 2r-1) lags -(r-1)..r-1 of the inducing Gram
    (never materialised dense); filt (d, m); idx_lo / w_lo the inducing
    geometry (plain versions only). ``variant`` "windowed" (pass 2 the
    banded ``ski_windowed_pass2``) or "fft" (the Gram by rfft/irfft between
    the passes, pass 2 ``ski_expand_pass2``): two ways to one operator,
    ``ref.ski_fused_tno_coef_ref``. Through ``ski_vjp.SKIFusedTNOCoef`` on
    both devices: the backward launches ``interp_reduce`` twice, the same
    pass 2 with the coefficients lag-flipped, the taps flipped and left
    mirrored, and ``conv_tap_grad``, with ``gram_coef_grad_fft`` on
    ``torch.fft``. ``REPRO_PALLAS_GRAD=0`` swaps in autograd's cotangents
    through the plain version."""
    with kernel_region(f"ski_{variant}"):
        return ski_vjp.ski_fused_tno_coef(x, a_coef, filt, idx_lo, w_lo, r,
                                          causal, variant)


def reset_ski_counters() -> None:
    """Zero the launch counts of the SKI kernels and the counts of the SKI
    autograd Functions' forwards and backwards."""
    for mod in (interp_matvec, sc, ski_fused, ski_grad, ski_vjp):
        mod.reset_counters()


def ski_counters() -> dict:
    """Launch counts of the eight SKI kernels (``interp_reduce``,
    ``interp_expand``, ``short_conv``, ``ski_fused_pass2``,
    ``ski_windowed_pass2``, ``ski_expand_pass2``, ``gram_grad``,
    ``conv_tap_grad``) and of their bf16 instances, each under its own
    name: ``interp_reduce_bf16``, ``interp_expand_bf16`` (the unfused
    route), ``ski_fused_pass2_bf16`` and ``ski_fused_pass2_at_bf16`` (Aᵀ,
    the bf16 signal backward), ``ski_windowed_pass2_bf16`` and
    ``ski_expand_pass2_bf16`` (the large-rank routes, both orientations),
    ``gram_grad_bf16`` and ``conv_tap_grad_bf16`` (Mamba's conv backward
    and the bf16 SKI model's), since their last reset. ``short_conv``
    counts both of its dtypes."""
    return {**interp_matvec.counters, **sc.counters, **ski_fused.counters,
            **ski_grad.counters}


def ski_op_counters() -> dict:
    """Differentiated forwards and backwards (``fwd``, ``bwd_kernel``,
    ``bwd_ref``) of each SKI autograd Function since the last reset."""
    return {"SKIFusedTNO": dict(ski_vjp.counters),
            "SKIFusedTNOCoef": dict(ski_vjp.coef_counters),
            "ShortConv": dict(sc.op_counters),
            "InterpReduce": dict(interp_matvec.reduce_op_counters),
            "InterpExpand": dict(interp_matvec.expand_op_counters)}
