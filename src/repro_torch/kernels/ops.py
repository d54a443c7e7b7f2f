"""Op entry points over the kernels (counterpart of ``repro/kernels/ops.py``).

There is no backend switch: a CPU tensor runs the plain torch version and
a CUDA tensor the hand-written kernels (see ``kernels/fd_fused.py``,
``kernels/interp_matvec.py``, ``kernels/ski_fused.py``,
``kernels/ski_grad.py`` and ``kernels/ski_vjp.py``).
"""
from __future__ import annotations

from repro_torch.kernels import (fd_fused, interp_matvec, ski_fused,
                                  ski_grad, ski_vjp)


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
    return fd_fused.fd_tno(x, khat_real)


def interp_reduce(x, idx_lo, w_lo, r: int):
    """z = Wᵀ x, projecting n positions onto r uniform inducing points.
    x (b, n, d); idx_lo (n,) / w_lo (n,) the inducing geometry (plain
    version only: the CUDA kernel regenerates the hat weights from (n, r));
    returns (b, r, d). Forward-only on the card: gradients go through
    :func:`ski_fused_tno`."""
    return interp_matvec.interp_reduce(x, idx_lo, w_lo, r)


def ski_fused_pass2(x, z, a_dense, filt, causal: bool,
                    left: int | None = None):
    """Fused SKI pass 2: y = W (A z) + T_sparse x in one kernel and one
    write. x (b, n, d); z = Wᵀx (b, r, d); a_dense (d, r, r); filt (d, m);
    ``left`` overrides the causal-derived tap offset. Forward-only on the
    card: gradients go through :func:`ski_fused_tno`."""
    return ski_fused.ski_fused_pass2(x, z, a_dense, filt, causal, left=left)


def ski_fused_tno(x, a_dense, filt, idx_lo, w_lo, r: int, causal: bool):
    """Differentiable two-pass fused SKI-TNO: y = W (A (Wᵀ x)) + T_sparse x.

    x (b, n, d); a_dense (d, r, r) per-channel inducing Gram; filt (d, m);
    idx_lo / w_lo the inducing geometry (plain versions only: the kernels
    regenerate the hat weights). The op the TNN block trains through,
    ``ski_vjp.SKIFusedTNO`` on both devices: on the card the forward is
    ``interp_reduce`` then ``ski_fused_pass2`` and the backward is kernel
    launches too (``interp_reduce`` twice, the transposed pass 2,
    ``gram_grad``, ``conv_tap_grad``); on the CPU the same structure runs
    the plain versions. ``REPRO_PALLAS_GRAD=0`` swaps in autograd's
    cotangents through ``ref.ski_fused_tno_ref``."""
    return ski_vjp.ski_fused_tno(x, a_dense, filt, idx_lo, w_lo, r, causal)


def reset_ski_counters() -> None:
    """Zero the launch counts of the four SKI kernels and the counts of
    ``SKIFusedTNO``'s forwards and backwards."""
    for mod in (interp_matvec, ski_fused, ski_grad, ski_vjp):
        mod.reset_counters()


def ski_counters() -> dict:
    """Launch counts of the four SKI kernels since their last reset."""
    return {**interp_matvec.counters, **ski_fused.counters,
            **ski_grad.counters}
