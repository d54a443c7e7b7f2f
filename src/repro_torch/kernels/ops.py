"""Op entry points over the kernels (counterpart of ``repro/kernels/ops.py``).

There is no backend switch: a CPU tensor runs the plain torch version and
a CUDA tensor the hand-written kernels (see ``kernels/fd_fused.py``).
"""
from __future__ import annotations

from repro_torch.kernels import fd_fused


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
