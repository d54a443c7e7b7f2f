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
    response on the rfft grid (no decay bias). On the card the lag window
    and the complex multiply are the CUDA kernels of ``csrc/fd_fused.cu``
    around cuFFT, forward-only for now; on the CPU it is plain torch with
    autograd."""
    return fd_fused.fd_tno(x, khat_real)
