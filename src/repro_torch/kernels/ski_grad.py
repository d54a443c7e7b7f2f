"""The SKI backward's parameter cotangents with the hand-written CUDA
kernels of ``csrc/ski_grad.cu``, counterpart of ``repro/kernels/ski_grad.py``:

* :func:`conv_tap_grad` — the short conv's filter cotangent
  df[c, k] = Σ_{b,j} g[b,j,c] · x[b, j-k+left, c] (replaces the Pallas
  ``_tap_grad_kernel`` / ``_tap_grad_call_impl``);
* :func:`gram_grad` — the dense inducing-Gram cotangent
  dA[c, s, t] = Σ_b gz[b,s,c] · z[b,t,c] (replaces ``_gram_grad_kernel`` /
  ``_gram_grad_call``).

Both sum in fp32 and return fp32, as in JAX. :func:`conv_tap_grad` takes
g and x both fp32 or both bf16 (one instance of the kernel body each, the
bf16 one for Mamba's conv backward, as the TPU kernel takes bf16 tiles),
:func:`gram_grad` fp32. Each wrapper takes the plain version
(``ref.conv_tap_grad_ref``, ``ref.gram_grad_ref``) for CPU tensors and
launches its kernel for CUDA tensors, counting the launch in
:data:`counters` under the instance's name; another device, dtype or
layout raises. A kernel writes
a tensor that autograd cannot see, so on the card a wrapper called on its
own refuses an input that requires grad while grad is enabled; the
kernels' caller is the backward of ``ski_vjp.SKIFusedTNO``.

:func:`gram_coef_grad_fft` is the coefficient-form Gram cotangent of the
large-rank variants (``ski_vjp.SKIFusedTNOCoef``), as in the JAX package
an FFT correlation and not a kernel: ``torch.fft`` (cuFFT on the card).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import backend, ref
from repro_torch.kernels.interp_matvec import forward_only

#: kernel launches (CUDA path only; the CPU path counts nothing)
counters = {"gram_grad": 0, "conv_tap_grad": 0, "conv_tap_grad_bf16": 0}

#: conv_tap_grad's (entry point, launch counter) for each element type
_TAP_ENTRIES = {torch.float32: ("conv_tap_grad_f32", "conv_tap_grad"),
                torch.bfloat16: ("conv_tap_grad_bf16", "conv_tap_grad_bf16")}


def reset_counters() -> None:
    for k in counters:
        counters[k] = 0


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = backend.library("ski_grad")
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    # an earlier build, loaded by tools/ab_kernel.py, may have no bf16
    # entry: a bf16 call then fails on the missing symbol
    for name, _ in _TAP_ENTRIES.values():
        if hasattr(lib, name):
            getattr(lib, name).argtypes = [p, p, p, p, i64, i64, i64, i64,
                                           i64, p]
            getattr(lib, name).restype = ctypes.c_int
    lib.conv_tap_grad_workspace_floats.argtypes = [i64, i64, i64, i64]
    lib.conv_tap_grad_workspace_floats.restype = i64
    lib.gram_grad_f32.argtypes = [p, p, p, i64, i64, i64, p]
    lib.gram_grad_f32.restype = ctypes.c_int
    return lib


def _require_pair(what: str, a: torch.Tensor, b: torch.Tensor,
                  dtypes=(torch.float32,)) -> None:
    """Both CUDA contiguous of one dtype among ``dtypes``, one non-empty
    (b, ·, d) shape, one device."""
    forward_only(what, a, b)
    if a.dtype not in dtypes or b.dtype != a.dtype:
        names = " or ".join(str(t).removeprefix("torch.") for t in dtypes)
        raise TypeError(f"{what}: inputs {a.dtype} and {b.dtype}; the kernel "
                        f"takes both of one dtype, {names}")
    backend.require_cuda(a, what, a.dtype)
    backend.require_cuda(b, what, a.dtype)
    if a.dim() != 3 or a.shape != b.shape or a.numel() == 0 \
            or a.device != b.device:
        raise ValueError(f"{what}: inputs {tuple(a.shape)} on {a.device} and "
                         f"{tuple(b.shape)} on {b.device} are not one "
                         "non-empty (b, ·, d) shape on one device")


def conv_tap_grad(g: torch.Tensor, x: torch.Tensor, m: int,
                  left: int) -> torch.Tensor:
    """df[c, k] = Σ_{b,j} g[b,j,c] · x[b, j-k+left, c], x zero outside
    [0, n): g, x (b, n, d), both fp32 or both bf16 → (d, m) fp32. Every
    n >= 1 (n < m included) and 0 <= left < m. On the card one launch of
    the dtype's instance (``conv_tap_grad`` or ``conv_tap_grad_bf16``): 8
    blocks split the rows of a channel tile, and the block that draws the
    tile's last ticket adds their sums in block order: no floating-point
    atomics, bitwise reproducible. CPU: :func:`ref.conv_tap_grad_ref`."""
    if not 0 <= left < m:
        raise ValueError(f"conv_tap_grad: left={left} outside [0, m={m})")
    if g.device.type == "cpu" and x.device.type == "cpu":
        return ref.conv_tap_grad_ref(g, x, m, left)
    _require_pair("conv_tap_grad", g, x, tuple(_TAP_ENTRIES))
    b, n, d = x.shape
    entry, counter = _TAP_ENTRIES[x.dtype]
    lib = _lib()
    # the blocks' sums (an earlier build, loaded by tools/ab_kernel.py,
    # asks for its own size of partials through the same call)
    part = torch.empty(lib.conv_tap_grad_workspace_floats(b, n, d, m),
                       dtype=torch.float32, device=x.device)
    df = torch.empty((d, m), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        rc = getattr(lib, entry)(
            g.data_ptr(), x.data_ptr(), part.data_ptr(), df.data_ptr(), b, n,
            d, m, left, backend.stream(x))
    backend.check(lib, rc, f"conv_tap_grad {x.dtype} (b={b}, n={n}, m={m})")
    counters[counter] += 1
    return df


def gram_grad(gz: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """dA[c, s, t] = Σ_b gz[b,s,c] · z[b,t,c]: gz, z (b, r, d) → (d, r, r)
    fp32, the batch summed in order. CPU: :func:`ref.gram_grad_ref`."""
    if gz.device.type == "cpu" and z.device.type == "cpu":
        return ref.gram_grad_ref(gz, z)
    _require_pair("gram_grad", gz, z)
    b, r, d = z.shape
    da = torch.empty((d, r, r), dtype=torch.float32, device=z.device)
    lib = _lib()
    with torch.cuda.device(z.device):
        rc = lib.gram_grad_f32(gz.data_ptr(), z.data_ptr(), da.data_ptr(), b,
                               r, d, backend.stream(z))
    backend.check(lib, rc, f"gram_grad (r={r})")
    counters["gram_grad"] += 1
    return da


def gram_coef_grad_fft(gz: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Coefficient-Gram cotangent: dcoef[c, k] = Σ_{b,t} gz[b, t+lag, c] ·
    z[b, t, c] with lag = k - (r-1); gz, z (b, r, d) → (d, 2r-1) fp32.

    The diagonal sums of the dense cotangent gz zᵀ, i.e. the
    cross-correlation of the two rank-r reductions, by a length-2r
    rfft/irfft (O(r log r)): at large rank the (d, r, r) panel that
    :func:`gram_grad` writes must never exist. ``conj_physical``, not a
    lazy ``conj()``, so that no conj-bit view reaches a kernel.
    CPU and card alike; matches ``ref.gram_coef_grad_ref``."""
    r = z.shape[1]
    gs = torch.fft.rfft(gz.float(), n=2 * r, dim=1)
    zs = torch.fft.rfft(z.float(), n=2 * r, dim=1)
    spec = torch.sum(gs * torch.conj_physical(zs), dim=0)    # (r+1, d)
    c = torch.fft.irfft(spec, n=2 * r, dim=0)                # (2r, d)
    # circular correlation: lag k at c[k] (k >= 0), lag -k at c[2r - k]
    return torch.cat([c[r + 1:], c[:r]], dim=0).T.contiguous()
