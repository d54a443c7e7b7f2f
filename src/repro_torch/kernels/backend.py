"""Serving and SKI policy knobs, the backward switch, and the build/loader
of the hand-written CUDA kernels.

Dispatch has no knob: every kernel wrapper takes its plain torch version
(``kernels/ref.py``) for a tensor on the CPU and launches the CUDA kernel
for a tensor on the card, or raises. There is no fallback from one to the
other. The one switch is ``REPRO_PALLAS_GRAD=0`` (:func:`resolve_pallas_grad`),
which keeps the kernel forwards of the autograd Functions and gives them
autograd's cotangents through the plain version, counted apart
(``bwd_ref``) so that it never passes for the kernel backward.

Building: each source under ``csrc/`` (:data:`SOURCES`) is compiled by
``nvcc`` for ``sm_90a`` into its own shared library with a plain C
interface, at first use, under ``<repo>/build/repro_torch/`` (listed in
``.gitignore``). A library's file name carries a hash of its source and
the flags, so an edited source is rebuilt and an unchanged one is loaded
as it is. :func:`build` starts one ``nvcc`` per missing library, all
together. The libraries are loaded with ``ctypes``; a missing ``nvcc`` or
a failed build raises.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

_ENV_FD_STREAM = "REPRO_FD_STREAM"
_ENV_FD_STREAM_C = "REPRO_FD_STREAM_C"
_ENV_DENSE_RMAX = "REPRO_SKI_DENSE_RMAX"
_ENV_WINDOWED_RMAX = "REPRO_SKI_WINDOWED_RMAX"
_ENV_BAND_MAX = "REPRO_SKI_BAND_MAX"
_ENV_GRAD = "REPRO_PALLAS_GRAD"

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
_CSRC = Path(__file__).resolve().parent / "csrc"
#: library name -> CUDA source
SOURCES = {"fd_fused": _CSRC / "fd_fused.cu", "ski": _CSRC / "ski.cu",
           "ski_grad": _CSRC / "ski_grad.cu",
           "short_conv": _CSRC / "short_conv.cu",
           "ssd_scan": _CSRC / "ssd_scan.cu"}


# ---------------------------------------------------------- serving knobs
def _env_int(name: str, default: int) -> int:
    v = os.environ.get(name, "")
    if not v.strip():
        return default
    try:
        return int(v)
    except ValueError:
        # a typo'd knob must not silently pick another code path
        raise ValueError(f"{name}={v!r} is not an integer") from None


def fd_stream_enabled() -> bool:
    """``REPRO_FD_STREAM`` as the JAX package reads it: "auto" (default),
    1/true/on enable the overlap-save streaming decode cache; 0/false/off
    ask for the hist-replay cache, which the port does not have yet."""
    v = os.environ.get(_ENV_FD_STREAM, "auto").lower()
    if v in ("1", "true", "on", "auto", ""):
        return True
    if v in ("0", "false", "off"):
        return False
    raise ValueError(f"{_ENV_FD_STREAM}={v!r} is not one of "
                     "auto/1/0/true/false/on/off")


def fd_stream_block() -> int:
    """Overlap-save block size C (``REPRO_FD_STREAM_C``, default 64)."""
    c = _env_int(_ENV_FD_STREAM_C, 64)
    if c < 2:
        raise ValueError(f"{_ENV_FD_STREAM_C}={c} must be >= 2")
    return c


def resolve_pallas_grad() -> bool:
    """Should a differentiable op whose forward ran the kernels also run
    its kernel backward? ``REPRO_PALLAS_GRAD`` as the JAX package reads it:
    "auto" (default) and 1/true give True; 0/false keep the kernel forward
    and swap in autograd's cotangents through the plain version, for
    numerical bisection. Read at each backward."""
    return os.environ.get(_ENV_GRAD, "auto").lower() not in ("0", "false")


def ref_cotangents(fn, inputs, g, *args):
    """Autograd's cotangents of ``fn(*inputs, *args)`` at the cotangent
    ``g``, one for each of ``inputs``: the backward of the kernels' autograd
    Functions when :func:`resolve_pallas_grad` is False."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in inputs]
        return torch.autograd.grad(fn(*leaves, *args), leaves, g)


# ------------------------------------------------------ SKI rank policy
#: dense (d, r, r) Gram budget of the fused pass-2 kernel (bytes)
SKI_GRAM_BYTES_MAX = 64 << 20


def ski_dense_rank_max() -> int:
    """Largest r served by the dense-Gram fused pass 2
    (``REPRO_SKI_DENSE_RMAX``, default 512)."""
    return _env_int(_ENV_DENSE_RMAX, 512)


def ski_windowed_rank_max() -> int:
    """Largest r of the windowed variant; beyond it, "fft"
    (``REPRO_SKI_WINDOWED_RMAX``, default 4096, as in the JAX package)."""
    return _env_int(_ENV_WINDOWED_RMAX, 4096)


def ski_rank_variant(r: int, d: int | None = None) -> str:
    """How the fused SKI pipeline applies the r×r inducing Gram: "dense" |
    "windowed" | "fft", with the JAX package's thresholds, the 64 MB dense
    ceiling included (the same operator on the same route in both
    packages). ``d`` (channels) feeds the dense (d, r, r) byte budget when
    known. "dense" runs ``ski_fused_pass2``, "windowed" the banded
    ``ski_windowed_pass2``, "fft" the rfft Gram and ``ski_expand_pass2``
    (``core/ski.ski_plan``)."""
    if r <= ski_dense_rank_max() and (
            d is None or d * r * r * 4 <= SKI_GRAM_BYTES_MAX):
        return "dense"
    if r <= ski_windowed_rank_max():
        return "windowed"
    return "fft"


#: default of ``REPRO_SKI_BAND_MAX`` on Hopper (the JAX package's 128 was
#: sized for TPU VMEM); see :func:`band_budget`
SKI_BAND_MAX = 160


def band_budget() -> int:
    """Max Gram band width bw of the windowed pass 2
    (``REPRO_SKI_BAND_MAX``): :func:`band_fit` shrinks the sequence tile
    until bw fits, so the knob changes the tiling, never the result.

    The Hopper default, 160, came from the shared memory of the CUDA-core
    ``ski_windowed_pass2`` (three blocks a SM of 33,536 + 260·bw bytes
    each at a 128-row tile and m = 32: bw ≤ 166). The tensor-core kernel
    (``csrc/ski.cu`` ``window_smem``) holds 4 · (159·32 x rows + 32·32
    taps + 33·bw window + 2·128 hat rows + 3 · (128·32 z rows + 4 · (16·MT
    + 128) coefficients) of a Gram stage, raw and split into TF32 halves)
    = 80,768 + 132·bw + 768·MT bytes, MT = 9 window m-tiles (3 for
    bw ≤ 48): 105,632 at bw = 136, two blocks a SM
    (``kWindowedBlocksPerSM``, each with 1 KB the card reserves, within
    ``kSmemPerSM`` = 233,472). Since r ≤ n, h ≥ 1 and
    ``band_width(128, n, r)`` ≤ 136 ≤ 16·9: the default never shrinks the
    kernel's 128-row tile, and every window fits its 9 m-tiles."""
    return _env_int(_ENV_BAND_MAX, SKI_BAND_MAX)


def _round_up(x: int, mult: int) -> int:
    return -(-x // mult) * mult


def band_width(bn: int, n: int, r: int) -> int:
    """Static Gram band width covering every hat tap of a length-bn
    sequence tile, as the JAX package computes it: the tile's rows span
    (bn-1)/h inducing columns, plus one tap each side and fp32-floor slack,
    rounded up to 8 and capped at r rounded up to 8."""
    h = (n - 1) / max(1, r - 1)
    bw = _round_up(int((bn - 1) / h) + 4, 8)
    return max(8, min(bw, _round_up(r, 8)))


def band_fit(bn: int, n: int, r: int) -> tuple[int, int]:
    """(bn, bw) with bn halved (to a floor of 8) until the band fits
    :func:`band_budget`, as in the JAX package: bw ≈ bn·r/n follows the
    tile, so shrinking the tile is the way to narrow the band without
    changing the result."""
    bw = band_width(bn, n, r)
    while bw > band_budget() and bn > 8:
        bn = max(8, _round_up(bn // 2, 8))
        bw = band_width(bn, n, r)
    return bn, bw


# ------------------------------------------------------- build and load
def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(nvcc).is_file():
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): "
                           "the CUDA kernels are built from source at first "
                           "use and there is no fallback")
    return nvcc


def _target(name: str) -> Path:
    src = SOURCES[name]
    h = hashlib.sha256(src.read_bytes()
                       + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{src.stem}-{h}.so"


def build(*names: str) -> list[Path]:
    """Compile the named kernel libraries (all of :data:`SOURCES` when none
    is named) unless a build of their current source exists: one ``nvcc``
    per missing library, started together. Returns their paths; raises if
    any ``nvcc`` fails."""
    outs = [_target(name) for name in names or SOURCES]
    jobs = []
    for name, out in zip(names or SOURCES, outs):
        if not out.is_file():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name])]
            jobs.append((subprocess.Popen(cmd), cmd, tmp, out))
    failed = []
    for proc, cmd, tmp, out in jobs:      # wait for all before raising
        if proc.wait() == 0:
            os.replace(tmp, out)
        else:
            failed.append(subprocess.CalledProcessError(proc.returncode, cmd))
    if failed:
        raise failed[0]
    return outs


def load(path: Path) -> ctypes.CDLL:
    """The kernel library built at ``path``, its error strings typed."""
    lib = ctypes.CDLL(str(path))
    lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name`` (a key of :data:`SOURCES`), built
    first if needed."""
    return load(build(name)[0])


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error (its
    ``cudaGetLastError()`` right after the launch)."""
    if rc != 0:
        msg = lib.repro_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


# ------------------------------------------------ wrapper argument checks
def require_cuda(t: torch.Tensor, what: str, dtype: torch.dtype) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype`` whose
    memory holds its values (no lazy conj or neg bit)."""
    # a conj/neg view only sets a bit: data_ptr() holds the unconjugated
    # (un-negated) values, which the kernel would read with the wrong sign
    if t.is_conj() or t.is_neg():
        raise ValueError(f"{what}: lazily conjugated or negated view; pass "
                         "torch.conj_physical(t) or t.resolve_conj()")
    if t.device.type != "cuda":
        raise ValueError(f"{what}: tensor on {t.device}; the kernel takes "
                         "CUDA tensors and the plain version CPU tensors")
    if t.dtype != dtype:
        raise TypeError(f"{what}: dtype {t.dtype}, the kernel takes {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: tensor of shape {tuple(t.shape)} and "
                         f"strides {t.stride()} is not contiguous")


def stream(t: torch.Tensor) -> int:
    """The current CUDA stream of ``t``'s device, as an int for ctypes."""
    return torch.cuda.current_stream(t.device).cuda_stream
