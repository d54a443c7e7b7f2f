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
_ENV_GRAD = "REPRO_PALLAS_GRAD"

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
_CSRC = Path(__file__).resolve().parent / "csrc"
#: library name -> CUDA source
SOURCES = {"fd_fused": _CSRC / "fd_fused.cu", "ski": _CSRC / "ski.cu",
           "ski_grad": _CSRC / "ski_grad.cu"}


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
    "windowed" | "fft", with the JAX package's thresholds. ``d`` (channels)
    feeds the dense (d, r, r) byte budget when known. Only "dense" is
    ported; ``core/ski.ski_plan`` raises for the others."""
    if r <= ski_dense_rank_max() and (
            d is None or d * r * r * 4 <= SKI_GRAM_BYTES_MAX):
        return "dense"
    if r <= ski_windowed_rank_max():
        return "windowed"
    return "fft"


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


@functools.cache
def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name`` (a key of :data:`SOURCES`), built
    first if needed."""
    lib = ctypes.CDLL(str(build(name)[0]))
    lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib


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
