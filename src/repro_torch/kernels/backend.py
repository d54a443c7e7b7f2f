"""Serving policy knobs and the build/loader of the hand-written CUDA kernels.

Dispatch has no knob: every kernel wrapper takes its plain torch version
(``kernels/ref.py``) for a tensor on the CPU and launches the CUDA kernel
for a tensor on the card, or raises. There is no fallback from one to the
other.

Building: ``csrc/fd_fused.cu`` is compiled by ``nvcc`` for ``sm_90a`` into
a shared library with a plain C interface, at first use, under
``<repo>/build/repro_torch/`` (listed in ``.gitignore``). The file name
carries a hash of the source and the flags, so an edited source is rebuilt
and an unchanged one is loaded as it is. The library is loaded with
``ctypes``; a missing ``nvcc`` or a failed build raises.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_ENV_FD_STREAM = "REPRO_FD_STREAM"
_ENV_FD_STREAM_C = "REPRO_FD_STREAM_C"

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
SOURCE = Path(__file__).resolve().parent / "csrc" / "fd_fused.cu"


# ---------------------------------------------------------- serving knobs
def _env_int(name: str, default: int) -> int:
    v = os.environ.get(name, "")
    return int(v) if v.strip() else default


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


# ------------------------------------------------------- build and load
def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(nvcc).is_file():
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): "
                           "the CUDA kernels are built from source at first "
                           "use and there is no fallback")
    return nvcc


def _target() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes()
                       + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{SOURCE.stem}-{h}.so"


def build() -> Path:
    """Compile the kernel library unless a build of its current source
    exists. Returns its path; raises if ``nvcc`` fails."""
    out = _target()
    if not out.is_file():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                       check=True)
        os.replace(tmp, out)
    return out


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    lib = ctypes.CDLL(str(build()))
    lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error (its
    ``cudaGetLastError()`` right after the launch)."""
    if rc != 0:
        msg = lib.repro_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
