"""PyTorch + CUDA port of the ``repro`` package for NVIDIA Hopper.

Module names mirror ``src/repro/`` so each counterpart is easy to find.
The package imports ``torch`` and never ``jax`` or anything of ``repro``;
the parity tests under ``tests/test_torch_*.py`` are the only place the
two packages meet. Entry points run on ``cuda`` unless the caller passes
``device="cpu"``; on the CPU every kernel wrapper runs its plain torch
version (``kernels/ref.py``).
"""
