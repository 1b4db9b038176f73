"""repro_torch — the PyTorch/CUDA port of ``repro`` for one NVIDIA H100.

Mirrors ``repro`` module for module (same function names, same contracts,
same parameter-tree names and layouts) on ``torch`` tensors. The l1,inf
projection engine's three kernels (``colstats``, ``mu_solve``,
``clip_apply``) are hand-written CUDA C++ for ``sm_90a`` under ``csrc/``,
built at first use by ``_build.py``; every kernel wrapper takes its plain
PyTorch version only for a CPU tensor and launches the kernel (or raises)
for a CUDA tensor.

Entry points that create tensors take an explicit ``device``; with none
given they run on the card and raise when CUDA is missing (see
``resolve_device``). Importing this package imports neither ``jax`` nor
``repro``.
"""
from ._device import resolve_device

__all__ = ["resolve_device"]
