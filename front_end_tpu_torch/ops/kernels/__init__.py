"""Hand-written CUDA kernels of the port, one module per kernel.

Each module holds the wrapper (launches the kernel on CUDA tensors, runs
the plain PyTorch twin on CPU tensors, raises on anything else), the
plain twin, and `launches`, a count of kernel launches.
"""
from __future__ import annotations

import importlib

NAMES = ("brief_keypoints", "brief_planes", "fast_detect", "fast_grid",
         "fast_margins", "match_reduce")


def modules() -> list:
    """The kernel modules, in the order of `NAMES`."""
    return [importlib.import_module(f"{__name__}.{n}") for n in NAMES]
