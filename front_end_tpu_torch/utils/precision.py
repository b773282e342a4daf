"""Matmul precision pin and device choice for the port's entry points,
and float32 arithmetic that rounds as the JAX package's does.

Counterpart of `front_end_tpu/utils/precision.py`.  On the card a float32
convolution runs in TF32 by default and a matmul may be asked to, which
rounds pixel coordinates and world points to ~3 decimal digits.
`f32_precision` pins true float32 for everything under the decorated
entry point and restores the caller's settings afterwards.  `true_div`
and `linspace_f32` give a division and a grid the same on the card, the
CPU and the JAX package.
"""
from __future__ import annotations

import contextlib
import functools
from fractions import Fraction

import numpy as np
import torch


@contextlib.contextmanager
def pinned_f32():
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved[0]
        torch.backends.cudnn.allow_tf32 = saved[1]
        torch.set_float32_matmul_precision(saved[2])


def f32_precision(fn):
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with pinned_f32():
            return fn(*args, **kwargs)
    return wrapper


def resolve_device(device="cuda") -> torch.device:
    """The entry points' device: the card unless the caller asks for the
    CPU.  Asking for CUDA where there is none raises; nothing falls back."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA was requested but torch.cuda.is_available() "
                           "is False; pass device='cpu' to run on the CPU")
    return dev


def _fma_f32(a, b, c) -> np.float32:
    """a·b + c rounded once to float32 (ties to even)."""
    v = Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c))
    f = np.float32(float(v))
    best = f
    for g in (np.nextafter(f, np.float32(-np.inf)),
              np.nextafter(f, np.float32(np.inf))):
        d, db = abs(Fraction(float(g)) - v), abs(Fraction(float(best)) - v)
        if d < db or (d == db and int(g.view(np.int32)) % 2 == 0):
            best = g
    return best


def linspace_f32(start: float, stop: float, num: int,
                 endpoint: bool = True) -> np.ndarray:
    """`jnp.linspace` at float32, value for value, as the JAX package's
    CPU runs compute it: JAX's start·(1 − s) + stop·s with s = i / div,
    which XLA compiles to fma(i, stop·r, start·(1 − i·r)), r the float32
    reciprocal of div; the endpoint appended (equal to JAX's array for the
    grids of `motion/five_point.py` and `ops/akaze.py`, which the tests
    hold).  `torch.linspace` rounds otherwise (77 of the 5-point solver's
    128 values differ) and has no `endpoint=False`."""
    f32 = np.float32
    start, stop = f32(start), f32(stop)
    div = num - 1 if endpoint else num
    r = f32(1) / f32(div)
    out = [_fma_f32(f32(i), stop * r, start * (f32(1) - f32(i) * r))
           for i in range(div)]
    if endpoint:
        out.append(stop)
    return np.asarray(out, f32)


def true_div(x, c: float):
    """x / c rounded once, on every device.  CUDA divides a tensor by a
    host scalar as a product with the scalar's rounded reciprocal, one
    rounding more than the CPU's (and the JAX package's) division; a
    device-side divisor keeps the true division."""
    return x / torch.full((), c, dtype=x.dtype, device=x.device)
